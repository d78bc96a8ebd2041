"""A second model family brought to the harness as files only: the toy
family in ``toy_family/`` (SCoordNet at the port's tiny widths, then the
port's PnP-RANSAC, no filter and no OFlowNet), found through a family
search path that only this test sets. A sound run of one camera is
correct; a measurement map moved by one cell is not; a limits file that
names a number the family does not define is not."""

from __future__ import annotations

import json
import os

import pytest
import torch

from perfbench import run
from perfbench.tests import tiny

HERE = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                    "toy_family")
CPU = torch.device("cpu")
CELL = {"name": "toy-stream1", "config": "toy-measure-only",
        "traffic": "stream1", "chips": 1}


def _load(name):
  with open(os.path.join(HERE, name)) as f:
    return json.load(f)


@pytest.fixture
def toy(monkeypatch):
  monkeypatch.setattr(run, "FAMILY_DIRS", [HERE] + run.FAMILY_DIRS)
  return _load("measure_only.json")


def _run(cfg, limits, seed=2 ** 31 + 29):
  res, _ = run.run_cell(CELL, cfg, tiny.mix("gn-stream1"), seed, 1.5, False,
                        CPU, limits)
  return res


def test_the_family_is_found_only_on_the_test_path(toy, monkeypatch):
  assert run.load_family(toy).NUMBERS == ("meas_z_rel", "pose_mismatch")
  monkeypatch.setattr(run, "FAMILY_DIRS", run.FAMILY_DIRS[1:])
  with pytest.raises(LookupError):
    run.family_file(toy)


def test_a_sound_run_is_correct(toy):
  res = _run(toy, _load("limits.json"))
  assert res["correct"], res["checks"]
  assert list(res["checks"]) == ["meas_z_rel", "pose_mismatch"]
  assert res["attempted"] > 0 and res["failed"] == 0


def test_a_measurement_moved_by_one_cell_is_not_correct(toy, monkeypatch):
  from kfnet_tpu_torch.models import scoordnet
  real = scoordnet.apply

  def moved(*args, **kwargs):
    z, V = real(*args, **kwargs)
    return torch.roll(z, 1, dims=-2), V

  monkeypatch.setattr(scoordnet, "apply", moved)
  res = _run(toy, _load("limits.json"))
  assert not res["correct"], res["checks"]
  assert res["checks"]["meas_z_rel"]["value"] > 0.01


def test_a_limit_on_a_number_the_family_lacks_is_not_correct(toy):
  limits = dict(_load("limits.json"), step_x_rel={"limit": 1.0})
  res = _run(toy, limits)
  assert not res["correct"]
  assert res["checks"]["step_x_rel"] == {"value": None, "limit": 1.0}
  assert list(res["checks"]) == ["meas_z_rel", "pose_mismatch",
                                 "step_x_rel"]
