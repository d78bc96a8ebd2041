"""The port's diagnosis (kfnet_tpu_torch/tools/diagnose.py) on the CPU:
tests/test_diagnose_stats.py's 20 cases, each run through both packages on
the same numpy inputs — its own assertions on the port's statistics, and
every output of the port's within 1e-6 relative of the JAX package's —
and main on a tiny cached work dir: the filtered rows' labels equal the
JAX tool's, and a --modes re-run merged into its report replaces only the
rows it re-ran; the report records seed_offset and scoordnet_norm beside
the JAX tool's keys, and a re-run refuses to merge into a report of other
settings.
"""

import contextlib
import inspect
import json
import unittest.mock as mock

import jax
import numpy as np
import pytest
import torch

from kfnet_tpu import configs as jconfigs
from kfnet_tpu.models import kfnet as jkfnet
from kfnet_tpu.tools import diagnose as jdiagnose
from kfnet_tpu.tools import protocol as jprotocol
from kfnet_tpu_torch.tools import diagnose, diagnose_summary, protocol
from tests import test_diagnose_stats as cases

FUNCS = ("residual_stats", "scene_geometry", "counterfactual_maps",
         "merge_modes")
CASES = [name for name, fn in inspect.getmembers(cases, inspect.isfunction)
         if name.startswith("test_")]
REL = 1e-6


@contextlib.contextmanager
def routed_to(module, calls):
  """The statistics of tests/test_diagnose_stats.py taken from ``module``,
  each call's output recorded in ``calls``."""
  with contextlib.ExitStack() as stack:
    for name in FUNCS:
      real = getattr(module, name)

      def rec(*a, _real=real, **kw):
        out = _real(*a, **kw)
        calls.append(out)
        return out

      # the test module binds residual_stats at import; the others it
      # imports from the JAX package's module inside each test
      stack.enter_context(mock.patch.object(jdiagnose, name, rec))
      if hasattr(cases, name):
        stack.enter_context(mock.patch.object(cases, name, rec))
    yield


def _close(got, want, where):
  if isinstance(want, dict):
    assert list(got) == list(want), where
    for k in want:
      _close(got[k], want[k], f"{where}.{k}")
  elif isinstance(want, list):
    assert len(got) == len(want), where
    for i, (g, w) in enumerate(zip(got, want)):
      _close(g, w, f"{where}[{i}]")
  elif want is None or isinstance(want, str):
    assert got == want, where
  else:
    np.testing.assert_allclose(np.asarray(got, np.float64),
                               np.asarray(want, np.float64), rtol=REL,
                               atol=0, err_msg=where)
    assert np.asarray(got).dtype == np.asarray(want).dtype, where


@pytest.mark.parametrize("case", CASES)
def test_stats_case_equals_jax(case):
  want, got = [], []
  with routed_to(jdiagnose, want):
    getattr(cases, case)()
  with routed_to(diagnose, got):
    getattr(cases, case)()
  assert len(got) == len(want) > 0
  for i, (g, w) in enumerate(zip(got, want)):
    _close(g, w, f"{case} call {i}")


ARGS = ["--height", "96", "--width", "128", "--train_frames", "6",
        "--test_frames", "6", "--scene", "sceneA"]


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  d = str(tmp_path_factory.mktemp("diagnose") / "cache")
  scenes = tuple(s for s in protocol.DEFAULT_SCENES if s.name == "sceneA")
  protocol.prepare_stages(H=96, W=128, train_frames=6, test_frames=6,
                          sc_steps=1, of_steps=1, joint_steps=1,
                          scenes=scenes, log=None, work_dir=d, device="cpu")
  yield d
  torch.set_num_threads(threads)


def _jax_filtered_labels():
  """The JAX tool's filtered rows' labels, from its main over an untrained
  model of the protocol's config (the labels depend on the config only)."""
  spec = next(s for s in jprotocol.DEFAULT_SCENES if s.name == "sceneA")

  def stages(scenes, **kw):
    data = {spec.name: jprotocol._scene_data(spec, 96, 128, 6, 6)}
    cfg = jkfnet.KFNetConfig(scoordnet=jconfigs.small_scoordnet(),
                             oflownet=jconfigs.small_oflownet())
    params = jkfnet.init(jax.random.key(0), cfg, (96, 128, 3))
    return data, None, None, {spec.name: (cfg, params)}

  with mock.patch.object(jprotocol, "prepare_stages", stages):
    out = jdiagnose.main(["--work_dir", "unused", *ARGS,
                          "--modes", "filtered"])
  return [r["mode"] for r in out["modes"]]


def test_main_labels_and_merge(cache, tmp_path):
  report = str(tmp_path / "diag.json")
  out = diagnose.main(["--work_dir", cache, *ARGS, "--device", "cpu",
                       "--report", report])
  labels = [r["mode"] for r in out["modes"]]
  assert labels[:4] == ["measurement_only", "cf_derigid", "cf_derigid_pool",
                        "cf_rigidonly"]
  assert labels[4:] == _jax_filtered_labels()
  for row in out["modes"]:
    assert np.isfinite(row["median_translation_m"])
    assert row["median_coord_err_m"] is not None
  assert np.isfinite(out["scene_geometry"]["lever_arm_gain"])
  assert list(out) == ["scene", "stress", "test_frames", "seed_offset",
                       "scoordnet_norm", "scene_geometry", "modes"]
  assert (out["seed_offset"], out["scoordnet_norm"]) == (0, None)

  # a targeted re-run replaces only its own rows in the report
  with open(report) as f:
    first = json.load(f)["modes"]
  again = diagnose.main(["--work_dir", cache, *ARGS, "--device", "cpu",
                         "--report", report, "--modes", "measurement_only"])
  with open(report) as f:
    merged = json.load(f)["modes"]
  assert again["modes"] == merged
  assert [r["mode"] for r in merged] == (
      ["measurement_only"] + [r["mode"] for r in first
                              if r["mode"] != "measurement_only"])
  assert merged[1:] == [r for r in first if r["mode"] != "measurement_only"]


RUN = {"scene": "sceneA", "stress": 0.0, "test_frames": 6, "seed_offset": 0,
       "scoordnet_norm": None}


@pytest.mark.parametrize("key,other", [
    ("scene", "heldout"), ("stress", 0.5), ("test_frames", 7),
    ("seed_offset", 1), ("scoordnet_norm", "none")])
def test_merge_refuses_a_report_of_other_settings(key, other):
  with pytest.raises(ValueError, match=key):
    diagnose.check_same_run({**RUN, key: other, "modes": []}, RUN)
  diagnose.check_same_run({**RUN, "modes": []}, RUN)


def test_merge_refuses_a_report_that_lacks_the_settings():
  """A report without seed_offset and scoordnet_norm (the JAX tool's)
  cannot show it was made under this run's settings."""
  prev = {k: v for k, v in RUN.items() if k not in ("seed_offset",
                                                    "scoordnet_norm")}
  with pytest.raises(ValueError, match="seed_offset=.missing"):
    diagnose.check_same_run(prev, RUN)


@pytest.mark.parametrize("key,other", [("scene", "heldout"),
                                       ("seed_offset", 1)])
def test_main_refuses_to_merge_into_another_runs_report(cache, tmp_path, key,
                                                        other):
  """A --modes re-run over a report whose scene or seed_offset differs
  raises before it runs anything and leaves the report as it was."""
  report = tmp_path / "diag.json"
  report.write_text(json.dumps({**RUN, key: other, "scene_geometry": {},
                                "modes": [{"mode": "measurement_only"}]}))
  before = report.read_text()
  with mock.patch.object(protocol, "prepare_stages",
                         side_effect=AssertionError("the run started")):
    with pytest.raises(ValueError, match=key):
      diagnose.main(["--work_dir", cache, *ARGS, "--device", "cpu",
                     "--report", str(report), "--modes", "measurement_only"])
  assert report.read_text() == before


def test_summary_prints_a_dash_for_a_degenerate_geometry(tmp_path, capsys):
  """No frame with more than 100 valid cells: scene_geometry's values are
  None, and the summary prints "—" for each (the JAX tool raises)."""
  geometry = diagnose.scene_geometry(np.zeros((2, 6, 8, 3)),
                                     np.zeros((2, 6, 8), bool),
                                     np.zeros((2, 3)))
  assert set(geometry.values()) == {None}
  row = {"mode": "measurement_only", "median_translation_m": 0.5}
  paths = []
  for name in ("gn", "alt"):
    path = tmp_path / f"{name}.json"
    path.write_text(json.dumps({**RUN, "scene_geometry": geometry,
                                "modes": [row]}))
    paths.append(str(path))
  table = diagnose_summary.main(["--pairs", "tiny:" + ":".join(paths)])
  lines = capsys.readouterr().out.splitlines()
  assert lines[-1] == ("tiny: lever_arm_gain=— (cam-centroid d=— m, "
                       "cloud radius r=— m)")
  assert [r[:2] for r in table] == [["tiny/group", "0.500"],
                                    ["tiny/none", "0.500"]]
