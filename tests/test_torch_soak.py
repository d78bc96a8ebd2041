"""The port's long-stream soak (kfnet_tpu_torch/tools/soak.py) on the CPU:
the cases of tests/test_soak.py that run by default (the mini soak, the
short stream's missing RSS window, the empty stream's error), the soak's
frames and report against the JAX package's soak on the same scene with
the same tiny weights, and the scene table (tools/protocol.py) equal to
the JAX package's.

Tolerances: the rendered frames as tests/test_torch_synthetic.py holds
the renderer (at most 0.1% of pixels off by more than 1e-4: sphere
silhouettes); the report's covariance and state figures at the goldens'
rtol 5e-4 / atol 5e-5; the consistency fractions within 0.01, as
tests/test_soak.py holds its chunked aux against the one-shot run (the χ²
gate may flip borderline pixels).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kfnet_tpu.models import kfnet as jkfnet
from kfnet_tpu.tools import protocol as jprotocol
from kfnet_tpu.tools import soak as jsoak
from kfnet_tpu_torch import convert
from kfnet_tpu_torch.tools import protocol, soak
from tests import tiny_configs as tc
from tests.test_torch_models import port_config


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
  jcfg = tc.tiny_kfnet()
  jparams = jkfnet.init(jax.random.key(0), jcfg, tc.IMG)
  tparams = convert.params_from_jax(
      jax.tree_util.tree_map(np.asarray, jparams))
  return jcfg, jparams, port_config(jcfg), tparams


@pytest.fixture(scope="module")
def mini(tiny):
  _, _, tcfg, tparams = tiny
  return soak.run_soak(tparams, tcfg, 100, 48, 64, chunk=24, log=None,
                       device="cpu")


def test_soak_harness_mini(mini):
  rep = mini
  assert rep["frames"] == 100
  assert rep["nonfinite_chunks"] == 0
  assert rep["min_P"] > 0
  assert np.isfinite(rep["max_abs_x"])
  assert rep["backend"] == "cpu"
  assert soak.healthy(rep) == []


def test_soak_report_equals_jax(tiny, mini):
  jcfg, jparams, _, _ = tiny
  want = jsoak.run_soak(jparams, jcfg, 100, 48, 64, chunk=24, log=None)
  for k in ("frames", "height", "width", "chunk", "world_scale",
            "nonfinite_chunks"):
    assert mini[k] == want[k], k
  for k in ("max_abs_x", "max_P", "min_P", "max_V", "mean_P_early",
            "mean_P_late"):
    np.testing.assert_allclose(mini[k], want[k], rtol=5e-4, atol=5e-5,
                               err_msg=k)
  for k in ("consistent_frac_early", "consistent_frac_late",
            "consistent_frac_min"):
    assert abs(mini[k] - want[k]) <= 0.01, k
  assert sorted(mini) == sorted(want)


def test_device_frame_chunks_equal_jax():
  got = list(soak.device_frame_chunks(30, 48, 64, 12, seed=3, scale=1.0,
                                      device="cpu"))
  want = list(jsoak.device_frame_chunks(30, 48, 64, 12, seed=3, scale=1.0))
  assert [g.shape[0] for g in got] == [w.shape[0] for w in want] == [12, 12,
                                                                     6]
  g = torch.cat(got).numpy()
  w = np.concatenate([np.asarray(x) for x in want])
  assert (np.abs(g - w) > 1e-4).mean() <= 1e-3


def test_soak_short_stream_flags_missing_rss_window(tiny):
  """A stream too short for a whole RSS window is flagged by healthy(),
  not passed by default."""
  _, _, tcfg, tparams = tiny
  rep = soak.run_soak(tparams, tcfg, 20, 48, 64, chunk=24, log=None,
                      device="cpu")
  assert rep["rss_growth_mb"] is None
  problems = soak.healthy(rep)
  assert any("RSS growth window absent" in p for p in problems), problems


def test_soak_empty_stream_raises(tiny):
  _, _, tcfg, tparams = tiny
  with pytest.raises(ValueError, match="no frames"):
    soak.run_soak(tparams, tcfg, 0, 48, 64, chunk=24, log=None,
                  device="cpu")


@pytest.mark.parametrize("field,value,problem", [
    ("nonfinite_chunks", lambda r: 2, "nonfinite"),
    ("min_P", lambda r: 0.0, "covariance floor"),
    ("max_P", lambda r: 2.0 * r["max_V"] + 1.0, "measurement envelope"),
    ("mean_P_late", lambda r: 3.0 * r["mean_P_early"] + 1.0, "drifted up"),
    ("consistent_frac_late",
     lambda r: r["consistent_frac_early"] + 0.5, "consistency fraction"),
    ("rss_growth_mb", lambda r: 1000.0, "host RSS grew")])
def test_healthy_flags_as_jax(mini, field, value, problem):
  rep = dict(mini, **{field: value(mini)})
  got = soak.healthy(rep)
  assert got == jsoak.healthy(rep)
  assert any(problem in p for p in got), got


def test_scene_table_equals_jax():
  assert ([dataclasses.astuple(s) for s in protocol.DEFAULT_SCENES]
          == [dataclasses.astuple(s) for s in jprotocol.DEFAULT_SCENES])


def test_soak_cli_on_the_shipped_weights(tmp_path):
  report = tmp_path / "soak.json"
  rc = soak.main(["--frames", "60", "--chunk", "12", "--device", "cpu",
                  "--report", str(report)])
  import json
  with open(report) as f:
    rep = json.load(f)
  assert rep["frames"] == 60 and (rep["height"], rep["width"]) == (96, 128)
  assert rc == (0 if rep["healthy"] else 1)
  assert rep["healthy"], rep["problems"]
