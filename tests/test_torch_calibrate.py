"""The port's calibration sweep (kfnet_tpu_torch/tools/calibrate.py) against
the JAX package's on the CPU: tests/test_calibrate.py's cases, each held
against JAX where JAX computes the same thing, on the tiny config with
JAX-initialised weights carried across by convert.py.

Tolerances: the series and the recursion at the goldens' rtol 5e-4 /
atol 5e-5 (tests/test_goldens.py); the recursion against the port's own
run_filter as tests/test_calibrate.py holds JAX's (atol 2e-5 on x, rtol
2e-5 + atol 1e-7 on P); the pose solves draw from another generator than
JAX's keys, so the sweep's rows are held by their keys and count, and
their values finite.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfnet_tpu.models import kfnet as jkfnet
from kfnet_tpu.tools import calibrate as jcalibrate
from kfnet_tpu_torch import convert
from kfnet_tpu_torch.filter import sequence
from kfnet_tpu_torch.models import kfnet
from kfnet_tpu_torch.pose import ransac
from kfnet_tpu_torch.tools import calibrate
from tests import tiny_configs as tc
from tests.test_torch_models import port_config

GOLDEN = dict(rtol=5e-4, atol=5e-5)
RCFG = dict(num_hypotheses=16, top_k=64)
K = np.asarray([[60.0, 0, 31.5], [0, 60.0, 23.5], [0, 0, 1]], np.float32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
  """JAX params, config, frames and series (w_scale 1), and the port's."""
  jcfg = tc.tiny_kfnet(w_scale=1.0)
  jparams = jkfnet.init(jax.random.key(0), jcfg, tc.IMG)
  images = tc.random_images(6, seed=1)
  jseries = jcalibrate.precompute_series(jparams, jcfg, images)
  tparams = convert.params_from_jax(
      jax.tree_util.tree_map(np.asarray, jparams))
  tcfg = port_config(jcfg, use_fused_kernel=False)
  timages = torch.from_numpy(np.array(images))
  tseries = calibrate.precompute_series(tparams, tcfg, timages)
  return {"jcfg": jcfg, "jparams": jparams, "images": images,
          "jseries": {k: np.asarray(v) for k, v in jseries.items()},
          "tcfg": tcfg, "tparams": tparams, "timages": timages,
          "tseries": tseries}


def _np(a):
  return a.detach().cpu().numpy()


def test_precompute_series_matches_jax(tiny):
  assert sorted(tiny["tseries"]) == sorted(tiny["jseries"])
  for k, want in tiny["jseries"].items():
    np.testing.assert_allclose(_np(tiny["tseries"][k]), want, err_msg=k,
                               **GOLDEN)


@pytest.mark.parametrize("stat", ["s", "v"])
@pytest.mark.parametrize("alpha", [0.0, 2.0])
@pytest.mark.parametrize("w", [1.0, 8.0])
@pytest.mark.parametrize("chi2", [0.0, 7.81])
def test_filter_from_series_matches_jax(tiny, chi2, w, alpha, stat):
  """The recursion alone, on the same series (JAX's, carried across)."""
  series = {k: torch.tensor(v) for k, v in tiny["jseries"].items()}
  xs, Ps = calibrate.filter_from_series(tiny["tcfg"], series, chi2, w,
                                        alpha, adaptive_stat=stat)
  jxs, jPs = jcalibrate.filter_from_series(
      tiny["jcfg"], tiny["jseries"], jnp.float32(chi2), jnp.float32(w),
      jnp.float32(alpha), adaptive_stat=stat)
  np.testing.assert_allclose(_np(xs), np.asarray(jxs), **GOLDEN)
  np.testing.assert_allclose(_np(Ps), np.asarray(jPs), **GOLDEN)


@pytest.mark.parametrize("fused", [False, True])
def test_series_recursion_matches_run_filter(tiny, fused):
  """filter_from_series with the knobs as tensors == run_filter with the
  same values in the config (non-default values included); on the CPU the
  fused kernel's config takes the kernel's plain version."""
  for w_scale, chi2 in [(1.0, None), (4.0, 2.37)]:
    kw = {"w_scale": w_scale, "use_fused_kernel": fused}
    if chi2 is not None:
      kw["chi2_threshold"] = chi2
    cfg = dataclasses.replace(tiny["tcfg"], **kw)
    xs_ref, Ps_ref, _ = sequence.run_filter(tiny["tparams"], cfg,
                                            tiny["timages"])
    xs, Ps = calibrate.filter_from_series(
        tiny["tcfg"], tiny["tseries"], torch.tensor(cfg.chi2_threshold),
        torch.tensor(w_scale))
    np.testing.assert_allclose(_np(xs), _np(xs_ref), atol=2e-5)
    np.testing.assert_allclose(_np(Ps), _np(Ps_ref), rtol=2e-5, atol=1e-7)


def test_measurement_maps_match_first_frame_and_measure(tiny):
  zs, Vs = calibrate.measurement_maps(tiny["tseries"])
  pre = kfnet.preprocess_images(tiny["tcfg"], tiny["timages"])
  z3, V3 = kfnet.measure(tiny["tparams"], tiny["tcfg"], pre[3])
  np.testing.assert_allclose(_np(zs[3]), _np(z3), atol=5e-5)
  np.testing.assert_allclose(_np(Vs[3]), _np(V3), atol=5e-5)


def test_w_scale_limits(tiny):
  """w_scale → large must drive the posterior to the measurement (K → 1);
  w_scale < 1 must pull it closer to the prior than w_scale = 1."""
  cfg, series = tiny["tcfg"], tiny["tseries"]
  zs, _ = calibrate.measurement_maps(series)
  chi2 = 1e9  # disable the gate so the limit is pure-gain
  xs_huge, _ = calibrate.filter_from_series(cfg, series, chi2, 1e9)
  np.testing.assert_allclose(_np(xs_huge), _np(zs), atol=1e-4)
  xs_1, _ = calibrate.filter_from_series(cfg, series, chi2, 1.0)
  xs_small, _ = calibrate.filter_from_series(cfg, series, chi2, 0.25)
  d1 = float(torch.mean(torch.abs(xs_1[1:] - zs[1:])))
  dsmall = float(torch.mean(torch.abs(xs_small[1:] - zs[1:])))
  assert dsmall > d1 > 0  # smaller W ⇒ more prior weight ⇒ further from z


def test_chi2_zero_is_measurement_only(tiny):
  zs, Vs = calibrate.measurement_maps(tiny["tseries"])
  xs, Ps = calibrate.filter_from_series(tiny["tcfg"], tiny["tseries"], 0.0,
                                        1.0)
  np.testing.assert_allclose(_np(xs), _np(zs), atol=1e-6)
  np.testing.assert_allclose(_np(Ps), _np(Vs), atol=1e-6)


def test_adaptive_inflation_off_is_identity_and_on_deflates_prior(tiny):
  """alpha_max < 1 must be the exact stock recursion; with an
  overconfident prior (W scaled down), adaptive inflation must pull the
  posterior toward the measurement relative to the stock filter."""
  cfg, series = tiny["tcfg"], tiny["tseries"]
  stock = calibrate.filter_from_series(cfg, series, 1e9, 1.0)
  off = calibrate.filter_from_series(cfg, series, 1e9, 1.0, 0.0)
  assert torch.equal(stock[0], off[0]) and torch.equal(stock[1], off[1])
  T, h, w = 7, 6, 8
  drift = torch.arange(1, T, dtype=torch.float32)[:, None, None, None]
  crafted = {
      "z0": torch.zeros((h, w, 3)),
      "V0": torch.full((h, w, 1), 0.1),
      "z": drift.expand(T - 1, h, w, 3).contiguous(),
      "V": torch.full((T - 1, h, w, 1), 0.1),
      "flow": torch.zeros((T - 1, h, w, 2)),
      "W": torch.full((T - 1, h, w, 1), 1e-3),
  }
  xs_over, _ = calibrate.filter_from_series(cfg, crafted, 1e9, 1.0, 0.0)
  xs_adapt, _ = calibrate.filter_from_series(cfg, crafted, 1e9, 1.0, 100.0)
  zs = torch.cat([crafted["z0"][None], crafted["z"]])
  d_over = float(torch.mean(torch.abs(xs_over[1:] - zs[1:])))
  d_adapt = float(torch.mean(torch.abs(xs_adapt[1:] - zs[1:])))
  assert d_adapt < 0.5 * d_over


def test_model_adaptive_matches_series_recursion(tiny):
  """KFNetConfig.adaptive_alpha_max (the model's path, filter/sequence)
  equals the sweep tool's tensor-alpha recursion."""
  cfg = dataclasses.replace(tiny["tcfg"], adaptive_alpha_max=8.0)
  xs_ref, Ps_ref, _ = sequence.run_filter(tiny["tparams"], cfg,
                                          tiny["timages"])
  xs, Ps = calibrate.filter_from_series(
      tiny["tcfg"], tiny["tseries"], cfg.chi2_threshold, 1.0, 8.0)
  np.testing.assert_allclose(_np(xs), _np(xs_ref), atol=2e-5)
  np.testing.assert_allclose(_np(Ps), _np(Ps_ref), rtol=2e-5, atol=1e-7)


def test_knobs_as_tensors_equal_numbers(tiny):
  """The sweep passes its knobs as tensors: the same recursion as with
  numbers, bit for bit (no config is rebuilt per grid point)."""
  a = calibrate.filter_from_series(tiny["tcfg"], tiny["tseries"], 2.37, 8.0,
                                   2.0)
  b = calibrate.filter_from_series(
      tiny["tcfg"], tiny["tseries"], torch.tensor(2.37), torch.tensor(8.0),
      torch.tensor(2.0))
  assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_fit_w_scale_runs_and_picks_from_grid(tiny):
  gt = np.broadcast_to(np.eye(4), (6, 4, 4))
  grid = [1.0, 8.0]
  best, means = calibrate.fit_w_scale(
      tiny["tparams"], tiny["tcfg"], tiny["timages"], K, gt, grid,
      ransac.RansacConfig(**RCFG))
  assert best in grid
  assert set(means) == set(grid)
  assert all(np.isfinite(v) for v in means.values())


def test_sweep_scene_smooth_grid_rows(tiny):
  """smooth_grid crosses pose-space smoothing with the Kalman grid; the
  rows' keys and count are JAX's; the beta=0 filtered row is the raw
  solver trajectory (the same as a sweep without smooth_grid)."""
  from kfnet_tpu.pose import ransac as jransac
  gt = np.broadcast_to(np.eye(4), (6, 4, 4))
  rows, meas = calibrate.sweep_scene(
      tiny["tparams"], tiny["tcfg"], tiny["timages"], K, gt, [2.37], [16.0],
      ransac.RansacConfig(**RCFG), block=3, smooth_grid=(0.0, 0.4))
  jrows, jmeas = jcalibrate.sweep_scene(
      tiny["jparams"], tiny["jcfg"], tiny["images"], jnp.asarray(K), gt,
      [2.37], [16.0], jransac.RansacConfig(**RCFG), block=3,
      smooth_grid=(0.0, 0.4))
  assert len(rows) == len(jrows)
  assert [list(r) for r in rows] == [list(r) for r in jrows]
  assert list(meas) == list(jmeas)
  assert np.isfinite(meas["median_translation_m"])
  bases = {(r["base"], r["smooth_beta"]) for r in rows}
  assert bases == {("measurement", 0.4), ("filtered", 0.0),
                   ("filtered", 0.4)}
  for r in rows:
    assert np.isfinite(r["median_translation_m"])
  ref_rows, _ = calibrate.sweep_scene(
      tiny["tparams"], tiny["tcfg"], tiny["timages"], K, gt, [2.37], [16.0],
      ransac.RansacConfig(**RCFG), block=3)
  raw = next(r for r in rows if r["base"] == "filtered"
             and r["smooth_beta"] == 0.0)
  assert raw["median_translation_m"] == ref_rows[0]["median_translation_m"]
