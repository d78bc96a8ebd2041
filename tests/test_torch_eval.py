"""The port's evaluation and bench modules on the CPU: eval/eval_sequence.py
(the cases of tests/test_eval_streaming.py), pose/metrics.py,
eval/flops.py, utils/timing.py, eval/benchmark.py and the
``python -m kfnet_tpu_torch.bench`` entry, held against the JAX package
where it has the function, on the tiny config with JAX-initialised weights
converted by convert.params_from_jax.

Tolerances: filter outputs against JAX at the goldens' rtol 5e-4 / atol
5e-5; the streaming form against the batch form at the JAX test's own
(atol 2e-5; rtol 1e-5 / atol 2e-5 on the covariance); chunked measurement
against one batch at rtol / atol 2e-5 (convolutions over another batch);
the host-numpy metrics and FLOP counts exactly.
"""

import json
import os
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfnet_tpu.eval import eval_sequence as jeval
from kfnet_tpu.eval import flops as jflops
from kfnet_tpu.models import kfnet as jkfnet
from kfnet_tpu.pose import metrics as jmetrics
from kfnet_tpu.pose import ransac as jransac
from kfnet_tpu_torch import convert
from kfnet_tpu_torch.eval import benchmark as tbench
from kfnet_tpu_torch.eval import eval_sequence as teval
from kfnet_tpu_torch.eval import flops as tflops
from kfnet_tpu_torch.models import kfnet as tkfnet
from kfnet_tpu_torch.pose import metrics as tmetrics
from kfnet_tpu_torch.pose import ransac as transac
from kfnet_tpu_torch.utils import timing
from tests import tiny_configs as tc
from tests.test_torch_models import port_config

ROOT = pathlib.Path(__file__).resolve().parent.parent
K = np.asarray([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)
GOLDEN = dict(rtol=5e-4, atol=5e-5)
RCFG = dict(num_hypotheses=16, top_k=32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
  """Small tensors on one thread: the suite runs in several processes at
  once, and torch's pool of a thread per core in each oversubscribes the
  host, which slows small-tensor work by an order of magnitude."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def setup():
  jcfg = tc.tiny_kfnet()
  jparams = jkfnet.init(jax.random.key(3), jcfg, tc.IMG)
  tparams = convert.params_from_jax(
      jax.tree_util.tree_map(np.asarray, jparams))
  return jcfg, jparams, port_config(jcfg, use_fused_kernel=False), tparams


def test_streaming_eval_matches_batch_eval_and_jax(setup):
  jcfg, jparams, tcfg, tparams = setup
  imgs = np.array(tc.random_images(7, seed=9))
  gt = np.broadcast_to(np.eye(4, dtype=np.float32), (7, 4, 4))
  rcfg = transac.RansacConfig(**RCFG)
  res_b = teval.evaluate_sequence(tparams, tcfg, imgs, K, gt_poses=gt,
                                  scene="s", ransac_config=rcfg,
                                  timing_reps=1)
  res_s = teval.evaluate_sequence_streaming(
      tparams, tcfg, list(imgs), K, gt_poses=gt, scene="s",
      ransac_config=rcfg, chunk_size=3)
  assert res_s.coords.shape == res_b.coords.shape == (7, 6, 8, 3)
  np.testing.assert_allclose(res_s.coords, res_b.coords, atol=2e-5)
  np.testing.assert_allclose(res_s.covariance, res_b.covariance,
                             rtol=1e-5, atol=2e-5)
  for res in (res_b, res_s):
    assert res.poses.shape == (7, 4, 4) and np.isfinite(res.poses).all()
    assert res.report["scene"] == "s" and res.report["frames"] == 7
    assert np.isfinite(res.report["median_translation_m"])
    assert res.report["frames_per_sec"] == res.frames_per_sec > 0
  want = jeval.evaluate_sequence(jparams, jcfg, jnp.asarray(imgs), K,
                                 ransac_config=jransac.RansacConfig(**RCFG),
                                 rng=jax.random.key(0), timing_reps=1)
  np.testing.assert_allclose(res_b.coords, want.coords, **GOLDEN)
  np.testing.assert_allclose(res_b.covariance, want.covariance, **GOLDEN)


def test_batch_eval_is_deterministic_and_report_free_without_gt(setup):
  _, _, tcfg, tparams = setup
  imgs = np.array(tc.random_images(4, seed=10))
  rcfg = transac.RansacConfig(**RCFG)
  a = teval.evaluate_sequence(tparams, tcfg, imgs, K, ransac_config=rcfg,
                              timing_reps=2, seed=3)
  b = teval.evaluate_sequence(tparams, tcfg, imgs, K, ransac_config=rcfg,
                              timing_reps=1, seed=3)
  assert a.report is None
  np.testing.assert_array_equal(a.poses, b.poses)  # one seed, same draws


def test_measure_chunked_matches_whole_batch_and_jax(setup):
  """Chunked measurement (a ragged tail, a host-numpy input) equals one
  batch of the whole stack, and the JAX package's."""
  jcfg, jparams, tcfg, tparams = setup
  imgs = np.array(tc.random_images(7, seed=11))
  ref_z, ref_V = tkfnet.measure(tparams, tcfg, torch.from_numpy(imgs))
  tol = dict(rtol=2e-5, atol=2e-5)
  z, V = teval.measure_chunked(tparams, tcfg, torch.from_numpy(imgs),
                               chunk_size=3)
  np.testing.assert_allclose(z.numpy(), ref_z.numpy(), **tol)
  np.testing.assert_allclose(V.numpy(), ref_V.numpy(), **tol)
  z2, V2 = teval.measure_chunked(tparams, tcfg, imgs, chunk_size=4)
  np.testing.assert_allclose(z2.numpy(), ref_z.numpy(), **tol)
  jz, jV = jeval.measure_chunked(jparams, jcfg, jnp.asarray(imgs),
                                 chunk_size=3)
  np.testing.assert_allclose(z.numpy(), np.asarray(jz), **GOLDEN)
  np.testing.assert_allclose(V.numpy(), np.asarray(jV), **GOLDEN)


def test_measurement_only_eval_matches_jax_maps(setup):
  jcfg, jparams, tcfg, tparams = setup
  imgs = np.array(tc.random_images(5, seed=12))
  gt = np.broadcast_to(np.eye(4, dtype=np.float32), (5, 4, 4))
  res = teval.evaluate_measurement_only(
      tparams, tcfg, imgs, K, gt_poses=gt, scene="m",
      ransac_config=transac.RansacConfig(**RCFG), timing_reps=1,
      chunk_size=2)
  want = jeval.evaluate_measurement_only(
      jparams, jcfg, jnp.asarray(imgs), K,
      ransac_config=jransac.RansacConfig(**RCFG), rng=jax.random.key(0),
      timing_reps=1, chunk_size=2)
  np.testing.assert_allclose(res.coords, want.coords, **GOLDEN)
  np.testing.assert_allclose(res.covariance, want.covariance, **GOLDEN)
  assert res.poses.shape == (5, 4, 4) and res.report["frames"] == 5


def test_pose_solver_is_cached():
  """Every sequence of an eval reuses one solver (and its K on the
  device), as the JAX package reuses one compiled solver."""
  rcfg = transac.RansacConfig(**RCFG)
  s1 = teval.make_pose_solver(K, config=rcfg)
  assert s1 is teval.make_pose_solver(np.asarray(K, np.float64),
                                      config=rcfg)
  assert s1 is not teval.make_pose_solver(K, stride=4, config=rcfg)


def test_coord_accuracy_report_and_write_report_match_jax(tmp_path):
  rng = np.random.default_rng(0)
  gt = rng.normal(size=(3, 6, 8, 3))
  est = gt + rng.normal(size=gt.shape) * 0.05
  valid = rng.uniform(size=(3, 6, 8)) > 0.3
  assert (teval.coord_accuracy_report(est, gt, valid)
          == jeval.coord_accuracy_report(est, gt, valid))
  empty = teval.coord_accuracy_report(est, gt, np.zeros_like(valid))
  assert empty["valid_pixels"] == 0 and empty["frac_within_2cm"] == 0.0
  reports = [{"scene": "a", "median_translation_m": 0.1}]
  teval.write_report(str(tmp_path / "t.json"), reports)
  jeval.write_report(str(tmp_path / "j.json"), reports)
  assert (tmp_path / "t.json").read_text() == (tmp_path / "j.json").read_text()


def _poses(rng, n):
  w = rng.normal(size=(n, 3)) * 0.4
  T = np.tile(np.eye(4), (n, 1, 1))
  for i, wi in enumerate(w):
    th = np.linalg.norm(wi)
    k = wi / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    T[i, :3, :3] = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    T[i, :3, 3] = rng.normal(size=3)
  return T


def test_metrics_equal_jax():
  rng = np.random.default_rng(1)
  gt = _poses(rng, 12)
  est = gt.copy()
  est[:, :3, 3] += rng.normal(size=(12, 3)) * 0.05
  est[:6] = _poses(rng, 6) @ gt[:6]  # some far off, one beyond 90°
  est[2, :3, :3] = -est[2, :3, :3] @ np.diag([1, -1, 1])
  for fn in ("pose_errors", "median_errors", "accuracy_at"):
    got, want = (getattr(m, fn)(est.astype(np.float32), gt)
                 for m in (tmetrics, jmetrics))
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
  assert tmetrics.report("s", est, gt) == jmetrics.report("s", est, gt)


@pytest.mark.parametrize("which", ["tiny", "default"])
def test_flops_equal_jax(which):
  jcfg = tc.tiny_kfnet() if which == "tiny" else jkfnet.KFNetConfig()
  tcfg = port_config(jcfg)
  h, w = tc.IMG[:2] if which == "tiny" else (480, 640)
  assert (tflops.scoordnet_flops(tcfg.scoordnet, h, w)
          == jflops.scoordnet_flops(jcfg.scoordnet, h, w))
  assert (tflops.oflownet_flops(tcfg.oflownet, h, w)
          == jflops.oflownet_flops(jcfg.oflownet, h, w))
  assert (tflops.filter_step_flops(tcfg, h, w)
          == jflops.filter_step_flops(jcfg, h, w))
  if which == "default":  # about 245 GFLOP a 640x480 frame
    assert 200 < tflops.filter_step_flops(tcfg) / 1e9 < 300


def test_counted_flops_track_the_analytic_count(setup):
  """PyTorch's count of one eager filter step's products (the composition,
  PyTorch's convolutions) within 0.8-1.25 of the analytic count, the
  bound of tests/test_flops.py against XLA's cost analysis."""
  _, _, tcfg, tparams = setup
  imgs = tkfnet.preprocess_images(
      tcfg, torch.from_numpy(np.array(tc.random_images(2))))
  x0, P0, f0 = tkfnet.first_step(tparams, tcfg, imgs[0])
  counted = tflops.counted_flops(
      lambda: tkfnet.filter_step(tparams, tcfg, x0, P0, f0, imgs[1]))
  analytic = tflops.filter_step_flops(tcfg, *tc.IMG[:2])
  assert 0.8 < analytic / counted < 1.25, (analytic, counted)


def test_peak_lookup(monkeypatch):
  assert tflops.peak_for("NVIDIA H100 80GB HBM3") == 989.4e12
  assert tflops.peak_for("NVIDIA H100 PCIe") == 756e12
  assert tflops.peak_for("NVIDIA H100 NVL") == 835e12
  assert tflops.peak_for("weird") is None
  assert tflops.peak_flops("cpu") is None
  monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "weird")
  assert tflops.peak_flops("cuda") is None  # an unknown card: no MFU


def test_sync_returns_the_checksum():
  a = torch.tensor([[1.0, -2.0]])
  b = torch.tensor([3], dtype=torch.uint8)
  assert timing.sync({"a": a, "rest": [b, (a, "not a tensor")]}) == 9.0


def test_benchmark_run_on_the_cpu():
  from kfnet_tpu_torch.bench import tiny_config
  res = tbench.run(48, 64, 4, config=tiny_config(), reps=1, tick=True,
                   device="cpu")
  for key in ("scoordnet_ms", "oflownet_encode_ms", "costvolume_decode_ms",
              "filter_ms_per_frame", "filtered_fps", "e2e_pose_fps",
              "pose_solve_ms_per_frame", "streaming_fps_device",
              "streaming_fps", "streaming_fps_host_uint8",
              "filtered_fps_batch4", "online_tick_ms",
              "online_host_tick_ms", "online_host_uint8_tick_ms"):
    assert np.isfinite(res[key]) and res[key] >= 0, key
  assert res["gpu"] is None and res["device"] == "cpu"
  assert not any(k.startswith("fleet") for k in res)


def _bench(*args, **env):
  # one torch thread, as one_torch_thread gives the tests in this process
  env = dict(os.environ, OMP_NUM_THREADS="1", **env)
  return subprocess.run([sys.executable, "-m", "kfnet_tpu_torch.bench",
                         *args], cwd=ROOT, capture_output=True, text=True,
                        timeout=240, env=env)


def test_bench_cpu_prints_one_json_line():
  res = _bench("--device", "cpu")
  assert res.returncode == 0, res.stderr
  lines = res.stdout.strip().splitlines()
  assert len(lines) == 1
  out = json.loads(lines[0])
  for key in ("metric", "value", "unit", "vs_baseline", "frames",
              "gflops_per_frame", "mfu", "flop_source",
              "peak_tflops_assumed", "baseline_note", "fps_kernels",
              "fps_composition", "fps_conv_kernels", "gpu", "power_limit"):
    assert key in out, key
  assert out["metric"].endswith("_tiny_cpu") and out["frames"] == 32
  assert out["value"] == out["fps_kernels"] > 0
  assert out["fps_composition"] > 0 and out["fps_conv_kernels"] > 0
  # the CPU has no peak in the table: no MFU, no ratio to the anchor
  assert out["mfu"] is None and out["peak_tflops_assumed"] is None
  assert out["vs_baseline"] is None and out["gpu"] is None


def test_bench_raises_without_a_device():
  res = _bench(CUDA_VISIBLE_DEVICES="")
  assert res.returncode != 0 and not res.stdout.strip()
  assert "device='cpu'" in res.stderr
