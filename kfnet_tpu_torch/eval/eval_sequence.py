"""Flagship inference path: recursive filtering of a test sequence, a PnP
pose solve for every frame and the per-scene median report (port of
``kfnet_tpu/eval/eval_sequence.py``). The fused maps stay on the device
between the filter and the batched solve; nothing is read back to the host
before the poses.
"""

from __future__ import annotations

import dataclasses
import functools
import json
import time

import numpy as np
import torch

from kfnet_tpu_torch.filter import sequence
from kfnet_tpu_torch.models import kfnet
from kfnet_tpu_torch.pose import metrics as pose_metrics
from kfnet_tpu_torch.pose import ransac
from kfnet_tpu_torch.utils.timing import sync


class PoseSolver:
  """PnP-RANSAC over stacked maps: (coords (T, h, w, 3), covariance (T, h,
  w, 1), generator) -> the ransac output dict of (T, ...) tensors, in one
  batched solve (validity is all ones: map cells are weighted by their
  covariance inside the solver). K is copied to a device once."""

  def __init__(self, K_flat: tuple, stride: int,
               config: ransac.RansacConfig):
    self._K = np.asarray(K_flat, np.float32).reshape(3, 3)
    self._K_on: dict = {}
    self.stride, self.config = stride, config

  def __call__(self, coords, covariance,
               generator: torch.Generator | None = None):
    dev = coords.device
    if dev not in self._K_on:
      self._K_on[dev] = torch.as_tensor(self._K, device=dev)
    return ransac.solve_pnp_from_maps_batched(
        coords, covariance, torch.ones_like(covariance, dtype=torch.bool),
        self._K_on[dev], generator, stride=self.stride, config=self.config)


def make_pose_solver(K, stride: int = 8,
                     config: ransac.RansacConfig = ransac.RansacConfig()):
  """THE shared pose-solve entry for batch, streaming and measurement eval
  and the benchmark: a ``PoseSolver``, cached per (K, stride, config) as
  the JAX package caches its jitted solver."""
  K_flat = tuple(float(v) for v in np.asarray(K).reshape(-1))
  return _pose_solver_cached(K_flat, stride, config)


@functools.lru_cache(maxsize=None)
def _pose_solver_cached(K_flat: tuple, stride: int,
                        config: ransac.RansacConfig):
  return PoseSolver(K_flat, stride, config)


def measure_chunked(params, config: kfnet.KFNetConfig, images,
                    chunk_size: int = 64, device=None):
  """SCoordNet over a (T, H, W, 3) stack in batches of ``chunk_size``.

  A batch of the whole sequence would hold a batch-T conv forward's
  activations (tens of GB for a 1000-frame 640x480 sequence), so the
  frames go in chunks; ``images`` may be a host (numpy) stack, uploaded a
  chunk at a time, which is the memory-bounded streaming form for
  measurement-only eval. (The JAX package pads the ragged tail to keep one
  compiled shape; PyTorch needs none, so the tail runs as it is.)
  """
  params, device = sequence.placed(params, device)
  T = images.shape[0]
  chunk = max(1, min(int(chunk_size), T))
  zs, Vs = [], []
  for s in range(0, T, chunk):
    z, V = kfnet.measure(params, config,
                         sequence.frames_to_device(images[s:s + chunk],
                                                   device))
    zs.append(z)
    Vs.append(V)
  if len(zs) == 1:
    return zs[0], Vs[0]
  return torch.cat(zs), torch.cat(Vs)


@dataclasses.dataclass
class EvalResult:
  poses: np.ndarray          # (T, 4, 4) estimated camera-to-world
  coords: np.ndarray         # (T, h, w, 3) fused coordinate maps
  covariance: np.ndarray     # (T, h, w, 1)
  frames_per_sec: float
  report: dict | None = None


def _result(poses, coords, covariance, fps, gt_poses, scene) -> EvalResult:
  result = EvalResult(poses=poses, coords=coords, covariance=covariance,
                      frames_per_sec=fps)
  if gt_poses is not None:
    result.report = pose_metrics.report(scene, poses, np.asarray(gt_poses))
    result.report["frames_per_sec"] = fps
  return result


def _timed(once, reps: int, frames: int):
  """``once()``'s last outputs and frames per second: the median of
  ``reps`` timed runs after one warm-up, each ending in ``sync``."""
  out = once()
  sync(out[-1]["T_wc"])
  dts = []
  for _ in range(max(1, reps)):
    t0 = time.perf_counter()
    out = once()
    sync(out[-1]["T_wc"])
    dts.append(time.perf_counter() - t0)
  return out, frames / float(np.median(dts))


def evaluate_sequence(params, config: kfnet.KFNetConfig, images, K,
                      gt_poses: np.ndarray | None = None, scene: str = "",
                      ransac_config=ransac.RansacConfig(),
                      stride: int = 8, seed: int = 0, timing_reps: int = 3,
                      device=None) -> EvalResult:
  """Filter a (T, H, W, 3) sequence and solve a pose per frame.

  The filter (``sequence.run_filter``, each step a CUDA graph on the card)
  and the batched solve run back to back; the fused maps stay on the
  device between them. fps is the median of ``timing_reps`` runs after one
  warm-up (the bench's protocol); every run draws its hypotheses from a
  generator seeded with ``seed`` (the JAX package splits one key per
  frame), so every run gives the same poses.
  """
  params, device = sequence.placed(params, device)
  images = sequence.frames_to_device(images, device)
  solve = make_pose_solver(K, stride=stride, config=ransac_config)
  gen = torch.Generator(device=device)

  def once():
    xs, Ps, _ = sequence.run_filter(params, config, images, device=device)
    return xs, Ps, solve(xs, Ps, gen.manual_seed(seed))

  (xs, Ps, out), fps = _timed(once, timing_reps, images.shape[0])
  return _result(out["T_wc"].cpu().numpy(), xs.cpu().numpy(),
                 Ps.cpu().numpy(), fps, gt_poses, scene)


def evaluate_measurement_only(params, config: kfnet.KFNetConfig, images, K,
                              gt_poses: np.ndarray | None = None,
                              scene: str = "",
                              ransac_config=ransac.RansacConfig(),
                              stride: int = 8, seed: int = 0,
                              timing_reps: int = 3, chunk_size: int = 64,
                              device=None) -> EvalResult:
  """SCoordNet-only ablation (no temporal filter), the reference's
  single-frame baseline row; fps as in ``evaluate_sequence``. The
  measurement runs in chunks (``measure_chunked``), so ``images`` may be a
  host-resident numpy stack."""
  params, device = sequence.placed(params, device)
  solve = make_pose_solver(K, stride=stride, config=ransac_config)
  gen = torch.Generator(device=device)

  def once():
    zs, Vs = measure_chunked(params, config, images, chunk_size=chunk_size,
                             device=device)
    return zs, Vs, solve(zs, Vs, gen.manual_seed(seed))

  (zs, Vs, out), fps = _timed(once, timing_reps, images.shape[0])
  return _result(out["T_wc"].cpu().numpy(), zs.cpu().numpy(),
                 Vs.cpu().numpy(), fps, gt_poses, scene)


def evaluate_sequence_streaming(params, config: kfnet.KFNetConfig,
                                frame_source, K,
                                gt_poses: np.ndarray | None = None,
                                scene: str = "",
                                ransac_config=ransac.RansacConfig(),
                                stride: int = 8, chunk_size: int = 32,
                                seed: int = 0, device=None) -> EvalResult:
  """Memory-bounded eval for arbitrarily long sequences: frames stream from
  the host through the chunked filter (O(chunk) device memory) and poses
  solve a chunk at a time, from one generator seeded with ``seed``. Timing
  includes the host transfer, so fps here is a streaming number, not the
  kernel number."""
  params, device = sequence.placed(params, device)
  solve = make_pose_solver(K, stride=stride, config=ransac_config)
  gen = torch.Generator(device=device).manual_seed(seed)
  xs_all, Ps_all, poses = [], [], []
  t0 = time.perf_counter()
  # whole chunks: the maps stay on the device between filter and solve
  for xs, Ps in sequence.run_filter_chunked_arrays(
      params, config, frame_source, chunk_size=chunk_size, device=device):
    out = solve(xs, Ps, gen)
    poses.extend(out["T_wc"].cpu().numpy())
    xs_all.append(xs.cpu().numpy())
    Ps_all.append(Ps.cpu().numpy())
  dt = time.perf_counter() - t0
  poses = np.stack(poses)
  return _result(poses, np.concatenate(xs_all), np.concatenate(Ps_all),
                 poses.shape[0] / dt, gt_poses, scene)


def coord_accuracy_report(coords: np.ndarray, gt_coords: np.ndarray,
                          valid: np.ndarray,
                          thresholds_m=(0.02, 0.05, 0.10)) -> dict:
  """Per-sequence coordinate-map accuracy stats (the reference's
  ``SCoordNet/eval.py`` per-image accuracy output).

  Args:
    coords/gt_coords: (T, h, w, 3); valid: (T, h, w) bool.
  """
  err = np.linalg.norm(np.asarray(coords) - np.asarray(gt_coords), axis=-1)
  v = np.asarray(valid).astype(bool)
  errs = err[v]
  out = {
      "valid_pixels": int(v.sum()),
      "mean_coord_err_m": float(errs.mean()) if errs.size else float("nan"),
      "median_coord_err_m":
          float(np.median(errs)) if errs.size else float("nan"),
  }
  for t in thresholds_m:
    out[f"frac_within_{int(t*100)}cm"] = (
        float((errs <= t).mean()) if errs.size else 0.0)
  return out


def write_report(path: str, reports: list[dict]):
  with open(path, "w") as f:
    json.dump({"scenes": reports}, f, indent=2)
