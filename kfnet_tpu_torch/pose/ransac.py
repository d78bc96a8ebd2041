"""Fixed-budget batched PnP-RANSAC (port of ``kfnet_tpu/pose/ransac.py``,
DLT solver only).

Confidence preselection is a top-k, hypotheses are a batched 6-point DLT
over an (M, 6) index tensor, scoring is one (M, N) reprojection-error
matrix, and the winner gets a fixed-iteration LM polish on its inliers.
Sampling is split from solving (``solve_with_indices``) so a test can
feed the JAX package and the port the same index set. Nothing here reads
a value back to the host.
"""

from __future__ import annotations

import dataclasses

import torch

from kfnet_tpu_torch.core import geometry as geo
from kfnet_tpu_torch.pose import pnp


@dataclasses.dataclass(frozen=True)
class RansacConfig:
  num_hypotheses: int = 256
  solver: str = "dlt"            # only the 6-point DLT is ported
  sample_size: int = 6
  inlier_threshold_px: float = 10.0
  top_k: int = 2048
  refine_iters: int = 10
  refine_threshold_px: float = 10.0

  def __post_init__(self):
    if self.solver != "dlt":
      raise NotImplementedError(
          f"solver={self.solver!r} is not ported yet; use 'dlt'")


def select_confident(pixels, coords, variance, valid, k):
  """Top-k lowest-variance valid correspondences.

  Returns (pixels_k, coords_k, weight_k); weight is 0 for slots that were
  invalid (when fewer than k valid points exist)."""
  score = torch.where(valid, -variance,
                      torch.full_like(variance, float("-inf")))
  idx = torch.topk(score, k).indices
  return pixels[idx], coords[idx], valid[idx].to(torch.float32)


def sample_hypotheses(w, num_hypotheses: int, sample_size: int,
                      generator: torch.Generator | None = None):
  """(M, s) index sets drawn without replacement, uniformly over the
  slots with weight > 0 (over all slots when none has).

  This is ``torch.multinomial(p, s, replacement=False)``'s own algorithm
  (keys p / Exp(1), the s largest win) without its input check, which
  reads a value back to the host."""
  p = (w > 0).to(torch.float32)
  p = torch.where(torch.any(w > 0), p, torch.ones_like(p))
  q = torch.empty((num_hypotheses, w.shape[0]), dtype=torch.float32,
                  device=w.device).exponential_(generator=generator)
  return torch.topk(p / q, sample_size, dim=-1).indices


def solve_with_indices(uv, X, w, K, idx, config: RansacConfig = RansacConfig()):
  """Hypothesize from (M, 6) index sets into the (k,) pool, score, refine.

  Args:
    uv: (k, 2) pixels; X: (k, 3) world points; w: (k,) weights; K: (3, 3).

  Returns:
    dict with T_wc (4x4 camera-to-world), num_inliers, inlier_ratio,
    mean_inlier_error_px.
  """
  cfg = config
  Rs, ts = pnp.dlt_pnp(uv[idx], X[idx], K)                   # (M, 3, 3)
  errs = pnp.reprojection_errors(uv, X, K, Rs, ts)           # (M, k)
  inl = (errs < cfg.inlier_threshold_px).to(torch.float32) * w
  # index_select, not Rs[best]: a 0-dim CUDA index would be read back
  best = torch.argmax(torch.sum(inl, dim=1)).reshape(1)
  pick = lambda a: torch.index_select(a, 0, best)[0]
  R, t = pnp.refine_pnp_lm(uv, X, K, pick(Rs), pick(ts), pick(inl),
                           iters=cfg.refine_iters)
  err_f = pnp.reprojection_errors(uv, X, K, R, t)
  inl_f = (err_f < cfg.refine_threshold_px).to(torch.float32) * w
  n_in = torch.sum(inl_f)
  return {
      "T_wc": geo.invert_pose(geo.make_pose(R, t)),
      "num_inliers": n_in,
      "inlier_ratio": n_in / torch.clamp_min(torch.sum(w), 1.0),
      "mean_inlier_error_px":
          torch.sum(err_f * inl_f) / torch.clamp_min(n_in, 1.0),
  }


def solve_pnp_ransac(pixels, coords, variance, valid, K,
                     generator: torch.Generator | None = None,
                     config: RansacConfig = RansacConfig()):
  """Robust pose from (N, 2) pixels, (N, 3) world coordinates, (N,)
  variances (confidence 1/σ²) and (N,) validity. See solve_with_indices."""
  k = min(config.top_k, pixels.shape[0])
  uv, X, w = select_confident(pixels, coords, variance, valid, k)
  idx = sample_hypotheses(w, config.num_hypotheses, config.sample_size,
                          generator)
  return solve_with_indices(uv, X, w, K, idx, config)


def solve_pnp_from_maps(coords_map, variance_map, valid_map, K,
                        generator: torch.Generator | None = None,
                        stride: int = 8,
                        config: RansacConfig = RansacConfig()):
  """(h, w, 3) / (h, w, 1) maps -> pose; pixels are the stride-cell
  centres used in label generation."""
  h, w = coords_map.shape[:2]
  grid = geo.cell_center_grid(h, w, stride,
                              device=coords_map.device).reshape(-1, 2)
  return solve_pnp_ransac(grid, coords_map.reshape(-1, 3),
                          variance_map.reshape(-1), valid_map.reshape(-1),
                          K, generator, config)
