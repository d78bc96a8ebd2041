"""Fixed-budget batched PnP-RANSAC (port of ``kfnet_tpu/pose/ransac.py``).

Confidence preselection is a top-k, hypotheses are a batched 6-point DLT
over an (M, 6) index tensor (or, with ``solver="p3p"``, Grunert's P3P over
an (M, 3) one, 4 candidates a draw: 4M scored), scoring is one (M, N) reprojection-error
matrix, and the winner gets a fixed-iteration LM polish on its inliers.
Every step takes a leading frame dim T, where the JAX package vmaps the
solve over frames: T frames solve in one pass of launches.
Sampling is split from solving (``solve_with_indices``) so a test can
feed the JAX package and the port the same index set. Nothing here reads
a value back to the host. A solve is the span ``pose.solve``
(``utils/tracing.py``) over its four stages: ``pose.draw`` (top-k and
draws), ``pose.hypothesize``, ``pose.score`` (errors, inliers, the pick)
and ``pose.refine`` (LM, final errors and outputs).
"""

from __future__ import annotations

import dataclasses

import torch

from kfnet_tpu_torch.core import geometry as geo
from kfnet_tpu_torch.pose import p3p, pnp
from kfnet_tpu_torch.utils import tracing

SOLVERS = ("dlt", "p3p")


@dataclasses.dataclass(frozen=True)
class RansacConfig:
  num_hypotheses: int = 256
  solver: str = "dlt"            # "dlt" (6 points) | "p3p" (3 points, up to
                                 # 4 candidates a draw)
  sample_size: int = 6           # the DLT's minimal set (P3P draws 3)
  inlier_threshold_px: float = 10.0
  top_k: int = 2048
  refine_iters: int = 10
  refine_threshold_px: float = 10.0

  def __post_init__(self):
    if self.solver not in SOLVERS:
      raise ValueError(f"solver={self.solver!r}: expected one of {SOLVERS}")

  @property
  def draw_size(self) -> int:
    """Points a hypothesis is drawn from."""
    return 3 if self.solver == "p3p" else self.sample_size


def _take(a, idx):
  """Rows of ``a`` ([T,] N, C) at ``idx`` ([T,] *S): ([T,] *S, C)."""
  sel = idx.reshape(a.shape[:-2] + (-1, 1))
  return torch.take_along_dim(a, sel, dim=-2).reshape(idx.shape
                                                      + a.shape[-1:])


def select_confident(pixels, coords, variance, valid, k):
  """Top-k lowest-variance valid correspondences of each frame.

  Args:
    pixels: ([T,] N, 2), shared by the frames when 2-dim; coords: ([T,] N,
      3); variance: ([T,] N); valid: ([T,] N) bool.

  Returns (pixels_k, coords_k, weight_k), ([T,] k, ...); weight is 0 for
  slots that were invalid (when fewer than k valid points exist)."""
  score = torch.where(valid, -variance,
                      torch.full_like(variance, float("-inf")))
  idx = torch.topk(score, k).indices
  pixels = pixels.expand(idx.shape[:-1] + pixels.shape[-2:])
  return (_take(pixels, idx), _take(coords, idx),
          torch.take_along_dim(valid, idx, dim=-1).to(torch.float32))


def sample_hypotheses(w, num_hypotheses: int, sample_size: int,
                      generator: torch.Generator | None = None):
  """([T,] M, s) index sets drawn without replacement, for each frame
  uniformly over its slots with weight > 0 (over all its slots when none
  has).

  This is ``torch.multinomial(p, s, replacement=False)``'s own algorithm
  (keys p / Exp(1), the s largest win) without its input check, which
  reads a value back to the host. The frames' draws come from one
  generator, frame after frame."""
  p = (w > 0).to(torch.float32)
  p = torch.where(torch.any(w > 0, dim=-1, keepdim=True), p,
                  torch.ones_like(p))
  q = torch.empty(w.shape[:-1] + (num_hypotheses, w.shape[-1]),
                  dtype=torch.float32,
                  device=w.device).exponential_(generator=generator)
  return torch.topk(p[..., None, :] / q, sample_size, dim=-1).indices


def _pick(a, best):
  """``a``'s row ``best`` along the hypothesis axis, by a gather: a CUDA
  index read as a Python int would be copied to the host."""
  n = best.dim()
  sel = best.reshape(best.shape + (1,) * (a.dim() - n))
  return torch.take_along_dim(a, sel, dim=n).squeeze(n)


def solve_with_indices(uv, X, w, K, idx, config: RansacConfig = RansacConfig()):
  """Hypothesize from ([T,] M, ``config.draw_size``) index sets into each
  frame's (k,) pool, score, refine; a leading T solves T frames at once.

  Args:
    uv: ([T,] k, 2) pixels; X: ([T,] k, 3) world points; w: ([T,] k)
      weights; K: (3, 3).

  Returns:
    dict with T_wc ([T,] 4, 4 camera-to-world), num_inliers, inlier_ratio,
    mean_inlier_error_px (([T,]) each).
  """
  cfg = config
  with tracing.span("pose.hypothesize"):
    if cfg.solver == "p3p":  # 4 candidates a draw: ([T,] 4M, 3, 3)
      Rs, ts = p3p.p3p_grunert(_take(uv, idx), _take(X, idx), K)
      Rs = Rs.flatten(-4, -3)
      ts = ts.flatten(-3, -2)
    else:  # ([T,] M, 3, 3)
      Rs, ts = pnp.dlt_pnp(_take(uv, idx), _take(X, idx), K)
  with tracing.span("pose.score"):
    pool = lambda a: a[..., None, :, :]  # against the M hypotheses
    errs = pnp.reprojection_errors(pool(uv), pool(X), K, Rs, ts)  # (.., M, k)
    inl = (errs < cfg.inlier_threshold_px).to(torch.float32) * w[..., None, :]
    best = torch.argmax(torch.sum(inl, dim=-1), dim=-1)
    R0, t0, inl0 = _pick(Rs, best), _pick(ts, best), _pick(inl, best)
  with tracing.span("pose.refine"):
    R, t = pnp.refine_pnp_lm(uv, X, K, R0, t0, inl0, iters=cfg.refine_iters)
    err_f = pnp.reprojection_errors(uv, X, K, R, t)
    inl_f = (err_f < cfg.refine_threshold_px).to(torch.float32) * w
    n_in = torch.sum(inl_f, dim=-1)
    return {
        "T_wc": geo.invert_pose(geo.make_pose(R, t)),
        "num_inliers": n_in,
        "inlier_ratio": n_in / torch.clamp_min(torch.sum(w, dim=-1), 1.0),
        "mean_inlier_error_px":
            torch.sum(err_f * inl_f, dim=-1) / torch.clamp_min(n_in, 1.0),
    }


def solve_pnp_ransac(pixels, coords, variance, valid, K,
                     generator: torch.Generator | None = None,
                     config: RansacConfig = RansacConfig()):
  """Robust pose from ([T,] N, 2) pixels (one (N, 2) grid serves every
  frame), ([T,] N, 3) world coordinates, ([T,] N) variances (confidence
  1/σ²) and ([T,] N) validity, for one frame or T at once. See
  solve_with_indices."""
  k = min(config.top_k, coords.shape[-2])
  with tracing.span("pose.draw"):
    uv, X, w = select_confident(pixels, coords, variance, valid, k)
    idx = sample_hypotheses(w, config.num_hypotheses, config.draw_size,
                            generator)
  return solve_with_indices(uv, X, w, K, idx, config)


def solve_pnp_from_maps(coords_map, variance_map, valid_map, K,
                        generator: torch.Generator | None = None,
                        stride: int = 8,
                        config: RansacConfig = RansacConfig()):
  """([T,] h, w, 3) / ([T,] h, w, 1) maps -> pose (per map); pixels are the
  stride-cell centres used in label generation."""
  with tracing.span("pose.solve"):
    h, w = coords_map.shape[-3:-1]
    lead = tuple(coords_map.shape[:-3])
    grid = geo.cell_center_grid(h, w, stride,
                                device=coords_map.device).reshape(-1, 2)
    return solve_pnp_ransac(grid, coords_map.reshape(lead + (-1, 3)),
                            variance_map.reshape(lead + (-1,)),
                            valid_map.reshape(lead + (-1,)), K, generator,
                            config)


def solve_pnp_from_maps_batched(coords_maps, variance_maps, valid_maps, K,
                                generator: torch.Generator | None = None,
                                stride: int = 8,
                                config: RansacConfig = RansacConfig()):
  """T frames' (T, h, w, 3) / (T, h, w, 1) maps -> T poses in one solve (the
  JAX package's ``vmap`` of ``solve_pnp_from_maps`` over frames): dict of
  (T, ...) tensors on the maps' device. Reads nothing back to the host;
  the T frames' hypotheses come from ``generator`` in one draw."""
  if coords_maps.dim() != 4:
    raise ValueError(f"expected (T, h, w, 3) maps, got "
                     f"{tuple(coords_maps.shape)}")
  return solve_pnp_from_maps(coords_maps, variance_maps, valid_maps, K,
                             generator, stride, config)
