"""Bilinear warp of state / covariance maps by backward flow (port of
``kfnet_tpu/core/warp.py``).

``flow[p]`` is the displacement from current-frame pixel p to its source
in the previous frame, in (u, v) = (x, y) order: src = grid + flow.
Samples outside the previous frame are invalid: zero value, and the
caller falls back to measurement-only there.
"""

from __future__ import annotations

import torch


def base_grid(height: int, width: int, dtype=torch.float32,
              device=None, first: int = 0) -> torch.Tensor:
  """(H, W, 2) grid of (u, v) map-resolution coordinates, u from column
  ``first`` on."""
  u = torch.arange(first, first + width, dtype=dtype, device=device)
  v = torch.arange(height, dtype=dtype, device=device)
  vv, uu = torch.meshgrid(v, u, indexing="ij")
  return torch.stack([uu, vv], dim=-1)


def bilinear_sample(img: torch.Tensor, pos: torch.Tensor, col0: int = 0,
                    width: int | None = None):
  """Bilinearly sample (..., H, W, C) ``img`` at (..., 2) (u, v) positions.

  ``img`` may carry leading batch dims B; then ``pos`` is (*B, ..., 2) and
  map b is sampled at ``pos[b]`` (the JAX package's ``vmap`` over maps).
  Valid iff the sample point lies in [0, w-1]x[0, h-1], inclusive; the
  corners are clamped to the map, so at u == w-1 exactly the x1 corner
  has zero weight and the sample is still exact.

  ``img`` may be a window of columns of a wider map (a W-shard with its
  halo): its column 0 is the map's column ``col0`` and the map is
  ``width`` wide. Positions, validity and the corners' clamp are then the
  whole map's, so a window's samples equal the whole map's wherever the
  window holds their corners.

  Returns (values (..., C) zero where invalid, valid (..., 1) bool).
  """
  h, wb, c = img.shape[-3:]
  w = wb if width is None else width
  u = pos[..., 0]
  v = pos[..., 1]
  u0 = torch.floor(u)
  v0 = torch.floor(v)
  du = u - u0
  dv = v - v0
  valid = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)

  x0 = torch.clamp(u0.to(torch.int64), 0, w - 1)
  x1 = torch.clamp(x0 + 1, 0, w - 1)
  y0 = torch.clamp(v0.to(torch.int64), 0, h - 1)
  y1 = torch.clamp(y0 + 1, 0, h - 1)
  if col0 or wb != w:  # the window's own columns
    x0 = torch.clamp(x0 - col0, 0, wb - 1)
    x1 = torch.clamp(x1 - col0, 0, wb - 1)

  flat = img.reshape(-1, h * wb, c)  # one row of pixels per map

  def gather(yy, xx):
    idx = (yy * wb + xx).reshape(flat.shape[0], -1, 1).expand(-1, -1, c)
    return torch.gather(flat, 1, idx).reshape(yy.shape + (c,))

  w00 = ((1 - du) * (1 - dv))[..., None]
  w01 = (du * (1 - dv))[..., None]
  w10 = ((1 - du) * dv)[..., None]
  w11 = (du * dv)[..., None]
  out = (w00 * gather(y0, x0) + w01 * gather(y0, x1) +
         w10 * gather(y1, x0) + w11 * gather(y1, x1))
  out = torch.where(valid[..., None], out, torch.zeros((), dtype=out.dtype,
                                                       device=out.device))
  return out, valid[..., None]


def warp_by_flow(prev: torch.Tensor, flow: torch.Tensor, first: int = 0,
                 col0: int = 0, width: int | None = None):
  """Warp a ([B,] H, W, C) previous-frame map by ([B,] H, W, 2) backward
  flow, map by map.

  For a W-shard: ``flow`` holds the map's columns from ``first`` on, and
  ``prev`` is a window of the ``width``-wide map from column ``col0`` on
  (``bilinear_sample``).

  Returns (warped ([B,] H, W, C), valid ([B,] H, W, 1) bool)."""
  h, w = flow.shape[-3:-1]
  pos = base_grid(h, w, dtype=flow.dtype, device=flow.device,
                  first=first) + flow
  return bilinear_sample(prev, pos, col0, width)


def warp_state_cov(x_prev: torch.Tensor, P_prev: torch.Tensor,
                   flow: torch.Tensor, W_noise: torch.Tensor,
                   invalid_cov: float = 1e8, first: int = 0, col0: int = 0,
                   width: int | None = None):
  """x⁻ = warp(x);  P⁻ = warp(P) + W, and ``invalid_cov`` out of bounds,
  for one map or a (B, ...) batch of maps (a W-shard: ``warp_by_flow``).

  Returns x_prior ([B,] H, W, 3), P_prior ([B,] H, W, 1), valid ([B,] H,
  W, 1) bool."""
  joint = torch.cat([x_prev, P_prev], dim=-1)
  warped, valid = warp_by_flow(joint, flow, first, col0, width)
  x_prior = warped[..., :3]
  P_prior = warped[..., 3:4] + W_noise
  P_prior = torch.where(valid, P_prior,
                        torch.full((), invalid_cov, dtype=P_prior.dtype,
                                   device=P_prior.device))
  return x_prior, P_prior, valid
