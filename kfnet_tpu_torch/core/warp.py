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
              device=None) -> torch.Tensor:
  """(H, W, 2) grid of (u, v) map-resolution coordinates."""
  u = torch.arange(width, dtype=dtype, device=device)
  v = torch.arange(height, dtype=dtype, device=device)
  vv, uu = torch.meshgrid(v, u, indexing="ij")
  return torch.stack([uu, vv], dim=-1)


def bilinear_sample(img: torch.Tensor, pos: torch.Tensor):
  """Bilinearly sample (..., H, W, C) ``img`` at (..., 2) (u, v) positions.

  ``img`` may carry leading batch dims B; then ``pos`` is (*B, ..., 2) and
  map b is sampled at ``pos[b]`` (the JAX package's ``vmap`` over maps).
  Valid iff the sample point lies in [0, w-1]x[0, h-1], inclusive; the
  corners are clamped to the map, so at u == w-1 exactly the x1 corner
  has zero weight and the sample is still exact.

  Returns (values (..., C) zero where invalid, valid (..., 1) bool).
  """
  h, w, c = img.shape[-3:]
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

  flat = img.reshape(-1, h * w, c)  # one row of pixels per map

  def gather(yy, xx):
    idx = (yy * w + xx).reshape(flat.shape[0], -1, 1).expand(-1, -1, c)
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


def warp_by_flow(prev: torch.Tensor, flow: torch.Tensor):
  """Warp a ([B,] H, W, C) previous-frame map by ([B,] H, W, 2) backward
  flow, map by map.

  Returns (warped ([B,] H, W, C), valid ([B,] H, W, 1) bool)."""
  h, w, _ = prev.shape[-3:]
  pos = base_grid(h, w, dtype=flow.dtype, device=flow.device) + flow
  return bilinear_sample(prev, pos)


def warp_state_cov(x_prev: torch.Tensor, P_prev: torch.Tensor,
                   flow: torch.Tensor, W_noise: torch.Tensor,
                   invalid_cov: float = 1e8):
  """x⁻ = warp(x);  P⁻ = warp(P) + W, and ``invalid_cov`` out of bounds,
  for one map or a (B, ...) batch of maps.

  Returns x_prior ([B,] H, W, 3), P_prior ([B,] H, W, 1), valid ([B,] H,
  W, 1) bool."""
  joint = torch.cat([x_prev, P_prev], dim=-1)
  warped, valid = warp_by_flow(joint, flow)
  x_prior = warped[..., :3]
  P_prior = warped[..., 3:4] + W_noise
  P_prior = torch.where(valid, P_prior,
                        torch.full((), invalid_cov, dtype=P_prior.dtype,
                                   device=P_prior.device))
  return x_prior, P_prior, valid
