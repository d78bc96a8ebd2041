"""Camera geometry: the subset of ``kfnet_tpu/core/geometry.py`` that the
pose solver needs.

Poses are 4x4 camera-to-world ``T_wc``; the solver works with
world-to-camera (R, t). Pixel (u, v) = (column, row); a strided map cell
samples the integer pixel ``(stride-1)//2 + stride*i``. Every function
broadcasts over leading batch dims and avoids linear-algebra library
calls that check their result on the host (no device sync).
"""

from __future__ import annotations

import torch


def cell_center_grid(height: int, width: int, stride: int,
                     device=None) -> torch.Tensor:
  """(h, w, 2) full-res (u, v) of the integer pixel each map cell samples."""
  off = (stride - 1) // 2
  vs = (torch.arange(height, device=device) * stride + off).to(torch.float32)
  us = (torch.arange(width, device=device) * stride + off).to(torch.float32)
  v, u = torch.meshgrid(vs, us, indexing="ij")
  return torch.stack([u, v], dim=-1)


def invert_pose(T: torch.Tensor) -> torch.Tensor:
  """Invert (..., 4, 4) rigid transforms."""
  R = T[..., :3, :3]
  t = T[..., :3, 3]
  Rt = R.transpose(-1, -2)
  return make_pose(Rt, -(Rt @ t[..., None])[..., 0])


def make_pose(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
  """Assemble (..., 4, 4) poses from (..., 3, 3) R and (..., 3) t.

  Built by concatenation: writing a Python scalar into one element of a
  CUDA tensor is a host->device copy that waits for the device."""
  top = torch.cat([R, t[..., None]], dim=-1)
  bottom = torch.eye(4, dtype=R.dtype, device=R.device)[3:]
  return torch.cat([top, bottom.expand(top.shape[:-2] + (1, 4))], dim=-2)


def hat(w: torch.Tensor) -> torch.Tensor:
  """Skew-symmetric (..., 3, 3) matrices of (..., 3) vectors."""
  wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
  z = torch.zeros_like(wx)
  return torch.stack([
      torch.stack([z, -wz, wy], dim=-1),
      torch.stack([wz, z, -wx], dim=-1),
      torch.stack([-wy, wx, z], dim=-1),
  ], dim=-2)


def axis_angle_to_matrix(w: torch.Tensor) -> torch.Tensor:
  """Rodrigues: (..., 3) axis-angle -> (..., 3, 3), Taylor-safe at 0."""
  theta2 = torch.sum(w * w, dim=-1)
  theta = torch.sqrt(theta2 + 1e-24)
  small = theta2 < 1e-12
  a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(theta) / theta)
  b = torch.where(small, 0.5 - theta2 / 24.0,
                  (1.0 - torch.cos(theta)) / theta2)
  W = hat(w)
  eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(W.shape)
  return eye + a[..., None, None] * W + b[..., None, None] * (W @ W)


def _det3(M: torch.Tensor) -> torch.Tensor:
  a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
  d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
  g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
  return a * (e * i - f * h) + b * (f * g - d * i) + c * (d * h - e * g)


def _inv3(M: torch.Tensor) -> torch.Tensor:
  """Closed-form (..., 3, 3) inverse via adjugate / det, det clamped so
  degenerate inputs stay finite."""
  a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
  d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
  g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
  A = e * i - f * h
  B = f * g - d * i
  C = d * h - e * g
  det = a * A + b * B + c * C
  det = torch.where(torch.abs(det) < 1e-20, torch.sign(det) * 1e-20 + 1e-30,
                    det)
  adj = torch.stack([
      torch.stack([A, c * h - b * i, b * f - c * e], -1),
      torch.stack([B, a * i - c * g, c * d - a * f], -1),
      torch.stack([C, b * g - a * h, a * e - b * d], -1),
  ], -2)
  return adj / det[..., None, None]


def polar_rotation(M: torch.Tensor, iters: int = 8) -> torch.Tensor:
  """Orthogonal polar factor of (..., 3, 3) matrices by determinant-scaled
  Newton iteration X ← ½(γX + (γX)⁻ᵀ), closed-form 3x3 inverses only."""
  X = M
  for _ in range(iters):
    gamma = torch.abs(_det3(X)) ** (-1.0 / 3.0)
    gamma = torch.clamp(torch.where(torch.isfinite(gamma), gamma,
                                    torch.ones_like(gamma)), 1e-4, 1e4)
    Xs = X * gamma[..., None, None]
    X = 0.5 * (Xs + _inv3(Xs).transpose(-1, -2))
  return X


def orthonormalize_rotation(M: torch.Tensor) -> torch.Tensor:
  """Project (..., 3, 3) near-rotations to proper rotations (det = +1):
  flip the last column of a det < 0 input, then take the polar factor."""
  flip = torch.where(_det3(M) < 0, -1.0, 1.0).to(M.dtype)
  col_scale = torch.stack([torch.ones_like(flip), torch.ones_like(flip),
                           flip], dim=-1)
  return polar_rotation(M * col_scale[..., None, :])


def translation_error(T_est: torch.Tensor, T_gt: torch.Tensor):
  """Camera-centre distance (broadcasts over batch)."""
  return torch.linalg.norm(T_est[..., :3, 3] - T_gt[..., :3, 3], dim=-1)


def rotation_error_deg(T_est: torch.Tensor, T_gt: torch.Tensor):
  """Geodesic rotation error in degrees: the Frobenius form for small
  angles, the trace form where cos θ ≤ 0."""
  diff = T_est[..., :3, :3] - T_gt[..., :3, :3]
  fro = torch.sqrt(torch.sum(diff * diff, dim=(-1, -2)))
  theta_small = 2.0 * torch.arcsin(torch.clamp(fro / (2.0 * 2.0 ** 0.5),
                                               0.0, 1.0))
  R = T_est[..., :3, :3] @ T_gt[..., :3, :3].transpose(-1, -2)
  trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
  cos_t = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
  return torch.rad2deg(torch.where(cos_t > 0.0, theta_small,
                                   torch.arccos(cos_t)))
