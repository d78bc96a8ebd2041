"""Camera geometry (port of ``kfnet_tpu/core/geometry.py``): intrinsics,
SE(3) poses, projection, scene-coordinate labels from depth, rotations and
pose errors.

Poses are 4x4 camera-to-world ``T_wc``; the solver works with
world-to-camera (R, t). Pixel (u, v) = (column, row), pixel (0, 0) at
(0.0, 0.0); a strided map cell samples the integer pixel
``(stride-1)//2 + stride*i``. The solver's functions broadcast over
leading batch dims and avoid linear-algebra library calls that check
their result on the host (no device sync); ``orthonormalize_rotation_svd``
is the numeric tests' reference and does not.
"""

from __future__ import annotations

import torch


# 7-Scenes / 12-Scenes calibration (Kinect, 640x480): fx, fy, cx, cy
SEVEN_SCENES_K = (585.0, 585.0, 320.0, 240.0)


def make_intrinsics(fx: float, fy: float, cx: float, cy: float,
                    device=None) -> torch.Tensor:
  """3x3 float32 pinhole intrinsics."""
  return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                      dtype=torch.float32, device=device)


def pixel_grid(height: int, width: int, device=None) -> torch.Tensor:
  """(H, W, 2) dense full-resolution (u, v) pixel coordinates (for a
  strided map's pixels use ``cell_center_grid``)."""
  vs = torch.arange(height, dtype=torch.float32, device=device)
  us = torch.arange(width, dtype=torch.float32, device=device)
  v, u = torch.meshgrid(vs, us, indexing="ij")
  return torch.stack([u, v], dim=-1)


def cell_center_grid(height: int, width: int, stride: int,
                     device=None) -> torch.Tensor:
  """(h, w, 2) full-res (u, v) of the integer pixel each map cell samples."""
  off = (stride - 1) // 2
  vs = (torch.arange(height, device=device) * stride + off).to(torch.float32)
  us = (torch.arange(width, device=device) * stride + off).to(torch.float32)
  v, u = torch.meshgrid(vs, us, indexing="ij")
  return torch.stack([u, v], dim=-1)


def backproject(depth: torch.Tensor, K: torch.Tensor,
                pixels: torch.Tensor | None = None) -> torch.Tensor:
  """(H, W) z-depth -> (H, W, 3) camera-frame points, at ``pixels`` ((H,
  W, 2) (u, v)) or the dense grid of the depth's shape."""
  if pixels is None:
    pixels = pixel_grid(*depth.shape, device=depth.device)
  x = (pixels[..., 0] - K[0, 2]) / K[0, 0] * depth
  y = (pixels[..., 1] - K[1, 2]) / K[1, 1] * depth
  return torch.stack([x, y, depth], dim=-1)


def transform_points(T: torch.Tensor, points: torch.Tensor) -> torch.Tensor:
  """Apply one 4x4 rigid transform to (..., 3) points."""
  return points @ T[:3, :3].T + T[:3, 3]


def project(points_world: torch.Tensor, K: torch.Tensor, T_wc: torch.Tensor):
  """World points into the camera: ((..., 2) (u, v), (...,) camera-frame
  depth, positive in front of the camera)."""
  pc = transform_points(invert_pose(T_wc), points_world)
  z = pc[..., 2]
  zs = torch.where(torch.abs(z) < 1e-8, torch.sign(z) * 1e-8 + 1e-12, z)
  u = K[0, 0] * pc[..., 0] / zs + K[0, 2]
  v = K[1, 1] * pc[..., 1] / zs + K[1, 2]
  return torch.stack([u, v], dim=-1), z


def depth_to_world_coords(depth: torch.Tensor, K: torch.Tensor,
                          T_wc: torch.Tensor, stride: int = 1,
                          min_depth: float = 1e-3, max_depth: float = 1e3):
  """A scene-coordinate label map from (H, W) depth and its pose: the
  depth sampled at each stride cell's pixel, back-projected and moved to
  the world. Returns ((H/stride, W/stride, 3) coordinates, 0 where invalid;
  (H/stride, W/stride) validity: depth in (min_depth, max_depth) and
  finite)."""
  h, w = depth.shape
  hs, ws = h // stride, w // stride
  if stride > 1:
    off = (stride - 1) // 2
    d = depth[off::stride, off::stride][:hs, :ws]
    pixels = cell_center_grid(hs, ws, stride, device=depth.device)
  else:
    d = depth
    pixels = pixel_grid(h, w, device=depth.device)
  valid = (d > min_depth) & (d < max_depth) & torch.isfinite(d)
  pc = backproject(torch.where(valid, d, torch.ones_like(d)), K, pixels)
  pw = transform_points(T_wc, pc)
  return torch.where(valid[..., None], pw, torch.zeros_like(pw)), valid


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


def matrix_to_axis_angle(R: torch.Tensor) -> torch.Tensor:
  """(..., 3, 3) rotations -> (..., 3) axis-angle (the log map), without
  branches: v·θ/(2 sin θ) in general, a Taylor form as θ -> 0, and near π
  (where the antisymmetric part v vanishes) the axis from the symmetric
  part, its sign from the row of the largest axis component."""
  trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
  cos_t = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
  theta = torch.arccos(cos_t)
  v = torch.stack([R[..., 2, 1] - R[..., 1, 2],
                   R[..., 0, 2] - R[..., 2, 0],
                   R[..., 1, 0] - R[..., 0, 1]], dim=-1)
  sin_t = torch.sin(theta)
  scale = torch.where(sin_t < 1e-6, 0.5 + theta * theta / 12.0,
                      theta / (2.0 * sin_t + 1e-24))
  w_generic = v * scale[..., None]
  # θ ~ π: S = (R + Rᵀ)/2 = cos θ I + (1 - cos θ) a aᵀ; |a_i| from the
  # diagonal, signs from row k of a aᵀ with k = argmax |a| (a_k > 0)
  sym = 0.5 * (R + R.transpose(-1, -2))
  one_minus = torch.clamp_min(1.0 - cos_t, 1e-12)[..., None]
  diag = torch.stack([R[..., 0, 0], R[..., 1, 1], R[..., 2, 2]], dim=-1)
  a2 = torch.clamp((diag - cos_t[..., None]) / one_minus, 0.0, 1.0)
  a = torch.sqrt(a2)
  k = torch.argmax(a2, dim=-1)
  onehot = (torch.arange(3, device=R.device) == k[..., None]).to(R.dtype)
  row_k = torch.einsum("...i,...ij->...j", onehot, sym)
  sign = torch.where(row_k >= 0, 1.0, -1.0).to(R.dtype)
  sign = torch.where(onehot > 0, torch.ones_like(sign), sign)
  w_pi = theta[..., None] * a * sign
  near_pi = (sin_t < 1e-3) & (cos_t < 0.0)
  return torch.where(near_pi[..., None], w_pi, w_generic)


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


def orthonormalize_rotation_svd(M: torch.Tensor) -> torch.Tensor:
  """The SVD reference (Kabsch with the reflection fix) of
  ``orthonormalize_rotation``, for the numeric tests."""
  u, _, vt = torch.linalg.svd(M)
  d = torch.ones(M.shape[:-2] + (3,), dtype=M.dtype, device=M.device)
  d[..., 2] = torch.linalg.det(u @ vt)
  return (u * d[..., None, :]) @ vt


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
