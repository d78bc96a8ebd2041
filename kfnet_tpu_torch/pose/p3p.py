"""P3P minimal solver, Grunert's solution in the form of Haralick et al.
(1994) (port of ``kfnet_tpu/pose/p3p.py``), over any leading batch dims
and without data-dependent control flow.

RANSAC with the 6-point DLT needs all-inlier samples with probability w⁶,
P3P with w³: at 30% inliers 2.7% of draws against 0.07%.
  * Grunert's quartic is solved by Durand–Kerner in complex64 with a fixed
    40 iterations;
  * each of the 4 roots gives the camera-frame distances of the 3 points,
    and the pose follows by matching orthonormal triads of the 3 points in
    both frames;
  * an invalid root gives a finite garbage pose that RANSAC's scoring
    discards.
Nothing here reads a value back to the host: K's inverse is the closed
form of ``core.geometry``, not ``torch.linalg.inv``, whose error check
would.

Returns 4 candidate (R, t) per minimal set (world -> camera).
"""

from __future__ import annotations

import cmath

import torch

from kfnet_tpu_torch.core import geometry as geo

# Durand–Kerner's start: powers 1..4 of 0.4 + 0.9i, as (modulus, angle)
_DK_BASE = cmath.polar(0.4 + 0.9j)


def durand_kerner_quartic(coeffs: torch.Tensor, iters: int = 40):
  """Roots of quartics given (..., 5) coefficients [A4..A0], highest
  first: (..., 4) complex64. A leading coefficient near 0 is replaced by
  1e-12 (callers reject bad roots by their geometry)."""
  A4 = coeffs[..., :1]
  safe = torch.where(torch.abs(A4) < 1e-12, torch.full_like(A4, 1e-12), A4)
  c = (coeffs / safe).to(torch.complex64)  # monic
  c1, c2, c3, c4 = (c[..., i:i + 1] for i in range(1, 5))
  eye = torch.eye(4, dtype=torch.complex64, device=coeffs.device)
  # made on the device: a tensor from host values would be a copy that
  # waits for the device
  k = torch.arange(1, 5, dtype=torch.float32, device=coeffs.device)
  z = torch.polar(_DK_BASE[0] ** k, _DK_BASE[1] * k).expand(
      c.shape[:-1] + (4,))
  for _ in range(iters):
    # z_i <- z_i - p(z_i) / prod_{j != i} (z_i - z_j)
    d = z[..., :, None] - z[..., None, :] + eye
    denom = d[..., 0] * d[..., 1] * d[..., 2] * d[..., 3]
    poly = (((z + c1) * z + c2) * z + c3) * z + c4
    z = z - poly / denom
  return z


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
  return torch.linalg.cross(a, b, dim=-1)


def _unit(a: torch.Tensor) -> torch.Tensor:
  return a / torch.clamp_min(torch.linalg.vector_norm(a, dim=-1,
                                                      keepdim=True), 1e-12)


def _triad(P: torch.Tensor) -> torch.Tensor:
  """Orthonormal bases (columns) of (..., 3, 3) point triples: u1 along
  P1 - P0, u3 the plane's normal, u2 = u3 x u1. Collinear points give
  garbage, but finite."""
  a = P[..., 1, :] - P[..., 0, :]
  b = P[..., 2, :] - P[..., 0, :]
  u1 = _unit(a)
  u3 = _unit(_cross(a, b))
  return torch.stack([u1, _cross(u3, u1), u3], dim=-1)


def _kabsch_w2c(Xw: torch.Tensor, Pc: torch.Tensor):
  """Rigid transforms with Pc ≈ R·Xw + t from 3 correspondences (..., 3,
  3): R = B_c·B_wᵀ of the matched triads, exact for rigid triples."""
  R = _triad(Pc) @ _triad(Xw).transpose(-1, -2)
  t = torch.mean(Pc, dim=-2) - (R @ torch.mean(Xw, dim=-2)[..., None])[..., 0]
  return R, t


def p3p_grunert(uv: torch.Tensor, X: torch.Tensor, K: torch.Tensor):
  """Solve P3P for minimal sets.

  Args:
    uv: (..., 3, 2) pixels; X: (..., 3, 3) world points; K: (3, 3).

  Returns:
    Rs (..., 4, 3, 3), ts (..., 4, 3): 4 world -> camera candidates each
    (an invalid root gives finite garbage, rejected by scoring).
  """
  Kinv = geo._inv3(K)
  rays = torch.cat([uv, torch.ones_like(uv[..., :1])], -1) @ Kinv.T
  f = rays / torch.linalg.vector_norm(rays, dim=-1, keepdim=True)

  def dot(a, b):
    return torch.sum(a * b, dim=-1)

  X0, X1, X2 = X[..., 0, :], X[..., 1, :], X[..., 2, :]
  a2 = dot(X1 - X2, X1 - X2)
  b2 = dot(X0 - X2, X0 - X2)
  c2 = dot(X0 - X1, X0 - X1)
  ca = dot(f[..., 1, :], f[..., 2, :])  # cos alpha (rays 2, 3)
  cb = dot(f[..., 0, :], f[..., 2, :])  # cos beta (rays 1, 3)
  cg = dot(f[..., 0, :], f[..., 1, :])  # cos gamma (rays 1, 2)

  b2s = torch.where(torch.abs(b2) < 1e-12, torch.full_like(b2, 1e-12), b2)
  q1 = (a2 - c2) / b2s
  q2 = (a2 + c2) / b2s

  A4 = (q1 - 1.0) ** 2 - 4.0 * (c2 / b2s) * ca ** 2
  A3 = 4.0 * (q1 * (1.0 - q1) * cb - (1.0 - q2) * ca * cg
              + 2.0 * (c2 / b2s) * ca ** 2 * cb)
  A2 = 2.0 * (q1 ** 2 - 1.0 + 2.0 * q1 ** 2 * cb ** 2
              + 2.0 * ((b2 - c2) / b2s) * ca ** 2
              - 4.0 * q2 * ca * cb * cg
              + 2.0 * ((b2 - a2) / b2s) * cg ** 2)
  A1 = 4.0 * (-q1 * (1.0 + q1) * cb + 2.0 * (a2 / b2s) * cg ** 2 * cb
              - (1.0 - q2) * ca * cg)
  A0 = (1.0 + q1) ** 2 - 4.0 * (a2 / b2s) * cg ** 2

  roots = durand_kerner_quartic(torch.stack([A4, A3, A2, A1, A0], dim=-1))
  v = roots.real
  bad = (torch.abs(roots.imag) > 1e-3) | (v <= 1e-6)
  ca, cb, cg, q1, b2 = (a[..., None] for a in (ca, cb, cg, q1, b2))

  denom_u = 2.0 * (cg - v * ca)
  denom_u = torch.where(torch.abs(denom_u) < 1e-9,
                        torch.full_like(denom_u, 1e-9), denom_u)
  u = ((-1.0 + q1) * v ** 2 - 2.0 * q1 * cb * v + 1.0 + q1) / denom_u

  s1 = torch.sqrt(torch.clamp_min(
      b2 / torch.clamp_min(1.0 + v ** 2 - 2.0 * v * cb, 1e-9), 1e-12))
  s2 = u * s1
  s3 = v * s1
  bad = bad | (s2 <= 1e-6) | (s3 <= 1e-6)
  # an invalid root's distances collapse to 1 (a finite garbage pose)
  s = torch.where(bad[..., None], torch.ones_like(s1)[..., None],
                  torch.stack([s1, s2, s3], dim=-1))      # (..., 4, 3)
  Pc = f[..., None, :, :] * s[..., None]                  # (..., 4, 3, 3)
  return _kabsch_w2c(X[..., None, :, :], Pc)
