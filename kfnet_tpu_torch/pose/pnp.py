"""Batched PnP: normalized weighted DLT and a fixed-iteration
Levenberg–Marquardt polish (port of ``kfnet_tpu/pose/pnp.py``).

Poses are world→camera (R, t): x_cam = R·X + t. Every function takes
optional leading batch dims (the RANSAC hypotheses) where the JAX package
vmaps. Linear algebra goes through the ``*_ex`` / triangular-solve forms,
which do not read a status back to the host, so a solve never syncs.
"""

from __future__ import annotations

import torch

from kfnet_tpu_torch.core import geometry as geo


def project_w2c(X, K, R, t):
  """Project (..., n, 3) world points with world→camera (R, t).
  Returns (uv (..., n, 2), z (..., n))."""
  pc = X @ R.transpose(-1, -2) + t[..., None, :]
  z = pc[..., 2]
  zs = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
  u = K[0, 0] * pc[..., 0] / zs + K[0, 2]
  v = K[1, 1] * pc[..., 1] / zs + K[1, 2]
  return torch.stack([u, v], dim=-1), z


def _normalize_2d(uv, w):
  """Hartley normalisation of (..., n, 2) points with weights (..., n)."""
  wsum = torch.clamp_min(torch.sum(w, dim=-1), 1e-8)
  mean = torch.sum(uv * w[..., None], dim=-2) / wsum[..., None]
  d = torch.sqrt(torch.sum((uv - mean[..., None, :]) ** 2, dim=-1))
  scale = 2.0 ** 0.5 / torch.clamp_min(torch.sum(d * w, dim=-1) / wsum,
                                       1e-8)
  zero, one = torch.zeros_like(scale), torch.ones_like(scale)
  T = torch.stack([
      torch.stack([scale, zero, -mean[..., 0] * scale], -1),
      torch.stack([zero, scale, -mean[..., 1] * scale], -1),
      torch.stack([zero, zero, one], -1)], -2)
  return (uv - mean[..., None, :]) * scale[..., None, None], T


def _normalize_3d(X, w):
  wsum = torch.clamp_min(torch.sum(w, dim=-1), 1e-8)
  mean = torch.sum(X * w[..., None], dim=-2) / wsum[..., None]
  d = torch.sqrt(torch.sum((X - mean[..., None, :]) ** 2, dim=-1))
  scale = 3.0 ** 0.5 / torch.clamp_min(torch.sum(d * w, dim=-1) / wsum,
                                       1e-8)
  zero, one = torch.zeros_like(scale), torch.ones_like(scale)
  rows = [torch.stack([scale if j == i else zero for j in range(3)]
                      + [-mean[..., i] * scale], -1) for i in range(3)]
  U = torch.stack(rows + [torch.stack([zero, zero, zero, one], -1)], -2)
  return (X - mean[..., None, :]) * scale[..., None, None], U


def _smallest_eigvec_12(M, iters: int = 8):
  """Eigenvector of the smallest eigenvalue of (..., 12, 12) PSD matrices
  by shifted inverse iteration: one Cholesky, then ``iters`` pairs of
  triangular solves. A degenerate sample gives a garbage vector, which
  RANSAC scoring discards."""
  eps = 1e-7 * torch.diagonal(M, dim1=-2, dim2=-1).sum(-1) / 12.0 + 1e-30
  eye = torch.eye(12, dtype=M.dtype, device=M.device)
  A = M + eps[..., None, None] * eye
  L, _ = torch.linalg.cholesky_ex(A)
  v = torch.full(M.shape[:-1] + (1,), 1.0 / 12.0 ** 0.5, dtype=M.dtype,
                 device=M.device)
  for _ in range(iters):
    y = torch.linalg.solve_triangular(L, v, upper=False)
    v = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    v = v / torch.clamp_min(torch.linalg.norm(v, dim=-2, keepdim=True),
                            1e-30)
  return v[..., 0]


def dlt_pnp(uv, X, K, weights=None):
  """Weighted DLT PnP from n ≥ 6 correspondences.

  Args:
    uv: (..., n, 2) pixels; X: (..., n, 3) world points; K: (3, 3).
    weights: (..., n) nonnegative weights, or None for all ones.

  Returns:
    (R (..., 3, 3), t (..., 3)) world→camera.
  """
  w = torch.ones(uv.shape[:-1], dtype=uv.dtype, device=uv.device) \
      if weights is None else weights
  ones = torch.ones(uv.shape[:-1] + (1,), dtype=uv.dtype, device=uv.device)
  Kinv = geo._inv3(K)
  xn = (torch.cat([uv, ones], dim=-1) @ Kinv.T)[..., :2]
  xn, T2 = _normalize_2d(xn, w)
  Xn, T3 = _normalize_3d(X, w)
  Xh = torch.cat([Xn, ones], dim=-1)
  zeros = torch.zeros_like(Xh)
  r1 = torch.cat([Xh, zeros, -xn[..., 0:1] * Xh], dim=-1)
  r2 = torch.cat([zeros, Xh, -xn[..., 1:2] * Xh], dim=-1)
  A = torch.cat([r1, r2], dim=-2) * torch.cat([w, w], dim=-1)[..., None]
  M = A.transpose(-1, -2) @ A
  p = _smallest_eigvec_12(M)
  P = p.reshape(p.shape[:-1] + (3, 4))
  P = geo._inv3(T2) @ P @ T3
  scale = torch.linalg.norm(P[..., 2, :3], dim=-1)
  P = P / torch.clamp_min(scale, 1e-12)[..., None, None]
  z = X @ P[..., 2, :3, None] + P[..., 2, 3, None, None]   # (..., n, 1)
  sign = torch.where(torch.sum(torch.sign(z[..., 0]) * w, dim=-1) >= 0,
                     1.0, -1.0)
  P = P * sign[..., None, None]
  R = geo.orthonormalize_rotation(P[..., :3])
  return R, P[..., 3]


def reprojection_errors(uv, X, K, R, t, max_err: float = 1e6):
  """Per-point reprojection error in pixels, clamped; points behind the
  camera get ``max_err``."""
  proj, z = project_w2c(X, K, R, t)
  err = torch.linalg.norm(proj - uv, dim=-1)
  err = torch.where(z > 1e-6, err, torch.full_like(err, max_err))
  return torch.clamp_max(err, max_err)


def _se3_apply(dw, dt, R, t):
  dR = geo.axis_angle_to_matrix(dw)
  return dR @ R, (dR @ t[..., None])[..., 0] + dt


def refine_pnp_lm(uv, X, K, R0, t0, weights, iters: int = 10,
                  damping: float = 1e-3):
  """Fixed-iteration Levenberg–Marquardt polish of (R, t) minimising the
  weighted reprojection error; each step solves a 6x6 system per frame.

  Args:
    uv: ([T,] n, 2); X: ([T,] n, 3); K: (3, 3); R0: ([T,] 3, 3); t0: ([T,]
      3); weights: ([T,] n). A leading T polishes T frames at once, each
      with its own damping. One frame runs as a batch of one, so that
      each frame of a batch sums its normal equations as it would alone.
  """
  if weights.dim() == 1:
    R, t = refine_pnp_lm(uv[None], X[None], K, R0[None], t0[None],
                         weights[None], iters, damping)
    return R[0], t[0]
  fx, fy = K[0, 0], K[1, 1]

  def residuals(R, t):
    pc = X @ R.transpose(-1, -2) + t[..., None, :]
    z = torch.clamp_min(pc[..., 2], 1e-6)
    u = fx * pc[..., 0] / z + K[0, 2]
    v = fy * pc[..., 1] / z + K[1, 2]
    return torch.stack([u - uv[..., 0], v - uv[..., 1]], -1), pc, z

  def residuals_jac(R, t):
    r, pc, z = residuals(R, t)
    zinv = 1.0 / z
    zero = torch.zeros_like(z)
    du = torch.stack([fx * zinv, zero, -fx * pc[..., 0] * zinv * zinv], -1)
    dv = torch.stack([zero, fy * zinv, -fy * pc[..., 1] * zinv * zinv], -1)
    Jp = torch.stack([du, dv], -2)                     # (.., n, 2, 3)
    Jw = -Jp @ geo.hat(pc)                             # (.., n, 2, 3)
    return r, torch.cat([Jw, Jp], -1)                  # (.., n, 2, 6)

  def cost_of(r):
    return torch.sum(weights * torch.sum(r * r, -1), -1)

  eye6 = torch.eye(6, dtype=uv.dtype, device=uv.device)
  R, t = R0, t0
  lam = torch.full(weights.shape[:-1], damping, dtype=uv.dtype,
                   device=uv.device)
  c = cost_of(residuals(R, t)[0])
  for _ in range(iters):
    r, J = residuals_jac(R, t)
    # [JᵀWJ | JᵀWr] as one (6, 2n) x (2n, 7) product a frame: the same
    # product for every frame of any batch (a separate JᵀWr would be a
    # matrix-vector product, whose summation order follows the batch)
    lead = J.shape[:-3]
    wJr = weights[..., None, None] * torch.cat([J, r[..., None]], -1)
    G = (J.reshape(lead + (-1, 6)).transpose(-1, -2)
         @ wJr.reshape(lead + (-1, 7)))
    JTJ, JTr = G[..., :6], G[..., 6]
    trace = torch.diagonal(JTJ, dim1=-2, dim2=-1).sum(-1)
    H = JTJ + (lam * torch.clamp_min(trace / 6.0, 1e-8))[..., None,
                                                          None] * eye6
    delta = -torch.linalg.solve_ex(H, JTr[..., None])[0][..., 0]
    R_new, t_new = _se3_apply(delta[..., :3], delta[..., 3:], R, t)
    c_new = cost_of(residuals(R_new, t_new)[0])
    improved = c_new < c
    R = torch.where(improved[..., None, None], R_new, R)
    t = torch.where(improved[..., None], t_new, t)
    c = torch.where(improved, c_new, c)
    lam = torch.where(improved, lam * 0.5, lam * 4.0)
  return R, t
