"""Per-pixel scalar-covariance Kalman update + consistency examination
(port of ``kfnet_tpu/core/kalman.py``).

Each pixel carries a 3-vector state x with isotropic scalar covariance P.
x-like tensors are (..., 3); covariances (..., 1). float32 throughout.
"""

from __future__ import annotations

import torch

# chi-square(3 dof) upper-tail critical values for the consistency test.
CHI2_3DOF_P05 = 7.814728  # p = 0.05 (the paper's gate)
CHI2_3DOF_P01 = 11.344867  # p = 0.01
CHI2_3DOF_P50 = 2.365974  # p = 0.50: the calibrated serving gate


def kalman_gain(P_prior: torch.Tensor, V: torch.Tensor) -> torch.Tensor:
  """K = P⁻ / (P⁻ + V), elementwise scalar gain."""
  return P_prior / (P_prior + V)


def mahalanobis_sq(innovation: torch.Tensor, P_prior: torch.Tensor,
                   V: torch.Tensor) -> torch.Tensor:
  """Squared Mahalanobis distance of the innovation under S = (P⁻+V)·I₃.

  The channel sum is taken left to right, the order the CUDA kernel uses,
  so the χ² mask of the two agrees bit for bit. Returns (..., 1)."""
  sq = innovation * innovation
  total = sq[..., 0:1]
  for c in range(1, sq.shape[-1]):
    total = total + sq[..., c:c + 1]
  return total / (P_prior + V)


def consistency_mask(innovation: torch.Tensor, P_prior: torch.Tensor,
                     V: torch.Tensor,
                     threshold: float = CHI2_3DOF_P05) -> torch.Tensor:
  """True where the prior is consistent with the measurement (χ², 3 dof).
  False resets the pixel to measurement-only (K→1)."""
  return mahalanobis_sq(innovation, P_prior, V) <= threshold


def kalman_update(x_prior: torch.Tensor, P_prior: torch.Tensor,
                  z: torch.Tensor, V: torch.Tensor,
                  threshold: float = CHI2_3DOF_P05):
  """Gain + innovation + posterior update + consistency reset.

  Returns (x_post (..., 3), P_post (..., 1), consistent (..., 1) bool).
  """
  innovation = z - x_prior
  consistent = consistency_mask(innovation, P_prior, V, threshold)
  K = kalman_gain(P_prior, V)
  x_post = x_prior + K * innovation
  # product form: (1-K)·P⁻ cancels catastrophically when P⁻ ≫ V
  P_post = (P_prior * V) / (P_prior + V)
  x_post = torch.where(consistent, x_post, z)
  P_post = torch.where(consistent, P_post, V)
  return x_post, P_post, consistent


def fuse_information_form(x_prior, P_prior, z, V):
  """Information-form fusion: P = (P⁻·V)/(P⁻+V), x = P·(x⁻/P⁻ + z/V).
  Algebraically ``kalman_update`` without the consistency branch."""
  P = (P_prior * V) / (P_prior + V)
  x = P * (x_prior / P_prior + z / V)
  return x, P
