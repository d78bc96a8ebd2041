"""Uncertainty-weighted negative log-likelihood losses (port of
``kfnet_tpu/losses/nll.py``).

All three training stages minimize the same isotropic-Gaussian NLL,
differing only in which (prediction, variance) pair is plugged in:

  * measurement loss (SCoordNet):   (z, V)             vs GT coords of t
  * process loss (OFlowNet):        (warp(y_{t-1}), W) vs GT coords of t
  * posterior loss (joint KFNet):   (x_post, P_post)   vs GT coords of t

With σ² the isotropic variance of a 3D Gaussian, the per-pixel NLL (up to
a constant) is (3/2)·log σ² + ‖Δ‖²/(2σ²). Invalid-label pixels are masked
out of the mean. Each function reduces over everything it is given: a
per-example mean is the caller's (the objectives take one per sequence
where the JAX package takes one under ``vmap``).
"""

from __future__ import annotations

import torch


def masked_mean(x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
  """Mean of x over True-mask entries (broadcasting), safe when the mask
  is empty (the count is at least 1)."""
  mask = torch.broadcast_to(mask, x.shape).to(x.dtype)
  total = torch.sum(x * mask)
  count = torch.sum(mask)
  return total / torch.clamp_min(count, 1.0)


def _with_channel(mask: torch.Tensor, ndim: int) -> torch.Tensor:
  return mask[..., None] if mask.dim() == ndim - 1 else mask


def gaussian_nll(pred: torch.Tensor, target: torch.Tensor,
                 variance: torch.Tensor, mask: torch.Tensor | None = None,
                 eps: float = 1e-12) -> torch.Tensor:
  """Masked mean isotropic-Gaussian NLL.

  Args:
    pred/target: (..., 3) coordinates.
    variance: (..., 1) isotropic variance σ².
    mask: optional (..., 1) or (...,) validity; None = all valid.
  """
  var = torch.clamp_min(variance, eps)
  sq = torch.sum(torch.square(pred - target), dim=-1, keepdim=True)
  nll = 1.5 * torch.log(var) + sq / (2.0 * var)
  if mask is None:
    return torch.mean(nll)
  return masked_mean(nll, _with_channel(mask, nll.dim()))


def l2_coord_error(pred: torch.Tensor, target: torch.Tensor,
                   mask: torch.Tensor | None = None) -> torch.Tensor:
  """Masked mean Euclidean coordinate error (meters), the monitoring
  metric logged beside the NLL."""
  err = torch.linalg.vector_norm(pred - target, dim=-1, keepdim=True)
  if mask is None:
    return torch.mean(err)
  return masked_mean(err, _with_channel(mask, err.dim()))
