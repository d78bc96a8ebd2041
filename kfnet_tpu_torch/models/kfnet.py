"""KFNet: measurement + process + filtering (port of
``kfnet_tpu/models/kfnet.py``).

One filter step: OFlowNet (flow, W) → warp of (x, P) → SCoordNet (z, V) →
Kalman update with χ² consistency reset. The warp ∘ gain ∘ update inner
piece runs as the CUDA kernel ``kernels/fused_filter.py`` when
``use_fused_kernel`` is set (the JAX package's ``use_pallas``).
"""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

import kfnet_tpu_torch
from kfnet_tpu_torch.core import kalman
from kfnet_tpu_torch.core import warp as warp_lib
from kfnet_tpu_torch.kernels import fused_filter
from kfnet_tpu_torch.kernels.cost_volume import cost_volume
from kfnet_tpu_torch.models import oflownet, scoordnet


@dataclasses.dataclass(frozen=True)
class KFNetConfig:
  """The JAX package's config, with ``use_fused_kernel`` in place of
  ``use_pallas``. False selects the warp ∘ kalman composition, which also
  returns the prior; the adaptive path (``adaptive_alpha_max > 1``) needs
  a global reduction between warp and update and always takes it."""
  scoordnet: scoordnet.SCoordNetConfig = scoordnet.SCoordNetConfig()
  oflownet: oflownet.OFlowNetConfig = oflownet.OFlowNetConfig()
  chi2_threshold: float = kalman.CHI2_3DOF_P50
  invalid_cov: float = 1e8
  use_fused_kernel: bool = True
  w_scale: float = 16.0
  adaptive_alpha_max: float = 0.0

  def __post_init__(self):
    a = self.adaptive_alpha_max
    if 0.0 < a < 1.0:
      raise ValueError(
          f"adaptive_alpha_max={a}: an inflation CAP below 1 cannot "
          "inflate — use 0 (off) or a value > 1")


def init(seed: int, config: KFNetConfig,
         image_shape: Tuple[int, int, int] = (480, 640, 3), device=None):
  """Random He-normal weights from ``seed``, on ``device`` (``cuda``
  unless given; raises when CUDA is absent and no device is given)."""
  device = kfnet_tpu_torch.resolve_device(device)
  gen = torch.Generator(device=device).manual_seed(seed)
  return {
      "scoordnet": scoordnet.init(gen, config.scoordnet, image_shape,
                                  device),
      "oflownet": oflownet.init(gen, config.oflownet, image_shape, device),
  }


def preprocess_images(config: KFNetConfig, images: torch.Tensor):
  """Apply the shared s2d stem once when both subnets use the same factor."""
  if config.scoordnet.stem_s2d == config.oflownet.stem_s2d:
    return scoordnet.maybe_space_to_depth(config.scoordnet, images)
  return images


def measure(params, config: KFNetConfig, image: torch.Tensor):
  """SCoordNet measurement: (..., H, W, 3) image -> (z, V) at 1/8 res."""
  return scoordnet.apply(params["scoordnet"], config.scoordnet, image)


def encode(params, config: KFNetConfig, image: torch.Tensor):
  """OFlowNet encoder features for one frame (carried across steps)."""
  return oflownet.encode(params["oflownet"], config.oflownet, image)


def flow_from_features(params, config: KFNetConfig, feat_prev, feat_cur):
  cv = cost_volume(feat_prev, feat_cur, config.oflownet.search_radius)
  flow, W = oflownet.decode(params["oflownet"], config.oflownet, cv)
  if config.w_scale != 1.0:
    W = W * config.w_scale
  return flow, W


def _fused_update(config: KFNetConfig, x_prev, P_prev, flow, W, z, V):
  """warp ∘ gain ∘ innovation ∘ update: the CUDA kernel or the composition.

  Returns (x_post, P_post, consistent, prior); prior is (x_prior, P_prior)
  on the composition and None on the kernel path."""
  # clip first, so both paths see the same flow for any caller
  r = float(config.oflownet.search_radius)
  flow = torch.clamp(flow, -r, r)
  adaptive = config.adaptive_alpha_max > 1.0
  if config.use_fused_kernel and not adaptive:
    x_post, P_post, consistent = fused_filter.fused_warp_kalman(
        x_prev.contiguous(), P_prev.contiguous(), flow.contiguous(),
        W.contiguous(), z.contiguous(), V.contiguous(),
        radius=config.oflownet.search_radius,
        threshold=config.chi2_threshold, invalid_cov=config.invalid_cov)
    return x_post, P_post, consistent, None
  x_pr, P_pr, valid = warp_lib.warp_state_cov(
      x_prev, P_prev, flow, W, invalid_cov=config.invalid_cov)
  if adaptive:
    maha = kalman.mahalanobis_sq(z - x_pr, P_pr, V)
    # mean over warp-valid pixels only: the invalid band's maha ≈ 0
    v = valid.to(torch.float32)
    m_bar = (torch.sum(torch.clamp_max(maha, 25.0) * v)
             / torch.clamp_min(torch.sum(v), 1.0))
    alpha = torch.clamp(m_bar / 3.0, 1.0, config.adaptive_alpha_max)
    P_pr = alpha * P_pr
  x_post, P_post, consistent = kalman.kalman_update(
      x_pr, P_pr, z, V, threshold=config.chi2_threshold)
  return x_post, P_post, consistent, (x_pr, P_pr)


def filter_step(params, config: KFNetConfig, x_prev, P_prev, feat_prev,
                image_cur):
  """One recursive-filter step on one frame (no batch dim).

  Args:
    x_prev/P_prev: (h, w, 3)/(h, w, 1) previous posterior.
    feat_prev: (h, w, C) OFlowNet features of the previous frame.
    image_cur: (H, W, 3) current frame (or its s2d form).

  Returns:
    (x_post, P_post, feat_cur, aux) with aux = dict(flow, W, z, V,
    consistent) and, on the composition, x_prior and P_prior.
  """
  feat_cur = encode(params, config, image_cur)
  flow, W = flow_from_features(params, config, feat_prev, feat_cur)
  z, V = measure(params, config, image_cur)
  x_post, P_post, consistent, prior = _fused_update(
      config, x_prev, P_prev, flow, W, z, V)
  aux = {"flow": flow, "W": W, "z": z, "V": V, "consistent": consistent}
  if prior is not None:
    aux["x_prior"], aux["P_prior"] = prior
  return x_post, P_post, feat_cur, aux


def first_step(params, config: KFNetConfig, image: torch.Tensor):
  """Frame 0: no prior, so the posterior is the measurement."""
  z, V = measure(params, config, image)
  feat = encode(params, config, image)
  return z, V, feat
