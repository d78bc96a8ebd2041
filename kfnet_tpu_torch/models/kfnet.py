"""KFNet: measurement + process + filtering (port of
``kfnet_tpu/models/kfnet.py``).

One filter step: OFlowNet (flow, W) → warp of (x, P) → SCoordNet (z, V) →
Kalman update with χ² consistency reset. When ``use_fused_kernel`` is set
(the JAX package's ``use_pallas``) the two heads' output steps, the flow
clip, the warp and the update run as one CUDA kernel
(``kernels/fused_filter.fused_filter_step``) on the heads' raw outputs, one
launch for a frame or a (B, ...) batch of frames. The nets' ``conv_impl``
picks their conv kernels (``kernels/conv3x3.py``); ``kernel_shapes`` lists
the calls of one frame. The conv kernels take one frame, so on a batch
``filter_step`` and ``first_step`` run a kernel net frame by frame (the
JAX package vmaps these steps over a batch, and each frame takes its
kernels), and a net of PyTorch's convs on the whole batch at once.
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
from kfnet_tpu_torch.nn import layers as L
from kfnet_tpu_torch.utils import tracing


@dataclasses.dataclass(frozen=True)
class KFNetConfig:
  """The JAX package's config, with ``use_fused_kernel`` in place of
  ``use_pallas``. False selects the warp ∘ kalman composition, which also
  returns the prior; the adaptive path (``adaptive_alpha_max > 1``) needs
  a reduction over each map between warp and update and always takes it."""
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
  of = config.oflownet
  cv = cost_volume(feat_prev, feat_cur, of.search_radius)
  flow, W = oflownet.output_step(_decode_raw(params, of, cv),
                                 of.search_radius)
  if config.w_scale != 1.0:
    W = W * config.w_scale
  return flow, W


def _frames(net_config, fn, x: torch.Tensor) -> torch.Tensor:
  """``fn`` of one (..., C) map or frame, or of a (B, h, w, C) batch: at
  once where the net runs PyTorch's convs (or Winograd's), frame by frame
  where its convs are kernels, which take one frame."""
  if net_config.conv_impl in ("xla", "winograd") or x.dim() == 3:
    return fn(x)
  return torch.stack([fn(f) for f in x.unbind(0)])


def _decode_raw(params, of, cv):
  return _frames(of, lambda c: oflownet.decode_raw(params["oflownet"], of,
                                                   c), cv)


def _kernel_path(config: KFNetConfig) -> bool:
  """The fused kernel takes the update; the adaptive path (a cap > 1)
  needs a reduction over each map between warp and update and never
  does."""
  return config.use_fused_kernel and not config.adaptive_alpha_max > 1.0


def _composed_update(config: KFNetConfig, x_prev, P_prev, flow, W, z, V):
  """warp ∘ gain ∘ innovation ∘ update as a composition, with the adaptive
  inflation when it is on, for one map or a (B, ...) batch. Returns
  (x_post, P_post, consistent, (x_prior, P_prior))."""
  # clip first, as the kernel does, so both paths see the same flow
  r = float(config.oflownet.search_radius)
  flow = torch.clamp(flow, -r, r)
  x_pr, P_pr, valid = warp_lib.warp_state_cov(
      x_prev, P_prev, flow, W, invalid_cov=config.invalid_cov)
  if config.adaptive_alpha_max > 1.0:
    maha = kalman.mahalanobis_sq(z - x_pr, P_pr, V)
    # mean over warp-valid pixels only (the invalid band's maha ≈ 0), one
    # mean per map: the JAX package computes it under vmap on a batch
    v = valid.to(torch.float32)
    per_map = dict(dim=(-3, -2, -1), keepdim=True)
    m_bar = (torch.sum(torch.clamp_max(maha, 25.0) * v, **per_map)
             / torch.clamp_min(torch.sum(v, **per_map), 1.0))
    alpha = torch.clamp(m_bar / 3.0, 1.0, config.adaptive_alpha_max)
    P_pr = alpha * P_pr
  x_post, P_post, consistent = kalman.kalman_update(
      x_pr, P_pr, z, V, threshold=config.chi2_threshold)
  return x_post, P_post, consistent, (x_pr, P_pr)


def filter_step(params, config: KFNetConfig, x_prev, P_prev, feat_prev,
                image_cur):
  """One recursive-filter step on one frame, or on a batch of B frames in
  lockstep (the kernel path: one fused launch for all B maps; the
  composition: each map warped and, when adaptive, inflated by its own
  statistic).

  Args:
    x_prev/P_prev: ([B,] h, w, 3)/([B,] h, w, 1) previous posterior.
    feat_prev: ([B,] h, w, C) OFlowNet features of the previous frame.
    image_cur: ([B,] H, W, 3) current frame (or its s2d form).

  Returns:
    (x_post, P_post, feat_cur, aux) with aux = dict(flow, W, z, V,
    consistent) and, on the composition, x_prior and P_prior.
  """
  sc, of = config.scoordnet, config.oflownet
  feat_cur = _frames(of, lambda im: encode(params, config, im), image_cur)
  if _kernel_path(config):
    cv = cost_volume(feat_prev, feat_cur, of.search_radius)
    raw_flow = _decode_raw(params, of, cv)
    raw_coord = _frames(sc, lambda im: scoordnet.apply_raw(
        params["scoordnet"], sc, im), image_cur)
    with tracing.span("fused"):
      out = fused_filter.fused_filter_step(
          raw_flow, raw_coord, x_prev.contiguous(), P_prev.contiguous(),
          radius=config.oflownet.search_radius, w_scale=config.w_scale,
          coord_scale=sc.coord_scale, coord_offset=sc.coord_offset,
          log_w_clip=oflownet.LOG_VAR_CLIP, log_v_clip=scoordnet.LOG_VAR_CLIP,
          threshold=config.chi2_threshold, invalid_cov=config.invalid_cov)
    x_post, P_post, consistent, flow, W, z, V = out
    aux = {"flow": flow, "W": W, "z": z, "V": V, "consistent": consistent}
    return x_post, P_post, feat_cur, aux
  flow, W = flow_from_features(params, config, feat_prev, feat_cur)
  z, V = _measure_frames(params, config, image_cur)
  x_post, P_post, consistent, prior = _composed_update(
      config, x_prev, P_prev, flow, W, z, V)
  aux = {"flow": flow, "W": W, "z": z, "V": V, "consistent": consistent,
         "x_prior": prior[0], "P_prior": prior[1]}
  return x_post, P_post, feat_cur, aux


def kernel_shapes(config: KFNetConfig,
                  image_shape: Tuple[int, int, int] = (480, 640, 3),
                  first: bool = False):
  """The (h, w, cin, cout) of each conv kernel call of one frame, of
  ``first_step`` when ``first`` else of ``filter_step``:
  {"conv3x3_gn_chain": [...], "conv3x3_same": [...]}. The convs come from
  the nets' own ``init``, run on the meta device (no weights)."""
  sc, of = config.scoordnet, config.oflownet
  gen = torch.Generator()
  with L.trace_convs() as sc_convs:
    scoordnet.init(gen, sc, image_shape, "meta")
  with L.trace_convs() as of_convs:
    oflownet.init(gen, of, image_shape, "meta")
  if first:  # frame 0 runs OFlowNet's encoder only
    of_convs = of_convs[:len(of.encoder_channels)]

  def same(convs, impl):
    return [c[:4] for c in convs if impl == "pallas_3x3"
            and L._pallas_conv_eligible(*c, 1, "SAME")]

  chain = []
  if sc.conv_impl == "pallas_fused":  # trunk blocks k.., then the head block
    chain = [c[:4] for c in
             sc_convs[scoordnet._fused_suffix_start(sc):len(sc.channels) + 1]]
  return {"conv3x3_gn_chain": chain,
          "conv3x3_same": same(sc_convs, sc.conv_impl)
                          + same(of_convs, of.conv_impl)}


def _measure_frames(params, config: KFNetConfig, image: torch.Tensor):
  sc = config.scoordnet
  raw = _frames(sc, lambda im: scoordnet.apply_raw(params["scoordnet"], sc,
                                                   im), image)
  return scoordnet.output_step(raw, sc.coord_scale, sc.coord_offset)


def first_step(params, config: KFNetConfig, image: torch.Tensor):
  """Frame 0 (or a batch of B frames 0): no prior, so the posterior is
  the measurement. The span ``filter.first``."""
  with tracing.span("filter.first"):
    z, V = _measure_frames(params, config, image)
    feat = _frames(config.oflownet, lambda im: encode(params, config, im),
                   image)
    return z, V, feat
