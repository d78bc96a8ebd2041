"""OFlowNet, the process system (port of ``kfnet_tpu/models/oflownet.py``).

A shared encoder maps each frame to 1/8-resolution features; the cost
volume correlates the current frame's against the previous frame's; a
small U-Net decodes it into backward flow ``r·tanh(raw)`` (2 channels)
and a process-noise variance ``exp(clip(logvar, ±12))`` (1 channel).
With ``conv_impl="pallas_3x3"`` a single frame's eligible convs run the
``conv3x3_same`` kernel (``kfnet.kernel_shapes`` lists them).
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from kfnet_tpu_torch.core import heads
from kfnet_tpu_torch.kernels.cost_volume import cost_volume
from kfnet_tpu_torch.models import scoordnet
from kfnet_tpu_torch.nn import layers as L

LOG_VAR_MIN = -12.0
LOG_VAR_MAX = 12.0
LOG_VAR_CLIP = (LOG_VAR_MIN, LOG_VAR_MAX)


@dataclasses.dataclass(frozen=True)
class OFlowNetConfig:
  """Field for field and default for default the JAX package's config."""
  encoder_channels: Sequence[int] = (32, 32, 64, 64, 128, 128)
  encoder_strides: Sequence[int] = (2, 1, 2, 1, 2, 1)
  search_radius: int = 4
  unet_channels: Sequence[int] = (128, 128, 256)  # enc0, down1, down2
  compute_dtype: str = "bfloat16"
  norm: str = "group"  # "group" | "none"
  stem_s2d: int = 2
  conv_impl: str = "xla"

  @property
  def dtype(self) -> torch.dtype:
    return L.as_dtype(self.compute_dtype)

  @property
  def cv_channels(self) -> int:
    return (2 * self.search_radius + 1) ** 2


def _encoder(config: OFlowNetConfig, single_frame: bool = False) -> L.Layer:
  strides = scoordnet._adjusted_strides(config.encoder_strides,
                                        config.stem_s2d)
  impl = L.frame_impl(config.conv_impl, single_frame)
  return L.serial(*[
      L.conv_block(c, 3, s, norm=config.norm, compute_dtype=config.dtype,
                   impl=impl)
      for c, s in zip(config.encoder_channels, strides)
  ])


def _decoder_layers(config: OFlowNetConfig, single_frame: bool = False):
  c0, c1, c2 = config.unet_channels
  dt, nm = config.dtype, config.norm
  im = L.frame_impl(config.conv_impl, single_frame)

  def block(c, s):
    return L.conv_block(c, 3, s, norm=nm, compute_dtype=dt, impl=im)

  return {
      "enc0": L.serial(block(c0, 1), block(c0, 1)),
      "down1": L.serial(block(c1, 2), block(c1, 1)),
      "down2": L.serial(block(c2, 2), block(c2, 1)),
      "up1": L.conv_transpose(c1, 4, 2, compute_dtype=dt),
      "fuse1": block(c1, 1),
      "up0": L.conv_transpose(c0, 4, 2, compute_dtype=dt),
      "fuse0": block(c0, 1),
      # f32 head: flow and log-variance need better than bf16 resolution
      "head": L.conv(3, 3, 1, use_bias=True, compute_dtype=torch.float32),
  }


def init(gen: torch.Generator, config: OFlowNetConfig,
         image_shape: Tuple[int, int, int] = (480, 640, 3), device=None):
  """He-normal weights drawn from ``gen`` (on ``device``)."""
  f = config.stem_s2d
  if f > 1:
    h, w, c = image_shape
    image_shape = (h // f, w // f, c * f * f)
  enc_params, feat_shape = _encoder(config).init(gen, image_shape, device)
  h, w, _ = feat_shape
  dec = _decoder_layers(config)
  params = {"encoder": enc_params}
  params["enc0"], s0 = dec["enc0"].init(gen, (h, w, config.cv_channels),
                                        device)
  params["down1"], s1 = dec["down1"].init(gen, s0, device)
  params["down2"], s2 = dec["down2"].init(gen, s1, device)
  # as in decode: each up-sampled map is cropped to its skip's, then joined
  params["up1"], u1 = dec["up1"].init(gen, s2, device)
  params["fuse1"], f1 = dec["fuse1"].init(gen, (s1[0], s1[1], u1[2] + s1[2]),
                                          device)
  params["up0"], u0 = dec["up0"].init(gen, f1, device)
  params["fuse0"], f0 = dec["fuse0"].init(gen, (s0[0], s0[1], u0[2] + s0[2]),
                                          device)
  params["head"], _ = dec["head"].init(gen, f0, device)
  return params


def encode(params, config: OFlowNetConfig, image: torch.Tensor):
  """Shared encoder: (..., H, W, 3) [or its s2d form] -> (..., H/8, W/8, C)
  in ``compute_dtype``. uint8 frames are cast and scaled on the device."""
  image = scoordnet.ingest(scoordnet.maybe_space_to_depth(config, image))
  x, lead = scoordnet.to_nchw(image)
  enc = _encoder(config, single_frame=image.dim() == 3)
  return scoordnet.from_nchw(enc.apply(params["encoder"], x), lead)


def _crop_to(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
  """Crop a (B, C, H, W) map to its first h rows and w columns."""
  return x[..., :h, :w]


def decode_raw(params, config: OFlowNetConfig, cv: torch.Tensor):
  """U-Net over the (..., h, w, K) cost volume -> the head's raw float32
  (..., h, w, 3): raw flow (2), raw log-variance (1), contiguous."""
  dec = _decoder_layers(config, single_frame=cv.dim() == 3)
  x, lead = scoordnet.to_nchw(cv)
  e0 = dec["enc0"].apply(params["enc0"], x)
  d1 = dec["down1"].apply(params["down1"], e0)
  d2 = dec["down2"].apply(params["down2"], d1)
  u1 = _crop_to(dec["up1"].apply(params["up1"], d2), *d1.shape[-2:])
  f1 = dec["fuse1"].apply(params["fuse1"], torch.cat([u1, d1], dim=1))
  u0 = _crop_to(dec["up0"].apply(params["up0"], f1), *e0.shape[-2:])
  f0 = dec["fuse0"].apply(params["fuse0"], torch.cat([u0, e0], dim=1))
  return scoordnet.from_nchw(dec["head"].apply(params["head"], f0),
                             lead).to(torch.float32)


def output_step(raw: torch.Tensor, radius: int):
  """The head's output step: raw (..., 3) -> (flow ``r·tanh(raw[..., :2])``
  (..., 2), process variance ``exp(clip(raw[..., 2:3], ±12))`` (..., 1))
  (``core.heads.flow_output``; the fused filter kernel computes the same)."""
  return heads.flow_output(raw, radius, LOG_VAR_CLIP)


def decode(params, config: OFlowNetConfig, cv: torch.Tensor):
  """U-Net over the (..., h, w, K) cost volume -> (flow (..., h, w, 2),
  process variance (..., h, w, 1)), float32."""
  return output_step(decode_raw(params, config, cv), config.search_radius)


def apply(params, config: OFlowNetConfig, image_prev: torch.Tensor,
          image_cur: torch.Tensor):
  """Image pair -> (backward flow, process-noise variance) at 1/8 res."""
  f_prev = encode(params, config, image_prev)
  f_cur = encode(params, config, image_cur)
  cv = cost_volume(f_prev, f_cur, config.search_radius)
  return decode(params, config, cv)
