"""SCoordNet, the measurement system (port of
``kfnet_tpu/models/scoordnet.py``).

One RGB frame (H, W, 3) maps to a 1/8-resolution scene-coordinate map
(H/8, W/8, 3) and a per-pixel measurement-noise variance (H/8, W/8, 1):
a space-to-depth stem, the conv trunk, a conv head block and a float32
1x1 head whose fourth channel is a log-variance clipped to ±12.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Sequence, Tuple

import torch

from kfnet_tpu_torch.nn import layers as L

LOG_VAR_MIN = -12.0
LOG_VAR_MAX = 12.0


@dataclasses.dataclass(frozen=True)
class SCoordNetConfig:
  """Field for field and default for default the JAX package's config."""
  channels: Sequence[int] = (64, 64, 128, 128, 256, 256,
                             512, 512, 512, 512, 512, 512, 512, 512, 512)
  strides: Sequence[int] = (1, 2, 1, 2, 1, 2, 1, 1, 1, 1, 1, 1, 1, 1, 1)
  head_channels: int = 512
  coord_offset: Tuple[float, float, float] = (0.0, 0.0, 0.0)
  coord_scale: float = 1.0
  compute_dtype: str = "bfloat16"
  norm: str = "group"  # "group" | "none" | "ws"
  stem_s2d: int = 2
  conv_impl: str = "xla"  # only "xla" (torch.nn.functional convs) is ported

  @property
  def dtype(self) -> torch.dtype:
    return L.as_dtype(self.compute_dtype)

  @property
  def total_stride(self) -> int:
    s = 1
    for st in self.strides:
      s *= st
    return s


def _adjusted_strides(strides, stem_s2d):
  """Drop trailing stride-2 layers so stem_s2d × conv strides still = 8."""
  strides = list(strides)
  if stem_s2d > 1:
    to_drop = {2: 1, 4: 2, 8: 3}[stem_s2d]
    for i in range(len(strides) - 1, -1, -1):
      if to_drop == 0:
        break
      if strides[i] == 2:
        strides[i] = 1
        to_drop -= 1
  return strides


def build(config: SCoordNetConfig) -> L.Layer:
  """Trunk + 4-channel head as one serial layer (the stem runs in apply)."""
  strides = _adjusted_strides(config.strides, config.stem_s2d)
  blocks = [
      L.conv_block(c, 3, s, norm=config.norm, compute_dtype=config.dtype,
                   impl=config.conv_impl)
      for c, s in zip(config.channels, strides)
  ]
  head = [
      L.conv_block(config.head_channels, 3, 1, norm=config.norm,
                   compute_dtype=config.dtype, impl=config.conv_impl),
      # f32 1x1 head: coordinates and log-variance need more than bf16
      L.conv(4, 1, 1, use_bias=True, compute_dtype=torch.float32),
  ]
  return L.serial(*blocks, *head)


def maybe_space_to_depth(config, image: torch.Tensor) -> torch.Tensor:
  """Apply the s2d stem unless the (..., H, W, C) input already has it
  (12 channels is unambiguous against raw RGB). Dtype-agnostic."""
  f = config.stem_s2d
  if f > 1 and image.shape[-1] == 3:
    return L.space_to_depth(f).apply({}, image)
  return image


def ingest(image: torch.Tensor) -> torch.Tensor:
  """uint8 frames (0..255) become float32 in [0, 1] on their device;
  float frames pass unchanged."""
  if image.dtype == torch.uint8:
    return image.to(torch.float32) * (1.0 / 255.0)
  return image


def init(gen: torch.Generator, config: SCoordNetConfig,
         image_shape: Tuple[int, int, int] = (480, 640, 3), device=None):
  """He-normal weights drawn from ``gen`` (on ``device``)."""
  net = build(config)
  f = config.stem_s2d
  if f > 1:
    h, w, c = image_shape
    image_shape = (h // f, w // f, c * f * f)
  params, out_shape = net.init(gen, image_shape, device)
  assert out_shape[-1] == 4
  return params


def to_nchw(x: torch.Tensor) -> tuple[torch.Tensor, tuple]:
  """(..., H, W, C) -> (B, C, H, W) view (channels-last in memory)."""
  lead = tuple(x.shape[:-3])
  xb = x.reshape((-1,) + tuple(x.shape[-3:]))
  return xb.permute(0, 3, 1, 2), lead


def from_nchw(y: torch.Tensor, lead: tuple) -> torch.Tensor:
  """(B, C, H, W) -> (..., H, W, C), contiguous."""
  y = y.permute(0, 2, 3, 1)
  return y.reshape(lead + tuple(y.shape[1:])).contiguous()


@functools.lru_cache(maxsize=16)
def _offset_tensor(offset: tuple, device: torch.device) -> torch.Tensor:
  # cached: a host->device copy of a fresh tensor would sync every frame
  return torch.tensor(offset, dtype=torch.float32, device=device)


def apply(params, config: SCoordNetConfig, image: torch.Tensor):
  """(..., H, W, 3) image in [0, 1] or uint8 (or its s2d form) ->
  (coords (..., H/8, W/8, 3), variance (..., H/8, W/8, 1)), float32."""
  image = ingest(maybe_space_to_depth(config, image))
  x, lead = to_nchw(image)
  out = from_nchw(build(config).apply(params, x), lead).to(torch.float32)
  raw = out[..., :3]
  log_var = torch.clamp(out[..., 3:4], LOG_VAR_MIN, LOG_VAR_MAX)
  offset = _offset_tensor(tuple(config.coord_offset), out.device)
  coords = raw * config.coord_scale + offset
  variance = torch.exp(log_var) * (config.coord_scale ** 2)
  return coords, variance
