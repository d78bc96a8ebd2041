"""SCoordNet, the measurement system (port of
``kfnet_tpu/models/scoordnet.py``).

One RGB frame (H, W, 3) maps to a 1/8-resolution scene-coordinate map
(H/8, W/8, 3) and a per-pixel measurement-noise variance (H/8, W/8, 1):
a space-to-depth stem, the conv trunk, a conv head block and a float32
1x1 head whose fourth channel is a log-variance clipped to ±12.

``conv_impl`` "xla" runs every conv through ``torch.nn.functional``;
"pallas_3x3" sends a single frame's eligible convs to the ``conv3x3_same``
kernel; "pallas_fused" (GroupNorm only) runs a single frame's 1/8-res trunk
as a chain of ``conv3x3_gn_chain`` kernels (``_apply_fused_trunk``);
"winograd" sends every 3x3 stride-1 conv of an even map to
``kernels/winograd.py``. A batch of frames takes the serial "xla" path
under the kernel impls, as in the JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence, Tuple

import torch

from kfnet_tpu_torch.core import heads
from kfnet_tpu_torch.nn import layers as L

LOG_VAR_MIN = -12.0
LOG_VAR_MAX = 12.0
LOG_VAR_CLIP = (LOG_VAR_MIN, LOG_VAR_MAX)


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
  conv_impl: str = "xla"  # "xla" | "pallas_3x3" | "pallas_fused" | "winograd"

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


def _layer_list(config: SCoordNetConfig, single_frame: bool = False) -> list:
  """Trunk blocks, the head conv block and the f32 1x1 head. Under
  "pallas_fused" every layer is "xla": the fused trunk calls the chain
  kernel itself."""
  if config.conv_impl == "pallas_fused" and config.norm != "group":
    # the chain's prologues and epilogues are GroupNorm passes
    raise ValueError(
        f"conv_impl='pallas_fused' requires norm='group' (got "
        f"norm={config.norm!r}); use conv_impl='xla' or 'pallas_3x3'")
  strides = _adjusted_strides(config.strides, config.stem_s2d)
  impl = ("xla" if config.conv_impl == "pallas_fused"
          else L.frame_impl(config.conv_impl, single_frame))
  blocks = [
      L.conv_block(c, 3, s, norm=config.norm, compute_dtype=config.dtype,
                   impl=impl)
      for c, s in zip(config.channels, strides)
  ]
  head = [
      L.conv_block(config.head_channels, 3, 1, norm=config.norm,
                   compute_dtype=config.dtype, impl=impl),
      # f32 1x1 head: coordinates and log-variance need more than bf16
      L.conv(4, 1, 1, use_bias=True, compute_dtype=torch.float32),
  ]
  return blocks + head


def build(config: SCoordNetConfig, single_frame: bool = False) -> L.Layer:
  """Trunk + 4-channel head as one serial layer (the stem runs in apply).
  ``single_frame``: the layers will see one frame, so "pallas_3x3" convs
  may take the kernel."""
  return L.serial(*_layer_list(config, single_frame))


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


def _fused_suffix_start(config: SCoordNetConfig) -> int:
  """First trunk index from which every remaining conv is fused-trunk
  eligible (stride 1, cin/cout multiples of 128); len(channels)+1 (nothing
  fused) if none is, or if the head conv block, which the fused loop
  always includes, is not."""
  strides = _adjusted_strides(config.strides, config.stem_s2d)
  f = config.stem_s2d
  cins = [3 * f * f if f > 1 else 3] + list(config.channels)
  n = len(config.channels)
  if config.head_channels % 128 or cins[-1] % 128:
    return n + 1
  start = n + 1
  for i in range(n - 1, -1, -1):
    if strides[i] == 1 and cins[i] % 128 == 0 and cins[i + 1] % 128 == 0:
      start = i
    else:
      break
  return start


def _apply_fused_trunk(params, config: SCoordNetConfig,
                       image: torch.Tensor) -> torch.Tensor:
  """One (H', W', C) frame after the stem: the serial prefix, then the
  fused suffix (``_fused_suffix``). Returns (1, 4, h, w) float32."""
  k = _fused_suffix_start(config)
  layers_list = _layer_list(config, single_frame=True)
  x, _ = to_nchw(image)
  for i in range(k):  # serial prefix (strided or narrow layers)
    x = layers_list[i].apply(params[i], x)
  return _fused_suffix(params, config, L.frame_hwc(x))


def _fused_suffix(params, config: SCoordNetConfig,
                  x: torch.Tensor) -> torch.Tensor:
  """The serial prefix's (h, w, c) output -> (1, 4, h, w) float32: the
  1/8-res GroupNorm trunk as a chain of ``conv3x3_gn_chain`` kernels whose
  prologues apply the previous layer's GroupNorm + ReLU and whose epilogues
  give the sums for the next, then a float32 normalize + ReLU and the f32
  1x1 head."""
  from kfnet_tpu_torch.kernels.conv3x3 import conv3x3_gn_chain, gn_scale_shift

  k = _fused_suffix_start(config)
  layers_list = _layer_list(config, single_frame=True)
  n_blocks = len(config.channels)
  h, w, c = x.shape
  scale = torch.ones((c,), dtype=torch.float32, device=x.device)
  shift = torch.zeros((c,), dtype=torch.float32, device=x.device)
  prologue_relu = False  # the prefix output is already normalized + relu'd
  for i in range(k, n_blocks + 1):  # trunk blocks k..n-1, then the head block
    # the chain takes bf16 in any config, as the JAX wrapper casts
    x, s1, s2 = conv3x3_gn_chain(x.to(torch.bfloat16), scale, shift,
                                 params[i][0]["w"],
                                 prologue_relu=prologue_relu)
    gn = params[i][1]
    scale, shift = gn_scale_shift(s1, s2, h * w, gn["scale"], gn["bias"])
    prologue_relu = True
  x = torch.relu(x.to(torch.float32) * scale + shift)
  return layers_list[n_blocks + 1].apply(params[n_blocks + 1],
                                         x.permute(2, 0, 1)[None])


def to_nchw(x: torch.Tensor) -> tuple[torch.Tensor, tuple]:
  """(..., H, W, C) -> (B, C, H, W) view (channels-last in memory)."""
  lead = tuple(x.shape[:-3])
  xb = x.reshape((-1,) + tuple(x.shape[-3:]))
  return xb.permute(0, 3, 1, 2), lead


def from_nchw(y: torch.Tensor, lead: tuple) -> torch.Tensor:
  """(B, C, H, W) -> (..., H, W, C), contiguous."""
  y = y.permute(0, 2, 3, 1)
  return y.reshape(lead + tuple(y.shape[1:])).contiguous()


def apply_raw(params, config: SCoordNetConfig, image: torch.Tensor):
  """(..., H, W, 3) image in [0, 1] or uint8 (or its s2d form) -> the
  head's raw float32 (..., H/8, W/8, 4): raw coordinates (3), raw
  log-variance (1), contiguous."""
  image = ingest(maybe_space_to_depth(config, image))
  single = image.dim() == 3
  if config.conv_impl == "pallas_fused" and single:
    out = from_nchw(_apply_fused_trunk(params, config, image), ())
  else:
    x, lead = to_nchw(image)
    out = from_nchw(build(config, single).apply(params, x), lead)
  return out.to(torch.float32)


def output_step(raw: torch.Tensor, coord_scale: float, coord_offset):
  """The head's output step: raw (..., 4) -> (coords ``raw[..., :3] ·
  coord_scale + coord_offset`` (..., 3), variance ``exp(clip(raw[..., 3:4],
  ±12)) · coord_scale²`` (..., 1)) (``core.heads.coord_output``; the fused
  filter kernel computes the same)."""
  return heads.coord_output(raw, coord_scale, coord_offset, LOG_VAR_CLIP)


def apply(params, config: SCoordNetConfig, image: torch.Tensor):
  """(..., H, W, 3) image in [0, 1] or uint8 (or its s2d form) ->
  (coords (..., H/8, W/8, 3), variance (..., H/8, W/8, 1)), float32."""
  return output_step(apply_raw(params, config, image), config.coord_scale,
                     config.coord_offset)
