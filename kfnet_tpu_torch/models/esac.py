"""ESAC, Expert Sample Consensus (Brachmann & Rother, ICCV 2019,
arXiv:1908.02484): a gating net and M expert scene-coordinate nets.

The gating net classifies a grayscale frame into M scene parts and gives a
distribution g over the experts (``gate``). Each of a frame's RANSAC
hypotheses draws its expert from g (``draw_experts``), its minimal set from
that expert's coordinate map, and is scored against that map
(``pose.ransac.solve_pnp_from_maps(..., map_of=)``). So only the experts
some hypothesis drew are run: a tick runs a chosen set of (slot, expert)
pairs, each with its own weights, as one grouped pass over weights
gathered on the device from the stacked experts (``experts_at``): a 1x1
conv (and the first, of one input channel) one batched matrix product over
the pairs, any other 3x3 conv a cuDNN conv a pair.

An expert is DSAC*'s scene-coordinate FCN (Brachmann & Rother, TPAMI 2021,
arXiv:2002.12324), output stride 8; "k/s, in→out", every conv but the last
followed by ReLU:

  stem  3/1 1→32, 3/2 32→64, 3/2 64→128, 3/2 128→256
  res1  3 256→256, 1 256→256, 3 256→256, added to its input
  res2  3 256→512, 1 512→512, 3 512→512, added to a 1x1 256→512 skip
  res3  three 1 512→512, added to its input
  head  1 512→512, 1 512→512, 1 512→3, plus the expert's scene centre

A 3x3 conv pads 1 on each side, as the published convs (``padding=1``);
the port's "SAME" would pad a stride-2 conv (0, 1). The gating net is the
expert's stem and res1 at ``gating_channels`` widths, a global average
pool and one linear layer to M logits (its weights carry the softmax's
temperature), then a softmax, all in float32 (a classifier of scene parts
tells them apart by small differences of its pooled features, which
bfloat16 rounding would swamp; the net is 2% of an expert's work), its
convolutions as matrix products (``_mm_conv``). The experts' convolutions
run in ``compute_dtype``.

Input: a frame's luma (0.299 R + 0.587 G + 0.114 B) / 255 in float32,
normalised with mean 0.4 and std 0.25, as DSAC*.

Parameters: {"gating": {layer: {"w", "b"}, "fc": {"w" (M, C), "b" (M,)}},
"experts": {layer: {"w" (M, out, in, k, k), "b" (M, out)}, "centre" (M,
3)}}, float32 masters; the experts stacked along a leading M.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import torch
import torch.nn.functional as F

import kfnet_tpu_torch
from kfnet_tpu_torch.nn import layers as L

LUMA = (0.299, 0.587, 0.114)
IMAGE_MEAN, IMAGE_STD = 0.4, 0.25  # DSAC*'s normalisation of the luma


@dataclasses.dataclass(frozen=True)
class EsacConfig:
  num_experts: int = 19
  stem_channels: Sequence[int] = (32, 64, 128, 256)
  res_channels: int = 512          # res2, res3 and the skip
  head_channels: int = 512
  gating_channels: Sequence[int] = (8, 16, 32, 64)
  compute_dtype: str = "bfloat16"  # the experts' convolutions

  @property
  def dtype(self) -> torch.dtype:
    return L.as_dtype(self.compute_dtype)


OUTPUT_STRIDE = 8


def _stem_and_res1(prefix_channels):
  c1, c2, c3, c4 = prefix_channels
  return [("conv1", 1, c1, 3, 1), ("conv2", c1, c2, 3, 2),
          ("conv3", c2, c3, 3, 2), ("conv4", c3, c4, 3, 2),
          ("res1_conv1", c4, c4, 3, 1), ("res1_conv2", c4, c4, 1, 1),
          ("res1_conv3", c4, c4, 3, 1)]


def expert_layers(cfg: EsacConfig):
  """(name, in, out, kernel, stride) of an expert's convs, in call order
  (the skip after res2's three)."""
  c4, r, h = cfg.stem_channels[-1], cfg.res_channels, cfg.head_channels
  return _stem_and_res1(cfg.stem_channels) + [
      ("res2_conv1", c4, r, 3, 1), ("res2_conv2", r, r, 1, 1),
      ("res2_conv3", r, r, 3, 1), ("res2_skip", c4, r, 1, 1),
      ("res3_conv1", r, r, 1, 1), ("res3_conv2", r, r, 1, 1),
      ("res3_conv3", r, r, 1, 1),
      ("fc1", r, h, 1, 1), ("fc2", h, h, 1, 1), ("fc3", h, 3, 1, 1)]


def gating_layers(cfg: EsacConfig):
  return _stem_and_res1(cfg.gating_channels)


def map_shape(frame_shape):
  """(h, w) of an expert's map of an (H, W, ...) frame."""
  h, w = frame_shape[:2]
  for _ in range(3):
    h, w = (h - 1) // 2 + 1, (w - 1) // 2 + 1
  return h, w


def init(seed: int, config: EsacConfig, device=None):
  """Seeded float32 weights: convs He-normal, biases 0, the gating's
  linear layer N(0, 1 / C), each expert's centre N(0, 1) per axis."""
  device = kfnet_tpu_torch.resolve_device(device)
  gen = torch.Generator(device=device).manual_seed(seed)
  M = config.num_experts

  def convs(table, lead):
    out = {}
    for name, cin, cout, k, _ in table:
      std = math.sqrt(2.0 / (k * k * cin))
      out[name] = {
          "w": torch.randn(lead + (cout, cin, k, k), generator=gen,
                           device=device) * std,
          "b": torch.zeros(lead + (cout,), device=device)}
    return out

  gating = convs(gating_layers(config), ())
  c = config.gating_channels[-1]
  gating["fc"] = {"w": torch.randn((M, c), generator=gen, device=device)
                       / math.sqrt(c),
                  "b": torch.zeros((M,), device=device)}
  experts = convs(expert_layers(config), (M,))
  experts["centre"] = torch.randn((M, 3), generator=gen, device=device)
  return {"gating": gating, "experts": experts}


def preprocess(config: EsacConfig, frames: torch.Tensor) -> torch.Tensor:
  """(B, H, W, 3) uint8 (or float in [0, 1]) RGB -> (B, 1, H, W) float32
  normalised luma."""
  x = frames.to(torch.float32)
  if frames.dtype == torch.uint8:
    x = x / 255.0
  luma = (x[..., 0] * LUMA[0] + x[..., 1] * LUMA[1] + x[..., 2] * LUMA[2])
  return ((luma - IMAGE_MEAN) / IMAGE_STD)[:, None]


def _pad(k: int):
  return (k - 1) // 2


def _trunk(conv, x, head: bool):
  """The net's body over ``conv(name, x, relu)``: the stem and res1, and
  with ``head`` res2, res3 and the head (an expert); else the res1 map (the
  gating's)."""
  x = conv("conv1", x, True)
  x = conv("conv2", x, True)
  x = conv("conv3", x, True)
  res = conv("conv4", x, True)
  x = conv("res1_conv1", res, True)
  x = conv("res1_conv2", x, True)
  x = conv("res1_conv3", x, True)
  res = res + x
  if not head:
    return res
  x = conv("res2_conv1", res, True)
  x = conv("res2_conv2", x, True)
  x = conv("res2_conv3", x, True)
  res = conv("res2_skip", res, False) + x
  x = conv("res3_conv1", res, True)
  x = conv("res3_conv2", x, True)
  x = conv("res3_conv3", x, True)
  res = res + x
  x = conv("fc1", res, True)
  x = conv("fc2", x, True)
  return conv("fc3", x, False)


def _mm_conv(table, params):
  """``conv(name, x, relu)`` of one weight set over (N, in, H, W) maps as
  matrix products, a 3x3 conv over its unfolded patches (cuDNN's float32
  convolutions of a few channels are FFTs, ten times slower)."""
  shapes = {name: (cout, k, s) for name, _, cout, k, s in table}

  def conv(name, x, relu):
    cout, k, s = shapes[name]
    N, C, H, W = x.shape
    cols = (x.reshape(N, C, H * W) if k == 1 else
            F.unfold(x, k, padding=_pad(k), stride=s))
    y = torch.matmul(params[name]["w"].reshape(cout, -1), cols)
    y = (y + params[name]["b"][:, None]).reshape(
        N, cout, (H - 1) // s + 1, (W - 1) // s + 1)
    return torch.relu_(y) if relu else y

  return conv


def gate(params, config: EsacConfig, image: torch.Tensor) -> torch.Tensor:
  """(B, 1, H, W) normalised luma -> (B, M) float32 gating probabilities."""
  g = params["gating"] if "gating" in params else params
  conv = _mm_conv(gating_layers(config), g)
  feat = _trunk(conv, image, head=False).mean((-2, -1))
  logits = feat @ g["fc"]["w"].T + g["fc"]["b"]
  return torch.softmax(logits, dim=-1)


# ---- the grouped pass -----------------------------------------------------


def served_experts(params, config: EsacConfig):
  """The stacked experts in the grouped pass's layout, in the compute
  dtype: a 3x3 conv's (M, out, in, 3, 3) filters channels-last and (M,
  out) biases; a 1x1 conv's, and the one-channel first conv's, (M, in·k·k,
  out) matrices and (M, 1, out) biases, the right operands of one batched
  product over the pairs; the centres (M, 3) in float32."""
  e = params["experts"] if "experts" in params else params
  cd = config.dtype
  out = {}
  for name, cin, _, k, _ in expert_layers(config):
    w, b = e[name]["w"].to(cd), e[name]["b"].to(cd)
    if k == 1 or cin == 1:  # (M, in·k·k, out)
      out[name] = (w.flatten(2).transpose(1, 2).contiguous(),
                   b[:, None].contiguous())
    else:  # each expert's filter channels-last, as cuDNN takes it
      out[name] = (w.permute(0, 1, 3, 4, 2).contiguous().permute(
          0, 1, 4, 2, 3), b.contiguous())
  out["centre"] = e["centre"].to(torch.float32)
  return out


def _pair_conv(served, table, expert):
  """``conv(name, x, relu)`` over P pairs, x (P, in, H, W) channels-last:
  pair p's conv with the weights of ``expert[p]``, gathered from the
  stacked experts. A 1x1 conv, and the one-channel first conv over its 9
  unfolded taps, is one batched product over the pairs (the bias in the
  product); any other 3x3 conv a cuDNN conv a pair, on the gathered
  filters (a P-group conv, or the patches unfolded for a batched product,
  is slower on an H100; cuDNN's conv of one input channel is 15 times
  slower than the product)."""
  shapes = {name: (cout, k, s) for name, _, cout, k, s in table}

  def conv(name, x, relu):
    cout, k, s = shapes[name]
    w, b = served[name]
    P, C, H, W = x.shape
    if k == 1 or C == 1:
      cols = (x.permute(0, 2, 3, 1).reshape(P, H * W, C) if k == 1 else
              F.unfold(x, k, padding=_pad(k), stride=s).transpose(1, 2))
      y = torch.baddbmm(b[expert], cols, w[expert])  # (P, Ho·Wo, out)
      y = y.reshape(P, (H - 1) // s + 1, (W - 1) // s + 1,
                    cout).permute(0, 3, 1, 2)
    else:
      wg, bg = w[expert], b[expert]
      y = torch.cat([F.conv2d(x[p:p + 1], wg[p], bg[p], stride=s,
                              padding=_pad(k)) for p in range(P)])
    return torch.relu_(y) if relu else y

  return conv


def experts_at(served, config: EsacConfig, image: torch.Tensor,
               slot: torch.Tensor, expert: torch.Tensor) -> torch.Tensor:
  """The maps of P (slot, expert) pairs, each expert on its slot's frame:
  ``image`` (B, 1, H, W) luma, ``slot`` and ``expert`` (P,) long on the
  device -> (P, h, w, 3) float32 scene coordinates, over weights gathered
  on the device for the pairs: the pairs need not share an expert or a
  slot."""
  x = image[slot].to(config.dtype).contiguous(
      memory_format=torch.channels_last)
  conv = _pair_conv(served, expert_layers(config), expert)
  y = _trunk(conv, x, head=True).permute(0, 2, 3, 1)  # (P, h, w, 3)
  return y.to(torch.float32) + served["centre"][expert][:, None, None]


# ---- routing --------------------------------------------------------------


def draw_experts(probs: torch.Tensor, uniforms: torch.Tensor) -> torch.Tensor:
  """Each hypothesis's expert: (B, M) probabilities and (B, H) uniforms in
  [0, 1) -> (B, H) long, the first expert whose cumulative probability
  exceeds the uniform (inverse CDF; the last expert past rounding)."""
  cdf = torch.cumsum(probs, dim=-1)
  e = torch.searchsorted(cdf, uniforms.contiguous(), right=True)
  return torch.clamp_max(e, probs.shape[-1] - 1)


def expert_counts(experts: torch.Tensor, num_experts: int) -> torch.Tensor:
  """(B, H) drawn experts -> (B, M) int32 hypotheses per expert."""
  B = experts.shape[0]
  flat = experts + num_experts * torch.arange(
      B, device=experts.device)[:, None]
  counts = torch.zeros(B * num_experts, dtype=torch.int32,
                       device=experts.device)
  # scatter_add, not bincount: bincount reads its input's max back
  return counts.scatter_add_(0, flat.flatten(), torch.ones_like(
      flat.flatten(), dtype=torch.int32)).reshape(B, num_experts)
