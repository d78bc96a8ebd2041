"""Functional layer toolkit (port of ``kfnet_tpu/nn/layers.py``).

Every layer is an (init, apply) pair and parameters are plain nested
lists and dicts of tensors, laid out as the JAX package's pytree is, so
the weight bridge (``convert.py``) maps one to the other leaf for leaf.

Layouts: ``init`` takes and returns (H, W, C) shapes, as in the JAX
package. ``apply`` takes and returns (B, C, H, W) tensors (channels-last
in memory when the models call it, which cuDNN prefers). Conv weights are
stored as PyTorch's (out, in, kh, kw); transposed-conv weights as
(in, out, kh, kw), already flipped (see ``conv_transpose``).

What is carried over exactly from the JAX package:
  * XLA "SAME" padding, computed per input size: a stride-2 3x3 conv pads
    (0, 1) on an even input and (1, 1) on an odd one.
  * The conv output rounds to ``compute_dtype``; a bias is then added in
    float32 and the sum rounds again.
  * GroupNorm with one-pass float32 moments and ``gn_group_count`` groups,
    cast back to the input dtype.
  * space_to_depth's channel order (fy·f + fx)·C + c, which is not
    ``pixel_unshuffle``'s.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class Layer:
  init: Callable  # (gen, in_shape (H, W, C), device) -> (params, out_shape)
  apply: Callable  # (params, x (B, C, H, W)) -> y (B, C', H', W')


def as_dtype(dtype) -> torch.dtype:
  """'bfloat16' / 'float32' (the JAX configs' spelling) or a torch dtype."""
  if isinstance(dtype, torch.dtype):
    return dtype
  return {"bfloat16": torch.bfloat16, "float32": torch.float32}[str(dtype)]


def _fan_in_init(gen, shape, fan_in, device):
  """He/Kaiming normal, as the JAX package initialises its convs."""
  std = math.sqrt(2.0 / fan_in)
  return torch.randn(shape, generator=gen, device=device,
                     dtype=torch.float32) * std


def same_pads(size: int, kernel: int, stride: int):
  """XLA's SAME padding (lo, hi) along one axis of length ``size``."""
  out = -(-size // stride)
  total = max((out - 1) * stride + kernel - size, 0)
  return total // 2, total - total // 2


def standardize_weights(w, gain, eps: float = 1e-8):
  """Scaled weight standardization per output channel of an (O, I, kh, kw)
  filter: re-centred and re-scaled to std sqrt(2/fan_in), times ``gain``."""
  n = w.shape[1] * w.shape[2] * w.shape[3]
  mu = w.mean(dim=(1, 2, 3), keepdim=True)
  var = torch.square(w - mu).mean(dim=(1, 2, 3), keepdim=True)
  return (w - mu) * torch.rsqrt(var * (n / 2.0) + eps) * gain[:, None, None,
                                                              None]


def _check_impl(impl):
  if impl != "xla":
    raise NotImplementedError(
        f"conv_impl={impl!r} is not ported yet; the port runs the convs of "
        "conv_impl='xla' through torch.nn.functional")


def _bias_round(y, params, compute_dtype):
  """The JAX package's epilogue: f32 bias add, then round to compute_dtype."""
  return (y.to(torch.float32) + params["b"][:, None, None]).to(compute_dtype)


def conv(out_ch: int, kernel: int = 3, stride: int = 1, use_bias: bool = True,
         compute_dtype="bfloat16", impl: str = "xla",
         weight_standardize: bool = False) -> Layer:
  """2D SAME convolution with the JAX package's padding and rounding."""
  _check_impl(impl)
  cd = as_dtype(compute_dtype)

  def init(gen, in_shape, device):
    h, w, c = in_shape
    params = {"w": _fan_in_init(gen, (out_ch, c, kernel, kernel),
                                kernel * kernel * c, device)}
    if weight_standardize:
      params["gain"] = torch.ones((out_ch,), device=device)
    if use_bias:
      params["b"] = torch.zeros((out_ch,), device=device)
    return params, (-(-h // stride), -(-w // stride), out_ch)

  def apply(params, x):
    wgt = params["w"]
    if weight_standardize:
      wgt = standardize_weights(wgt, params["gain"])
    x = x.to(cd)
    (t, b) = same_pads(x.shape[-2], kernel, stride)
    (l, r) = same_pads(x.shape[-1], kernel, stride)
    if t == b and l == r:
      pad = (t, l)
    else:  # asymmetric (a stride-2 conv on an even input): pad explicitly
      x = F.pad(x, (l, r, t, b))
      pad = (0, 0)
    y = F.conv2d(x, wgt.to(cd), stride=stride, padding=pad)
    if use_bias:
      y = _bias_round(y, params, cd)
    return y

  return Layer(init, apply)


def conv_transpose_pads(kernel: int, stride: int):
  """(padding, output_padding) of ``F.conv_transpose2d`` that reproduce
  ``lax.conv_transpose(padding="SAME")``: XLA pads the dilated input by
  (a, b), which is torch's ``padding = kernel-1-a`` with the extra
  ``b - a`` rows on the high side as ``output_padding``."""
  pad_len = kernel + stride - 2
  a = kernel - 1 if stride > kernel - 1 else int(math.ceil(pad_len / 2))
  b = pad_len - a
  p, op = kernel - 1 - a, b - a
  if p < 0 or not 0 <= op < stride:
    raise NotImplementedError(
        f"conv_transpose kernel={kernel} stride={stride} has no "
        "conv_transpose2d equivalent")
  return p, op


def conv_transpose(out_ch: int, kernel: int = 4, stride: int = 2,
                   use_bias: bool = True, compute_dtype="bfloat16") -> Layer:
  """Transposed conv equal to ``lax.conv_transpose(..., padding="SAME")``
  with ``transpose_kernel=False``.

  XLA correlates the stride-dilated input with the kernel as stored;
  ``conv_transpose2d`` correlates it with the kernel flipped in both
  spatial axes. So the port stores the kernel flipped, as (in, out, kh,
  kw): ``convert`` maps HWIO ``w`` to ``w[::-1, ::-1].permute(2, 3, 0, 1)``."""
  cd = as_dtype(compute_dtype)
  pad, out_pad = conv_transpose_pads(kernel, stride)

  def init(gen, in_shape, device):
    h, w, c = in_shape
    params = {"w": _fan_in_init(gen, (c, out_ch, kernel, kernel),
                                kernel * kernel * c, device)}
    if use_bias:
      params["b"] = torch.zeros((out_ch,), device=device)
    return params, (h * stride, w * stride, out_ch)

  def apply(params, x):
    y = F.conv_transpose2d(x.to(cd), params["w"].to(cd), stride=stride,
                           padding=pad, output_padding=out_pad)
    if use_bias:
      y = _bias_round(y, params, cd)
    return y

  return Layer(init, apply)


GN_GROUPS = 32
GN_EPS = 1e-5


def gn_group_count(c: int, groups: int = GN_GROUPS) -> int:
  """Largest divisor of ``c`` not exceeding ``groups``."""
  g = min(groups, c)
  while c % g:
    g -= 1
  return g


def group_norm(groups: int = GN_GROUPS, eps: float = GN_EPS) -> Layer:
  """GroupNorm with the JAX package's arithmetic: per-channel f32 sums over
  the spatial axes, a (g, cg) group combine, one-pass E[x²]−E[x]², then one
  per-channel scale/shift, cast back to the input dtype."""

  def init(gen, in_shape, device):
    c = in_shape[-1]
    return {"scale": torch.ones((c,), device=device),
            "bias": torch.zeros((c,), device=device)}, in_shape

  def apply(params, x):
    b, c = x.shape[0], x.shape[1]
    g = gn_group_count(c, groups)
    cg = c // g
    in_dtype = x.dtype
    x32 = x.to(torch.float32)
    n = x.shape[-2] * x.shape[-1] * cg
    s1 = torch.sum(x32, dim=(-2, -1))                    # (B, C)
    s2 = torch.sum(torch.square(x32), dim=(-2, -1))      # (B, C)
    mean_g = s1.reshape(b, g, cg).sum(-1) / n            # (B, g)
    var_g = torch.clamp_min(s2.reshape(b, g, cg).sum(-1) / n
                            - torch.square(mean_g), 0.0)
    inv_g = torch.rsqrt(var_g + eps)
    mean_c = torch.repeat_interleave(mean_g, cg, dim=-1)  # (B, C)
    inv_c = torch.repeat_interleave(inv_g, cg, dim=-1)
    scale = params["scale"] * inv_c
    shift = params["bias"] - mean_c * scale
    out = x32 * scale[:, :, None, None] + shift[:, :, None, None]
    return out.to(in_dtype)

  return Layer(init, apply)


def relu() -> Layer:
  return Layer(init=lambda gen, in_shape, device: ({}, in_shape),
               apply=lambda params, x: torch.relu(x))


def space_to_depth(factor: int = 2) -> Layer:
  """(..., H, W, C) -> (..., H/f, W/f, C·f²) on NHWC tensors, channel
  (fy·f + fx)·C + c — the JAX package's order, not ``pixel_unshuffle``'s
  c·f² + fy·f + fx."""

  def init(gen, in_shape, device):
    h, w, c = in_shape
    assert h % factor == 0 and w % factor == 0
    return {}, (h // factor, w // factor, c * factor * factor)

  def apply(params, x):
    lead = tuple(x.shape[:-3])
    h, w, c = x.shape[-3:]
    f = factor
    y = x.reshape(lead + (h // f, f, w // f, f, c))
    nd = len(lead)
    perm = tuple(range(nd)) + (nd, nd + 2, nd + 1, nd + 3, nd + 4)
    return y.permute(perm).reshape(lead + (h // f, w // f, c * f * f))

  return Layer(init, apply)


def serial(*layers: Layer) -> Layer:
  """Sequential composition; params are a list of per-layer params."""

  def init(gen, in_shape, device):
    params = []
    shape = in_shape
    for l in layers:
      p, shape = l.init(gen, shape, device)
      params.append(p)
    return params, shape

  def apply(params, x):
    for p, l in zip(params, layers):
      x = l.apply(p, x)
    return x

  return Layer(init, apply)


def conv_block(out_ch: int, kernel: int = 3, stride: int = 1,
               norm: bool | str = True, act: bool = True,
               compute_dtype="bfloat16", impl: str = "xla") -> Layer:
  """conv [+ GroupNorm] [+ ReLU]; norm "group"/True, "none"/False or "ws"
  (weight-standardized conv + bias, no activation norm)."""
  use_norm = norm is True or norm == "group"
  ls = [conv(out_ch, kernel, stride, use_bias=not use_norm,
             compute_dtype=compute_dtype, impl=impl,
             weight_standardize=norm == "ws")]
  if use_norm:
    ls.append(group_norm())
  if act:
    ls.append(relu())
  return serial(*ls)


def tree_leaves(tree):
  if isinstance(tree, dict):
    return [x for k in sorted(tree) for x in tree_leaves(tree[k])]
  if isinstance(tree, (list, tuple)):
    return [x for v in tree for x in tree_leaves(v)]
  return [tree]


def tree_map(fn, tree):
  if isinstance(tree, dict):
    return {k: tree_map(fn, v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return [tree_map(fn, v) for v in tree]
  return fn(tree)


def param_count(params) -> int:
  return sum(int(p.numel()) for p in tree_leaves(params))
