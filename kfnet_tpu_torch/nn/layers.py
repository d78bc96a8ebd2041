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
  * ``impl="pallas_3x3"``: a single frame's eligible convs (the JAX
    package's ``_pallas_conv_eligible``, its TPU byte bound included) run
    the ``conv3x3_same`` kernel, which adds the bias before its one
    rounding; every other conv takes the path above. The JAX package
    decides "single frame" by ``x.ndim == 3``; here the models build the
    layers for one frame (``frame_impl``) and the layer takes (1, C, H, W).
  * ``impl="winograd"``: the JAX package's rule (3x3, stride 1, dilation
    1, SAME, even H and W) sends a conv to ``kernels/winograd.py``
    (F(2x2, 3x3), one rounding after the float32 bias); every other conv
    takes the direct path.
  * SAME and VALID padding, dilation, and the activations and pools of
    the JAX module (``activation``, ``relu``, ``elu``, ``max_pool``,
    ``avg_pool`` with SAME padding counted in the divisor,
    ``upsample_nearest``).

A layer also applies to a map split along W over a mesh (a
``parallel.mesh.Sharded`` (1, C, H, W) whose shards split the last axis
as ``even_bounds`` does), for ``parallel.spatial``: a conv computes each
shard's output columns from the input columns they read, taken from as
many neighbours as they span; GroupNorm sums each shard's moments across
the shards, in shard order, before the group combine. Each shard computes
with its entry's params (``mesh.entry_params``: ``Replicated`` leaves,
placed once per device).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Callable

import torch
import torch.nn.functional as F

from kfnet_tpu_torch.parallel.mesh import Sharded, entry_params, even_bounds


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


# "pallas_fused" is SCoordNet's fused trunk; the layers themselves run it
# as "xla", as in the JAX package
CONV_IMPLS = ("xla", "pallas_3x3", "pallas_fused", "winograd")


def _check_impl(impl):
  if impl not in CONV_IMPLS:
    raise ValueError(f"conv_impl={impl!r}: expected one of {CONV_IMPLS}")


def frame_impl(impl: str, single_frame: bool) -> str:
  """The impl a model builds its layers with: ``pallas_3x3`` applies to one
  frame only (the JAX package's ``x.ndim == 3``); a batch runs ``xla``."""
  return "xla" if impl == "pallas_3x3" and not single_frame else impl


def _pallas_conv_eligible(h, w, cin, cout, kernel, stride, dilation,
                          padding):
  """The JAX package's rule, byte bound included (``nn/layers.py``): SAME
  stride-1 3x3 convs with cin and cout multiples of 128 whose TPU working
  set fits its VMEM. Kept as it is so that the port rounds where the JAX
  package rounds, layer for layer."""
  if not (kernel == 3 and stride == 1 and dilation == 1
          and padding == "SAME"):
    return False
  if cin % 128 or cout % 128:
    return False
  pad_bytes = (h + 2) * (w + 2) * cin * 2
  acc_bytes = h * w * 128 * 4
  x_bytes = h * w * cin * 2
  return pad_bytes + acc_bytes + x_bytes < 11 * 1024 * 1024


# Single-frame (1, C, H, W) inputs that were not channels-last in memory and
# were copied before a conv kernel: counted, so that a run shows them.
layout_copies = 0


def frame_hwc(x: torch.Tensor) -> torch.Tensor:
  """(1, C, H, W) -> the (H, W, C) contiguous map the conv kernels take:
  a view of channels-last memory, else a counted copy."""
  global layout_copies
  if x.dim() != 4 or x.shape[0] != 1:
    raise ValueError(f"the conv kernels take one frame (1, C, H, W), got "
                     f"{tuple(x.shape)}")
  y = x[0].permute(1, 2, 0)
  if not y.is_contiguous():
    layout_copies += 1
    y = y.contiguous()
  return y


# While ``trace_convs`` runs, every ``conv`` init appends the (h, w, cin,
# cout, kernel, stride) of the conv it sizes.
_conv_trace = None


@contextlib.contextmanager
def trace_convs():
  """Collect the geometry of each ``conv`` that an ``init`` inside the
  block sizes, in init order (a net's order of calls)."""
  global _conv_trace
  outer, _conv_trace = _conv_trace, []
  try:
    yield _conv_trace
  finally:
    _conv_trace = outer


def _bias_round(y, params, compute_dtype):
  """The JAX package's epilogue: f32 bias add, then round to compute_dtype."""
  return (y.to(torch.float32) + params["b"][:, None, None]).to(compute_dtype)


def _empty_columns(x: torch.Tensor, channels: int, rows: int, dtype):
  return torch.empty((x.shape[0], channels, rows, 0), dtype=dtype,
                     device=x.device)


def _conv_sharded(x: Sharded, params, weights, out_ch, kernel, stride, cd,
                  use_bias, eligible):
  """A SAME conv of a W-sharded (1, C, H, W) map. Output shard i holds the
  columns ``even_bounds`` gives it and reads the input columns those
  need (zeros past the map's edges: SAME's padding there); H is padded as
  SAME pads it. ``eligible``: the conv3x3_same kernel takes the conv (as
  on the whole frame), on the block with one column more on each side,
  cropped after its own SAME pad. Each shard takes its entry's params
  (``entry_params``); ``weights`` gives the conv's kernel of them."""
  h, w = x.shape[-2:]
  t, b = same_pads(h, kernel, stride)
  left, _ = same_pads(w, kernel, stride)
  ob = even_bounds(-(-w // stride), len(x.shards))
  out = []
  for i, shard in enumerate(x.shards):
    o0, o1 = ob[i], ob[i + 1]
    if o0 == o1:
      out.append(_empty_columns(shard, out_ch, -(-h // stride), cd))
      continue
    p_i = entry_params(params, i, shard.device)
    w_i = weights(p_i)
    if eligible:
      from kfnet_tpu_torch.kernels import conv3x3
      blk = x.take(i, o0 - 1, o1 + 1).to(torch.bfloat16)
      y = conv3x3.conv3x3_same(blk[0].permute(1, 2, 0).contiguous(), w_i,
                               p_i.get("b"), relu=False, out_dtype=cd)
      out.append(y.permute(2, 0, 1)[None, :, :, 1:-1])
      continue
    blk = x.take(i, stride * o0 - left, stride * (o1 - 1) - left + kernel)
    y = F.conv2d(F.pad(blk.to(cd), (0, 0, t, b)), w_i.to(cd), stride=stride)
    out.append(_bias_round(y, p_i, cd) if use_bias else y)
  return Sharded(out, -1, x.devices)


def conv(out_ch: int, kernel: int = 3, stride: int = 1, dilation: int = 1,
         padding: str = "SAME", use_bias: bool = True,
         compute_dtype="bfloat16", impl: str = "xla",
         weight_standardize: bool = False) -> Layer:
  """2D convolution with the JAX package's padding and rounding.

  padding: "SAME" (XLA's, per input size) or "VALID"; ``dilation`` spaces
  the kernel's taps. impl: "xla" (``torch.nn.functional``), "pallas_3x3"
  (the ``conv3x3_same`` kernel where ``_pallas_conv_eligible`` holds; the
  layer then takes one frame) or "winograd" (``conv3x3_winograd`` on a
  3x3 stride-1 undilated SAME conv of an even H and W)."""
  _check_impl(impl)
  if padding not in ("SAME", "VALID"):
    raise ValueError(f"padding={padding!r}: expected 'SAME' or 'VALID'")
  cd = as_dtype(compute_dtype)
  eff = dilation * (kernel - 1) + 1  # the dilated kernel's extent

  def init(gen, in_shape, device):
    h, w, c = in_shape
    if _conv_trace is not None:
      _conv_trace.append((h, w, c, out_ch, kernel, stride))
    params = {"w": _fan_in_init(gen, (out_ch, c, kernel, kernel),
                                kernel * kernel * c, device)}
    if weight_standardize:
      params["gain"] = torch.ones((out_ch,), device=device)
    if use_bias:
      params["b"] = torch.zeros((out_ch,), device=device)
    if padding == "SAME":
      return params, (-(-h // stride), -(-w // stride), out_ch)
    return params, ((h - eff) // stride + 1, (w - eff) // stride + 1, out_ch)

  def weights(params):
    if weight_standardize:
      return standardize_weights(params["w"], params["gain"])
    return params["w"]

  def apply(params, x):
    eligible = impl == "pallas_3x3" and _pallas_conv_eligible(
        x.shape[-2], x.shape[-1], x.shape[-3], out_ch, kernel, stride,
        dilation, padding)
    if isinstance(x, Sharded):
      if dilation != 1 or padding != "SAME":
        raise NotImplementedError("a W-sharded map takes undilated SAME "
                                  "convs only")
      return _conv_sharded(x, params, weights, out_ch, kernel, stride, cd,
                           use_bias, eligible)
    wgt = weights(params)
    if eligible:
      from kfnet_tpu_torch.kernels import conv3x3
      # the kernel casts x to bf16 in any config, as the JAX wrapper does
      y = conv3x3.conv3x3_same(frame_hwc(x.to(torch.bfloat16)), wgt,
                               params.get("b"), relu=False, out_dtype=cd)
      return y.permute(2, 0, 1)[None]
    if (impl == "winograd" and kernel == 3 and stride == 1
        and dilation == 1 and padding == "SAME"
        and x.shape[-2] % 2 == 0 and x.shape[-1] % 2 == 0):
      from kfnet_tpu_torch.kernels import winograd
      return winograd.conv3x3_winograd(x, wgt, params.get("b"),
                                       compute_dtype=cd)
    x = x.to(cd)
    if padding == "SAME":
      (t, b) = same_pads(x.shape[-2], eff, stride)
      (l, r) = same_pads(x.shape[-1], eff, stride)
    else:
      t = b = l = r = 0
    if t == b and l == r:
      pad = (t, l)
    else:  # asymmetric (a stride-2 conv on an even input): pad explicitly
      x = F.pad(x, (l, r, t, b))
      pad = (0, 0)
    y = F.conv2d(x, wgt.to(cd), stride=stride, padding=pad,
                 dilation=dilation)
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
    if isinstance(x, Sharded):
      return _sharded(params, x)
    y = F.conv_transpose2d(x.to(cd), params["w"].to(cd), stride=stride,
                           padding=pad, output_padding=out_pad)
    if use_bias:
      y = _bias_round(y, params, cd)
    return y

  def _sharded(params, x):
    # XLA pads the dilated input by a = kernel - 1 - pad: output column o
    # reads the inputs j with o <= a + stride·j <= o + kernel - 1; an
    # unpadded transposed conv of the block starting at j0 gives column o
    # at o + pad - stride·j0
    a = kernel - 1 - pad
    ob = even_bounds(x.shape[-1] * stride, len(x.shards))
    out = []
    for i, shard in enumerate(x.shards):
      o0, o1 = ob[i], ob[i + 1]
      if o0 == o1:
        out.append(_empty_columns(shard, out_ch, shard.shape[-2] * stride,
                                  cd))
        continue
      j0 = -(-(o0 - a) // stride)
      j1 = (o1 + kernel - 2 - a) // stride + 1
      p_i = entry_params(params, i, shard.device)
      y = F.conv_transpose2d(x.take(i, j0, j1).to(cd), p_i["w"].to(cd),
                             stride=stride, padding=(pad, 0),
                             output_padding=(out_pad, 0))
      f0 = o0 + pad - stride * j0
      y = y[..., f0:f0 + o1 - o0]
      out.append(_bias_round(y, p_i, cd) if use_bias else y)
    return Sharded(out, -1, x.devices)

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

  def moments(x):
    x32 = x.to(torch.float32)
    return (torch.sum(x32, dim=(-2, -1)),                 # (B, C)
            torch.sum(torch.square(x32), dim=(-2, -1)))   # (B, C)

  def apply(params, x):
    if isinstance(x, Sharded):
      # each shard's sums are its columns'; the map's are their total,
      # added on the first entry's device in shard order
      parts = [moments(t) for t in x.shards]
      dev = x.devices[0]
      s1, s2 = (sum_in_order([p[k] for p in parts], dev) for k in (0, 1))
      return Sharded([normalize(entry_params(params, i, t.device), t,
                                s1.to(t.device), s2.to(t.device),
                                x.shape[-2:])
                      for i, t in enumerate(x.shards)], x.axis, x.devices)
    s1, s2 = moments(x)
    return normalize(params, x, s1, s2, x.shape[-2:])

  def normalize(params, x, s1, s2, hw):
    b, c = x.shape[0], x.shape[1]
    g = gn_group_count(c, groups)
    cg = c // g
    in_dtype = x.dtype
    x32 = x.to(torch.float32)
    n = hw[0] * hw[1] * cg
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


def sum_in_order(parts, device) -> torch.Tensor:
  """Σ of ``parts`` (tensors on any devices) on ``device``, added in list
  order: a fixed order, whichever device finishes first."""
  total = parts[0].to(device)
  for p in parts[1:]:
    total = total + p.to(device)
  return total


def activation(fn: Callable) -> Layer:
  """An elementwise ``fn`` that keeps the input's dtype (on a W-sharded
  map, shard by shard)."""

  def apply(params, x):
    return x.map(fn) if isinstance(x, Sharded) else fn(x)

  return Layer(init=lambda gen, in_shape, device: ({}, in_shape),
               apply=apply)


def relu() -> Layer:
  return activation(torch.relu)


def elu() -> Layer:
  return activation(F.elu)


def _pool(window: int, stride: int, fill: float, reduce) -> Layer:
  """A SAME-padded ``window`` pool of stride ``stride``: the pads hold
  ``fill`` and take part in the window."""

  def init(gen, in_shape, device):
    h, w, c = in_shape
    return {}, (-(-h // stride), -(-w // stride), c)

  def apply(params, x):
    t, b = same_pads(x.shape[-2], window, stride)
    l, r = same_pads(x.shape[-1], window, stride)
    xp = F.pad(x, (l, r, t, b), value=fill)
    return reduce(xp, window, stride)

  return Layer(init, apply)


def max_pool(window: int = 2, stride: int = 2) -> Layer:
  return _pool(window, stride, float("-inf"), F.max_pool2d)


def avg_pool(window: int = 2, stride: int = 2) -> Layer:
  """The window's sum over window² (zero pads counted), as the JAX
  module's."""
  return _pool(window, stride, 0.0, F.avg_pool2d)


def upsample_nearest(factor: int = 2) -> Layer:
  def init(gen, in_shape, device):
    h, w, c = in_shape
    return {}, (h * factor, w * factor, c)

  def apply(params, x):
    return x.repeat_interleave(factor, dim=-2).repeat_interleave(factor,
                                                                 dim=-1)

  return Layer(init, apply)


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
