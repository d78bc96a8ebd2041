"""Seeded weights in the program's parameter tree, made on the device.

The tree is the one both the program and ``reference/kfnet_ref.py`` read:
SCoordNet a list of blocks ``[conv, (GroupNorm,) relu]`` (16: the trunk
and the head block) and the 1x1 head; OFlowNet a dict of its encoder
blocks, the U-Net's block pairs, the two transposed convs and the head.
A conv is ``{"w": (out, in, k, k)[, "b": (out,)]}`` (a transposed conv
``(in, out, 4, 4)``), GroupNorm ``{"scale", "bias"}``, ReLU ``{}``.

All leaves come from ONE ``torch.randn`` of their total size on the
device, drawn by a ``torch.Generator`` seeded with the run's seed, then
scaled in place: convs He-normal (std sqrt(2 / fan_in)), biases and
GroupNorm shifts 0.1·N(0, 1), GroupNorm scales 1 + 0.1·N(0, 1).
float32, the type the program keeps its weights in.
"""

from __future__ import annotations

import math

import torch

from perfbench.reference.kfnet_ref import adjusted_strides


def _conv(cout, cin, k, bias):
  leaf = {"w": ("he", (cout, cin, k, k), k * k * cin)}
  if bias:
    leaf["b"] = ("shift", (cout,), 0)
  return leaf


def _block(cout, cin, norm):
  """[conv, (GroupNorm,) relu]: a normed conv has no bias."""
  grouped = norm == "group"
  out = [_conv(cout, cin, 3, not grouped)]
  if grouped:
    out.append({"scale": ("scale", (cout,), 0), "bias": ("shift", (cout,),
                                                          0)})
  out.append({})
  return out


def spec(cfg: dict):
  """The tree of (kind, shape, fan_in) leaves of a configuration."""
  sc, of = cfg["scoordnet"], cfg["oflownet"]
  f = sc["stem_s2d"]
  cin = 3 * f * f
  sc_tree = []
  for c in sc["channels"]:
    sc_tree.append(_block(c, cin, sc["norm"]))
    cin = c
  sc_tree.append(_block(sc["head_channels"], cin, sc["norm"]))
  sc_tree.append(_conv(4, sc["head_channels"], 1, True))
  f = of["stem_s2d"]
  cin = 3 * f * f
  enc = []
  for c in of["encoder_channels"]:
    enc.append(_block(c, cin, of["norm"]))
    cin = c
  c0, c1, c2 = of["unet_channels"]
  nm = of["norm"]
  cv = (2 * of["search_radius"] + 1) ** 2
  of_tree = {
      "encoder": enc,
      "enc0": [_block(c0, cv, nm), _block(c0, c0, nm)],
      "down1": [_block(c1, c0, nm), _block(c1, c1, nm)],
      "down2": [_block(c2, c1, nm), _block(c2, c2, nm)],
      "up1": {"w": ("he", (c2, c1, 4, 4), 16 * c2), "b": ("shift", (c1,), 0)},
      "fuse1": _block(c1, 2 * c1, nm),
      "up0": {"w": ("he", (c1, c0, 4, 4), 16 * c1), "b": ("shift", (c0,), 0)},
      "fuse0": _block(c0, 2 * c0, nm),
      "head": _conv(3, c0, 3, True),
  }
  return {"scoordnet": sc_tree, "oflownet": of_tree}


def _leaves(tree):
  if isinstance(tree, dict):
    return [x for k in tree for x in _leaves(tree[k])]
  if isinstance(tree, list):
    return [x for v in tree for x in _leaves(v)]
  return [tree]


def _fill(tree, take):
  if isinstance(tree, dict):
    return {k: _fill(v, take) for k, v in tree.items()}
  if isinstance(tree, list):
    return [_fill(v, take) for v in tree]
  return take(tree)


def make(cfg: dict, seed: int, device) -> dict:
  """The weights of ``cfg`` from ``seed``, on ``device``."""
  tree = spec(cfg)
  total = sum(math.prod(shape) for _, shape, _ in _leaves(tree))
  gen = torch.Generator(device=device).manual_seed(seed)
  flat = torch.randn(total, generator=gen, device=device,
                     dtype=torch.float32)
  at = [0]

  def take(leaf):
    kind, shape, fan_in = leaf
    n = math.prod(shape)
    t = flat[at[0]:at[0] + n].view(shape)
    at[0] += n
    if kind == "he":
      t.mul_(math.sqrt(2.0 / fan_in))
    elif kind == "shift":
      t.mul_(0.1)
    else:  # a GroupNorm scale
      t.mul_(0.1).add_(1.0)
    return t

  return _fill(tree, take)


def count(cfg: dict) -> int:
  return sum(math.prod(shape) for _, shape, _ in _leaves(spec(cfg)))


def conv_shapes(cfg: dict, frame_shape, first: bool):
  """(h_in, w_in, cin, cout, k, stride, transposed, low) of every conv of a
  frame's nets, in call order: SCoordNet's, OFlowNet's encoder and, unless
  ``first`` (a first frame has no flow), its U-Net. ``low``: the
  configuration's low-precision convs (all but the two float32 heads)."""
  sc, of = cfg["scoordnet"], cfg["oflownet"]
  H, W = frame_shape[:2]
  out = []

  def chain(h, w, cin, chans, strides):
    for c, s in zip(chans, strides):
      out.append((h, w, cin, c, 3, s, False, True))
      h, w, cin = -(-h // s), -(-w // s), c
    return h, w, cin

  f = sc["stem_s2d"]
  h, w, cin = chain(H // f, W // f, 3 * f * f,
                    list(sc["channels"]) + [sc["head_channels"]],
                    adjusted_strides(sc["strides"], f) + [1])
  out.append((h, w, cin, 4, 1, 1, False, False))
  f = of["stem_s2d"]
  h, w, cin = chain(H // f, W // f, 3 * f * f, of["encoder_channels"],
                    adjusted_strides(of["encoder_strides"], f))
  if first:
    return out
  c0, c1, c2 = of["unet_channels"]
  cv = (2 * of["search_radius"] + 1) ** 2
  h1, w1, _ = chain(h, w, cv, [c0, c0, c1, c1], [1, 1, 2, 1])
  h2, w2, _ = chain(h1, w1, c1, [c2, c2], [2, 1])
  out.append((h2, w2, c2, c1, 4, 2, True, True))
  chain(h1, w1, 2 * c1, [c1], [1])
  out.append((h1, w1, c1, c0, 4, 2, True, True))
  chain(h, w, 2 * c0, [c0], [1])
  out.append((h, w, c0, 3, 3, 1, False, False))
  return out
