"""KFNet (arXiv:2003.10629): SCoordNet's measurement, OFlowNet's process
model, a per-pixel Kalman filter and the PnP-RANSAC pose, as
``kfnet_tpu_torch`` runs them. The family's check, its numbers and its
control are in ``kfnet_check.py``; its reference is
``reference/kfnet_ref.py``.
"""

from __future__ import annotations

import math
import types

import numpy as np
import torch

from perfbench import flops, tracing
from perfbench.families.kfnet_check import (  # noqa: F401
    NUMBERS, compare, control, failures)
from perfbench.reference.kfnet_ref import adjusted_strides
from perfbench.traffic import generator

# ---- the program ----------------------------------------------------------


def modules():
  """The program's modules that the runners and the spans reach."""
  from kfnet_tpu_torch.eval import online
  from kfnet_tpu_torch.filter import sequence
  from kfnet_tpu_torch.models import kfnet
  from kfnet_tpu_torch.nn import layers
  from kfnet_tpu_torch.pose import ransac
  return {"online": online, "sequence": sequence, "kfnet": kfnet,
          "layers": layers, "ransac": ransac}


def kfnet_config(cfg: dict):
  from kfnet_tpu_torch.models import kfnet, oflownet, scoordnet
  sc, of = dict(cfg["scoordnet"]), dict(cfg["oflownet"])
  for key in ("channels", "strides", "coord_offset"):
    sc[key] = tuple(sc[key])
  for key in ("encoder_channels", "encoder_strides", "unet_channels"):
    of[key] = tuple(of[key])
  return kfnet.KFNetConfig(scoordnet=scoordnet.SCoordNetConfig(**sc),
                           oflownet=oflownet.OFlowNetConfig(**of),
                           **cfg["filter"])


def ransac_config(cfg: dict):
  from kfnet_tpu_torch.pose import ransac
  return ransac.RansacConfig(**cfg["ransac"])


def program_config(cfg: dict):
  """``kfnet``: the ``KFNetConfig``; ``ransac``: the ``RansacConfig``."""
  return types.SimpleNamespace(kfnet=kfnet_config(cfg),
                               ransac=ransac_config(cfg))


def build_kernels(device) -> None:
  """Build (or load from the checkout's build directory) the fused
  update's library, so that no build falls inside the window."""
  if device.type == "cuda":
    from kfnet_tpu_torch.kernels import fused_filter
    fused_filter.build()


# ---- weights --------------------------------------------------------------
#
# Seeded weights in the program's parameter tree, made on the device. The
# tree is the one both the program and ``reference/kfnet_ref.py`` read:
# SCoordNet a list of blocks ``[conv, (GroupNorm,) relu]`` (16: the trunk
# and the head block) and the 1x1 head; OFlowNet a dict of its encoder
# blocks, the U-Net's block pairs, the two transposed convs and the head.
# A conv is ``{"w": (out, in, k, k)[, "b": (out,)]}`` (a transposed conv
# ``(in, out, 4, 4)``), GroupNorm ``{"scale", "bias"}``, ReLU ``{}``.
#
# All leaves come from ONE ``torch.randn`` of their total size on the
# device, drawn by a ``torch.Generator`` seeded with the run's seed, then
# scaled in place: convs He-normal (std sqrt(2 / fan_in)), biases and
# GroupNorm shifts 0.1·N(0, 1), GroupNorm scales 1 + 0.1·N(0, 1).
# float32, the type the program keeps its weights in.


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


def make_weights(cfg: dict, seed: int, device) -> dict:
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


# ---- work and kernel bounds -----------------------------------------------
#
# The conv and cost-volume count is the analytic one of the program's
# ``eval/flops.py`` at the time this benchmark was written (one filter step
# at 640x480: 241.7 GFLOP in the paper's widths), frozen here so that a
# later change to the program cannot move it. The fused update's count is
# what its inputs and outputs need, each byte read or written once.


def conv_flops(cfg, frame_shape, first: bool = False) -> float:
  return sum(flops.conv_work(*c)[0]
             for c in conv_shapes(cfg, frame_shape, first))


def map_shape(cfg, frame_shape):
  """(h, w) of the filtered maps: the frame over SCoordNet's total stride
  (the stem's factor times the strided convs)."""
  s = cfg["scoordnet"]["stem_s2d"]
  for st in adjusted_strides(cfg["scoordnet"]["strides"],
                             cfg["scoordnet"]["stem_s2d"]):
    s *= st
  return frame_shape[0] // s, frame_shape[1] // s


def cost_volume_flops(cfg, frame_shape) -> float:
  """(2r+1)² correlations of C-dim features a map pixel."""
  of = cfg["oflownet"]
  h, w = map_shape(cfg, frame_shape)
  return (2.0 * h * w * (2 * of["search_radius"] + 1) ** 2
          * of["encoder_channels"][-1])


def frame_flops(cfg, frame_shape, first: bool = False) -> float:
  """Analytic FLOPs of a frame's nets: a filter step (both nets, the cost
  volume), or with ``first`` a first frame (SCoordNet and the encoder)."""
  total = conv_flops(cfg, frame_shape, first)
  return total if first else total + cost_volume_flops(cfg, frame_shape)


def conv_bound_s(cfg, frame_shape, peaks, first: bool = False) -> float:
  """The least time a frame's convs could take on the card
  (``flops.convs_bound_s``)."""
  return flops.convs_bound_s(conv_shapes(cfg, frame_shape, first), peaks)


# the fused update per map pixel: reads the two raw heads (3 + 4 floats)
# and the previous posterior (3 + 1), writes the posterior (3 + 1), flow
# (2), W, z (3), V (float32 each) and the consistency mask (1 byte)
FUSED_BYTES_PER_PIXEL = 4 * (3 + 4 + 3 + 1) + 4 * (3 + 1 + 2 + 1 + 3 + 1) + 1
# float32 operations a pixel: the heads' tanh (2), exp (2), scales (6);
# bilinear weights and the 4-tap blend of 4 channels (40); the
# innovation, its norm and the test (10); gain and update (12)
FUSED_OPS_PER_PIXEL = 72


def fused_bound_s(cfg, frame_shape, peaks, maps: int = 1) -> float:
  """The least time of one fused-update launch over ``maps`` maps."""
  h, w = map_shape(cfg, frame_shape)
  n = maps * h * w
  return max(n * FUSED_BYTES_PER_PIXEL / peaks["hbm_bytes"],
             n * FUSED_OPS_PER_PIXEL / peaks["fp32"])


# ---- spans ----------------------------------------------------------------

# (module key in modules(), attribute path, span name, CUDA events)
PATCHES = (
    ("online", "OnlineRelocalizer.tick", "online.tick", False),
    ("online", "FleetRelocalizer.tick", "online.tick", False),
    ("ransac", "solve_pnp_from_maps", "pose.solve", False),
    ("sequence", "GraphedStep.replay", "filter.replay", True),
    ("kfnet", "first_step", "filter.first", False),
)
LAYERS = ("conv", "groupnorm", "fused")
REPLAY_SPAN = "filter.replay"


def layer_patches(spans, mods):
  """The layer spans: the convs' and the fused update's calls, and the
  apply of each GroupNorm layer made while the spans are on."""
  layers, kfnet = mods["layers"], mods["kfnet"]
  F = layers.F
  yield layers, "F", tracing.Proxy(F, {
      "conv2d": spans.wrap("conv", F.conv2d),
      "conv_transpose2d": spans.wrap("conv", F.conv_transpose2d)})
  fused = kfnet.fused_filter
  yield kfnet, "fused_filter", tracing.Proxy(fused, {
      "fused_filter_step": spans.wrap("fused", fused.fused_filter_step)})
  group_norm = layers.group_norm

  def traced_group_norm(*args, **kwargs):
    layer = group_norm(*args, **kwargs)
    return layers.Layer(layer.init, spans.wrap("groupnorm", layer.apply))

  yield layers, "group_norm", traced_group_norm


def attribution_step(prog, params, frame_shape, device):
  """One eager filter step of two seeded frames, as a call."""
  kfnet = modules()["kfnet"]
  kcfg = prog.kfnet
  gen = torch.Generator(device=device).manual_seed(0)
  frames = torch.randint(0, 256, (2,) + tuple(frame_shape), generator=gen,
                         device=device, dtype=torch.uint8)
  image = kfnet.preprocess_images(kcfg, frames)
  x, P, feat = kfnet.first_step(params, kcfg, image[0])
  return lambda: kfnet.filter_step(params, kcfg, x, P, feat, image[1])


# ---- the runners ----------------------------------------------------------


class Server:
  """One camera through ``OnlineRelocalizer.process`` ("stream") or B in
  lockstep through ``FleetRelocalizer.process`` ("fleet"). ``keep`` is the
  posterior (x, P) of the tick just served, each (B, h, w, C)."""

  def __init__(self, prog, params, cfg, mix, pool, seed, device):
    online = modules()["online"]
    K = generator.intrinsics(mix, "cpu").numpy()
    self.pool, self.B = pool, pool.shape[1]
    self.fleet = mix["mode"] == "fleet"
    if self.fleet:
      self.reloc = online.FleetRelocalizer(
          params, prog.kfnet, K, batch_size=self.B,
          ransac_config=prog.ransac, stride=cfg["pose_stride"], seed=seed,
          pipeline_depth=mix["pipeline_depth"], device=device)
    else:
      self.reloc = online.OnlineRelocalizer(
          params, prog.kfnet, K, ransac_config=prog.ransac,
          stride=cfg["pose_stride"], seed=seed, device=device)

  def tick(self, row, reset):
    if self.fleet:
      poses, info = self.reloc.process(self.pool[row], reset=reset)
      return poses, info["num_inliers"]
    if reset[0]:
      self.reloc.reset()
    pose, info = self.reloc.process(self.pool[row, 0])
    return pose[None], np.array([info["num_inliers"]])

  def keep(self):
    x, P = self.reloc.state[0], self.reloc.state[1]
    B = self.B
    return (x.reshape((B,) + tuple(x.shape[-3:])).clone(),
            P.reshape((B,) + tuple(P.shape[-3:])).clone())


def sequences(prog, params, mix, device):
  """Recorded sequences through ``filter.sequence.run_filter_chunked_arrays``
  in chunks of ``chunk_size``: each chunk (xs, Ps), the posteriors of its
  frames."""
  seq = modules()["sequence"]

  def run(frames):
    return seq.run_filter_chunked_arrays(params, prog.kfnet, frames,
                                         chunk_size=mix["chunk_size"],
                                         device=device)

  return run
