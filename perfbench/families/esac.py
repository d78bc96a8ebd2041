"""ESAC (arXiv:1908.02484): a gating net shares out each frame's RANSAC
hypotheses among M expert scene-coordinate nets, as ``kfnet_tpu_torch``
serves it (``eval/online.EsacRelocalizer``). The family's check, its
numbers and its control are in ``esac_check.py``; its reference is
``reference/esac_ref.py``.
"""

from __future__ import annotations

import math
import time
import types

import torch

from perfbench.families.esac_check import (  # noqa: F401
    NUMBERS, compare, control, failures)
from perfbench.reference import esac_ref as ref
from perfbench.traffic import generator, render

# ---- the program ----------------------------------------------------------


def modules():
  """The program's modules that the runners and the spans reach."""
  from kfnet_tpu_torch.eval import online
  from kfnet_tpu_torch.models import esac
  from kfnet_tpu_torch.pose import ransac
  return {"online": online, "esac": esac, "ransac": ransac}


def program_config(cfg: dict):
  """``esac``: the ``EsacConfig``; ``ransac``: the ``RansacConfig``."""
  mods = modules()
  e, g = cfg["expert"], cfg["gating"]
  return types.SimpleNamespace(
      esac=mods["esac"].EsacConfig(
          num_experts=cfg["num_experts"],
          stem_channels=tuple(e["stem_channels"]),
          res_channels=e["res_channels"], head_channels=e["head_channels"],
          gating_channels=tuple(g["channels"]),
          compute_dtype=cfg["compute_dtype"]),
      ransac=mods["ransac"].RansacConfig(**cfg["ransac"]))


def build_kernels(device) -> None:
  """ESAC runs no kernel of the program's own build."""


# ---- weights --------------------------------------------------------------
#
# Seeded weights in the program's parameter tree (``models/esac.py``):
# {"gating": {layer: {"w" (out, in, k, k), "b" (out,)}, "fc": {"w" (M, C),
# "b" (M,)}}, "experts": {layer: {"w" (M, out, in, k, k), "b" (M, out)},
# "centre" (M, 3)}}. All leaves come from ONE ``torch.randn`` of their total
# size on the device, drawn by a generator seeded with the run's seed and
# scaled in place, as KFNet's: convs He-normal, biases 0.1·N(0, 1), centres
# 2·N(0, 1). The gating's linear layer is then set from frames rendered from
# the seed (``calibrate_gating``). float32, the program's master type.


def stem_and_res1(c1, c2, c3, c4):
  """(name, in, out, k, stride) of DSAC*'s stem and first residual block."""
  return [("conv1", 1, c1, 3, 1), ("conv2", c1, c2, 3, 2),
          ("conv3", c2, c3, 3, 2), ("conv4", c3, c4, 3, 2),
          ("res1_conv1", c4, c4, 3, 1), ("res1_conv2", c4, c4, 1, 1),
          ("res1_conv3", c4, c4, 3, 1)]


def expert_layers(cfg: dict):
  e = cfg["expert"]
  c4, r, h = e["stem_channels"][-1], e["res_channels"], e["head_channels"]
  return stem_and_res1(*e["stem_channels"]) + [
      ("res2_conv1", c4, r, 3, 1), ("res2_conv2", r, r, 1, 1),
      ("res2_conv3", r, r, 3, 1), ("res2_skip", c4, r, 1, 1),
      ("res3_conv1", r, r, 1, 1), ("res3_conv2", r, r, 1, 1),
      ("res3_conv3", r, r, 1, 1),
      ("fc1", r, h, 1, 1), ("fc2", h, h, 1, 1), ("fc3", h, 3, 1, 1)]


def gating_layers(cfg: dict):
  return stem_and_res1(*cfg["gating"]["channels"])


def spec(cfg: dict):
  """The tree of (kind, shape, fan_in) leaves of a configuration."""
  M = cfg["num_experts"]

  def convs(table, lead):
    return {name: {"w": ("he", lead + (cout, cin, k, k), k * k * cin),
                   "b": ("shift", lead + (cout,), 0)}
            for name, cin, cout, k, _ in table}

  gating = convs(gating_layers(cfg), ())
  c = cfg["gating"]["channels"][-1]
  gating["fc"] = {"w": ("fitted", (M, c), 0), "b": ("fitted", (M,), 0)}
  experts = convs(expert_layers(cfg), (M,))
  experts["centre"] = ("centre", (M, 3), 0)
  return {"gating": gating, "experts": experts}


def _leaves(tree):
  if isinstance(tree, dict):
    return [x for k in tree for x in _leaves(tree[k])]
  return [tree]


def _fill(tree, take):
  if isinstance(tree, dict):
    return {k: _fill(v, take) for k, v in tree.items()}
  return take(tree)


def farthest_points(z: torch.Tensor, k: int):
  """Indices of ``k`` rows of ``z`` by farthest-point sampling from row 0
  (Euclidean)."""
  picks = [0]
  d = torch.sum((z - z[0]) ** 2, -1)
  for _ in range(k - 1):
    i = int(torch.argmax(d))
    picks.append(i)
    d = torch.minimum(d, torch.sum((z - z[i]) ** 2, -1))
  return picks


def calibration_frames(cfg: dict, seed: int, device):
  """The frames the gating's linear layer is set from: ``cameras`` orbits
  of scene ``scene_seed``, each from its own seed, ``frames / cameras``
  frames an orbit, uint8 (N, H, W, 3) on ``device``."""
  cal = cfg["gating"]["calibration"]
  H, W = cfg["frame"][:2]
  scene = render.make_scene(cal["scene_seed"])
  K = generator.intrinsics(cal, device)
  per = cal["frames"] // cal["cameras"]
  out = []
  step = render.chunk_frames(H, W, len(scene["radii"]))
  for c in range(cal["cameras"]):
    poses = torch.as_tensor(render.orbit(
        per, generator.camera_seed(seed, (1 << 23) + c),
        frames_per_orbit=cal["frames_per_orbit"]), device=device)
    for i in range(0, per, step):
      rgb = render.render(scene, poses[i:i + step], K, H, W)
      out.append(torch.round(rgb * 255.0).to(torch.uint8))
  return torch.cat(out)


def experts_drawn(logits, hypotheses: int):
  """The expected number of distinct experts ``hypotheses`` draws from
  softmax(``logits``) give, mean over the rows."""
  p = torch.softmax(logits, dim=-1)
  return float(torch.mean(torch.sum(1.0 - (1.0 - p) ** hypotheses, -1)))


def temperature(logits, hypotheses: int, target: float) -> float:
  """The scale s at which a row of s · ``logits`` draws ``target``
  distinct experts on average (bisection on log s; the count falls as s
  grows)."""
  lo, hi = -8.0, 8.0
  for _ in range(60):
    mid = (lo + hi) / 2
    if experts_drawn(math.exp(mid) * logits, hypotheses) > target:
      lo = mid
    else:
      hi = mid
  return math.exp((lo + hi) / 2)


def calibrate_gating(params, cfg: dict, seed: int, device) -> None:
  """Set the gating's linear layer, a seeded stand-in for a trained
  classifier of scene parts: the gating's pooled features of the
  calibration frames (the float32 reference's) are standardised per
  channel, M of them are picked by farthest-point sampling as prototypes,
  and expert m's logit is -s times the squared distance of the
  standardised features to prototype m (less |z|², the same for every
  expert, which the softmax drops: so a linear layer), the temperature s
  such that a calibration frame's hypotheses draw ``experts_per_frame``
  distinct experts on average; the standardisation and s are folded into
  the layer's weights and bias."""
  cal = cfg["gating"]["calibration"]
  with torch.no_grad():
    frames = calibration_frames(cfg, seed, device)
    with ref.tf32_mode(False):
      f = torch.cat([ref.gating_features(params, cfg, frames[i:i + 16])
                     for i in range(0, frames.shape[0], 16)])
      mu, sd = f.mean(0), torch.clamp_min(f.std(0), 1e-6)
      z = (f - mu) / sd
      proto = z[farthest_points(z, cfg["num_experts"])]
      norm = torch.sum(proto * proto, -1)
      s = temperature(2.0 * z @ proto.T - norm,
                      cfg["ransac"]["num_hypotheses"],
                      cal["experts_per_frame"])
    w = 2.0 * s * proto / sd
    params["gating"]["fc"] = {"w": w.contiguous(),
                              "b": -(w @ mu) - s * norm}


def make_weights(cfg: dict, seed: int, device) -> dict:
  """The weights of ``cfg`` from ``seed``, on ``device``."""
  tree = spec(cfg)
  total = sum(math.prod(shape) for kind, shape, _ in _leaves(tree)
              if kind != "fitted")
  gen = torch.Generator(device=device).manual_seed(seed)
  flat = torch.randn(total, generator=gen, device=device,
                     dtype=torch.float32)
  at = [0]

  def take(leaf):
    kind, shape, fan_in = leaf
    if kind == "fitted":
      return None
    n = math.prod(shape)
    t = flat[at[0]:at[0] + n].view(shape)
    at[0] += n
    if kind == "he":
      t.mul_(math.sqrt(2.0 / fan_in))
    elif kind == "shift":
      t.mul_(0.1)
    else:  # a centre
      t.mul_(2.0)
    return t

  params = _fill(tree, take)
  calibrate_gating(params, cfg, seed, device)
  return params


def count(cfg: dict) -> int:
  return sum(math.prod(shape) for _, shape, _ in _leaves(spec(cfg)))


# ---- work -----------------------------------------------------------------
#
# Analytic FLOPs, frozen here so that a change to the program cannot move
# them: 2·k²·in·out a conv's output, each 3x3 conv padded 1 (so a stride-2
# conv halves a size rounding up).


def _convs_flops(table, frame_shape) -> float:
  h, w = frame_shape[:2]
  total = 0.0
  for _, cin, cout, k, s in table:
    h, w = -(-h // s), -(-w // s)
    total += 2.0 * k * k * cin * cout * h * w
  return total


def expert_flops(cfg: dict, frame_shape) -> float:
  """One expert on one frame (70.97 GFLOP at 480x640 in the published
  widths)."""
  return _convs_flops(expert_layers(cfg), frame_shape)


def gating_flops(cfg: dict, frame_shape) -> float:
  """The gating net on one frame, its linear layer included."""
  g = cfg["gating"]["channels"]
  return (_convs_flops(gating_layers(cfg), frame_shape)
          + 2.0 * g[-1] * cfg["num_experts"])


# ---- spans ----------------------------------------------------------------

# (module key in modules(), attribute path, span name, CUDA events)
PATCHES = (
    ("online", "EsacRelocalizer.tick", "online.tick", False),
    ("online", "EsacRelocalizer._gated", "esac.gate", True),
    ("online", "EsacRelocalizer._run_pairs", "esac.experts", True),
    ("ransac", "solve_pnp_from_maps", "pose.solve", True),
)
# a graph's kernels take the span its replay was launched in
LAYERS = ("esac.gate", "esac.experts", "pose.solve")
REPLAY_SPAN = None


def layer_patches(spans, mods):
  """The pairs each tick ran and when it answered, kept with the run's
  spans as ``spans.pairs`` ([(perf_counter, pairs)]) for the readers of a
  tick's work after the traced part."""
  cls = mods["online"].EsacRelocalizer
  process = cls.process
  spans.pairs = []

  def logged(self, *args, **kwargs):
    out = process(self, *args, **kwargs)
    spans.pairs.append((time.perf_counter(), out[1]["pairs"]))
    return out

  yield cls, "process", logged


def attribution_step(prog, params, frame_shape, device):
  """One eager gating of a seeded frame, as a call."""
  esac = modules()["esac"]
  gen = torch.Generator(device=device).manual_seed(0)
  frames = torch.randint(0, 256, (1,) + tuple(frame_shape), generator=gen,
                         device=device, dtype=torch.uint8)
  image = esac.preprocess(prog.esac, frames)
  return lambda: esac.gate(params, prog.esac, image)


# ---- the runner -----------------------------------------------------------


class Server:
  """B cameras in lockstep through ``EsacRelocalizer.process`` (B = 1: one
  camera). ``keep`` is the tick's gating probabilities (B, M), each
  hypothesis's map row b·M + e (B, H), the flat pairs b·M + e the tick ran
  (P,) and their maps (P, h, w, 3)."""

  def __init__(self, prog, params, cfg, mix, pool, seed, device):
    online = modules()["online"]
    K = generator.intrinsics(mix, "cpu").numpy()
    self.pool = pool
    self.reloc = online.EsacRelocalizer(
        params, prog.esac, K, batch_size=pool.shape[1],
        ransac_config=prog.ransac, stride=cfg["pose_stride"], seed=seed,
        device=device)

  def tick(self, row, reset):
    """A tick of pool row ``row`` (ESAC keeps no state: ``reset`` changes
    nothing)."""
    poses, info = self.reloc.process(self.pool[row])
    return poses, info["num_inliers"]

  def keep(self):
    probs, map_of, pairs = self.reloc.last
    return (probs.clone(), map_of.clone(), pairs.clone(),
            self.reloc.maps.index_select(0, pairs))
