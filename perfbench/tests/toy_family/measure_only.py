"""A toy second family, for the test of the family contract: camera
relocalisation by measurement alone. The port's SCoordNet measures each
frame's scene coordinates (z, V), and the port's PnP-RANSAC solves the
pose from them; no filter and no OFlowNet. It serves the "stream" and
"fleet" modes, untraced. Its reference is ``measure_only_ref.py``; it has
no control, since ``control.py`` never runs it.

The check: ``meas_z_rel``, the worst ||z - z_ref|| / ||z_ref|| over the
compared ticks' maps, and ``pose_mismatch``, the share of compared solves
whose pose differs from the reference's solve of the program's maps with
the same draws.
"""

from __future__ import annotations

import math
import types

import numpy as np
import torch

from perfbench import check
from perfbench.tests.toy_family import measure_only_ref as ref
from perfbench.traffic import generator

NUMBERS = ("meas_z_rel", "pose_mismatch")


def modules():
  from kfnet_tpu_torch.models import scoordnet
  from kfnet_tpu_torch.pose import ransac
  return {"scoordnet": scoordnet, "ransac": ransac}


def program_config(cfg: dict):
  mods = modules()
  sc = dict(cfg["scoordnet"])
  for key in ("channels", "strides", "coord_offset"):
    sc[key] = tuple(sc[key])
  return types.SimpleNamespace(
      scoordnet=mods["scoordnet"].SCoordNetConfig(**sc),
      ransac=mods["ransac"].RansacConfig(**cfg["ransac"]))


def build_kernels(device) -> None:
  pass


def make_weights(cfg: dict, seed: int, device) -> dict:
  """SCoordNet's blocks ``[conv, (GroupNorm,) relu]`` and its 1x1 head,
  He-normal convs, 0.1 N(0, 1) biases and shifts, 1 + 0.1 N(0, 1)
  scales, drawn from ``seed``."""
  sc = cfg["scoordnet"]
  gen = torch.Generator(device=device).manual_seed(seed)
  normal = lambda *shape: torch.randn(shape, generator=gen, device=device)

  def conv(cout, cin, k, bias):
    leaf = {"w": normal(cout, cin, k, k) * math.sqrt(2.0 / (k * k * cin))}
    if bias:
      leaf["b"] = 0.1 * normal(cout)
    return leaf

  def block(cout, cin):
    if sc["norm"] == "group":
      return [conv(cout, cin, 3, False),
              {"scale": 1.0 + 0.1 * normal(cout), "bias": 0.1 * normal(cout)},
              {}]
    return [conv(cout, cin, 3, True), {}]

  cin, tree = 3 * sc["stem_s2d"] ** 2, []
  for c in list(sc["channels"]) + [sc["head_channels"]]:
    tree.append(block(c, cin))
    cin = c
  tree.append(conv(4, cin, 1, True))
  return {"scoordnet": tree}


def count(cfg: dict) -> int:
  return sum(t.numel() for t in _leaves(make_weights(cfg, 0, "cpu")))


def _leaves(tree):
  if isinstance(tree, dict):
    return [x for v in tree.values() for x in _leaves(v)]
  if isinstance(tree, list):
    return [x for v in tree for x in _leaves(v)]
  return [tree]


class Server:
  """Each tick: the measurement of the row's frames, then the pose solve of
  its maps (one map a camera, B in one solve in a fleet)."""

  def __init__(self, prog, params, cfg, mix, pool, seed, device):
    mods = modules()
    self.scoordnet, self.ransac = mods["scoordnet"], mods["ransac"]
    self.prog, self.params, self.pool, self.device = prog, params, pool, device
    self.K = generator.intrinsics(mix, device)
    self.gen = torch.Generator(device=device).manual_seed(seed)
    self.stride = cfg["pose_stride"]
    self.fleet = mix["mode"] == "fleet"
    self.maps = None

  def tick(self, row, reset):
    frames = self.pool[row].to(self.device)
    if not self.fleet:
      frames = frames[0]
    z, V = self.scoordnet.apply(self.params["scoordnet"],
                                self.prog.scoordnet, frames)
    out = self.ransac.solve_pnp_from_maps(
        z, V, torch.ones_like(V, dtype=torch.bool), self.K, self.gen,
        stride=self.stride, config=self.prog.ransac)
    self.maps = (z, V)
    return (out["T_wc"].reshape(-1, 4, 4).cpu().numpy(),
            out["num_inliers"].reshape(-1).cpu().numpy())

  def keep(self):
    B = self.pool.shape[1]
    return tuple(m.reshape((B,) + tuple(m.shape[-3:])).clone()
                 for m in self.maps)


def _resolve(cfg, mix, rec, seed, device, maps: dict):
  """{tick: (program's (T_wc, inliers), reference's)}, the reference
  solving the program's maps with the program's draws."""
  if not maps:
    return {}
  B = mix["cameras"]
  z0 = next(iter(maps.values()))[0]
  k = min(cfg["ransac"]["top_k"], z0.shape[1] * z0.shape[2])
  shape = ((B,) if mix["mode"] == "fleet" else ()) + (
      cfg["ransac"]["num_hypotheses"], k)
  solve_of = {rec.ticks[i][4]: i for i in maps}
  q = check.draws(seed, shape, rec.solves, device, set(solve_of))
  K = generator.intrinsics(mix, device)
  out = {}
  for s, i in solve_of.items():
    z, V = maps[i]
    Tr, n_r = ref.solve(z, V, K, q[s].reshape((B,) + q[s].shape[-2:]), cfg)
    out[i] = ((rec.ticks[i][2], rec.ticks[i][3]),
              (Tr.cpu().numpy(), n_r.cpu().numpy()))
  return out


def compare(cfg, mix, params, pool, rec, seed, device) -> dict:
  rng = np.random.default_rng(generator.camera_seed(seed, 1 << 21))
  ticks = sorted(rec.kept)
  out = {}
  with torch.no_grad():
    meas = [(i, b) for i in ticks for b in range(mix["cameras"])]
    errs = []
    for i, b in check.pick(rng, meas, mix["checks"]["measure"]):
      z = rec.kept[i][2][b]
      zr, _ = ref.measure(params, cfg, pool[rec.ticks[i][0], b].to(device))
      errs.append(check.rel(z, zr))
    if errs:
      out["meas_z_rel"] = max(errs)
    chosen = check.pick(rng, ticks, mix["checks"]["pose"])
    got = _resolve(cfg, mix, rec, seed, device,
                   {i: rec.kept[i][2:] for i in chosen})
    bad = total = 0
    for (Tp, n_p), (Tr, n_r) in got.values():
      for b in range(mix["cameras"]):
        total += 1
        bad += check.pose_disagrees(Tp[b], Tr[b], n_p[b], n_r[b])
    if total:
      out["pose_mismatch"] = bad / total
  return out


def failures(cfg, mix, rec, seed, device) -> tuple[int, int]:
  got = _resolve(cfg, mix, rec, seed, device, rec.odd)
  odd = failed = 0
  for (Tp, _), (Tr, _) in got.values():
    for b in range(mix["cameras"]):
      if not np.isfinite(Tp[b]).all():
        odd += 1
        failed += int(np.isfinite(Tr[b]).all())
  return odd, failed
