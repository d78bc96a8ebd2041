"""How ``correct`` is decided for ESAC: the answers of the timed path,
compared with ``reference/esac_ref.py`` once the window has closed.

Of the ticks a seeded reservoir kept (``Server.keep``: the gating
probabilities, each hypothesis's map row, the pairs run and their maps),
``checks["step"]`` are drawn from the run's seed, and the uniforms and keys
the program drew for each are drawn again (the surface's generator, seeded
with the run's seed, draws a (B, H) block of uniforms and a (B, H, h·w)
block of Exp(1) keys a tick, in that order, graphed or not).

* ``gate_rel``: ||g - g_ref|| / ||g_ref|| of the tick's (B, M) gating
  probabilities, the reference's from the raw frames.
* ``route_mismatch``: the share of hypotheses whose expert, drawn from the
  reference's probabilities with the program's uniforms, differs from the
  program's (``route_replay_mismatch``: the same from the program's own
  probabilities, which must be 0: it holds the draw and its replay;
  printed).
* ``map_rel``: ||x - x_ref|| / ||x_ref|| of each map the tick ran, the
  reference running that expert on that slot's frame; up to
  ``checks["maps"]`` pairs.
* ``pose_mismatch``: the share of the ``checks["pose"]`` ticks' slots
  whose pose or inlier count differs (``check.pose_disagrees``) from the
  reference's solve of the program's maps with the program's hypotheses'
  experts and keys (``pose_mismatch_ref_maps``: the same solve of the
  reference's maps, printed: with seeded weights a map is no scene, and a
  map rounded otherwise wins with another hypothesis).
* Printed, of the whole pool with the reference's gating and uniforms
  drawn from the seed: ``top_share_median`` (the median share of a frame's
  hypotheses its top expert takes), ``experts_per_frame`` (distinct
  experts drawn a frame, mean), ``top_experts`` (the frames' distinct top
  experts); and of the compared ticks ``pairs_per_tick``.

Each compared number is the worst over the compared answers. A served pose
that is not finite is solved again by the reference from the program's
maps and draws; where the reference finds a finite pose, the answer
counts as failed.

The control (``control``): the reference takes the program's place one
step lower in precision (``esac_ref.CONTROL``: fp8 e4m3 expert
convolutions, TF32 gating and pose) and answers as many ticks as asked.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import check, loops
from perfbench.reference import esac_ref as ref
from perfbench.traffic import generator

NUMBERS = ("gate_rel", "route_mismatch", "map_rel", "pose_mismatch",
           "route_replay_mismatch", "pose_mismatch_ref_maps",
           "top_share_median", "experts_per_frame", "top_experts",
           "pairs_per_tick")


def _sizes(cfg, mix):
  h, w = (-(-d // cfg["pose_stride"]) for d in cfg["frame"][:2])
  return (mix["cameras"], cfg["ransac"]["num_hypotheses"], h, w,
          cfg["num_experts"])


def draws(cfg, mix, seed, solves, device, wanted):
  """{solve: (uniforms (B, H), keys (B, H, h·w))} of the solves ``wanted``
  of a generator seeded with ``seed``, drawn as the surface draws them."""
  B, H, h, w, _ = _sizes(cfg, mix)
  gen = torch.Generator(device=device).manual_seed(seed)
  out = {}
  for s in range(min(solves, max(wanted, default=-1) + 1)):
    u = torch.rand((B, H), generator=gen, device=device)
    q = torch.empty((B, H, h * w), device=device).exponential_(generator=gen)
    if s in wanted:
      out[s] = (u, q)
  return out


def _stack(cfg, mix, pairs, maps, device):
  """The (B·M, h, w, 3) stack with ``maps`` at rows ``pairs``."""
  B, _, h, w, M = _sizes(cfg, mix)
  out = torch.zeros((B * M, h, w, 3), device=device)
  out[pairs] = maps
  return out


def _resolve(cfg, mix, rec, seed, device, kept: dict, prec, maps_of=None):
  """{tick: (program's (T_wc, inliers), reference's)} of the ticks of
  ``kept`` ({tick: (probs, map_of, pairs, maps)}), solved again with the
  program's experts and keys, on the program's maps (or ``maps_of[tick]``
  (P, h, w, 3))."""
  if not kept:
    return {}
  solve_of = {rec.ticks[i][4]: i for i in kept}
  q = draws(cfg, mix, seed, rec.solves, device, set(solve_of))
  K = generator.intrinsics(mix, device)
  out = {}
  for s, i in solve_of.items():
    _, map_of, pairs, maps = kept[i]
    if maps_of is not None:
      maps = maps_of[i]
    Tr, n_r = ref.solve(_stack(cfg, mix, pairs, maps, device), map_of, K,
                        q[s][1], cfg["ransac"], cfg["pose_stride"], prec)
    out[i] = ((rec.ticks[i][2], rec.ticks[i][3]),
              (Tr.cpu().numpy(), n_r.cpu().numpy()))
  return out


def _disagree(got, B):
  bad = total = 0
  for (Tp, n_p), (Tr, n_r) in got.values():
    for b in range(B):
      total += 1
      bad += check.pose_disagrees(Tp[b], Tr[b], n_p[b], n_r[b])
  return bad / max(total, 1)


def routing(cfg, mix, params, pool, seed, device, prec=ref.REFERENCE):
  """(median top share, mean distinct experts a frame, distinct top
  experts) of every frame of the pool, the reference's gating drawn with
  uniforms from the seed."""
  B, H, _, _, M = _sizes(cfg, mix)
  gen = torch.Generator(device=device).manual_seed(
      generator.camera_seed(seed, 1 << 24))
  tops, distinct, top_e = [], [], set()
  for row in range(pool.shape[0]):
    probs = ref.gate(params, cfg, pool[row].to(device), prec)
    u = torch.rand((B, H), generator=gen, device=device)
    e = ref.draw_experts(probs, u)
    counts = torch.zeros((B, M), device=device).scatter_add_(
        1, e, torch.ones_like(e, dtype=torch.float32))
    tops += (counts.max(1).values / H).tolist()
    distinct += (counts > 0).sum(1).tolist()
    top_e |= set(counts.argmax(1).tolist())
  return float(np.median(tops)), float(np.mean(distinct)), len(top_e)


def compare(cfg, mix, params, pool, rec, seed, device,
            prec=ref.REFERENCE) -> dict:
  """The numbers of a run's record (see the module's docstring)."""
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  rng = np.random.default_rng(generator.camera_seed(seed, 1 << 21))
  checks = mix["checks"]
  B, _, _, _, M = _sizes(cfg, mix)
  out = {}
  with torch.no_grad():
    chosen = check.pick(rng, sorted(rec.kept), checks["step"])
    kept = {i: rec.kept[i][-4:] for i in chosen}
    solve_of = {rec.ticks[i][4]: i for i in chosen}
    got = draws(cfg, mix, seed, rec.solves, device, set(solve_of))
    gate, route, replay, ref_maps, map_rel, pairs_n = [], [], [], {}, [], []
    budget = checks["maps"]
    for s, i in sorted(solve_of.items()):
      probs, map_of, pairs, maps = kept[i]
      frames = pool[rec.ticks[i][0]].to(device)
      pr = ref.gate(params, cfg, frames, prec)
      u = got[s][0]
      e = map_of % M
      gate.append(check.rel(probs, pr))
      route.append(float((ref.draw_experts(pr, u) != e).float().mean()))
      replay.append(float((ref.draw_experts(probs, u) != e).float().mean()))
      pairs_n.append(pairs.numel())
      ref_maps[i] = torch.stack([
          ref.expert(params, cfg, int(p) % M, frames[int(p) // M:
                                                     int(p) // M + 1],
                     prec)[0] for p in pairs.tolist()])
      for x, xr in zip(maps, ref_maps[i]):
        if budget > 0:
          map_rel.append(check.rel(x, xr))
          budget -= 1
    if chosen:
      out["gate_rel"] = max(gate)
      out["route_mismatch"] = max(route)
      out["route_replay_mismatch"] = max(replay)
      out["map_rel"] = max(map_rel)
      out["pairs_per_tick"] = float(np.mean(pairs_n))
    if checks["pose"] and chosen:
      posed = {i: kept[i] for i in chosen[:checks["pose"]]}
      out["pose_mismatch"] = _disagree(
          _resolve(cfg, mix, rec, seed, device, posed, prec), B)
      out["pose_mismatch_ref_maps"] = _disagree(
          _resolve(cfg, mix, rec, seed, device, posed, prec, ref_maps), B)
    (out["top_share_median"], out["experts_per_frame"],
     out["top_experts"]) = routing(cfg, mix, params, pool, seed, device,
                                   prec)
  return out


def failures(cfg, mix, rec, seed, device) -> tuple[int, int]:
  """(answers that are not a finite pose, and of them those where the
  reference solving the same maps with the same draws finds a finite
  one: the answers that failed)."""
  with torch.no_grad():
    got = _resolve(cfg, mix, rec, seed, device, rec.odd, ref.REFERENCE)
  odd = failed = 0
  for (Tp, _), (Tr, _) in got.values():
    for b in range(mix["cameras"]):
      if not np.isfinite(Tp[b]).all():
        odd += 1
        failed += int(np.isfinite(Tr[b]).all())
  return odd, failed


# ---- the control ----------------------------------------------------------


def control(cfg, mix, params, pool, seed, device, ticks: int, frames: int,
            prec=ref.CONTROL) -> loops.Record:
  """``ticks`` ticks of the mix answered by the reference in ``prec`` from
  the window's first tick on, drawing as the program draws."""
  B, H, h, w, M = _sizes(cfg, mix)
  n_pool = pool.shape[0]
  K = generator.intrinsics(mix, device)
  gen = torch.Generator(device=device).manual_seed(seed)
  rec = loops.Record(mix["mode"])
  keep = loops.Reservoir(max(mix["checks"]["step"], mix["checks"]["pose"]),
                         generator.camera_seed(seed, 1 << 22))
  tick = mix["warmup"]
  while not generator.resets(mix, 1, tick)[0].any():
    tick += 1
  prev = None
  slots = M * torch.arange(B, device=device)[:, None]
  with torch.no_grad():
    for i in range(ticks):
      row = tick % n_pool
      reset = generator.resets(mix, 1, tick)[0]
      f = pool[row].to(device)
      probs = ref.gate(params, cfg, f, prec)
      u = torch.rand((B, H), generator=gen, device=device)
      q = torch.empty((B, H, h * w), device=device).exponential_(
          generator=gen)
      map_of = ref.draw_experts(probs, u) + slots
      pairs = torch.unique(map_of)
      maps = torch.stack([ref.expert(params, cfg, int(p) % M,
                                     f[int(p) // M:int(p) // M + 1], prec)[0]
                          for p in pairs.tolist()])
      T, n_in = ref.solve(_stack(cfg, mix, pairs, maps, device), map_of, K,
                          q, cfg["ransac"], cfg["pose_stride"], prec)
      T = T.cpu().numpy()
      rec.ticks.append((row, reset, T, n_in.cpu().numpy(), i))
      cur = (probs, map_of, pairs, maps)
      if reset.any():
        rec.firsts[i] = cur
      if not np.isfinite(T).all():
        rec.odd[i] = cur
      if prev is not None:
        keep.offer(i, prev + cur)
      prev = cur
      tick += 1
  rec.solves = ticks
  rec.kept = keep.items()
  return rec
