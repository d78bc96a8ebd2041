"""How ``correct`` is decided: the answers of the timed path, compared with
``reference/kfnet_ref.py`` once the window has closed.

* First frames: a frame that starts a track (a reset, an offline
  sequence's frame 0) has the measurement (z, V) as its posterior.
  ``meas_z_rel`` is ||x - z_ref|| / ||z_ref|| over the map, and
  ``meas_logV_rms`` the root mean square of log P - log V_ref.
* Filter steps: the reference takes the program's posterior of the frame
  before (the one state it follows the program in) and the two raw frames,
  works out flow, process noise, cost volume, measurement, warp and update
  anew, and compares the posterior: ``step_x_rel`` and ``step_logP_rms``,
  as above, and ``step_x_med`` / ``step_logP_med``, the same over the
  median pixel (steady where a few pixels whose χ² test or warp validity
  flips carry most of the error; ``step_*_top1_share`` is the share the
  worst 1% of pixels carry, printed, not compared).
* Poses (serving): the reference solves the program's posterior maps with
  the same draws (a generator seeded as the program's, drawn once per
  solve in the same order), and ``pose_mismatch`` is the share of solves
  whose pose or inlier count differs (rotation over 0.5 degrees, camera
  centre over 0.5% of its distance to the origin, at least 1 unit, or
  inliers by more than 2).

Each number is the worst over the compared answers drawn from the run's
seed; those a cell compares have their limits in ``limits/<cell>.json``.
A served pose that is not finite is solved again by the reference; where
the reference finds a finite pose, the answer counts as failed.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

from perfbench.reference import kfnet_ref as ref
from perfbench.traffic import generator

HERE = os.path.dirname(os.path.abspath(__file__))
NUMBERS = ("meas_z_rel", "meas_logV_rms", "step_x_rel", "step_logP_rms",
           "step_x_med", "step_logP_med", "pose_mismatch")


def load_limits(cell: str) -> dict:
  path = os.path.join(HERE, "limits", f"{cell}.json")
  with open(path) as f:
    return json.load(f)


def rel(a, r) -> float:
  return float(torch.linalg.norm(a - r) / torch.clamp_min(
      torch.linalg.norm(r), 1e-30))


def log_rms(a, r) -> float:
  d = torch.log(torch.clamp_min(a, 1e-30)) - torch.log(torch.clamp_min(r,
                                                                       1e-30))
  return float(torch.sqrt(torch.mean(d * d)))


def _frame(pool, row, slot, device):
  return pool[row, slot].to(device)


def _pick(rng, items, n):
  if len(items) <= n:
    return list(items)
  return [items[i] for i in sorted(rng.choice(len(items), n, replace=False))]


def draws(seed: int, shape, n: int, device, wanted):
  """The Exp(1) keys of solves ``wanted`` (indices) of a generator seeded
  with ``seed`` that draws one (shape) block per solve, ``n`` solves."""
  gen = torch.Generator(device=device).manual_seed(seed)
  out = {}
  last = max(wanted) if wanted else -1
  for i in range(min(n, last + 1)):
    q = torch.empty(shape, dtype=torch.float32,
                    device=device).exponential_(generator=gen)
    if i in wanted:
      out[i] = q
  return out


def pose_disagrees(Tp, Tr, n_p, n_r) -> bool:
  Rp, Rr = Tp[:3, :3], Tr[:3, :3]
  cos = np.clip((np.trace(Rp.T @ Rr) - 1.0) / 2.0, -1.0, 1.0)
  angle = math.degrees(math.acos(cos))
  cp, cr = Tp[:3, 3], Tr[:3, 3]
  dist = np.linalg.norm(cp - cr) / max(1.0, np.linalg.norm(cr))
  ok = (np.isfinite(Tp).all() and angle <= 0.5 and dist <= 5e-3
        and abs(float(n_p) - float(n_r)) <= 2)
  return not ok


def compare(cfg, mix, params, pool, rec, seed, device,
            prec=ref.REFERENCE) -> dict:
  """The numbers of a run's record (see the module's docstring)."""
  torch.backends.cuda.matmul.allow_tf32 = False
  torch.backends.cudnn.allow_tf32 = False
  rng = np.random.default_rng(generator.camera_seed(seed, 1 << 21))
  checks = mix["checks"]
  meas, steps = [], []
  with torch.no_grad():
    if rec.mode == "offline":
      firsts = sorted(k for k in rec.samples if k[1] == 0)
      for key in firsts[:checks["measure"]]:
        meas.append((rec.samples[key], _frame(pool, 0, 0, device)))
      for key in sorted(k for k in rec.samples if k[1] > 0)[
          :2 * checks["step"]]:
        xp, Pp, x, P = rec.samples[key]
        t = key[1]
        steps.append((xp, Pp, x, P, _frame(pool, t - 1, 0, device),
                      _frame(pool, t, 0, device)))
    else:
      ticks = rec.ticks
      firsts = [(i, b) for i in sorted(rec.firsts)
                for b in np.flatnonzero(ticks[i][1])]
      for i, b in _pick(rng, firsts, checks["measure"]):
        x, P = rec.firsts[i]
        meas.append(((x[b], P[b]), _frame(pool, ticks[i][0], b, device)))
      later = [(i, b) for i in sorted(rec.kept)
               for b in range(mix["cameras"]) if not ticks[i][1][b]]
      for i, b in _pick(rng, later, checks["step"]):
        xp, Pp, x, P = rec.kept[i]
        steps.append((xp[b], Pp[b], x[b], P[b],
                      _frame(pool, ticks[i - 1][0], b, device),
                      _frame(pool, ticks[i][0], b, device)))
    out = {}
    if meas:
      zr = [ref.measure(params, cfg, f, prec) for _, f in meas]
      out["meas_z_rel"] = max(rel(x, z) for ((x, _), _), (z, _) in
                              zip(meas, zr))
      out["meas_logV_rms"] = max(log_rms(P, V) for ((_, P), _), (_, V) in
                                 zip(meas, zr))
    if steps:
      got = {k: [] for k in ("step_x_rel", "step_logP_rms", "step_x_med",
                             "step_logP_med", "step_x_top1_share",
                             "step_logP_top1_share")}
      for xp, Pp, x, P, f0, f1 in steps:
        s = ref.filter_step(params, cfg, xp, Pp, f0, f1, prec)
        got["step_x_rel"].append(rel(x, s["x"]))
        got["step_logP_rms"].append(log_rms(P, s["P"]))
        ex = torch.sum((x - s["x"]) ** 2, -1).flatten()
        eP = ((torch.log(torch.clamp_min(P, 1e-30))
               - torch.log(torch.clamp_min(s["P"], 1e-30))) ** 2).flatten()
        xr = torch.sqrt(torch.mean(torch.sum(s["x"] ** 2, -1)))
        got["step_x_med"].append(float(torch.sqrt(torch.median(ex)) / xr))
        got["step_logP_med"].append(float(torch.sqrt(torch.median(eP))))
        for key, e in (("step_x_top1_share", ex), ("step_logP_top1_share",
                                                    eP)):
          worst = torch.sort(e, descending=True).values[:max(1, e.numel()
                                                              // 100)]
          got[key].append(float(worst.sum() / torch.clamp_min(e.sum(),
                                                              1e-30)))
      for k, v in got.items():
        out[k] = max(v)
    if rec.mode != "offline" and checks["pose"]:
      out["pose_mismatch"] = _poses(cfg, mix, rec, seed, device, rng, prec)
  return out


def _resolve(cfg, mix, rec, seed, device, maps: dict, prec):
  """{tick: (program's (T_wc, inliers), reference's)} of the ticks whose
  (x, P) ``maps`` holds, solved again with the same draws."""
  rc = cfg["ransac"]
  B = mix["cameras"]
  if not maps:
    return {}
  x0 = next(iter(maps.values()))[0]
  n = x0.shape[1] * x0.shape[2]
  shape = ((B,) if mix["mode"] == "fleet" else ()) + (
      rc["num_hypotheses"], min(rc["top_k"], n))
  solve_of = {rec.ticks[i][4]: i for i in maps}
  q = draws(seed, shape, rec.solves, device, set(solve_of))
  K = generator.intrinsics(mix, device)
  out = {}
  for s, i in solve_of.items():
    x, P = maps[i]
    Tr, n_r = ref.solve(x, P, K, q[s].reshape((B,) + q[s].shape[-2:]), rc,
                        cfg["pose_stride"], prec)
    out[i] = ((rec.ticks[i][2], rec.ticks[i][3]),
              (Tr.cpu().numpy(), n_r.cpu().numpy()))
  return out


def _poses(cfg, mix, rec, seed, device, rng, prec):
  chosen = _pick(rng, sorted(rec.kept), mix["checks"]["pose"])
  got = _resolve(cfg, mix, rec, seed, device,
                 {i: rec.kept[i][2:] for i in chosen}, prec)
  bad = total = 0
  for (Tp, n_p), (Tr, n_r) in got.values():
    for b in range(mix["cameras"]):
      total += 1
      bad += pose_disagrees(Tp[b], Tr[b], n_p[b], n_r[b])
  return bad / max(total, 1)


def failures(cfg, mix, rec, seed, device) -> tuple[int, int]:
  """(answers that are not a finite pose, and of them those where the
  reference solving the same maps with the same draws finds a finite
  one: the answers that failed)."""
  got = _resolve(cfg, mix, rec, seed, device, rec.odd, ref.REFERENCE)
  odd = failed = 0
  for (Tp, _), (Tr, _) in got.values():
    for b in range(mix["cameras"]):
      if not np.isfinite(Tp[b]).all():
        odd += 1
        failed += int(np.isfinite(Tr[b]).all())
  return odd, failed


def judge(numbers: dict, limits: dict) -> tuple[bool, dict]:
  """(correct, {name: {"value", "limit"}}): every number compared is
  finite and within its limit, and every limited number was read."""
  shown, ok = {}, True
  for name in NUMBERS:
    if name not in limits:
      continue
    v = numbers.get(name)
    lim = limits[name]["limit"]
    shown[name] = {"value": v, "limit": lim}
    if v is None or not math.isfinite(v) or v > lim:
      ok = False
  return ok, shown
