"""How ``correct`` is decided for KFNet: the answers of the timed path,
compared with ``reference/kfnet_ref.py`` once the window has closed.

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
  whose pose or inlier count differs (``check.pose_disagrees``).

Each number is the worst over the compared answers drawn from the run's
seed; those a cell compares have their limits in ``limits/<cell>.json``.
A served pose that is not finite is solved again by the reference; where
the reference finds a finite pose, the answer counts as failed.

A record keeps, of a served tick, the posterior (x, P) (``Server.keep``),
and of an offline frame t the chunks' (x_{t-1}, P_{t-1}, x_t, P_t).

The control (``control``): the reference takes the program's place one
step lower in precision (``kfnet_ref.CONTROL``: fp8 trunk convolutions,
TF32 heads and pose) and answers as many ticks or frames as a run does.
"""

from __future__ import annotations

import numpy as np
import torch

from perfbench import check, loops
from perfbench.reference import kfnet_ref as ref
from perfbench.traffic import generator

NUMBERS = ("meas_z_rel", "meas_logV_rms", "step_x_rel", "step_logP_rms",
           "step_x_med", "step_logP_med", "pose_mismatch")


def _frame(pool, row, slot, device):
  return pool[row, slot].to(device)


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
      for i, b in check.pick(rng, firsts, checks["measure"]):
        x, P = rec.firsts[i]
        meas.append(((x[b], P[b]), _frame(pool, ticks[i][0], b, device)))
      later = [(i, b) for i in sorted(rec.kept)
               for b in range(mix["cameras"]) if not ticks[i][1][b]]
      for i, b in check.pick(rng, later, checks["step"]):
        xp, Pp, x, P = rec.kept[i]
        steps.append((xp[b], Pp[b], x[b], P[b],
                      _frame(pool, ticks[i - 1][0], b, device),
                      _frame(pool, ticks[i][0], b, device)))
    out = {}
    if meas:
      zr = [ref.measure(params, cfg, f, prec) for _, f in meas]
      out["meas_z_rel"] = max(check.rel(x, z) for ((x, _), _), (z, _) in
                              zip(meas, zr))
      out["meas_logV_rms"] = max(check.log_rms(P, V) for ((_, P), _), (_, V)
                                 in zip(meas, zr))
    if steps:
      got = {k: [] for k in ("step_x_rel", "step_logP_rms", "step_x_med",
                             "step_logP_med", "step_x_top1_share",
                             "step_logP_top1_share")}
      for xp, Pp, x, P, f0, f1 in steps:
        s = ref.filter_step(params, cfg, xp, Pp, f0, f1, prec)
        got["step_x_rel"].append(check.rel(x, s["x"]))
        got["step_logP_rms"].append(check.log_rms(P, s["P"]))
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
  q = check.draws(seed, shape, rec.solves, device, set(solve_of))
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
  chosen = check.pick(rng, sorted(rec.kept), mix["checks"]["pose"])
  got = _resolve(cfg, mix, rec, seed, device,
                 {i: rec.kept[i][2:] for i in chosen}, prec)
  bad = total = 0
  for (Tp, n_p), (Tr, n_r) in got.values():
    for b in range(mix["cameras"]):
      total += 1
      bad += check.pose_disagrees(Tp[b], Tr[b], n_p[b], n_r[b])
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


# ---- the control ----------------------------------------------------------


def serve_control(cfg, mix, params, pool, seed, device, ticks: int,
                  prec=ref.CONTROL) -> loops.Record:
  """``ticks`` ticks of a serving mix answered by the reference in ``prec``
  from the window's first tick on, as the program answers them."""
  rc, B = cfg["ransac"], mix["cameras"]
  n_pool = pool.shape[0]
  K = generator.intrinsics(mix, device)
  gen = torch.Generator(device=device).manual_seed(seed)
  h, w = (d // 8 for d in cfg["frame"][:2])
  k = min(rc["top_k"], h * w)
  shape = ((B,) if mix["mode"] == "fleet" else ()) + (rc["num_hypotheses"], k)
  rec = loops.Record(mix["mode"])
  keep = loops.Reservoir(max(mix["checks"]["step"], mix["checks"]["pose"]),
                         generator.camera_seed(seed, 1 << 22))
  tick = mix["warmup"]
  while not generator.resets(mix, 1, tick)[0].any():
    tick += 1
  x = P = prev = None
  prev_row = None
  with torch.no_grad():
    for i in range(ticks):
      row = tick % n_pool
      reset = generator.resets(mix, 1, tick)[0]
      xs, Ps = [], []
      for b in range(B):
        frame = pool[row, b].to(device)
        if x is None or reset[b]:
          z, V = ref.measure(params, cfg, frame, prec)
          xs.append(z)
          Ps.append(V)
        else:
          s = ref.filter_step(params, cfg, x[b], P[b],
                              pool[prev_row, b].to(device), frame, prec)
          xs.append(s["x"])
          Ps.append(s["P"])
      x, P = torch.stack(xs), torch.stack(Ps)
      q = torch.empty(shape, dtype=torch.float32,
                      device=device).exponential_(generator=gen)
      T, n_in = ref.solve(x, P, K, q.reshape((B,) + shape[-2:]), rc,
                          cfg["pose_stride"], prec)
      T = T.cpu().numpy()
      rec.ticks.append((row, reset, T, n_in.cpu().numpy(), i))
      cur = (x.clone(), P.clone())
      if reset.any():
        rec.firsts[i] = cur
      if not np.isfinite(T).all():
        rec.odd[i] = cur
      if i:
        keep.offer(i, prev + cur)
      prev, prev_row = cur, row
      tick += 1
  rec.solves = ticks
  rec.kept = keep.items()
  return rec


def offline_control(cfg, mix, params, pool, seed, device, frames: int,
                    prec=ref.CONTROL) -> loops.Record:
  """The first ``frames`` frames of an offline sequence filtered by the
  reference in ``prec``, with the samples a run keeps."""
  picks = set(loops.offline_picks(mix, seed))
  rec = loops.Record(mix["mode"])
  with torch.no_grad():
    x, P = ref.measure(params, cfg, pool[0, 0].to(device), prec)
    rec.samples[(0, 0)] = (x.clone(), P.clone())
    for t in range(1, frames):
      s = ref.filter_step(params, cfg, x, P, pool[t - 1, 0].to(device),
                          pool[t, 0].to(device), prec)
      if t in picks:
        rec.samples[(0, t)] = (x.clone(), P.clone(), s["x"].clone(),
                               s["P"].clone())
      x, P = s["x"], s["P"]
  return rec


def control(cfg, mix, params, pool, seed, device, ticks: int,
            frames: int) -> loops.Record:
  if mix["mode"] == "offline":
    return offline_control(cfg, mix, params, pool, seed, device, frames)
  return serve_control(cfg, mix, params, pool, seed, device, ticks)
