"""The control of ``correct``, and the readings its limits come from.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 \
        [--program] [--seconds 8]

For each seed it makes the cell's weights and traffic as a run does. With
``--program`` it runs the program as a run does (a window of
``--seconds``) and prints the numbers that ``check.py`` reads from it: the
lower readings. Without it, the reference itself takes the program's
place in one step lower precision (``kfnet_ref.CONTROL``: fp8 trunk
convolutions, TF32 heads and pose) over as many answers as a run compares,
and prints the same numbers, judged by the float32 reference: the upper
readings, which the limits must fail. A line of JSON per seed.
Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
  sys.path.insert(0, ROOT)

from perfbench import check, loops, weights  # noqa: E402
from perfbench.reference import kfnet_ref as ref  # noqa: E402
from perfbench.traffic import generator  # noqa: E402


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


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--workload", required=True)
  ap.add_argument("--seeds", required=True)
  ap.add_argument("--program", action="store_true")
  ap.add_argument("--seconds", type=float, default=8.0)
  ap.add_argument("--ticks", type=int, default=300)
  ap.add_argument("--frames", type=int, default=1000)
  args = ap.parse_args(argv)
  from perfbench import run
  run._env()
  bench = run.load_benchmark()
  cell = next(w for w in bench["workloads"] if w["name"] == args.workload)
  cfg = run.load_config(bench, cell["config"])
  mix = generator.load(cell["traffic"])
  limits = check.load_limits(cell["name"])
  if not torch.cuda.is_available():
    print("no CUDA device", file=sys.stderr)
    return 3
  device = torch.device("cuda", 0)
  for seed in (int(s) for s in args.seeds.split(",")):
    if args.program:
      res, _ = run.run_cell(cell, cfg, mix, seed, args.seconds, False, device,
                            limits)
      numbers = res["numbers"]
    else:
      params = weights.make(cfg, seed, device)
      pool = generator.frames(mix, seed, tuple(cfg["frame"]), device)
      if mix["mode"] == "offline":
        rec = offline_control(cfg, mix, params, pool, seed, device,
                              args.frames)
      else:
        rec = serve_control(cfg, mix, params, pool, seed, device, args.ticks)
      numbers = check.compare(cfg, mix, params, pool, rec, seed, device)
      del params, pool, rec
      torch.cuda.empty_cache()
    correct, _ = check.judge(numbers, limits)
    print(json.dumps({"workload": cell["name"], "seed": seed,
                      "side": "program" if args.program else "control",
                      "numbers": numbers, "correct": correct}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
