"""The control of ``correct``, and the readings its limits come from.

    python3 perfbench/control.py --workload <cell> --seeds 11,12,13 \
        [--program] [--seconds 8]

For each seed it makes the cell's weights and traffic as a run does. With
``--program`` it runs the program as a run does (a window of
``--seconds``) and prints the numbers that the family's ``compare`` reads
from it: the lower readings. Without it, the reference itself takes the
program's place one step lower in precision (the family's ``control``:
``--ticks`` ticks of a serving mix, ``--frames`` frames of an offline
one), and prints the same numbers, judged by the float32 reference: the
upper readings, which the limits must fail. A line of JSON per seed.
Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import os
import sys

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
  sys.path.insert(0, ROOT)

from perfbench import check  # noqa: E402
from perfbench.traffic import generator  # noqa: E402


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
  family = run.load_family(cfg)
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
      params = family.make_weights(cfg, seed, device)
      pool = generator.frames(mix, seed, tuple(cfg["frame"]), device)
      rec = family.control(cfg, mix, params, pool, seed, device, args.ticks,
                           args.frames)
      numbers = family.compare(cfg, mix, params, pool, rec, seed, device)
      del params, pool, rec
      torch.cuda.empty_cache()
    correct, _ = check.judge(numbers, limits, family.NUMBERS)
    print(json.dumps({"workload": cell["name"], "seed": seed,
                      "side": "program" if args.program else "control",
                      "numbers": numbers, "correct": correct}), flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
