"""``eval.benchmark.run`` with the serving ticks, in the default and the
conv-kernel configuration (640x480, weights and frames from seed 0), one
JSON line each with the card's name and power limit. It calls only what
the port had before its fleet (the fleet's rows are in the line where the
checkout has them), so the same file times an older checkout too:

    PYTHONPATH=<checkout> python kfnet_tpu_torch/tools/bench_configs.py

Appends the lines to ``--out`` (``chiprun_out/bench_configs.jsonl``) with
``--tag`` and the package's path beside them. On the card unless
``--device cpu``.
"""

from __future__ import annotations

import argparse
import json
import os

import kfnet_tpu_torch
from kfnet_tpu_torch import bench
from kfnet_tpu_torch.eval import benchmark
from kfnet_tpu_torch.models import kfnet


def run_all(device=None, height: int = 480, width: int = 640,
            frames: int = 32, config: kfnet.KFNetConfig | None = None,
            tag: str = "", reps: int = 3) -> list[dict]:
  """One ``benchmark.run(..., tick=True)`` row per configuration."""
  device = kfnet_tpu_torch.resolve_device(device)
  cfg = config or kfnet.KFNetConfig()
  gpu, limit = (bench.gpu_name_and_power_limit() if device.type == "cuda"
                else (None, None))
  rows = []
  for name, c in (("default", cfg),
                  ("conv_kernels", bench.conv_kernel_config(cfg))):
    row = benchmark.run(height, width, frames, c, reps=reps, tick=True,
                        device=device)
    rows.append({"tag": tag, "config": name,
                 "package": os.path.dirname(kfnet_tpu_torch.__file__),
                 "power_limit": limit, **row, "gpu": gpu})
  return rows


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--device", default=None)
  p.add_argument("--tag", default="")
  p.add_argument("--out", default=os.path.join("chiprun_out",
                                               "bench_configs.jsonl"))
  args = p.parse_args(argv)
  rows = run_all(args.device, tag=args.tag)
  os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
  with open(args.out, "a") as f:
    for row in rows:
      f.write(json.dumps(row) + "\n")
  for row in rows:
    print(json.dumps(row), flush=True)


if __name__ == "__main__":
  main()
