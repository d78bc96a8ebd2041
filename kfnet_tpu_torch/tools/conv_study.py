"""Re-measure the conv kernels end to end per trunk norm (port of
``kfnet_tpu/tools/conv_study.py``).

Runs the headline timing protocol (``eval/benchmark.filter_fps``, the
timing ``kfnet_tpu_torch.bench`` uses) for every (norm, conv_impl) cell of
SCoordNet, so the conv-kernel verdict is measured under each trunk norm.
On the card the cells ``pallas_3x3`` and ``pallas_fused`` run the port's
conv kernels (``kernels/conv3x3.py``: ``conv3x3_same`` on the eligible
convs; the ``conv3x3_gn_chain`` trunk, GroupNorm only), and every cell
runs the fused update kernel.

    python -m kfnet_tpu_torch.tools.conv_study --report CONV_STUDY.json \
        [--device cuda]

The MFU is the analytic FLOP count over the card's dense bf16 peak
(``eval/flops.peak_flops``); null on a device with no known peak (the
CPU). ``--device`` (``cuda`` unless given; raises without one) is the one
flag the JAX tool lacks.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch.eval import benchmark
from kfnet_tpu_torch.eval import flops as flops_lib
from kfnet_tpu_torch.models import kfnet


def cell_config(norm: str, conv_impl: str, use_fused_kernel: bool):
  cfg = kfnet.KFNetConfig(use_fused_kernel=use_fused_kernel)
  return dataclasses.replace(
      cfg, scoordnet=dataclasses.replace(cfg.scoordnet, norm=norm,
                                         conv_impl=conv_impl))


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--norms", default="none,group,ws")
  p.add_argument("--impls", default="xla,pallas_3x3")
  p.add_argument("--frames", type=int, default=32)
  p.add_argument("--height", type=int, default=480)
  p.add_argument("--width", type=int, default=640)
  p.add_argument("--report", default="")
  p.add_argument("--device", default=None,
                 help="cuda (the default; raises without one) or cpu")
  args = p.parse_args(argv)
  device = kfnet_tpu_torch.resolve_device(args.device)

  on_card = device.type == "cuda"
  rng = np.random.default_rng(0)
  imgs = torch.from_numpy(rng.uniform(
      0, 1, (args.frames, args.height, args.width, 3)).astype(np.float32)
                          ).to(device)
  peak = flops_lib.peak_flops(device)

  rows = []
  for norm in args.norms.split(","):
    for impl in args.impls.split(","):
      if impl == "pallas_fused" and norm != "group":
        continue  # rejected at build time by design (scoordnet._layer_list)
      cfg = cell_config(norm, impl, on_card)
      params = kfnet.init(0, cfg, tuple(imgs.shape[1:]), device=device)
      fps = benchmark.filter_fps(cfg, params, imgs)
      fpf = flops_lib.filter_step_flops(cfg, args.height, args.width)
      row = {"norm": norm, "conv_impl": impl, "fps": round(fps, 2),
             "mfu": None if peak is None else round(fpf * fps / peak, 4)}
      rows.append(row)
      print(json.dumps(row), flush=True)
      del params

  out = {"backend": device.type, "height": args.height,
         "width": args.width, "frames": args.frames, "rows": rows}
  if args.report:
    with open(args.report, "w") as f:
      json.dump(out, f, indent=2)
  return out


if __name__ == "__main__":
  main()
