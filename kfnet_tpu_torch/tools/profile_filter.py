"""Capture and attribute a profile of the full-size filter (port of
``kfnet_tpu/tools/profile_filter.py``): where does a filter step's device
time go?

    python -m kfnet_tpu_torch.tools.profile_filter \
        [--trace_dir DIR] [--report PROFILE_FILTER.json] [--frames 32] \
        [--no_pallas] [--device cuda]

Runs ``filter/sequence.run_filter`` over the flagship at 640x480 (weights
from seed 0, random frames; graphed, as served) three times under
``torch.profiler`` (CUPTI), writes the chrome trace to ``--trace_dir``,
and reads its kernels into a time breakdown: the top self-time kernels,
the conv-class share (cuDNN's convolutions and the port's conv kernels)
against everything else, and the idle fraction of the device between the
first and the last kernel. ``--no_pallas`` selects the warp ∘ Kalman
composition in place of the fused update kernel. The trace is read by
``tools/profile_online.py``'s reader. A trace with no kernels (one taken
with ``--device cpu``) has nothing to attribute, and the summary raises.
``--device`` (``cuda`` unless given; raises without one) is the one flag
the JAX tool lacks.
"""
from __future__ import annotations

import argparse
import collections
import glob
import json
import os
import tempfile
import time

import numpy as np
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch.filter import sequence
from kfnet_tpu_torch.models import kfnet
from kfnet_tpu_torch.tools import profile_online
from kfnet_tpu_torch.utils.timing import sync

TRACE_FILE = "filter.trace.json"
RUNS = 3
# a kernel of the conv class, by a part of its name: cuDNN's convolution
# kernels (implicit GEMM "fprop", xmma) and the port's conv kernels
# (conv3x3_wgmma)
CONV_CLASS = ("conv", "fprop", "implicit_gemm", "xmma", "wgmma")


def capture_trace(trace_dir: str, frames: int = 32, height: int = 480,
                  width: int = 640, use_fused_kernel: bool = True,
                  device=None) -> dict:
  """Profile RUNS calls of run_filter after a warm-up (which captures the
  filter step's graph on the card); the trace goes to
  ``trace_dir/TRACE_FILE``. Returns what the trace does not hold: the
  frame size and the wall ms a run."""
  device = kfnet_tpu_torch.resolve_device(device)
  cfg = kfnet.KFNetConfig(use_fused_kernel=use_fused_kernel)
  params = kfnet.init(0, cfg, (height, width, 3), device=device)
  rng = np.random.default_rng(0)
  images = torch.from_numpy(rng.uniform(
      0, 1, (frames, height, width, 3)).astype(np.float32)).to(device)

  def run():
    return sequence.run_filter(params, cfg, images)[:2]

  sync(run())  # warm-up (and the graph's capture) outside the trace
  # CUPTI's kernels on the card; the CPU's operators elsewhere (a trace
  # with no kernels, which the summary refuses)
  activity = (torch.profiler.ProfilerActivity.CUDA if device.type == "cuda"
              else torch.profiler.ProfilerActivity.CPU)
  with torch.profiler.profile(activities=[activity]) as prof:
    t0 = time.perf_counter()
    for _ in range(RUNS):
      out = run()
    sync(out)
    wall_ms = (time.perf_counter() - t0) * 1e3 / RUNS
  os.makedirs(trace_dir, exist_ok=True)
  prof.export_chrome_trace(os.path.join(trace_dir, TRACE_FILE))
  return {"device": device.type, "height": height, "width": width,
          "frames": frames, "use_fused_kernel": use_fused_kernel,
          "runs": RUNS, "wall_ms_per_run": wall_ms}


def summarize_trace(trace_dir: str, top_k: int = 25, runs: int = RUNS
                    ) -> dict:
  """Read the kernels of the newest trace under ``trace_dir`` into a time
  table (a kernel's self time is its duration: kernels do not nest)."""
  paths = sorted(glob.glob(os.path.join(trace_dir, "**", "*.trace.json"),
                           recursive=True), key=os.path.getmtime)
  if not paths:
    raise FileNotFoundError(f"no *.trace.json under {trace_dir}")
  kernels = [(e["name"], e["ts"], e["dur"])
             for e in profile_online.trace_events(paths[-1], ("kernel",))]
  if not kernels:
    raise ValueError(f"{paths[-1]}: no kernels in the trace")
  self_us = collections.Counter()
  counts = collections.Counter()
  for name, _, us in kernels:
    self_us[name] += us
    counts[name] += 1
  total = sum(self_us.values())
  conv = sum(us for name, us in self_us.items()
             if any(c in name.lower() for c in CONV_CLASS))
  busy = profile_online.summarize(kernels, 1.0, runs)
  ops = [{"name": name, "self_ms_per_run": us / 1e3 / runs,
          "count_per_run": counts[name] / runs, "share": us / total}
         for name, us in self_us.most_common()]
  return {
      "source": paths[-1],
      "device_busy_ms_per_run": busy["device_busy_ms"],
      "idle_fraction": busy["device_idle_share"],
      "self_ms_per_run": total / 1e3 / runs,
      "conv_class_ms_per_run": conv / 1e3 / runs,
      "conv_class_share": conv / total,
      "other_ms_per_run": (total - conv) / 1e3 / runs,
      "own_kernels_per_run": busy["own_kernels_per_call"],
      "ops": ops[:top_k], "n_ops": len(ops)}


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--trace_dir",
                 default=os.path.join(tempfile.gettempdir(), "kfnet_trace"))
  p.add_argument("--report", default="")
  p.add_argument("--frames", type=int, default=32)
  p.add_argument("--no_pallas", action="store_true",
                 help="the warp + Kalman composition in place of the "
                      "fused update kernel")
  p.add_argument("--parse_only", action="store_true",
                 help="summarize an existing trace without re-running")
  p.add_argument("--top_k", type=int, default=25)
  p.add_argument("--device", default=None,
                 help="cuda (the default; raises without one) or cpu")
  args = p.parse_args(argv)
  about = {}
  if not args.parse_only:
    t0 = time.time()
    about = capture_trace(args.trace_dir, frames=args.frames,
                          use_fused_kernel=not args.no_pallas,
                          device=args.device)
    print(f"trace captured in {time.time()-t0:.1f}s -> {args.trace_dir}")
  summary = {**about, **summarize_trace(args.trace_dir, top_k=args.top_k)}
  print(json.dumps(summary["ops"][:10], indent=2, default=str)[:4000])
  if args.report:
    with open(args.report, "w") as f:
      json.dump(summary, f, indent=2, default=str)
    print(f"report -> {args.report}")
  return summary


if __name__ == "__main__":
  main()
