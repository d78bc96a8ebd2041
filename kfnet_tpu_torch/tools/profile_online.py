"""Where a served frame's time goes on the card: device busy share, kernel
count and the heaviest kernels of ``OnlineRelocalizer.process`` at full
width (640x480, default KFNetConfig, weights from a seed), for the whole
frame, the filter step alone and the pose solve alone, plus the fused
warp + Kalman kernel's device time.

    python -m kfnet_tpu_torch.tools.profile_online [--frames 4]

Prints one JSON line. Device times come from a torch.profiler (CUPTI)
trace; wall times from the host clock around synchronised runs.
"""

from __future__ import annotations

import argparse
import collections
import itertools
import json
import os
import subprocess
import tempfile
import time

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile

from kfnet_tpu_torch.eval.online import OnlineRelocalizer
from kfnet_tpu_torch.kernels import fused_filter
from kfnet_tpu_torch.models import kfnet
from kfnet_tpu_torch.pose import ransac


def trace_kernels(fn, n):
  """(name, start us, duration us) of the kernels run by n calls of fn,
  and the wall ms per call."""
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for _ in range(n):
      fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
  with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
      events = json.load(f)["traceEvents"]
  return [(e["name"], e["ts"], e["dur"]) for e in events
          if e.get("cat") == "kernel"], wall_ms


def summarize(kernels, wall_ms, n):
  spans = sorted((ts, ts + dur) for _, ts, dur in kernels)
  busy, (s0, e0) = 0.0, spans[0]
  for s, e in spans[1:]:
    if s > e0:
      busy, s0, e0 = busy + e0 - s0, s, e
    else:
      e0 = max(e0, e)
  busy += e0 - s0
  by_name = collections.Counter()
  for name, _, dur in kernels:
    by_name[name[:70]] += dur
  return {"wall_ms": wall_ms,
          "device_busy_ms": busy / 1e3 / n,
          "device_idle_share": 1.0 - busy / (spans[-1][1] - spans[0][0]),
          "kernels_per_call": len(kernels) / n,
          "top_kernels_ms": {k: v / 1e3 / n
                             for k, v in by_name.most_common(6)}}


def main():
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--frames", type=int, default=4)
  ap.add_argument("--seed", type=int, default=0)
  args = ap.parse_args()
  dev = torch.device("cuda")
  cfg = kfnet.KFNetConfig()
  params = kfnet.init(args.seed, cfg, device=dev)
  K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]], np.float32)
  frames = np.random.default_rng(args.seed).integers(
      0, 256, (8, 480, 640, 3), dtype=np.uint8)
  it = itertools.cycle(frames)
  full = OnlineRelocalizer(params, cfg, K, device=dev)
  nopose = OnlineRelocalizer(params, cfg, K, device=dev, solve_pose=False)
  for f in frames[:2]:
    full.process(f)
    nopose.process(f)
  n = args.frames
  out = {"gpu": torch.cuda.get_device_name(0), "torch": torch.__version__}
  try:
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=20).stdout.strip()
  except (OSError, subprocess.TimeoutExpired) as e:
    out["nvidia_smi"] = f"failed: {e}"
  rng = np.random.default_rng(0)
  fargs = [torch.as_tensor(rng.uniform(0.1, 1.0, (60, 80, c)).astype(
      np.float32), device=dev) for c in (3, 1, 2, 1, 3, 1)]
  kernels, _ = trace_kernels(lambda: fused_filter.fused_warp_kalman(
      *fargs, radius=4, threshold=cfg.chi2_threshold), 200)
  ours = [d for name, _, d in kernels if "fused_warp_kalman" in name]
  out["fused_kernel_device_ms"] = (sum(ours) / len(ours) / 1e3
                                   if ours else "not measured")
  out["process"] = summarize(*trace_kernels(
      lambda: full.process(next(it)), n), n)
  out["filter_step_only"] = summarize(*trace_kernels(
      lambda: nopose.process(next(it)), n), n)
  x, P = full.state[:2]
  ones = torch.ones_like(P, dtype=torch.bool)
  Kd = torch.as_tensor(K, device=dev)
  gen = torch.Generator(device=dev).manual_seed(args.seed)
  out["pose_solve_only"] = summarize(*trace_kernels(
      lambda: ransac.solve_pnp_from_maps(x, P, ones, Kd, gen), n), n)
  print(json.dumps(out), flush=True)


if __name__ == "__main__":
  main()
