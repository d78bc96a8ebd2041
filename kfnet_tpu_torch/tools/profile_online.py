"""Where a served frame's time goes on the card: device busy share, kernel
count and the heaviest kernels of ``OnlineRelocalizer.process`` at full
width (640x480, default KFNetConfig, weights from a seed), for the whole
frame, the filter step alone (as served: one CUDA graph replayed a frame;
and eagerly, ``graph=False``, beside it, with the kernels by name whose
counts differ between the two) and the pose solve alone, plus
the fused update's device time and the filter step's host ms a frame (the
enqueue, without the profiler), graphed and eager.

    python -m kfnet_tpu_torch.tools.profile_online [--frames 4] [--conv-kernels]

``--conv-kernels`` profiles the conv-kernel configuration instead of the
default one: SCoordNet ``conv_impl="pallas_fused"`` and OFlowNet
``"pallas_3x3"``, whose convs run the CUDA kernels of ``kernels/conv3x3.py``.

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
from kfnet_tpu_torch.models import kfnet, oflownet, scoordnet
from kfnet_tpu_torch.pose import ransac

# the port's own kernels, by a part of their names in the trace
OWN_KERNELS = ("fused_filter_kernel", "conv3x3_wgmma", "moments_kernel",
               "split_sum_kernel")


# a trace's device work: kernels, and the copies and fills that run on the
# copy engines (a CUDA graph runs the same as memcpy / memset kernels)
COPIES = ("gpu_memcpy", "gpu_memset")


def trace_kernels(fn, n, copies=False):
  """(name, start us, duration us) of the kernels run by n calls of fn,
  with ``copies`` also of its copies and fills (named "[gpu_memcpy] ..."
  and "[gpu_memset] ..."), and the wall ms per call."""
  fn()
  torch.cuda.synchronize()
  with profile(activities=[ProfilerActivity.CUDA]) as prof:
    t0 = time.perf_counter()
    for _ in range(n):
      fn()
    torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3 / n
  return profiled_kernels(prof, copies), wall_ms


def profiled_kernels(prof, copies=False):
  """(name, start us, duration us) of the kernels in the finished trace
  of ``prof``, with ``copies`` also of its copies and fills."""
  with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "trace.json")
    prof.export_chrome_trace(path)
    events = trace_events(path, ("kernel",) + (COPIES if copies else ()))
  return [(e["name"] if e["cat"] == "kernel" else f"[{e['cat']}] {e['name']}",
           e["ts"], e["dur"]) for e in events]


def trace_events(path, categories):
  """The events of ``categories`` in the chrome trace at ``path`` (as
  ``export_chrome_trace`` writes it), as dicts."""
  with open(path) as f:
    events = json.load(f)["traceEvents"]
  return [e for e in events if e.get("cat") in categories]


def host_ms(tick, n):
  """Mean host ms of ``tick()`` (the enqueue; each result waited for
  outside the timed span)."""
  total = 0.0
  for _ in range(n):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = tick()
    total += time.perf_counter() - t0
    res.cpu()
  return total * 1e3 / n


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
  own = {k: [d for name, _, d in kernels if k in name] for k in OWN_KERNELS}
  return {"wall_ms": wall_ms,
          "device_busy_ms": busy / 1e3 / n,
          "device_idle_share": 1.0 - busy / (spans[-1][1] - spans[0][0]),
          "kernels_per_call": len(kernels) / n,
          "own_kernels_per_call": {k: len(v) / n for k, v in own.items()},
          "own_kernels_device_ms": {k: sum(v) / 1e3 / n
                                    for k, v in own.items()},
          "top_kernels_ms": {k: v / 1e3 / n
                             for k, v in by_name.most_common(6)}}


def kernel_count_diff(kernels_a, kernels_b, n):
  """Per name, the launches a call of a makes minus those of b (names
  whose counts differ only), over n calls each."""
  a = collections.Counter(name[:120] for name, _, _ in kernels_a)
  b = collections.Counter(name[:120] for name, _, _ in kernels_b)
  return {k: (a[k] - b[k]) / n for k in sorted(set(a) | set(b))
          if a[k] != b[k]}


def main():
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--frames", type=int, default=4)
  ap.add_argument("--seed", type=int, default=0)
  ap.add_argument("--conv-kernels", action="store_true",
                  help="SCoordNet pallas_fused + OFlowNet pallas_3x3")
  args = ap.parse_args()
  dev = torch.device("cuda")
  cfg = kfnet.KFNetConfig()
  if args.conv_kernels:
    cfg = kfnet.KFNetConfig(
        scoordnet=scoordnet.SCoordNetConfig(conv_impl="pallas_fused"),
        oflownet=oflownet.OFlowNetConfig(conv_impl="pallas_3x3"))
  params = kfnet.init(args.seed, cfg, device=dev)
  K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]], np.float32)
  frames = np.random.default_rng(args.seed).integers(
      0, 256, (8, 480, 640, 3), dtype=np.uint8)
  it = itertools.cycle(frames)
  full = OnlineRelocalizer(params, cfg, K, device=dev)
  nopose = {mode: OnlineRelocalizer(params, cfg, K, device=dev,
                                    solve_pose=False, graph=mode == "graph")
            for mode in ("graph", "eager")}
  for f in frames[:2]:
    full.process(f)
    for rl in nopose.values():
      rl.process(f)
  n = args.frames
  out = {"gpu": torch.cuda.get_device_name(0), "torch": torch.__version__,
         "config": "conv_kernels" if args.conv_kernels else "default"}
  try:
    out["nvidia_smi"] = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=20).stdout.strip()
  except (OSError, subprocess.TimeoutExpired) as e:
    out["nvidia_smi"] = f"failed: {e}"
  rng = np.random.default_rng(0)
  heads = [torch.as_tensor(rng.uniform(-1.0, 1.0, (60, 80, c)).astype(
      np.float32), device=dev) for c in (3, 4)]
  state = [torch.as_tensor(rng.uniform(0.1, 1.0, (60, 80, c)).astype(
      np.float32), device=dev) for c in (3, 1)]
  kernels, _ = trace_kernels(lambda: fused_filter.fused_filter_step(
      *heads, *state, radius=4, w_scale=cfg.w_scale, coord_scale=1.0,
      coord_offset=(0.0, 0.0, 0.0), log_w_clip=oflownet.LOG_VAR_CLIP,
      log_v_clip=scoordnet.LOG_VAR_CLIP, threshold=cfg.chi2_threshold), 200)
  ours = [d for name, _, d in kernels if "fused_filter_kernel" in name]
  out["fused_kernel_device_ms"] = (sum(ours) / len(ours) / 1e3
                                   if ours else "not measured")
  out["process"] = summarize(*trace_kernels(
      lambda: full.process(next(it)), n), n)
  traces = {mode: trace_kernels(lambda rl=rl: rl.process(next(it)), n,
                                copies=True)
            for mode, rl in nopose.items()}
  kernels_of = lambda ev: [e for e in ev if not e[0].startswith("[gpu_mem")]
  for mode, key in (("graph", "filter_step_only"),
                    ("eager", "filter_step_only_eager")):
    out[key] = summarize(kernels_of(traces[mode][0]), traces[mode][1], n)
  # the kernels, copies and fills a replay runs that the eager step does
  # not (positive), and back (negative)
  out["filter_step_graph_minus_eager"] = kernel_count_diff(
      traces["graph"][0], traces["eager"][0], n)
  # the profiler sees the kernels a replay runs, or it sees none of them
  out["graph_kernels_traced"] = (
      out["filter_step_only"]["kernels_per_call"] > 1)
  out["filter_step_host_ms"] = {
      mode: host_ms(lambda rl=rl: rl.tick(next(it)), n)
      for mode, rl in nopose.items()}
  x, P = full.state[:2]
  ones = torch.ones_like(P, dtype=torch.bool)
  Kd = torch.as_tensor(K, device=dev)
  gen = torch.Generator(device=dev).manual_seed(args.seed)
  out["pose_solve_only"] = summarize(*trace_kernels(
      lambda: ransac.solve_pnp_from_maps(x, P, ones, Kd, gen), n), n)
  print(json.dumps(out), flush=True)


if __name__ == "__main__":
  main()
