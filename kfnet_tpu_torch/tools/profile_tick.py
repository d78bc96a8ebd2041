"""Attribute the serving tick's latency (port of
``kfnet_tpu/tools/profile_tick.py``), with wall-clock experiments over the
port's ``FleetRelocalizer`` at B streams (4 by default):

  * ``compute_ms``          — device time per tick: N back-to-back ticks
    (``FleetRelocalizer.tick``: enqueued, no host sync between them), one
    sync at the end. This is the latency a host that never waits would
    see.
  * ``roundtrip_floor_ms``  — the floor of syncing any result to the host:
    a trivial op + its (B, 19)-float download, timed the same way a tick
    is.
  * ``tick_ms``             — the end-to-end ``process()`` wall time
    (the filter step, the pose solve, one packed download and the Python
    bookkeeping).
  * ``dispatch_residual_ms`` = tick − compute − roundtrip: host work not
    explained by the two above.

Each is measured for the full tick and a ``solve_pose=False`` fleet, so
the PnP share falls out by difference.

    python -m kfnet_tpu_torch.tools.profile_tick --report PROFILE_TICK.json \
        [--device cuda]

The flagship (weights from seed 0), with the fused update kernel on the
card. ``--device`` (``cuda`` unless given; raises without one) is the one
flag the JAX tool lacks.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch.eval.online import FleetRelocalizer
from kfnet_tpu_torch.models import kfnet


def _median_ms(fn, k=5, reps=3):
  fn()  # warm
  times = []
  for _ in range(k):
    t0 = time.perf_counter()
    for _ in range(reps):
      fn()
    times.append((time.perf_counter() - t0) / reps)
  return 1e3 * float(np.median(times))


def measure_fleet(params, cfg, K, images, solve_pose: bool, chain_n=16,
                  device=None):
  fleet = FleetRelocalizer(params, cfg, K, batch_size=images.shape[0],
                           solve_pose=solve_pose, device=device)
  fleet.process(images)  # first tick
  fleet.process(images)  # the tick that captures the filter step's graph

  # end-to-end tick: the step, the solve and ONE packed download a call
  tick_ms = _median_ms(lambda: fleet.process(images))

  # pipelined device compute: enqueue ticks with no host sync until the
  # end, so the per-tick time converges to the device's own tick cost
  def chain(n):
    packed = None
    for _ in range(n):
      packed = fleet.tick(images)
    return packed

  chain(2).cpu()  # warm
  times = []
  for _ in range(5):
    t0 = time.perf_counter()
    packed = chain(chain_n)
    packed.cpu()  # single sync for the whole chain
    times.append((time.perf_counter() - t0) / chain_n)
  compute_ms = 1e3 * float(np.median(times))
  return tick_ms, compute_ms


def roundtrip_floor_ms(batch: int = 4, device=None):
  """Enqueue + tiny download of a trivial op — the irreducible per-tick
  cost of syncing ANY result to this host."""
  device = kfnet_tpu_torch.resolve_device(device)
  x = torch.zeros((batch, 19), dtype=torch.float32, device=device)
  (x + 1.0).cpu()
  return _median_ms(lambda: (x + 1.0).cpu().numpy(), k=7, reps=10)


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--batch", type=int, default=4)
  p.add_argument("--height", type=int, default=480)
  p.add_argument("--width", type=int, default=640)
  p.add_argument("--report", default="")
  p.add_argument("--device", default=None,
                 help="cuda (the default; raises without one) or cpu")
  args = p.parse_args(argv)
  device = kfnet_tpu_torch.resolve_device(args.device)

  cfg = kfnet.KFNetConfig(use_fused_kernel=device.type == "cuda")
  params = kfnet.init(0, cfg, (args.height, args.width, 3), device=device)
  K = np.asarray([[585.0, 0.0, args.width / 2.0 - 0.5],
                  [0.0, 585.0, args.height / 2.0 - 0.5],
                  [0.0, 0.0, 1.0]], np.float32)
  rng = np.random.default_rng(0)
  images = torch.from_numpy(rng.uniform(
      0, 1, (args.batch, args.height, args.width, 3)).astype(np.float32)
                            ).to(device)

  floor = roundtrip_floor_ms(args.batch, device)
  tick_full, compute_full = measure_fleet(params, cfg, K, images, True,
                                          device=device)
  tick_nopose, compute_nopose = measure_fleet(params, cfg, K, images, False,
                                              device=device)

  report = {
      "batch": args.batch, "height": args.height, "width": args.width,
      "backend": device.type,
      "roundtrip_floor_ms": round(floor, 2),
      "tick_ms": round(tick_full, 2),
      "tick_ms_no_pose": round(tick_nopose, 2),
      "compute_ms": round(compute_full, 2),
      "compute_ms_no_pose": round(compute_nopose, 2),
      "pnp_compute_ms": round(compute_full - compute_nopose, 2),
      "dispatch_residual_ms": round(
          max(0.0, tick_full - compute_full - floor), 2),
      "aggregate_fps": round(1e3 * args.batch / tick_full, 1),
      "pipelined_aggregate_fps": round(1e3 * args.batch / compute_full, 1),
      "note": "compute_ms enqueues ticks with no host sync — the latency "
              "a host that never waits would see; roundtrip_floor_ms is "
              "this host's cost per synced tick",
  }
  print(json.dumps(report, indent=2))
  if args.report:
    with open(args.report, "w") as f:
      json.dump(report, f, indent=2)
  return report


if __name__ == "__main__":
  main()
