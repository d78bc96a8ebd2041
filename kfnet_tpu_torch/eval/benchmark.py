"""Throughput benchmarking (port of ``kfnet_tpu/eval/benchmark.py``):
per-stage and end-to-end frames per second with an honest device sync
(``utils/timing.sync``), on the card unless ``--device cpu``.

    python -m kfnet_tpu_torch.eval.benchmark [--frames 32] [--height 480] ...

Stage times (``scoordnet_ms``, ``oflownet_encode_ms``,
``costvolume_decode_ms``) are eager calls on one frame; the sequence
figures run ``filter.sequence``, whose filter steps replay as CUDA graphs
on the card.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import time

import numpy as np
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch.utils.timing import sync


def bench_fn(fn, args, reps: int = 10) -> float:
  """Wall seconds per call of ``fn(*args)`` over ``reps`` calls after one
  warm-up call, the last call's outputs synced."""
  out = fn(*args)
  sync(out)
  t0 = time.perf_counter()
  for _ in range(reps):
    out = fn(*args)
  sync(out)
  return (time.perf_counter() - t0) / reps


def filter_fps(cfg, params, images, reps: int = 3, k: int = 3) -> float:
  """The headline timing protocol (the JAX package's ``aot_filter_fps``):
  one warm-up ``run_filter`` call, which captures the filter step's graph
  on the card and is synced, then the median of ``k`` batches of ``reps``
  calls, each batch ending in ``sync``. Returns frames per second."""
  from kfnet_tpu_torch.filter import sequence

  def run():
    return sequence.run_filter(params, cfg, images)[:2]

  sync(run())
  times = []
  for _ in range(k):
    t0 = time.perf_counter()
    for _ in range(reps):
      out = run()
    sync(out)
    times.append((time.perf_counter() - t0) / reps)
  return images.shape[0] / float(np.median(times))


def e2e_pose_fps(cfg, params, images, K, reps: int = 3) -> float:
  """Frames per second of the whole pipeline, the filter and the batched
  pose solve of every frame: what a user gets from ``evaluate_sequence``
  per frame, poses included (``bench_fn`` over ``reps`` calls)."""
  from kfnet_tpu_torch.eval import eval_sequence
  from kfnet_tpu_torch.filter import sequence

  solve = eval_sequence.make_pose_solver(K)
  gen = torch.Generator(device=images.device)

  def run_with_pose(im):
    xs, Ps = sequence.run_filter(params, cfg, im)[:2]
    return solve(xs, Ps, gen.manual_seed(0))["T_wc"]

  return images.shape[0] / bench_fn(run_with_pose, (images,), reps=reps)


def streaming_fps(cfg, params, frame_list, chunk: int = 32,
                  k: int = 3) -> float:
  """Frames per second of the chunked filter over ``frame_list``: one
  warm-up pass (captures for the frames' type), then the median of ``k``
  passes, each ending in ``sync`` of the last chunk."""
  from kfnet_tpu_torch.filter import sequence

  def stream_once():
    n, last = 0, None
    for xs, _ in sequence.run_filter_chunked_arrays(params, cfg, frame_list,
                                                    chunk_size=chunk):
      n, last = n + xs.shape[0], xs
    sync(last)
    return n

  stream_once()
  times = []
  for _ in range(k):
    t0 = time.perf_counter()
    n = stream_once()
    times.append(time.perf_counter() - t0)
  return n / float(np.median(times))


def tick_ms(reloc, frame, warm: int = 2, k: int = 3, reps: int = 5) -> float:
  """The online tick protocol: ``warm`` ticks (capture and settle), then the
  median of ``k`` batches of ``reps`` ``process()`` calls, each of which
  ends in its one result copy. Returns ms a tick."""
  for _ in range(warm):
    reloc.process(frame)
  times = []
  for _ in range(k):
    t0 = time.perf_counter()
    for _ in range(reps):
      reloc.process(frame)
    times.append((time.perf_counter() - t0) / reps)
  return 1e3 * float(np.median(times))


FLEET_B = 4


def fleet_ticks(cfg, params, K, frame: torch.Tensor, B: int = FLEET_B,
                device=None) -> dict:
  """The fleet rows, by ``tick_ms``: a ``FleetRelocalizer`` tick of B
  slots (filter step and per-slot pose solve, one result copy) on frames
  on the device (``fleet_tick_ms_b4``), the same pipelined one deep
  (``fleet_pipelined_tick_ms_b4``), and pipelined on uint8 host frames
  (``fleet_pipelined_host_uint8_tick_ms_b4``). A failure raises."""
  from kfnet_tpu_torch.eval.online import FleetRelocalizer

  tick = frame.expand((B,) + tuple(frame.shape)).contiguous()
  out = {f"fleet_tick_ms_b{B}": tick_ms(
      FleetRelocalizer(params, cfg, K, batch_size=B, device=device), tick)}
  pipelined = FleetRelocalizer(params, cfg, K, batch_size=B,
                               pipeline_depth=1, device=device)
  out[f"fleet_pipelined_tick_ms_b{B}"] = tick_ms(pipelined, tick, warm=3)
  pipelined.flush()
  tick_u8 = (tick.cpu().numpy() * 255).astype(np.uint8)
  pipelined = FleetRelocalizer(params, cfg, K, batch_size=B,
                               pipeline_depth=1, device=device)
  out[f"fleet_pipelined_host_uint8_tick_ms_b{B}"] = tick_ms(
      pipelined, tick_u8, warm=3)
  pipelined.flush()
  return out


def run(height: int = 480, width: int = 640, frames: int = 32,
        config=None, reps: int = 3, tick: bool = False, device=None,
        seed: int = 0) -> dict:
  """Every figure of the JAX package's ``run``, on ``config`` (the default
  ``KFNetConfig``) with weights and frames from ``seed``. A failure
  raises: no row is recorded as missing."""
  from kfnet_tpu_torch.eval.online import OnlineRelocalizer
  from kfnet_tpu_torch.filter import sequence
  from kfnet_tpu_torch.models import kfnet

  device = kfnet_tpu_torch.resolve_device(device)
  cfg = config or kfnet.KFNetConfig()
  params = kfnet.init(seed, cfg, (height, width, 3), device=device)
  rng = np.random.default_rng(seed)
  host = rng.uniform(0, 1, (frames, height, width, 3)).astype(np.float32)
  images = torch.from_numpy(host).to(device)
  img = images[0]

  results = {"device": str(device),
             "gpu": (torch.cuda.get_device_name(device)
                     if device.type == "cuda" else None),
             "height": height, "width": width, "frames": frames,
             "use_fused_kernel": cfg.use_fused_kernel,
             "conv_impl": [cfg.scoordnet.conv_impl, cfg.oflownet.conv_impl]}

  results["scoordnet_ms"] = 1e3 * bench_fn(
      lambda im: kfnet.measure(params, cfg, im), (img,))
  results["oflownet_encode_ms"] = 1e3 * bench_fn(
      lambda im: kfnet.encode(params, cfg, im), (img,))
  feat = kfnet.encode(params, cfg, img)
  results["costvolume_decode_ms"] = 1e3 * bench_fn(
      lambda a, b: kfnet.flow_from_features(params, cfg, a, b), (feat, feat))
  t = bench_fn(lambda im: sequence.run_filter(params, cfg, im)[:2],
               (images,), reps=reps)
  results["filter_ms_per_frame"] = 1e3 * t / frames
  results["filtered_fps"] = frames / t

  # the whole pipeline, filter and batched pose solve
  K = np.asarray([[585.0, 0.0, width / 2.0 - 0.5],
                  [0.0, 585.0, height / 2.0 - 0.5],
                  [0.0, 0.0, 1.0]], np.float32)
  results["e2e_pose_fps"] = e2e_pose_fps(cfg, params, images, K, reps=reps)
  # the difference of two separately timed runs, clamped at 0
  results["pose_solve_ms_per_frame"] = max(
      0.0, 1e3 / results["e2e_pose_fps"] - results["filter_ms_per_frame"])

  # streaming (the chunked filter at its default chunk over a 3-chunk
  # stream): device-resident frames isolate the chunking's cost, host
  # frames add the upload (f32, and uint8 as a camera gives it)
  stream_T = 3 * 32
  reps_np = np.concatenate([host] * (-(-stream_T // frames)))[:stream_T]
  results["streaming_fps_device"] = streaming_fps(
      cfg, params, list(torch.from_numpy(reps_np).to(device)))
  results["streaming_fps"] = streaming_fps(cfg, params, list(reps_np), k=1)
  results["streaming_fps_host_uint8"] = streaming_fps(
      cfg, params, [np.ascontiguousarray((f * 255).astype(np.uint8))
                    for f in reps_np], k=1)

  # serving: B independent sequences in lockstep, one fused launch a step;
  # frames per second count all B streams
  B = FLEET_B
  batch_seqs = images[:, None].expand((frames, B) + tuple(images.shape[1:]))
  tb = bench_fn(lambda im: sequence.run_filter_batched(params, cfg, im),
                (batch_seqs,), reps=reps)
  results["filtered_fps_batch4"] = B * frames / tb

  if tick:
    results.update(fleet_ticks(cfg, params, K, img, B, device))
    # one stream's online tick: the frame on the device, then as host
    # numpy each tick (f32, then uint8 in the same relocaliser)
    results["online_tick_ms"] = tick_ms(
        OnlineRelocalizer(params, cfg, K, device=device), img)
    img_np = host[0]
    reloc_h = OnlineRelocalizer(params, cfg, K, device=device)
    results["online_host_tick_ms"] = tick_ms(reloc_h, img_np)
    results["online_host_uint8_tick_ms"] = tick_ms(
        reloc_h, (img_np * 255).astype(np.uint8))
  return results


def main(argv=None):
  from kfnet_tpu_torch.models import kfnet

  p = argparse.ArgumentParser()
  p.add_argument("--height", type=int, default=480)
  p.add_argument("--width", type=int, default=640)
  p.add_argument("--frames", type=int, default=32)
  p.add_argument("--no_fused_kernel", action="store_true")
  p.add_argument("--serving", action="store_true",
                 help="also time the online ticks, at the given size and at "
                      "96x128, one JSON line per size")
  p.add_argument("--device", default=None,
                 help="cuda (the default) or cpu")
  args = p.parse_args(argv)
  cfg = dataclasses.replace(kfnet.KFNetConfig(),
                            use_fused_kernel=not args.no_fused_kernel)
  print(json.dumps(run(args.height, args.width, args.frames, cfg,
                       tick=args.serving, device=args.device)))
  if args.serving and (args.height, args.width) != (96, 128):
    print(json.dumps(run(96, 128, args.frames, cfg, tick=True,
                         device=args.device)))


if __name__ == "__main__":
  main()
