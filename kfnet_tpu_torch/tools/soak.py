"""Long-stream soak (port of ``kfnet_tpu/tools/soak.py``): measurements for
the claim that the chunked streaming path (``filter/sequence.py``
``run_filter_chunked_arrays``) filters arbitrarily long videos. It streams
a long synthetic video through that path and checks its health end to end:

  * no NaN or Inf in the posterior state or covariance, ever;
  * the covariance bounded: min P > 0, and max P within the measurement
    noise's envelope (the Kalman invariant P_post <= V);
  * the mean covariance and the consistency fraction stationary: the late
    stream's window within a tolerance of the early one's (the χ² gate
    does not saturate open or shut as the stream ages);
  * flat host memory: the RSS growth over the equal-size steady chunks
    below a bound (nothing accumulates a frame). The one-time allocations
    (the first chunk, the first steady chunk, a ragged tail of another
    size) are outside that window; the tail's cost is reported apart.

Frames are rendered a chunk at a time on the device (``data/synthetic.py``)
and handed to the filter there, so a long full-size soak never holds the
whole (T, H, W, 3) video anywhere. Each chunk's statistics reduce on the
device to an 8-number vector, read back once: one host sync a chunk.

    python -m kfnet_tpu_torch.tools.soak --frames 5000 --report soak.json
    python -m kfnet_tpu_torch.tools.soak \\
        --pretrained artifacts/pretrained_full --frames 5000

``--pretrained`` defaults to the shipped synthetic weights
(``pretrained.ASSETS``); ``artifacts/pretrained_full``
(``pretrained.FULL_ASSETS``) soaks the full-size GroupNorm stages at
640x480 and ``artifacts/pretrained_full_nonorm``
(``pretrained.FULL_NONORM_ASSETS``) the ``norm="none"`` ones, each with
``--scene sceneA`` or ``outdoor_train``. ``--device`` (``cuda`` unless given) is the port's own
flag. ``steady_state_fps`` is the streaming API's rate, renders included.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch import pretrained
from kfnet_tpu_torch.data import synthetic
from kfnet_tpu_torch.filter import sequence
from kfnet_tpu_torch.models import kfnet
from kfnet_tpu_torch.tools import protocol as protocol_lib
from kfnet_tpu_torch.utils import checkpoint as ckpt_lib


def _rss_kb() -> float:
  """The current resident set (kB): ru_maxrss is a peak, which would hide
  a leak behind any earlier high-water mark."""
  with open("/proc/self/statm") as f:
    return int(f.read().split()[1]) * os.sysconf("SC_PAGE_SIZE") / 1024.0


def device_frame_chunks(num_frames: int, height: int, width: int,
                        chunk: int, seed: int = 0, scale: float = 1.0,
                        traj_seed: int | None = None, device=None):
  """Yield (k, H, W, 3) chunks of one continuous trajectory, rendered on
  ``device`` (``cuda`` unless given).

  The poses of the whole stream are made on the host ((T, 4, 4), small);
  the frames render a chunk at a time, in pieces of
  ``synthetic.render_chunk`` frames to bound the raycast's memory.
  ``duration`` grows with T so that the motion a frame is that of the
  48-frame protocol streams."""
  device = kfnet_tpu_torch.resolve_device(device)
  scene = synthetic.make_scene(seed, scale=scale)
  sx, sy = width / 640.0, height / 480.0
  K = torch.tensor([[585.0 * sx, 0.0, width / 2.0 - 0.5],
                    [0.0, 585.0 * sy, height / 2.0 - 0.5],
                    [0.0, 0.0, 1.0]], dtype=torch.float32, device=device)
  poses = torch.from_numpy(synthetic.orbit_trajectory(
      num_frames, seed=(seed + 1 if traj_seed is None else traj_seed),
      scale=scale, duration=num_frames / 48.0)).to(device)
  piece = synthetic.render_chunk(height, width, len(scene.radii))
  for i in range(0, num_frames, chunk):
    sl = poses[i:i + chunk]
    yield torch.cat([synthetic.render(scene, sl[j:j + piece], K, height,
                                      width)[0]
                     for j in range(0, sl.shape[0], piece)])


def _chunk_stats(xs, Ps, Vs, consistent):
  """One output chunk as 8 numbers on the device (read back at once)."""
  finite = torch.isfinite(xs).all() & torch.isfinite(Ps).all()
  return torch.stack([
      1.0 - finite.float(),           # non-finite flag
      xs.abs().max(),
      Ps.max(),
      Ps.min(),
      consistent.float().mean(),
      Ps.mean(),
      xs.abs().mean(),
      Vs.max(),
  ])


def run_soak(params, config: kfnet.KFNetConfig, num_frames: int,
             height: int, width: int, chunk: int = 48, seed: int = 0,
             scale: float = 1.0, log=print, device=None):
  """Stream ``num_frames`` rendered frames through the chunked filter on
  ``device`` (where the params live unless given).

  Returns a report dict (the module docstring's health criteria read it,
  ``healthy``); raises nothing itself beyond argument checks: callers
  assert on the report.
  """
  if num_frames <= 0:
    raise ValueError(f"soak needs a positive frame count, got no frames "
                     f"({num_frames})")
  params, device = sequence.placed(params, device)
  frames = device_frame_chunks(num_frames, height, width, chunk,
                               seed=seed, scale=scale, device=device)

  def frame_iter():  # frame views of each device chunk (they stay there)
    for ch in frames:
      yield from ch

  rows = []
  chunk_times = []   # wall time a received chunk (each ends in its sync)
  chunk_sizes = []
  rss0_kb = rss_full_kb = rss_tail_kb = None
  done = 0
  t_prev = time.perf_counter()
  for xs, Ps, auxs in sequence.run_filter_chunked_arrays(
      params, config, frame_iter(), chunk_size=chunk, return_aux=True,
      device=device):
    stats = _chunk_stats(xs, Ps, auxs["V"], auxs["consistent"])
    if not rows:
      # frame 0's posterior is its measurement variance (the first step
      # has no prior), but aux V covers the updated frames (1..T-1) only:
      # fold P[0] into the measurement envelope, so that healthy()'s
      # max_P <= max_V compares the same frames
      stats[7] = torch.maximum(stats[7], Ps[0].max())
    stats = stats.cpu().numpy()  # the chunk's one sync
    now = time.perf_counter()
    k = int(xs.shape[0])
    chunk_times.append(now - t_prev)
    t_prev = now
    chunk_sizes.append(k)
    done += k
    rows.append(stats)
    # RSS: the growth window covers equal-size steady chunks only. Chunk
    # 0 (chunk + 1 frames) and the first chunk of the steady size
    # allocate once (the filter step's graphs and buffers); a ragged
    # tail allocates for its own size at the end. None of that grows a
    # frame, so the baseline is taken after the first steady chunk, and
    # the tail's one-time cost is reported apart.
    if k == chunk:
      if rss0_kb is None:
        rss0_kb = _rss_kb()
      else:
        rss_full_kb = _rss_kb()
    elif rss0_kb is not None and done >= num_frames:
      rss_tail_kb = _rss_kb()
    if log and (len(rows) % 16 == 0 or done >= num_frames):
      log(f"soak: {done}/{num_frames} frames, maxP={stats[2]:.4g} "
          f"minP={stats[3]:.4g} consistent={stats[4]:.3f}")
  if not rows:
    raise ValueError("soak stream yielded no frames (num_frames <= 0?)")
  # the steady rate: the median over equal-size chunks after the first of
  # them (not the first chunk of chunk + 1 frames, nor a ragged tail)
  full_idx = [i for i, n in enumerate(chunk_sizes) if n == chunk]
  steady_idx = full_idx[1:]
  steady_fps = (chunk / float(np.median([chunk_times[i] for i in
                                         steady_idx]))
                if steady_idx else None)
  if rss0_kb is None:
    rss0_kb = _rss_kb()
  rows = np.stack(rows)  # (n_chunks, 8)
  n = rows.shape[0]
  warm = max(1, n // 10)           # the post-warm-up window: [1, 1 + warm)
  early = rows[1:1 + warm] if n > 1 else rows
  late = rows[-warm:]
  backend = device.type + (f" ({torch.cuda.get_device_name(device)})"
                           if device.type == "cuda" else "")
  return {
      "frames": int(done),
      "height": height, "width": width, "chunk": chunk,
      "world_scale": scale,
      "nonfinite_chunks": int(rows[:, 0].sum()),
      "max_abs_x": float(rows[:, 1].max()),
      "max_P": float(rows[:, 2].max()),
      "min_P": float(rows[:, 3].min()),
      "max_V": float(rows[:, 7].max()),
      "consistent_frac_early": float(early[:, 4].mean()),
      "consistent_frac_late": float(late[:, 4].mean()),
      "consistent_frac_min": float(rows[1:, 4].min()) if n > 1 else None,
      "mean_P_early": float(early[:, 5].mean()),
      "mean_P_late": float(late[:, 5].mean()),
      "steady_state_fps": steady_fps,
      "rss_start_mb": rss0_kb / 1024.0,
      "rss_growth_mb": ((rss_full_kb - rss0_kb) / 1024.0
                        if rss_full_kb is not None else None),
      "rss_ragged_tail_mb": (
          (rss_tail_kb - (rss_full_kb or rss0_kb)) / 1024.0
          if rss_tail_kb is not None else None),
      "backend": backend,
  }


def healthy(report: dict, consistent_drift: float = 0.15,
            rss_growth_mb: float = 256.0) -> list[str]:
  """The module docstring's health criteria on a ``run_soak`` report: the
  failures, as strings (empty: healthy)."""
  bad = []
  if report["nonfinite_chunks"]:
    bad.append(f"nonfinite values in {report['nonfinite_chunks']} chunks")
  if not (report["min_P"] > 0.0):
    bad.append(f"covariance floor violated: min_P={report['min_P']}")
  # bounded covariance, the Kalman invariant: P_post = P⁻V/(P⁻+V) <= V
  # pointwise (and the χ² reset falls back to V), so the posterior's
  # envelope never exceeds the measurement noise's. max_P itself follows
  # the content (max V a frame), so it may grow from window to window;
  # past max_V the update's arithmetic broke.
  if report["max_P"] > 1.01 * report["max_V"] + 1e-6:
    bad.append(f"covariance exceeded the measurement envelope: "
               f"max_P={report['max_P']:.6g} > max_V={report['max_V']:.6g}")
  # stationarity: the mean posterior variance does not trend
  if report["mean_P_late"] > 2.0 * report["mean_P_early"] + 1e-9:
    bad.append(f"mean covariance drifted up: "
               f"{report['mean_P_early']:.6g} -> {report['mean_P_late']:.6g}")
  drift = abs(report["consistent_frac_late"]
              - report["consistent_frac_early"])
  if drift > consistent_drift:
    bad.append(f"consistency fraction drifted {drift:.3f} "
               f"({report['consistent_frac_early']:.3f} -> "
               f"{report['consistent_frac_late']:.3f})")
  if report["rss_growth_mb"] is None:
    # fewer than two full chunks streamed: the growth window never
    # existed, so the criterion cannot pass by default; flag it
    bad.append("RSS growth window absent (stream too short to measure)")
  elif report["rss_growth_mb"] > rss_growth_mb:
    bad.append(f"host RSS grew {report['rss_growth_mb']:.0f} MB")
  return bad


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--pretrained", default=pretrained.ASSETS,
                 help="export root (stage3_<scene> preferred): "
                      "artifacts/pretrained_full (GroupNorm) and "
                      "artifacts/pretrained_full_nonorm (norm none) hold "
                      "the full-size stages of sceneA and outdoor_train")
  p.add_argument("--scene", default="sceneA")
  p.add_argument("--frames", type=int, default=5000)
  p.add_argument("--chunk", type=int, default=48)
  p.add_argument("--seed", type=int, default=None,
                 help="soak scene seed (default: the scene's own "
                      "protocol seed — the weights' training scene, but "
                      "a longer, fresh trajectory over it; any other "
                      "seed = an unseen scene — transfer soak)")
  p.add_argument("--report", default="")
  p.add_argument("--device", default="cuda",
                 help="torch device of the soak (cpu for tests)")
  args = p.parse_args(argv)

  cfg, params = pretrained.load(args.pretrained, scene=args.scene,
                                device=args.device)
  meta = None
  for stage in (f"stage3_{args.scene}", f"stage1_{args.scene}"):
    meta = ckpt_lib.load_meta(os.path.join(args.pretrained, stage))
    if meta:
      break
  H, W = int(meta["height"]), int(meta["width"])
  # the scene's protocol regime: its world scale and (by default) its
  # seed come from the scene table, so that --scene outdoor_train soaks
  # the 20x outdoor world the weights were trained on
  spec = next((s for s in protocol_lib.DEFAULT_SCENES
               if s.name == args.scene), None)
  scale = spec.scale if spec else 1.0
  seed = args.seed if args.seed is not None else (spec.seed if spec else 0)
  print(f"soak: {args.frames} frames at {W}x{H} (world scale {scale}), "
        f"chunk {args.chunk}, scene seed {seed}, "
        f"weights {args.pretrained}/{args.scene}")
  report = run_soak(params, cfg, args.frames, H, W, chunk=args.chunk,
                    seed=seed, scale=scale)
  problems = healthy(report)
  report["healthy"] = not problems
  report["problems"] = problems
  print(json.dumps(report, indent=2))
  if args.report:
    with open(args.report, "w") as f:
      json.dump(report, f, indent=2)
  return 0 if not problems else 1


if __name__ == "__main__":
  raise SystemExit(main())
