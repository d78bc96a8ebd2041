#!/usr/bin/env python3
"""Drive the PyTorch / H100 port (kfnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, with their seconds:
  1. environment: torch and CUDA versions, the GPU, nvidia-smi's name and
     power limit, the float32 settings in force;
  2. build: the CUDA kernel, with nvcc, from the sources in the checkout;
  3. kernel against its plain PyTorch version on the card, at the main
     path's 60x80 map (r=4, χ² 2.365974), with out-of-bounds-heavy flow,
     and on an odd 17x23 map (r=3): atol 2e-5 on x, rtol 2e-5 on P, the
     consistency mask equal;
  4. the slice at full width: the default KFNetConfig (GN SCoordNet
     64..512 with a 512 head, OFlowNet encoder 32..128, r=4, U-Net
     128/128/256, s2d 2, bf16) with weights drawn from seed 0, serving
     eight 640x480 uint8 frames through OnlineRelocalizer. The kernel must
     launch once per frame after the first, the packed outputs must be
     finite, and the same frames through use_fused_kernel=False must give
     the same x and P (rtol 1e-3, atol 1e-3: the two paths share every bf16
     op, so any difference is the kernel's);
  5. pose on known data: 4800 correspondences, 30% outliers, solved on the
     card to within 1 cm and 0.1°;
  6. times with CUDA events: process() per frame, the kernel, its plain
     version, the pose solve.
The line before the last lists each kernel with its launches on the main
path, its error against the plain version, its times and its bound. The
last line is the run's verdict. Exits non-zero, printing no verdict, when
there is no CUDA device or a phase fails.

Imports only the standard library, numpy, torch and kfnet_tpu_torch; reads
nothing under artifacts/; writes only the kernel build directory.
"""

import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time
import warnings

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

HBM_BYTES_PER_S = 3.35e12   # H100 SXM device memory rate
F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
TOL_X, TOL_P = 2e-5, 2e-5   # the kernel against its plain version
TOL_PATH = 1e-3             # fused vs unfused slice, x and P (rtol, atol)
FORBIDDEN = ("jax", "kfnet_tpu", "orbax", "tensorstore", "cv2")


def say(phase, t0, **fields):
  print(json.dumps({"phase": phase, "seconds": round(time.time() - t0, 3),
                    **fields}), flush=True)


def nvidia_smi():
  try:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=20)
    if res.returncode == 0 and res.stdout.strip():
      return res.stdout.strip().splitlines()[0]
    return f"nvidia-smi failed ({res.returncode}): {res.stderr.strip()}"
  except (OSError, subprocess.TimeoutExpired) as e:
    return f"nvidia-smi failed: {e}"


def filter_inputs(rng, h, w, r, oob):
  """The inputs of tests/test_pallas_fused.py at (h, w), float32 numpy."""
  import numpy as np
  x = rng.normal(size=(h, w, 3)).astype(np.float32)
  P = rng.uniform(0.05, 2.0, (h, w, 1)).astype(np.float32)
  lim = r if oob else 1.5
  flow = rng.uniform(-lim, lim, (h, w, 2)).astype(np.float32)
  W = rng.uniform(0.01, 0.5, (h, w, 1)).astype(np.float32)
  z = x + rng.normal(size=(h, w, 3)).astype(np.float32) * 0.3
  V = rng.uniform(0.05, 2.0, (h, w, 1)).astype(np.float32)
  return x, P, flow, W, z, V


def rodrigues(w):
  import numpy as np
  th = float(np.linalg.norm(w))
  k = w / th
  Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
  return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def host_syncs(reloc, frame):
  """Warnings of torch's sync debug mode while one frame is enqueued: the
  frame's work must not wait on the device before its one result copy."""
  import torch
  with warnings.catch_warnings(record=True) as caught:
    warnings.simplefilter("always")
    torch.cuda.set_sync_debug_mode("warn")
    try:
      packed = reloc.tick(frame)
    finally:
      torch.cuda.set_sync_debug_mode("default")
  packed.cpu()
  return [str(w.message)[:120] for w in caught
          if "called a synchronizing" in str(w.message)]


def cuda_ms(fn, n):
  """Mean ms of ``fn`` over n runs, by CUDA events, after one warm-up."""
  import torch
  fn()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(n):
    fn()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / n


def main():
  t_all = time.time()
  import numpy as np
  import torch
  if not torch.cuda.is_available():
    print("chip_smoke: no CUDA device (torch.cuda.is_available() is false)",
          file=sys.stderr)
    return 1
  import kfnet_tpu_torch
  from kfnet_tpu_torch.core import geometry
  from kfnet_tpu_torch.eval.online import OnlineRelocalizer
  from kfnet_tpu_torch.kernels import fused_filter as ff
  from kfnet_tpu_torch.models import kfnet
  from kfnet_tpu_torch.pose import ransac

  # 1. environment
  t0 = time.time()
  dev = torch.device("cuda")
  gpu = torch.cuda.get_device_name(0)
  smi = nvidia_smi()
  precision = kfnet_tpu_torch.set_fp32_precision()
  print(smi, flush=True)
  say("env", t0, torch=torch.__version__, cuda=torch.version.cuda, gpu=gpu,
      count=torch.cuda.device_count(), nvidia_smi=smi, fp32=precision)

  # 2. build
  t0 = time.time()
  ff.build()
  say("build", t0, source="kfnet_tpu_torch/kernels/csrc/fused_filter.cu")

  # 3. kernel against its plain version on the card
  t0 = time.time()
  rng = np.random.default_rng(0)
  cases = [("main_60x80_r4", 60, 80, 4, False, 2.365974),
           ("oob_60x80_r4", 60, 80, 4, True, 2.365974),
           ("odd_17x23_r3", 17, 23, 3, True, 7.814728)]
  errs = {}
  main_inputs = None
  for name, h, w, r, oob, thr in cases:
    args = [torch.from_numpy(a).to(dev) for a in filter_inputs(rng, h, w, r,
                                                               oob)]
    if main_inputs is None:
      main_inputs = (args, r, thr)
    kx, kP, kc = ff.fused_warp_kalman(*args, radius=r, threshold=thr)
    px, pP, pc = ff.fused_warp_kalman_reference(*args, radius=r,
                                                threshold=thr)
    torch.cuda.synchronize()
    dx = (kx - px).abs().max().item()
    dP = ((kP - pP).abs() / pP.abs()).max().item()
    mask_equal = bool(torch.equal(kc, pc))
    errs[name] = {"max_abs_dx": dx, "max_rel_dP": dP,
                  "max_abs_err": max(dx, (kP - pP).abs().max().item()),
                  "mask_equal": mask_equal,
                  "inconsistent_frac": 1.0 - float(pc.float().mean())}
    if not (dx <= TOL_X and dP <= TOL_P and mask_equal):
      raise AssertionError(f"kernel disagrees with its plain version on "
                           f"{name}: {errs[name]}")
  say("kernel_vs_plain", t0, tol={"x_atol": TOL_X, "P_rtol": TOL_P},
      cases=errs)

  # 4. the slice at full width
  t0 = time.time()
  cfg = kfnet.KFNetConfig()
  params = kfnet.init(0, cfg, (480, 640, 3), device=dev)
  K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]], np.float32)
  frames = np.random.default_rng(0).integers(0, 256, (8, 480, 640, 3),
                                             dtype=np.uint8)
  reloc = OnlineRelocalizer(params, cfg, K, device=dev, seed=0)
  ff.fused_warp_kalman.launches = 0
  outs = [reloc.process(f) for f in frames]
  torch.cuda.synchronize()
  launches = ff.fused_warp_kalman.launches
  x_f, P_f = (a.clone() for a in reloc.state[:2])
  plain_cfg = dataclasses.replace(cfg, use_fused_kernel=False)
  plain = OnlineRelocalizer(params, plain_cfg, K, device=dev, seed=0)
  plain_outs = [plain.process(f) for f in frames]
  x_p, P_p = plain.state[:2]
  poses = np.stack([p for p, _ in outs])
  fracs = [i["consistent_frac"] for _, i in outs]
  checks = {
      "launches": launches,
      "launches_expected": len(frames) - 1,
      "state_shapes": [list(x_f.shape), list(P_f.shape)],
      "packed_finite": bool(np.isfinite(poses).all() and all(
          np.isfinite([i["consistent_frac"], i["num_inliers"],
                       i["inlier_ratio"]]).all() for _, i in outs)),
      "x_max_abs_diff_vs_unfused": (x_f - x_p).abs().max().item(),
      "P_max_rel_diff_vs_unfused": ((P_f - P_p).abs() / P_p).max().item(),
      "consistent_frac": fracs,
      "consistent_frac_unfused": [i["consistent_frac"]
                                  for _, i in plain_outs],
      "inliers_last": outs[-1][1]["num_inliers"],
      "host_syncs_in_one_tick": host_syncs(reloc, frames[0]),
  }
  say("slice_full_width", t0, config="KFNetConfig() 640x480 bf16", **checks)
  if launches != len(frames) - 1:
    raise AssertionError(f"fused kernel launched {launches} times for "
                         f"{len(frames)} frames")
  if not checks["packed_finite"]:
    raise AssertionError("non-finite packed output")
  if not torch.allclose(x_f, x_p, rtol=TOL_PATH, atol=TOL_PATH) or \
      not torch.allclose(P_f, P_p, rtol=TOL_PATH, atol=TOL_PATH):
    raise AssertionError("fused and unfused paths disagree")
  if checks["host_syncs_in_one_tick"]:
    raise AssertionError("a frame's work waits on the device before its "
                         "result copy")

  # 5. pose on known data
  t0 = time.time()
  prng = np.random.default_rng(1)
  n = 4800
  R_wc = rodrigues(np.array([0.2, -0.3, 0.1]))
  t_wc = np.array([0.5, -0.2, 1.0])
  pc = np.stack([prng.uniform(-1.5, 1.5, n), prng.uniform(-1.0, 1.0, n),
                 prng.uniform(1.0, 5.0, n)], -1)
  X = pc @ R_wc.T + t_wc
  uv = pc[:, :2] / pc[:, 2:] * 525.0 + np.array([320.0, 240.0])
  uv += prng.normal(size=uv.shape) * 0.5
  out_idx = prng.choice(n, int(0.3 * n), replace=False)
  X[out_idx] += prng.normal(size=(len(out_idx), 3)) * 2.0
  T_gt = np.eye(4)
  T_gt[:3, :3], T_gt[:3, 3] = R_wc, t_wc
  var = prng.uniform(0.5, 2.0, n)
  f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
  gen = torch.Generator(device=dev).manual_seed(0)
  K_dev = f32(K)
  pose_args = (f32(uv), f32(X), f32(var),
               torch.ones(n, dtype=torch.bool, device=dev), K_dev)
  sol = ransac.solve_pnp_ransac(*pose_args, gen)
  T_gt_t = f32(T_gt)
  terr = geometry.translation_error(sol["T_wc"], T_gt_t).item()
  rerr = geometry.rotation_error_deg(sol["T_wc"], T_gt_t).item()
  say("pose_known_data", t0, n=n, outliers=0.3, t_err_m=terr,
      r_err_deg=rerr, inlier_ratio=sol["inlier_ratio"].item())
  if not (terr < 0.01 and rerr < 0.1):
    raise AssertionError(f"pose off: {terr} m, {rerr} deg")

  # 6. times
  t0 = time.time()
  args, r, thr = main_inputs
  kernel_ms = cuda_ms(lambda: ff.fused_warp_kalman(*args, radius=r,
                                                   threshold=thr), 200)
  plain_ms = cuda_ms(lambda: ff.fused_warp_kalman_reference(
      *args, radius=r, threshold=thr), 200)
  more = np.random.default_rng(2).integers(0, 256, (16, 480, 640, 3),
                                           dtype=np.uint8)
  cycle = itertools.cycle(more)
  process_ms = cuda_ms(lambda: reloc.process(next(cycle)), 16)
  x_now, P_now = reloc.state[:2]
  ones = torch.ones_like(P_now, dtype=torch.bool)
  pose_ms = cuda_ms(lambda: ransac.solve_pnp_from_maps(
      x_now, P_now, ones, K_dev, gen), 10)
  # the bound: each input read once, each output written once, per pixel
  # 11 f32 in, 4 f32 + 1 byte out; ~70 f32 operations per pixel
  h, w = args[0].shape[:2]
  bytes_moved = h * w * (11 * 4 + 4 * 4 + 1)
  bytes_ms = bytes_moved / HBM_BYTES_PER_S * 1e3
  ops_ms = h * w * 70 / F32_FLOPS_PER_S * 1e3
  print(smi, flush=True)
  say("times", t0, gpu=gpu, nvidia_smi=smi, process_ms_per_frame=process_ms,
      fused_kernel_ms=kernel_ms, plain_ms=plain_ms, pose_solve_ms=pose_ms,
      kernel_bytes=bytes_moved, total_seconds=round(time.time() - t_all, 1))

  bad = [m for m in FORBIDDEN if m in sys.modules]
  if bad:
    raise AssertionError(f"imported {bad}")
  print(json.dumps({"kernels": [{
      "name": "fused_warp_kalman", "route": "cuda",
      "source": "kfnet_tpu_torch/kernels/csrc/fused_filter.cu",
      "replaces": "kfnet_tpu/kernels/fused_filter.py:44",
      "launches": launches,
      "max_abs_err": errs["main_60x80_r4"]["max_abs_err"],
      "ms": kernel_ms, "plain_ms": plain_ms,
      "bound_ms": max(bytes_ms, ops_ms),
      "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
      "library_ms": None}]}), flush=True)
  torch.cuda.synchronize()
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": gpu, "count": torch.cuda.device_count()}}),
        flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
