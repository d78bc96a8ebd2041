#!/usr/bin/env python3
"""Drive the PyTorch / H100 port (kfnet_tpu_torch) on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each, with their seconds:
  1. environment: torch and CUDA versions, the GPU, nvidia-smi's name and
     power limit, the float32 settings in force (TF32 off, so the plain
     versions' float32 products are full float32);
  2. build: the two CUDA libraries, one nvcc each, started together, from
     the sources in the checkout;
  3. the fused warp + Kalman kernel against its plain PyTorch version on
     the card, at the main path's 60x80 map (r=4, χ² 2.365974), with
     out-of-bounds-heavy flow, and on an odd 17x23 map (r=3): atol 2e-5 on
     x, rtol 2e-5 on P, the consistency mask equal; then a loss on its
     outputs at 60x80 with inputs that require grad: the gradients of all
     six inputs through its autograd node (forward: the kernel; backward:
     autograd through the plain version) against autograd through the
     plain version, at the golden tolerance (rtol 5e-4, atol 5e-5);
  3b. the fused update's heads-in entry (fused_filter_step: the two
     heads' raw outputs in, their output steps, the flow clip, the warp and
     the update in one launch) against its plain version on the card at
     60x80, one map and a batch of four, on heads drawn
     from a seeded generator with raw flows deep in tanh's saturation (the
     flow at ±r) and log-variances past ±12: flow, W, z and V within
     ULP_TOL units in the last place (both sides use libdevice's tanhf and
     expf, each within 2 ulps of the truth), x and P at phase 3's
     tolerances, the mask equal away from χ² ties; then its gradients into
     both raw heads, x_prev and P_prev through its autograd node against
     autograd through the plain version, at the golden tolerance;
  4. the conv kernels against their plain versions on the card at every
     distinct shape of the conv-kernel configuration's path (below), plus
     an odd 17x23 map and a 13x21 map (neither a multiple of the 8 x 8
     pixel tile) at cout 128 and 512; conv3x3_gn_chain twice, bit-equal
     (its sums are reduced in a fixed order), and conv3x3_same twice where
     it splits K (15x20, 30x40: partials summed in split order), bit-equal.
     Tolerances: float32 outputs
     and Σy within 3e-5 of the largest |value| (the kernel sums the same
     exact bf16 products in another order); Σy² within rtol 5e-5 (the same
     reordering, squared); bf16 outputs within one bf16 rounding step
     (rtol 2^-7, plus 3e-5 of the largest |value| near zero);
  5. the slice at full width: the default KFNetConfig (GN SCoordNet
     64..512 with a 512 head, OFlowNet encoder 32..128, r=4, U-Net
     128/128/256, s2d 2, bf16) with weights drawn from seed 0, serving
     eight 640x480 uint8 frames through OnlineRelocalizer, whose filter
     step is one CUDA graph replayed a frame. The kernel must launch once
     per frame after the first (launches counted under replay), the packed
     outputs must be finite, the same frames through use_fused_kernel=False
     must give the same x and P (rtol 1e-3, atol 1e-3: the two paths share
     every bf16 op, so any difference is the kernel's), and through the
     eager filter step (graph=False) the same x, P and packed outputs
     (bit-equal is recorded; held at rtol = atol = 1e-3); no host sync
     inside a replayed frame, nor in the two frames after a reset, which
     keep the graph and replay it from the new carry;
  6. the same weights and frames in the conv-kernel configuration
     (SCoordNet conv_impl="pallas_fused", OFlowNet "pallas_3x3"): every
     kernel's launches equal the count kfnet.kernel_shapes gives for the
     config (12 chain calls a frame; conv3x3_same once on the first frame
     and 6 times on each later one; the fused update once a frame after the
     first), outputs finite, no host sync inside a frame, and the bf16
     weight layout copied once per weight tensor, not per frame (no copy
     after the second frame); every kernel
     call of one frame's (z, V) and one pair's (flow, W) within phase 4's
     tolerances of its plain version on its own inputs; those outputs
     within BOUNDS of the same path with each kernel's plain version in
     its place, and of the default config's; the graphed relocaliser
     against the eager filter step, as in phase 5;
  7. pose on known data: 4800 correspondences, 30% outliers, solved on the
     card to within 1 cm and 0.1°;
  7b. sequence: the sequence path (filter/sequence.py) in the default
     config on 16 uint8 640x480 frames: run_filter (each filter step a
     CUDA graph replay), the chunked stream of host frames at chunk 4
     (chunks 5/4/4/3, a ragged tail, uploads on a copy stream) and the run
     resumed from the carry after frame 7, each against the eager
     run_filter_python_loop on x and P at rtol = atol = TOL_PATH (bit-equal
     recorded), the fused update launched once a filter-step frame (15,
     counted under replay); run_filter_batched on two such sequences
     (B = 2), one fused launch a step for both maps, each sequence of the
     batch against its own eager loop: in bf16 recorded (a batch of two
     takes other conv and reduction orders than one frame, and a flipped
     bf16 rounding spreads through the random-weight nets), with frame 0's
     z and V within BOUNDS of the single frame's, and the same in float32
     (compute_dtype of both nets, same widths and weights) held at
     TOL_PATH; the conv-kernel config on 8 frames held the same way
     (graphed, chunked, resumed; a batch runs PyTorch's convs, the kernels
     take one frame), its launches kfnet.kernel_shapes' count for frame 0
     plus 7 filter-step frames; the batched pose solve on 8 frames of
     known poses (4800 points, 30% outliers each): every frame within 1 cm
     and 0.1°, and equal to each frame's solve_with_indices on the same
     index sets at POSE_RTOL/POSE_ATOL on T_wc (bit-equal recorded), the
     batched solve's time against 8 single solves; then, in both configs,
     eval/benchmark.py's filter_fps (32 float frames), e2e_pose_fps
     (filter + batched solve), streaming_fps_device (a 96-frame stream at
     chunk 32), the analytic GFLOP a frame, the MFU and the card's bf16
     peak (eval/flops.py; null for a card it does not know), beside the
     card's name and power limit;
  8. times with CUDA events: process() per frame in both configurations,
     graphed and eager, and the filter step alone (solve_pose=False): its
     host ms a frame (the enqueue) and its ms a frame, graphed and eager,
     in turns default, conv, conv, default; what a capture costs: in each
     configuration the host ms of process() on the frame that captures,
     on the next (a replay), on the two frames after a reset and on the
     frame after an in-place weight update (which captures again); the
     fused update's heads-in entry alone (its wrapper in a CUDA graph) at
     one map and a batch of four, and through its wrapper back to back; the
     kernel launches it removes from a frame (torch.profiler: the output
     steps, W * w_scale, the flow clip and the TPU kernel's entry against
     the one entry);
     each kernel through its wrapper called back to back, beside its
     plain version and (conv3x3_same) cuDNN's conv at the same shape,
     also back to back (the kernels line's ms, plain_ms, library_ms; the
     conv kernels at each distinct main-path shape, summed over a
     filter-step frame); each kernel alone: the fused update and every
     conv kernel call of one served filter-step frame on that call's own
     inputs, bias, ReLU and output type (prepared weights, preallocated
     outputs), and cuDNN's conv at each call's shape, as device time from
     a CUDA graph of 20 launches (kfnet_tpu_torch/tools/conv_tiles.py;
     the kernels line's alone_ms, library_alone_ms); the bounds; the pose
     solve.
Imports only the standard library, numpy, torch and kfnet_tpu_torch; reads
nothing under artifacts/; writes only the kernel build directory.
"""

import contextlib
import dataclasses
import itertools
import json
import os
import subprocess
import sys
import time
import unittest.mock as mock
import warnings

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

# the conv kernels' tolerances (TOL_F32_SUM: f32 outputs and Σy, of the
# largest |value|; TOL_S2: Σy², rtol; BF16_STEP: one bf16 rounding step,
# rtol), their check against the plain version and the H100 SXM's memory
# rate live beside the conv kernels' timing tool, which checks the same
from kfnet_tpu_torch.tools.conv_tiles import (  # noqa: E402
    BF16_STEP, HBM_BYTES_PER_S, TOL_F32_SUM, TOL_S2, call_errors)

F32_FLOPS_PER_S = 67e12     # H100 SXM float32 outside the tensor cores
TOL_X, TOL_P = 2e-5, 2e-5   # the kernel against its plain version
ULP_TOL = 4                 # heads-in entry's flow, W, z, V: two libdevice
                            # results of at most 2 ulps error each
# the heads-in entry's constants; the clamps are the nets' LOG_VAR_CLIP
STEP_KW = dict(w_scale=16.0, coord_scale=1.5, coord_offset=(0.5, -1.0, 2.0),
               log_w_clip=(-12.0, 12.0), log_v_clip=(-12.0, 12.0))
TOL_PATH = 1e-3             # fused vs unfused slice, x and P (rtol, atol)
GRAD_RTOL, GRAD_ATOL = 5e-4, 5e-5  # fused kernel's gradients: golden tols
# conv-kernel config against the default one, and against the same path
# with each conv kernel's plain version in its place, same weights and
# frames: the largest |difference| over the largest |value| of the other
# output for z and flow, the largest relative difference for the variances
# V and W. About 3x what the card showed against the default (z 0.015,
# flow 0.023, V 0.035, W 0.023); against the plain path it showed as much
# (z 0.014, flow 0.022, V 0.033, W 0.029). A reordered float32 sum flips a
# bf16 rounding now and then, and through the 15-layer random-weight trunk
# the flips spread until both sides differ at bf16's own noise level. So
# this bound cannot be tight; each kernel call of the path is held tightly
# against its plain version on its own inputs instead (check_calls).
BOUNDS = {"z": 0.05, "flow": 0.07, "V": 0.1, "W": 0.1}
IMG = (480, 640, 3)
SEQ_T, SEQ_T_CONV = 16, 8   # frames of the sequence phase, per config
# the batched pose solve against each frame's solve on the same indices,
# T_wc: rtol, and an atol for its entries near 0
POSE_RTOL, POSE_ATOL = 1e-4, 1e-6
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


def fused_grads(ff, args, r, thr):
  """Gradients of a loss on the fused update's outputs through the kernel's
  autograd node and through the plain version, on the card; raises unless
  all six agree at the golden tolerance. Returns the largest |difference|
  of each."""
  import numpy as np
  import torch
  g = torch.Generator(device=args[0].device).manual_seed(7)
  gx = torch.randn(args[0].shape, generator=g, device=args[0].device)
  gP = torch.randn(args[1].shape, generator=g, device=args[0].device)
  grads = []
  for fn in (ff.fused_warp_kalman, ff.fused_warp_kalman_reference):
    ts = [a.detach().clone().requires_grad_(True) for a in args]
    x, P, _ = fn(*ts, radius=r, threshold=thr)
    grads.append(torch.autograd.grad(
        torch.sum(x * gx) + torch.sum(P * gP), ts))
  out = {}
  for name, k, p in zip(("x_prev", "P_prev", "flow", "W", "z", "V"),
                        *grads):
    out[name] = (k - p).abs().max().item()
    if not (p.abs().max().item() > 0 and np.allclose(
        k.cpu().numpy(), p.cpu().numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)):
      raise AssertionError(f"fused kernel gradient of {name} disagrees: "
                           f"{out[name]}")
  return out


def raw_heads(rng, h, w, batch=None):
  """OFlowNet's and SCoordNet's raw heads and a previous (x, P), float32
  numpy: flows and variances near the previous state, every 11th raw flow
  at +30 and every 13th at -30 (tanh saturates: the flow is ±r), every 7th
  raw log W at +20 and every 7th at -20, every 5th raw log V at +15 and
  every 9th at -15 (past the ±12 clamps)."""
  import numpy as np
  lead = (h, w) if batch is None else (batch, h, w)
  x = rng.normal(size=lead + (3,)).astype(np.float32)
  P = rng.uniform(0.05, 2.0, lead + (1,)).astype(np.float32)
  fl = (rng.normal(size=lead + (2,)) * 0.4).astype(np.float32)
  lw = np.log(rng.uniform(0.01, 0.5, lead + (1,)) / 16.0).astype(np.float32)
  off = np.asarray(STEP_KW["coord_offset"], np.float32)
  z = x + (rng.normal(size=lead + (3,)) * 0.3).astype(np.float32)
  rc = ((z - off) / STEP_KW["coord_scale"]).astype(np.float32)
  lv = np.log(rng.uniform(0.05, 2.0, lead + (1,)) / 2.25).astype(np.float32)
  fl.reshape(-1)[::11], fl.reshape(-1)[5::13] = 30.0, -30.0
  lw.reshape(-1)[::7], lw.reshape(-1)[3::7] = 20.0, -20.0
  lv.reshape(-1)[::5], lv.reshape(-1)[2::9] = 15.0, -15.0
  return (np.concatenate([fl, lw], -1), np.concatenate([rc, lv], -1), x, P)


def ulps(a, b):
  """Largest distance in units in the last place between two float32
  tensors (0: the same bits)."""
  import torch
  def ordered(t):
    i = t.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
  return int((ordered(a) - ordered(b)).abs().max().item())


def step_vs_plain(ff, args, r, thr):
  """The heads-in entry's launch against its plain version on the same
  inputs; raises on a miss. Returns the deviations."""
  import torch
  kw = dict(radius=r, threshold=thr, **STEP_KW)
  got = ff._launch_step(*args, r, *STEP_KW.values(), thr, 1e8)
  want = ff.fused_filter_step_reference(*args, **kw)
  torch.cuda.synchronize()
  flow, W, z, V = want[3:]  # the plain mask just under and over the gate
  chi2 = torch.stack([ff.fused_warp_kalman_reference(
      args[2], args[3], flow, W, z, V, r, t)[2] for t in (thr * (1 - 1e-5),
                                                         thr * (1 + 1e-5))])
  away = chi2[0] == chi2[1]  # not within 1e-5 of the gate
  out = {"ulps": {n: ulps(g, w) for n, g, w in
                  zip(("flow", "W", "z", "V"), got[3:], want[3:])},
         "max_abs_dx": (got[0] - want[0]).abs().max().item(),
         "max_rel_dP": ((got[1] - want[1]).abs() / want[1].abs()).max().item(),
         "mask_equal_away_from_ties": bool(torch.equal(got[2][away],
                                                       want[2][away])),
         "ties": int((~away).sum().item()),
         "bit_equal": all(torch.equal(g, w) for g, w in zip(got, want)),
         "flow_at_bound": int((want[3].abs() == r).sum().item())}
  out["max_abs_err"] = max((g.float() - w.float()).abs().max().item()
                           for g, w in zip(got, want))
  if not (max(out["ulps"].values()) <= ULP_TOL and out["max_abs_dx"] <= TOL_X
          and out["max_rel_dP"] <= TOL_P and out["mask_equal_away_from_ties"]):
    raise AssertionError(f"fused_filter_step disagrees with its plain "
                         f"version: {out}")
  return out


def step_grads(ff, args, r, thr):
  """Gradients of a loss on all six differentiable outputs of the heads-in
  entry through its autograd node and through the plain version, on the
  card; raises unless the four inputs' agree at the golden tolerance."""
  import numpy as np
  import torch
  g = torch.Generator(device=args[0].device).manual_seed(8)
  kw = dict(radius=r, threshold=thr, **STEP_KW)
  cots = None
  grads = []
  for fn in (ff.fused_filter_step, ff.fused_filter_step_reference):
    ts = [a.detach().clone().requires_grad_(True) for a in args]
    out = fn(*ts, **kw)
    diff = [o for i, o in enumerate(out) if i != 2]
    if cots is None:
      cots = [torch.randn(o.shape, generator=g, device=o.device)
              for o in diff]
    loss = sum(torch.sum(o * c) for o, c in zip(diff, cots))
    grads.append(torch.autograd.grad(loss, ts))
  res = {}
  for name, k, p in zip(("raw_flow_head", "raw_coord_head", "x_prev",
                         "P_prev"), *grads):
    res[name] = (k - p).abs().max().item()
    if not (p.abs().max().item() > 0 and np.allclose(
        k.cpu().numpy(), p.cpu().numpy(), rtol=GRAD_RTOL, atol=GRAD_ATOL)):
      raise AssertionError(f"fused_filter_step gradient of {name} "
                           f"disagrees: {res[name]}")
  return res


def profiled_kernels(fn, n=5):
  """CUDA kernels one call of ``fn`` runs (torch.profiler's trace, as
  tools/profile_online.py reads it)."""
  from kfnet_tpu_torch.tools import profile_online
  return len(profile_online.trace_kernels(fn, n)[0]) / n


def same_outputs(a, b):
  """(bit-equal, largest |difference|) of two relocalisers' states and of
  the packed outputs of their process() calls."""
  import numpy as np
  import torch
  def packed(outs):
    return np.stack([np.concatenate([[i["consistent_frac"]],
                                     p.reshape(-1), [i["num_inliers"],
                                                     i["inlier_ratio"]]])
                     for p, i in outs])
  pa, pb = packed(a[1]), packed(b[1])
  xa, Pa = a[0].state[:2]
  xb, Pb = b[0].state[:2]
  return {"bit_equal": bool(torch.equal(xa, xb) and torch.equal(Pa, Pb) and
                            np.array_equal(pa, pb)),
          "x_max_abs": (xa - xb).abs().max().item(),
          "P_max_abs": (Pa - Pb).abs().max().item(),
          "packed_max_abs": float(np.abs(pa - pb).max()),
          "held": bool(torch.allclose(xa, xb, rtol=TOL_PATH, atol=TOL_PATH)
                       and torch.allclose(Pa, Pb, rtol=TOL_PATH,
                                          atol=TOL_PATH)
                       and np.allclose(pa, pb, rtol=TOL_PATH,
                                       atol=TOL_PATH))}


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


def capture_costs(reloc, frames):
  """Host ms of process() (each ends in its one result copy) on a new
  graphed relocaliser: the frame that captures the filter step, the next
  one (a replay), the two after a reset (first_step, then a replay from
  the new carry) and the one after an in-place weight update (which
  captures again); raises unless only the first and last captured."""
  import torch
  def ms(frame):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    reloc.process(frame)
    return (time.perf_counter() - t0) * 1e3
  reloc.process(frames[0])
  out = {"capture": ms(frames[1]), "replay": ms(frames[2])}
  graph = reloc._step
  reloc.reset()
  out["after_reset"] = [ms(frames[3]), ms(frames[4])]
  kept = reloc._step is graph
  leaf = next(p for p in graph._leaves if p.dim() == 4)
  with torch.no_grad():
    leaf.add_(0.0)  # a new version of the same values
  out["after_weight_update"] = ms(frames[5])
  if not (kept and reloc._step is not graph):
    raise AssertionError("captures: not at the first filter frame and "
                         "after the weight update only")
  return out


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


# beyond the main path's shapes: an odd map, and a map whose rows and
# columns are not multiples of the 8 x 8 pixel tile, at cout 128 and 512
EXTRA_SAME = [(17, 23, 256, 128), (13, 21, 128, 128), (13, 21, 128, 512)]
EXTRA_CHAIN = [(17, 23, 256, 128), (13, 21, 256, 512)]


def check_conv_kernels(c3, conv_inputs, gen, dev, same_shapes, chain_shapes):
  """Each conv kernel against its plain version; raises on a miss."""
  import torch
  out = {"conv3x3_same": {}, "conv3x3_gn_chain": {}, "same_splits": {}}
  for shape in same_shapes + EXTRA_SAME:
    x, wt, b, _, _ = conv_inputs(gen, *shape, dev)
    splits = c3.plan(*shape, sms=c3.sm_count(dev.index)).splits
    for bias, relu, od in ((b, True, torch.float32),
                           (None, False, torch.bfloat16)):
      args = (x, wt, bias, relu, od)
      got = c3.conv3x3_same(*args)
      errs, ok = call_errors("conv3x3_same", args, {}, got)
      same_twice = torch.equal(got, c3.conv3x3_same(*args))
      err = errs["y"]
      key = f"{shape}/{'f32_bias_relu' if relu else 'bf16_layer'}"
      out["conv3x3_same"][key] = err
      out["same_splits"][str(shape)] = splits
      if not (ok and same_twice):
        raise AssertionError(f"conv3x3_same disagrees at {key}: {err}, "
                             f"bit-equal twice: {same_twice}")
  for i, shape in enumerate(chain_shapes + EXTRA_CHAIN):
    x, wt, _, scale, shift = conv_inputs(gen, *shape, dev)
    args = (x, scale, shift, wt, i > 0)
    got = c3.conv3x3_gn_chain(*args)
    again = c3.conv3x3_gn_chain(*args)
    errs, ok = call_errors("conv3x3_gn_chain", args, {}, got)
    same_twice = all(torch.equal(a, b) for a, b in zip(got, again))
    out["conv3x3_gn_chain"][str(shape)] = dict(
        errs, prologue_relu=i > 0, bit_equal_twice=same_twice)
    if not (ok and same_twice):
      raise AssertionError(f"conv3x3_gn_chain disagrees at {shape}: "
                           f"{out['conv3x3_gn_chain'][str(shape)]}")
  return out


@contextlib.contextmanager
def recording(c3, calls):
  """Record each conv kernel call's arguments and result in ``calls``
  ({wrapper name: []}). While patched, a wrapper adds its launch to its
  recorder's count, not to its own."""
  with contextlib.ExitStack() as stack:
    for name, log in calls.items():
      def rec(*args, _real=getattr(c3, name), _log=log, **kwargs):
        out = _real(*args, **kwargs)
        _log.append((args, kwargs, out))
        return out
      rec.launches = 0
      stack.enter_context(mock.patch.object(c3, name, rec))
    yield


def check_calls(c3, calls):
  """Every recorded call against its plain version on its own inputs, at
  the tolerances of ``check_conv_kernels``; raises on a miss."""
  out = {}
  for name, log in calls.items():
    worst = {}
    for args, kwargs, got in log:
      errs, ok = call_errors(name, args, kwargs, got)
      if not ok:
        raise AssertionError(f"{name} disagrees in the path at "
                             f"{tuple(args[0].shape)}: {errs}")
      worst = {k: max(v, worst.get(k, 0.0)) for k, v in errs.items()}
    out[name] = dict(calls=len(log), **worst)
  return out


def deviation(got, want, relative):
  d = (got.float() - want.float()).abs()
  if relative:
    return {"max_abs": d.max().item(),
            "max_rel": (d / want.float().abs()).max().item()}
  scale = want.float().abs().max().item()
  return {"max_abs": d.max().item(), "scale": scale,
          "max_rel": d.max().item() / scale}


def time_conv_kernels(c3, conv_tiles, gen, dev, shapes, chain):
  """Per distinct shape, ms per call by CUDA events, called back to back:
  the wrapper (bf16 output, no bias; the chain's prologue ReLU after its
  first shape), its plain version and cuDNN's bf16 channels-last conv
  (``F.conv2d``); and the call's bound."""
  import torch
  import torch.nn.functional as F
  rows = {}
  for i, shape in enumerate(shapes):
    x, wt, _, scale, shift = conv_tiles.inputs(gen, *shape, dev)
    if chain:
      relu = i > 0
      kern = lambda: c3.conv3x3_gn_chain(x, scale, shift, wt, relu)
      plain = lambda: c3.conv3x3_gn_chain_reference(x, scale, shift, wt, relu)
    else:
      kern = lambda: c3.conv3x3_same(x, wt, None, False, torch.bfloat16)
      plain = lambda: c3.conv3x3_same_reference(x, wt, None, False,
                                                torch.bfloat16)
    xl = x.permute(2, 0, 1)[None]  # channels-last (1, C, H, W) view
    wl = wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
    bound, by = conv_tiles.bound_ms(*shape, chain=chain)
    rows[shape] = {"ms": cuda_ms(kern, 30), "plain_ms": cuda_ms(plain, 10),
                   "cudnn_ms": cuda_ms(lambda: F.conv2d(xl, wl, padding=1),
                                       30),
                   "bound_ms": bound, "bound_by": by}
  return rows


def per_frame(rows, calls):
  """Sum of each column over one frame's calls (shapes repeat)."""
  tot = {k: sum(rows[c][k] for c in calls)
         for k in ("ms", "plain_ms", "cudnn_ms", "bound_ms")}
  ops = sum(rows[c]["bound_by"] == "operations" for c in calls)
  tot["bound_by"] = "operations" if 2 * ops >= len(calls) else "bytes"
  return tot


def time_calls_alone(conv_tiles, calls):
  """Each recorded conv kernel call of one served frame, on its own inputs
  and its own bias, ReLU and output type: the kernel alone (prepared
  weights, preallocated outputs; device ms from a CUDA graph) and cuDNN's
  bare conv at its shape, timed the same way. Raises unless the kernel
  alone gives the served call's bits. Returns {wrapper name: {"alone_ms",
  "cudnn_alone_ms": sums over the frame, "calls"}}."""
  import torch
  out = {}
  for name, log in calls.items():
    alone = cudnn = 0.0
    for args, kwargs, got in log:
      run, mine = conv_tiles.kernel_call(name, args, kwargs)
      run()
      pairs = zip(mine, got) if isinstance(got, tuple) else [(mine, got)]
      if not all(torch.equal(a, b) for a, b in pairs):
        raise AssertionError(f"{name} alone differs from the served call at "
                             f"{tuple(args[0].shape)}")
      alone += conv_tiles.graph_ms(run, 20)
      a = conv_tiles.arguments(name, args, kwargs)
      cudnn += conv_tiles.cudnn_ms(a["x"], a["w"], 20)
    out[name] = {"alone_ms": alone, "cudnn_alone_ms": cudnn,
                 "calls": len(log)}
  return out


def close_to(got, want):
  """(bit-equal, largest |difference| of x and of P, within TOL_PATH) of
  two (xs, Ps) results."""
  import torch
  (gx, gP), (wx, wP) = got, want
  return {"bit_equal": bool(torch.equal(gx, wx) and torch.equal(gP, wP)),
          "x_max_abs": (gx - wx).abs().max().item(),
          "P_max_abs": (gP - wP).abs().max().item(),
          "held": bool(torch.allclose(gx, wx, rtol=TOL_PATH, atol=TOL_PATH)
                       and torch.allclose(gP, wP, rtol=TOL_PATH,
                                          atol=TOL_PATH))}


def counted(wrappers, fn):
  """``fn()``'s result and the launches of each wrapper it made (counted
  under replay), the counts set to 0 just before."""
  import torch
  for w in wrappers.values():
    w.launches = 0
  out = fn()
  torch.cuda.synchronize()
  return out, {name: w.launches for name, w in wrappers.items()}


def sequence_forms(sequence, params, c, frames, resume_at, chunk, wrappers,
                   dev):
  """The graphed run, the chunked stream (host uint8 frames) and the run
  resumed from a carry after frame ``resume_at - 1``, each against the
  eager loop on x and P, with each one's kernel launches."""
  import torch
  dev_frames = torch.from_numpy(frames).to(dev)
  ref = sequence.run_filter_python_loop(params, c, dev_frames)

  def chunked():
    outs = list(sequence.run_filter_chunked_arrays(params, c, list(frames),
                                                   chunk_size=chunk))
    return ((torch.cat([o[0] for o in outs]), torch.cat([o[1] for o in outs])),
            [o[0].shape[0] for o in outs])

  def resumed():
    xa, Pa, carry = sequence.run_filter(params, c, dev_frames[:resume_at])
    xb, Pb, _ = sequence.run_filter(params, c, dev_frames[resume_at:],
                                    carry=carry)
    return torch.cat([xa, xb]), torch.cat([Pa, Pb])

  forms = {}
  out, n = counted(wrappers, lambda: sequence.run_filter(
      params, c, dev_frames)[:2])
  forms["graphed"] = dict(close_to(out, ref), launches=n)
  (out, sizes), n = counted(wrappers, chunked)
  forms["chunked"] = dict(close_to(out, ref), launches=n, chunks=sizes)
  out, n = counted(wrappers, resumed)
  forms["resumed"] = dict(close_to(out, ref), launches=n)
  return forms, ref


def known_poses(rng, T, n, K):
  """T frames of n correspondences of known poses (camera-to-world), 0.5
  px pixel noise and 30% outliers (2 m world noise): (uv, X, var, T_wc)."""
  import numpy as np
  uvs, Xs, poses = [], [], []
  for _ in range(T):
    R_wc = rodrigues(rng.normal(size=3) * 0.3)
    t_wc = rng.normal(size=3)
    pc = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                   rng.uniform(1.0, 5.0, n)], -1)
    X = pc @ R_wc.T + t_wc
    uv = pc[:, :2] / pc[:, 2:] * K[0, 0] + K[:2, 2]
    uv += rng.normal(size=uv.shape) * 0.5
    out = rng.choice(n, int(0.3 * n), replace=False)
    X[out] += rng.normal(size=(len(out), 3)) * 2.0
    T_wc = np.eye(4)
    T_wc[:3, :3], T_wc[:3, 3] = R_wc, t_wc
    uvs.append(uv)
    Xs.append(X)
    poses.append(T_wc)
  return (np.stack(uvs), np.stack(Xs), rng.uniform(0.5, 2.0, (T, n)),
          np.stack(poses))


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
  from kfnet_tpu_torch.eval import benchmark, flops
  from kfnet_tpu_torch.eval.online import OnlineRelocalizer
  from kfnet_tpu_torch.filter import sequence
  from kfnet_tpu_torch.kernels import _build
  from kfnet_tpu_torch.kernels import conv3x3 as c3
  from kfnet_tpu_torch.kernels import fused_filter as ff
  from kfnet_tpu_torch.models import kfnet, oflownet, scoordnet
  from kfnet_tpu_torch.nn import layers as L
  from kfnet_tpu_torch.pose import ransac
  from kfnet_tpu_torch.tools import conv_tiles, profile_online

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
  _build.build_libraries([(ff.LIBRARY, ff.SOURCES), (c3.LIBRARY, c3.SOURCES)])
  ff.build()
  c3.build()
  say("build", t0, sources=["kfnet_tpu_torch/kernels/csrc/fused_filter.cu",
                            "kfnet_tpu_torch/kernels/csrc/conv3x3.cu"])

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
  grad_errs = fused_grads(ff, main_inputs[0], main_inputs[1],
                          main_inputs[2])
  say("kernel_vs_plain", t0, tol={"x_atol": TOL_X, "P_rtol": TOL_P,
                                  "grad_rtol": GRAD_RTOL,
                                  "grad_atol": GRAD_ATOL},
      cases=errs, grads_vs_plain=grad_errs)

  # 3b. the heads-in entry against its plain version
  t0 = time.time()
  srng = np.random.default_rng(3)
  step_args = {}
  step_errs = {}
  for label, batch in (("B1_60x80_r4", None), ("B4_60x80_r4", 4)):
    step_args[label] = [torch.from_numpy(a).to(dev)
                        for a in raw_heads(srng, 60, 80, batch)]
    step_errs[label] = step_vs_plain(ff, step_args[label], 4, 2.365974)
  step_grad_errs = step_grads(
      ff, [torch.from_numpy(a).to(dev) for a in raw_heads(srng, 17, 23)], 3,
      7.814728)
  say("fused_step_vs_plain", t0, tol={"ulps": ULP_TOL, "x_atol": TOL_X,
                                      "P_rtol": TOL_P, "grad_rtol": GRAD_RTOL,
                                      "grad_atol": GRAD_ATOL},
      cases=step_errs,
      grads_vs_plain=step_grad_errs)

  # 4. the conv kernels against their plain versions
  t0 = time.time()
  conv_cfg = kfnet.KFNetConfig(
      scoordnet=scoordnet.SCoordNetConfig(conv_impl="pallas_fused"),
      oflownet=oflownet.OFlowNetConfig(conv_impl="pallas_3x3"))
  first = kfnet.kernel_shapes(conv_cfg, IMG, first=True)
  later = kfnet.kernel_shapes(conv_cfg, IMG)
  same_shapes = list(dict.fromkeys(later["conv3x3_same"]))
  chain_shapes = list(dict.fromkeys(later["conv3x3_gn_chain"]))
  gen = torch.Generator(device=dev).manual_seed(0)
  conv_errs = check_conv_kernels(c3, conv_tiles.inputs, gen, dev,
                                 same_shapes, chain_shapes)
  say("conv_kernels_vs_plain", t0,
      tol={"f32_and_s1_of_max": TOL_F32_SUM, "s2_rtol": TOL_S2,
           "bf16_rtol": BF16_STEP}, **conv_errs)

  # 5. the slice at full width
  t0 = time.time()
  cfg = kfnet.KFNetConfig()
  params = kfnet.init(0, cfg, IMG, device=dev)
  K = np.array([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]], np.float32)
  frames = np.random.default_rng(0).integers(0, 256, (8, 480, 640, 3),
                                             dtype=np.uint8)
  reloc = OnlineRelocalizer(params, cfg, K, device=dev, seed=0)
  # the main path's fused update is the heads-in entry, counted under replay
  ff.fused_filter_step.launches = 0
  outs = [reloc.process(f) for f in frames]
  torch.cuda.synchronize()
  launches = ff.fused_filter_step.launches
  x_f, P_f = (a.clone() for a in reloc.state[:2])
  eager = OnlineRelocalizer(params, cfg, K, device=dev, seed=0, graph=False)
  graph_vs_eager = same_outputs((reloc, outs),
                                (eager, [eager.process(f) for f in frames]))
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
      "graph_vs_eager": graph_vs_eager,
      "host_syncs_in_one_tick": host_syncs(reloc, frames[0]),
  }
  graph_before = reloc._step
  reloc.reset()
  checks["host_syncs_after_reset"] = (host_syncs(reloc, frames[0]) +
                                      host_syncs(reloc, frames[1]))
  checks["graph_kept_across_reset"] = reloc._step is graph_before
  say("slice_full_width", t0, config="KFNetConfig() 640x480 bf16", **checks)
  if not graph_vs_eager["held"]:
    raise AssertionError(f"the graphed filter step disagrees with the eager "
                         f"one: {graph_vs_eager}")
  if launches != len(frames) - 1:
    raise AssertionError(f"fused kernel launched {launches} times for "
                         f"{len(frames)} frames")
  if not checks["packed_finite"]:
    raise AssertionError("non-finite packed output")
  if not torch.allclose(x_f, x_p, rtol=TOL_PATH, atol=TOL_PATH) or \
      not torch.allclose(P_f, P_p, rtol=TOL_PATH, atol=TOL_PATH):
    raise AssertionError("fused and unfused paths disagree")
  if checks["host_syncs_in_one_tick"] or checks["host_syncs_after_reset"]:
    raise AssertionError("a frame's work waits on the device before its "
                         "result copy")
  if not checks["graph_kept_across_reset"]:
    raise AssertionError("reset() captured the filter step again")

  # 6. the conv-kernel configuration at full width
  t0 = time.time()
  reloc_c = OnlineRelocalizer(params, conv_cfg, K, device=dev, seed=0)
  ff.fused_filter_step.launches = 0
  c3.conv3x3_same.launches = 0
  c3.conv3x3_gn_chain.launches = 0
  L.layout_copies = 0
  c3.prepared_weights.copies = 0
  outs_c = [reloc_c.process(f) for f in frames[:2]]
  weight_copies_first_pair = c3.prepared_weights.copies
  outs_c += [reloc_c.process(f) for f in frames[2:]]
  torch.cuda.synchronize()
  weight_copies_later = c3.prepared_weights.copies - weight_copies_first_pair
  # "fused_warp_kalman" is the kernels line's name for the fused update
  conv_launches = {"fused_warp_kalman": ff.fused_filter_step.launches,
                   "conv3x3_same": c3.conv3x3_same.launches,
                   "conv3x3_gn_chain": c3.conv3x3_gn_chain.launches}
  eager_c = OnlineRelocalizer(params, conv_cfg, K, device=dev, seed=0,
                              graph=False)
  conv_graph_vs_eager = same_outputs(
      (reloc_c, outs_c), (eager_c, [eager_c.process(f) for f in frames]))
  n_later = len(frames) - 1
  expected = {"fused_warp_kalman": n_later}
  for name in ("conv3x3_same", "conv3x3_gn_chain"):
    expected[name] = len(first[name]) + n_later * len(later[name])
  copies = L.layout_copies
  up = lambda f: kfnet.preprocess_images(cfg, torch.from_numpy(f).to(dev))
  img0, img1 = up(frames[0]), up(frames[1])

  def pair_outputs(c):
    z, V = kfnet.measure(params, c, img1)
    flow, W = kfnet.flow_from_features(params, c, kfnet.encode(params, c, img0),
                                       kfnet.encode(params, c, img1))
    return {"z": z, "V": V, "flow": flow, "W": W}

  calls = {"conv3x3_same": [], "conv3x3_gn_chain": []}
  with recording(c3, calls):
    out_c = pair_outputs(conv_cfg)
  in_path = check_calls(c3, calls)
  n_calls = {k: len(v) for k, v in calls.items()}
  if n_calls != {"conv3x3_same": len(first["conv3x3_same"])
                 + len(later["conv3x3_same"]),
                 "conv3x3_gn_chain": len(later["conv3x3_gn_chain"])}:
    raise AssertionError(f"kernel calls in the checked pair: {n_calls}")
  out_x = pair_outputs(cfg)
  # the same path with each kernel's plain version in its place (same
  # rounding points; these calls are not counted)
  with mock.patch.object(c3, "conv3x3_same", c3.conv3x3_same_reference), \
      mock.patch.object(c3, "conv3x3_gn_chain",
                        c3.conv3x3_gn_chain_reference):
    out_p = pair_outputs(conv_cfg)
  dev_vs_xla = {k: deviation(out_c[k], out_x[k], k in ("V", "W"))
                for k in out_c}
  dev_vs_plain = {k: deviation(out_c[k], out_p[k], k in ("V", "W"))
                  for k in out_c}
  poses_c = np.stack([p for p, _ in outs_c])
  conv_checks = {
      "launches": conv_launches, "launches_expected": expected,
      "layout_copies": copies,
      "weight_layout_copies": {"first_two_frames": weight_copies_first_pair,
                               "later_frames": weight_copies_later},
      "packed_finite": bool(np.isfinite(poses_c).all() and all(
          np.isfinite([i["consistent_frac"], i["num_inliers"],
                       i["inlier_ratio"]]).all() for _, i in outs_c)),
      "consistent_frac": [i["consistent_frac"] for _, i in outs_c],
      "calls_in_path_vs_plain": in_path, "vs_plain_path": dev_vs_plain,
      "vs_default_config": dev_vs_xla, "bounds": BOUNDS,
      "graph_vs_eager": conv_graph_vs_eager,
      "host_syncs_in_one_tick": host_syncs(reloc_c, frames[0]),
  }
  say("slice_conv_kernels", t0,
      config="KFNetConfig(SCoordNet pallas_fused, OFlowNet pallas_3x3) "
      "640x480 bf16", **conv_checks)
  if conv_launches != expected:
    raise AssertionError(f"kernel launches {conv_launches}, expected "
                         f"{expected}")
  if not conv_graph_vs_eager["held"]:
    raise AssertionError(f"the graphed filter step disagrees with the eager "
                         f"one (conv kernels): {conv_graph_vs_eager}")
  if weight_copies_later:
    raise AssertionError(f"{weight_copies_later} weight layout copies after "
                         f"the second frame: the copy is not once per "
                         f"weight tensor")
  if not conv_checks["packed_finite"]:
    raise AssertionError("non-finite packed output (conv kernels)")
  for what, devs in (("its plain version", dev_vs_plain),
                     ("the default config", dev_vs_xla)):
    over = {k: v["max_rel"] for k, v in devs.items()
            if not v["max_rel"] <= BOUNDS[k]}
    if over:
      raise AssertionError(f"conv-kernel path off {what}: {over}")
  if conv_checks["host_syncs_in_one_tick"]:
    raise AssertionError("a frame's work waits on the device before its "
                         "result copy (conv kernels)")

  # 7. pose on known data
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

  # 7b. the sequence path
  t0 = time.time()
  wrappers = {"fused_warp_kalman": ff.fused_filter_step,
              "conv3x3_same": c3.conv3x3_same,
              "conv3x3_gn_chain": c3.conv3x3_gn_chain}
  srng = np.random.default_rng(4)
  seq_a, seq_b = (srng.integers(0, 256, (SEQ_T,) + IMG, dtype=np.uint8)
                  for _ in range(2))
  forms, ref_a = sequence_forms(sequence, params, cfg, seq_a, 8, 4, wrappers,
                                dev)
  ref_b = sequence.run_filter_python_loop(params, cfg,
                                          torch.from_numpy(seq_b).to(dev))
  pair = torch.from_numpy(np.stack([seq_a, seq_b], 1)).to(dev)
  (xs_b, Ps_b), n_b = counted(wrappers, lambda: sequence.run_filter_batched(
      params, cfg, pair))
  # a batch of two takes other conv and reduction orders than one frame,
  # and in bf16 a flipped rounding spreads through the random-weight nets
  # (frame 0's z already 1.6% of its largest value off): the bf16 batch
  # is recorded, its frame 0 held at BOUNDS, and the same sequences in
  # float32 (same widths and weights) held at TOL_PATH
  cfg32 = dataclasses.replace(
      cfg, scoordnet=dataclasses.replace(cfg.scoordnet,
                                         compute_dtype="float32"),
      oflownet=dataclasses.replace(cfg.oflownet, compute_dtype="float32"))
  xs32, Ps32 = sequence.run_filter_batched(params, cfg32, pair)
  forms["batched_B2"] = {
      "launches": n_b,
      "bf16": {"vs_a": close_to((xs_b[:, 0], Ps_b[:, 0]), ref_a),
               "vs_b": close_to((xs_b[:, 1], Ps_b[:, 1]), ref_b),
               "frame0_vs_alone": {
                   "z": deviation(xs_b[0, 0], ref_a[0][0], False),
                   "V": deviation(Ps_b[0, 0], ref_a[1][0], True)}},
      "float32": {
          "vs_" + k: close_to((xs32[:, i], Ps32[:, i]),
                              sequence.run_filter_python_loop(
                                  params, cfg32, pair[:, i]))
          for i, k in enumerate("ab")}}
  conv_forms, _ = sequence_forms(sequence, params, conv_cfg,
                                 seq_a[:SEQ_T_CONV], 4, 4, wrappers, dev)
  seq_expected = {
      "default": {"fused_warp_kalman": SEQ_T - 1, "conv3x3_same": 0,
                  "conv3x3_gn_chain": 0},
      "conv_kernels": {
          "fused_warp_kalman": SEQ_T_CONV - 1,
          **{k: len(first[k]) + (SEQ_T_CONV - 1) * len(later[k])
             for k in ("conv3x3_same", "conv3x3_gn_chain")}}}
  # the batched solve on known poses, and against each frame's solve on
  # the same index sets
  puv, pX, pvar, pT = known_poses(np.random.default_rng(5), 8, 4800, K)
  rc = ransac.RansacConfig()
  pgen = torch.Generator(device=dev).manual_seed(0)
  pose_in = (f32(puv), f32(pX), f32(pvar),
             torch.ones(pvar.shape, dtype=torch.bool, device=dev))
  uv_k, X_k, w_k = ransac.select_confident(*pose_in, rc.top_k)
  idx = ransac.sample_hypotheses(w_k, rc.num_hypotheses, rc.sample_size, pgen)
  batched = ransac.solve_with_indices(uv_k, X_k, w_k, K_dev, idx, rc)
  single = torch.stack([ransac.solve_with_indices(
      uv_k[f], X_k[f], w_k[f], K_dev, idx[f], rc)["T_wc"] for f in range(8)])
  T_true = f32(pT)
  pose_check = {
      "t_err_m": geometry.translation_error(batched["T_wc"], T_true).tolist(),
      "r_err_deg": geometry.rotation_error_deg(batched["T_wc"],
                                               T_true).tolist(),
      "vs_single_bit_equal": bool(torch.equal(batched["T_wc"], single)),
      "vs_single_max_abs": (batched["T_wc"] - single).abs().max().item(),
      "vs_single_held": bool(torch.allclose(batched["T_wc"], single,
                                            rtol=POSE_RTOL, atol=POSE_ATOL)),
      "inlier_ratio": batched["inlier_ratio"].tolist(),
      # CUDA events around the enqueue: the host's pace
      "ms_batched_8_frames": cuda_ms(lambda: ransac.solve_pnp_ransac(
          *pose_in, K_dev, pgen), 3),
      "ms_single_8_frames": cuda_ms(lambda: [ransac.solve_pnp_ransac(
          *(a[f] for a in pose_in), K_dev, pgen) for f in range(8)], 3)}
  # the bench's figures (eval/benchmark.py's protocols): 32 float frames
  # of the bench, a 96-frame stream of them on the card
  fimg = torch.from_numpy(np.random.default_rng(0).uniform(
      0, 1, (32,) + IMG).astype(np.float32)).to(dev)
  K_bench = np.array([[585.0, 0, 319.5], [0, 585.0, 239.5], [0, 0, 1]],
                     np.float32)
  peak = flops.peak_flops(dev)
  figures = {}
  for name, c in (("default", cfg), ("conv_kernels", conv_cfg)):
    fps = benchmark.filter_fps(c, params, fimg)
    fl = flops.filter_step_flops(c, *IMG[:2])
    figures[name] = {
        "filter_fps": fps,
        "e2e_pose_fps": benchmark.e2e_pose_fps(c, params, fimg, K_bench),
        "streaming_fps_device": benchmark.streaming_fps(
            c, params, list(torch.cat([fimg] * 3))),
        "gflops_per_frame": fl / 1e9,
        "mfu": fl * fps / peak if peak else None, "peak_flops": peak}
  print(smi, flush=True)
  say("sequence", t0, gpu=gpu, nvidia_smi=smi, frames=SEQ_T,
      frames_conv_kernels=SEQ_T_CONV, tol=TOL_PATH,
      default=forms, conv_kernels=conv_forms, launches_expected=seq_expected,
      batched_pose=pose_check, pose_tol={"rtol": POSE_RTOL, "atol": POSE_ATOL},
      figures=figures)
  for name, fs in (("default", forms), ("conv_kernels", conv_forms)):
    for form, res in fs.items():
      checks = (list(res["float32"].values()) if form == "batched_B2"
                else [res])
      if not all(r["held"] for r in checks):
        raise AssertionError(f"{name} {form} off the eager loop: {res}")
      want = seq_expected[name]
      if form == "batched_B2":  # one fused launch a step for both maps
        want = dict(want, fused_warp_kalman=SEQ_T - 1)
      if res["launches"] != want:
        raise AssertionError(f"{name} {form} launches {res['launches']}, "
                             f"expected {want}")
  frame0 = forms["batched_B2"]["bf16"]["frame0_vs_alone"]
  if not all(frame0[k]["max_rel"] <= BOUNDS[k] for k in frame0):
    raise AssertionError(f"bf16 batch's frame 0 off the single frame's: "
                         f"{frame0}")
  if forms["chunked"]["chunks"] != [5, 4, 4, 3]:
    raise AssertionError(f"chunks {forms['chunked']['chunks']}")
  if not (max(pose_check["t_err_m"]) < 0.01
          and max(pose_check["r_err_deg"]) < 0.1):
    raise AssertionError(f"batched pose off: {pose_check}")
  if not pose_check["vs_single_held"]:
    raise AssertionError(f"batched pose differs from the per-frame solves: "
                         f"{pose_check}")
  if not all(np.isfinite(v["filter_fps"]) for v in figures.values()):
    raise AssertionError(f"figures: {figures}")

  # 8. times
  t0 = time.time()
  # the TPU kernel's contract (fused_warp_kalman) at 60x80
  args, r, thr = main_inputs
  fwk = {"ms": cuda_ms(lambda: ff.fused_warp_kalman(*args, radius=r,
                                                    threshold=thr), 200),
         "plain_ms": cuda_ms(lambda: ff.fused_warp_kalman_reference(
             *args, radius=r, threshold=thr), 200),
         "alone_ms": conv_tiles.graph_ms(lambda: ff.fused_warp_kalman(
             *args, radius=r, threshold=thr), 20)}
  # the bound: each input read once, each output written once: per pixel
  # 11 f32 in, 4 f32 + 1 byte out; ~70 f32 operations
  h, w = args[0].shape[:2]
  fwk["bytes"] = h * w * (11 * 4 + 4 * 4 + 1)
  fwk["bound_ms"] = max(fwk["bytes"] / HBM_BYTES_PER_S,
                        h * w * 70 / F32_FLOPS_PER_S) * 1e3
  fwk["max_abs_err"] = errs["main_60x80_r4"]["max_abs_err"]
  # the main path's entry (fused_filter_step), one 60x80 map and four:
  # per pixel 11 f32 in (raw heads 3 + 4, x 3, P 1), 11 f32 + 1 byte out;
  # ~130 f32 operations
  skw = dict(radius=4, threshold=2.365974, **STEP_KW)
  step = {}
  for label, sa in step_args.items():
    run = lambda sa=sa: ff.fused_filter_step(*sa, **skw)
    pixels = sa[2][..., 0].numel()
    row = {"ms": cuda_ms(run, 200),
           "plain_ms": cuda_ms(lambda sa=sa: ff.fused_filter_step_reference(
               *sa, **skw), 50),
           "alone_ms": conv_tiles.graph_ms(run, 20),
           "bytes": pixels * (11 * 4 + 11 * 4 + 1)}
    ops_ms = pixels * 130 / F32_FLOPS_PER_S * 1e3
    bytes_ms = row["bytes"] / HBM_BYTES_PER_S * 1e3
    row["bound_ms"] = max(bytes_ms, ops_ms)
    row["bound_by"] = "bytes" if bytes_ms >= ops_ms else "operations"
    step[label] = row

  def unfused_route(fh, ch, x, P):
    """What the filter step launched around the update before the heads-in
    entry: the nets' output steps, W * w_scale, the flow clip, then the TPU
    kernel's contract."""
    flow, W = oflownet.output_step(fh, 4)
    W = W * STEP_KW["w_scale"]
    z, V = scoordnet.output_step(ch, STEP_KW["coord_scale"],
                                 STEP_KW["coord_offset"])
    flow = torch.clamp(flow, -4.0, 4.0)
    return ff.fused_warp_kalman(x, P, flow.contiguous(), W.contiguous(),
                                z.contiguous(), V.contiguous(), radius=4,
                                threshold=2.365974)

  more = np.random.default_rng(2).integers(0, 256, (16, 480, 640, 3),
                                           dtype=np.uint8)
  cycle = itertools.cycle(more)
  serve = {"default": {"graph": reloc, "eager": eager},
           "conv_kernels": {"graph": reloc_c, "eager": eager_c}}
  for name, c in (("default", cfg), ("conv_kernels", conv_cfg)):
    for mode in ("graph", "eager"):
      rl = OnlineRelocalizer(params, c, K, device=dev, solve_pose=False,
                             graph=mode == "graph")
      for f in more[:2]:
        rl.process(f)
      serve[name]["filter_" + mode] = rl
  # in turns, default, conv, conv, default: 8 frames each, graphed and eager
  turns = {"default": [], "conv_kernels": []}  # process(), graphed (served)
  turns_eager = {"default": [], "conv_kernels": []}
  filter_host_ms = {n: {"graph": [], "eager": []} for n in serve}
  filter_ms = {n: {"graph": [], "eager": []} for n in serve}
  for name in ("default", "conv_kernels", "conv_kernels", "default"):
    sv = serve[name]
    turns[name].append(cuda_ms(lambda: sv["graph"].process(next(cycle)), 8))
    turns_eager[name].append(cuda_ms(lambda: sv["eager"].process(next(cycle)),
                                     8))
    for mode in ("graph", "eager"):
      rl = sv["filter_" + mode]
      filter_host_ms[name][mode].append(
          profile_online.host_ms(lambda: rl.tick(next(cycle)), 8))
      filter_ms[name][mode].append(
          cuda_ms(lambda: rl.process(next(cycle)), 8))
  capture = {name: capture_costs(OnlineRelocalizer(
      params, c, K, device=dev, solve_pose=False), more)
             for name, c in (("default", cfg), ("conv_kernels", conv_cfg))}
  process_ms = sum(turns["default"]) / 2
  process_conv_ms = sum(turns["conv_kernels"]) / 2
  # every conv kernel call of one filter-step frame, served eagerly (a
  # replay calls no wrapper), timed alone
  frame_calls = {"conv3x3_same": [], "conv3x3_gn_chain": []}
  with recording(c3, frame_calls):
    eager_c.process(next(cycle))
  if {k: len(v) for k, v in frame_calls.items()} != {
      k: len(later[k]) for k in frame_calls}:
    raise AssertionError("conv kernel calls in the timed frame: "
                         f"{ {k: len(v) for k, v in frame_calls.items()} }")
  alone = time_calls_alone(conv_tiles, frame_calls)
  same_rows = time_conv_kernels(c3, conv_tiles, gen, dev, same_shapes,
                                chain=False)
  chain_rows = time_conv_kernels(c3, conv_tiles, gen, dev, chain_shapes,
                                 chain=True)
  same_frame = per_frame(same_rows, later["conv3x3_same"])
  chain_frame = per_frame(chain_rows, later["conv3x3_gn_chain"])
  x_now, P_now = reloc.state[:2]
  ones = torch.ones_like(P_now, dtype=torch.bool)
  pose_ms = cuda_ms(lambda: ransac.solve_pnp_from_maps(
      x_now, P_now, ones, K_dev, gen), 10)
  # last, so that the profiler runs after every time above is taken
  b1 = step_args["B1_60x80_r4"]
  route_kernels = {
      "before": profiled_kernels(lambda: unfused_route(*b1)),
      "fused_filter_step": profiled_kernels(
          lambda: ff.fused_filter_step(*b1, **skw))}
  removed = route_kernels["before"] - route_kernels["fused_filter_step"]
  print(smi, flush=True)
  say("times", t0, gpu=gpu, nvidia_smi=smi, process_ms_per_frame=process_ms,
      process_ms_per_frame_conv_kernels=process_conv_ms, process_turns=turns,
      process_turns_eager=turns_eager, filter_step_host_ms=filter_host_ms,
      filter_step_ms=filter_ms, capture_ms=capture,
      fused_warp_kalman_entry=fwk,
      fused_filter_step=step, fused_route_kernels=route_kernels,
      pose_solve_ms=pose_ms,
      conv3x3_same_per_shape={str(k): v for k, v in same_rows.items()},
      conv3x3_same_per_frame=same_frame,
      conv3x3_gn_chain_per_shape={str(k): v for k, v in chain_rows.items()},
      conv3x3_gn_chain_per_frame=chain_frame,
      served_frame_alone=alone,
      total_seconds=round(time.time() - t_all, 1))

  bad = [m for m in FORBIDDEN if m in sys.modules]
  if bad:
    raise AssertionError(f"imported {bad}")
  b1, b4 = step["B1_60x80_r4"], step["B4_60x80_r4"]
  print(json.dumps({"kernels": [{
      # the fused update: the main path's heads-in entry, one 60x80 map
      # (ms and plain_ms back to back, alone_ms its wrapper in a graph);
      # the same at four maps, and the TPU kernel's contract entry, beside
      "name": "fused_warp_kalman", "route": "cuda",
      "source": "kfnet_tpu_torch/kernels/csrc/fused_filter.cu",
      "replaces": "kfnet_tpu/kernels/fused_filter.py:44",
      "launches": launches,
      "max_abs_err": step_errs["B1_60x80_r4"]["max_abs_err"],
      "ms": b1["ms"], "plain_ms": b1["plain_ms"],
      "bound_ms": b1["bound_ms"], "bound_by": b1["bound_by"],
      "library_ms": None,
      "alone_ms": b1["alone_ms"], "library_alone_ms": None,
      "alone_ms_batch4": b4["alone_ms"], "bound_ms_batch4": b4["bound_ms"],
      "ms_batch4": b4["ms"],
      "launches_removed_per_frame": removed,
      "warp_kalman_entry": fwk}, {
      # conv kernels: times summed over one filter-step frame's calls;
      # ms, plain_ms and library_ms back to back per distinct shape,
      # alone_ms and library_alone_ms device times of the served calls
      "name": "conv3x3_same", "route": "cuda",
      "source": "kfnet_tpu_torch/kernels/csrc/conv3x3.cu",
      "replaces": "kfnet_tpu/kernels/conv3x3.py:31",
      "launches": conv_launches["conv3x3_same"],
      "max_abs_err": max(v for k, v in conv_errs["conv3x3_same"].items()
                         if any(k.startswith(str(s)) for s in same_shapes)),
      "ms": same_frame["ms"], "plain_ms": same_frame["plain_ms"],
      "bound_ms": same_frame["bound_ms"],
      "bound_by": same_frame["bound_by"],
      "library_ms": same_frame["cudnn_ms"],
      "alone_ms": alone["conv3x3_same"]["alone_ms"],
      "library_alone_ms": alone["conv3x3_same"]["cudnn_alone_ms"]}, {
      "name": "conv3x3_gn_chain", "route": "cuda",
      "source": "kfnet_tpu_torch/kernels/csrc/conv3x3.cu",
      "replaces": "kfnet_tpu/kernels/conv3x3.py:57",
      "launches": conv_launches["conv3x3_gn_chain"],
      "max_abs_err": max(v["y"] for k, v in
                         conv_errs["conv3x3_gn_chain"].items()
                         if k in {str(s) for s in chain_shapes}),
      "ms": chain_frame["ms"], "plain_ms": chain_frame["plain_ms"],
      "bound_ms": chain_frame["bound_ms"],
      "bound_by": chain_frame["bound_by"],
      "library_ms": None,
      "alone_ms": alone["conv3x3_gn_chain"]["alone_ms"],
      "library_alone_ms": None}]}), flush=True)
  torch.cuda.synchronize()
  print(json.dumps({"ok": True, "device": {
      "platform": "gpu", "kind": gpu, "count": torch.cuda.device_count()}}),
        flush=True)
  return 0


if __name__ == "__main__":
  sys.exit(main())
