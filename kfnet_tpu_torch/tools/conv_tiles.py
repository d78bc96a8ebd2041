"""Check and time every launch plan of the conv kernels on the card.

    python -m kfnet_tpu_torch.tools.conv_tiles [--out FILE] [--reps N]

For each distinct conv shape of the conv-kernel configuration's filter
step at 640x480 (``kfnet.kernel_shapes``: SCoordNet ``pallas_fused``,
OFlowNet ``pallas_3x3``) and an odd 17x23 map, and for each plan the
kernel takes (``conv3x3.plan``: 1 or 2 consumer warpgroups a block; for
``conv3x3_same`` every split of K that divides cin/64), it checks the
result against the plain version (``call_errors``, with the tolerances
chip_smoke.py shares: float32 values and Σy within 3e-5 of the largest
|value|, Σy² within rtol 5e-5, bf16 values within one bf16 step) and times the kernel alone: ``--reps``
launches on prepared weights and preallocated outputs captured in one CUDA
graph, replayed and timed with CUDA events, so that the time is the
device's and not the host's. Beside each shape: its bound (the larger of
2·h·w·9·cin·cout operations at the bf16 tensor-core peak and the bytes
of x, the bf16 weights and y at the memory rate) and cuDNN's bf16
channels-last conv (``F.conv2d``) at the same shape, timed the same way.
Prints one JSON line per shape and the card's name and power limit, and
writes them all to ``--out``. Needs one CUDA device and nvcc.
"""

from __future__ import annotations

import argparse
import inspect
import json
import os
import subprocess

import torch
import torch.nn.functional as F

import kfnet_tpu_torch
from kfnet_tpu_torch.kernels import conv3x3 as c3
from kfnet_tpu_torch.models import kfnet, oflownet, scoordnet

# the card's rates (H100 SXM) and the conv kernels' tolerances on the card,
# shared with chip_smoke.py
HBM_BYTES_PER_S = 3.35e12       # device memory
BF16_PEAK_FLOPS_PER_S = 989e12  # dense bf16 tensor cores
TOL_F32_SUM = 3e-5              # f32 outputs and Σy, of the largest |value|
TOL_S2 = 5e-5                   # conv3x3_gn_chain: Σy², rtol
BF16_STEP = 2.0 ** -7           # one bf16 rounding step, rtol
IMG = (480, 640, 3)
ODD = (17, 23, 256, 128)


def conv_config() -> kfnet.KFNetConfig:
  return kfnet.KFNetConfig(
      scoordnet=scoordnet.SCoordNetConfig(conv_impl="pallas_fused"),
      oflownet=oflownet.OFlowNetConfig(conv_impl="pallas_3x3"))


def main_path_shapes():
  """(conv3x3_same shapes, conv3x3_gn_chain shapes): the distinct (h, w,
  cin, cout) of one filter-step frame, in call order."""
  later = kfnet.kernel_shapes(conv_config(), IMG)
  return (list(dict.fromkeys(later["conv3x3_same"])),
          list(dict.fromkeys(later["conv3x3_gn_chain"])))


def bound_ms(h, w, cin, cout, chain=False):
  """(ms, "operations" or "bytes"): the least time of one call."""
  ops = 2 * h * w * 9 * cin * cout
  nbytes = h * w * cin * 2 + 9 * cin * cout * 2 + h * w * cout * 2
  if chain:
    nbytes += 2 * cin * 4 + 2 * cout * 4
  ops_ms = ops / BF16_PEAK_FLOPS_PER_S * 1e3
  bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
  return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                 else "bytes")


def graph_ms(fn, reps: int) -> float:
  """Device ms of one ``fn()``: ``reps`` calls captured in a CUDA graph,
  replayed three times, timed with CUDA events."""
  fn()
  torch.cuda.synchronize()
  g = torch.cuda.CUDAGraph()
  with torch.cuda.graph(g):
    for _ in range(reps):
      fn()
  g.replay()
  torch.cuda.synchronize()
  start = torch.cuda.Event(enable_timing=True)
  end = torch.cuda.Event(enable_timing=True)
  start.record()
  for _ in range(3):
    g.replay()
  end.record()
  torch.cuda.synchronize()
  return start.elapsed_time(end) / (3 * reps)


def inputs(gen, h, w, cin, cout, dev):
  """A bf16 map, He-scaled weights, a bias and a GroupNorm (scale, shift)."""
  x = torch.randn((h, w, cin), generator=gen, device=dev).to(torch.bfloat16)
  wt = torch.randn((cout, cin, 3, 3), generator=gen, device=dev) * (
      2.0 / (9 * cin)) ** 0.5
  b = torch.randn((cout,), generator=gen, device=dev)
  scale = torch.rand((cin,), generator=gen, device=dev) + 0.5
  shift = torch.randn((cin,), generator=gen, device=dev) * 0.3
  return x, wt, b, scale, shift


def held(got, want, rtol, atol_of_max):
  """(max |got - want|, whether |got - want| <= rtol |want| + atol_of_max
  max |want| holds everywhere)."""
  g, w = got.float(), want.float()
  d = (g - w).abs()
  lim = rtol * w.abs() + atol_of_max * w.abs().max()
  return d.max().item(), bool((d <= lim).all())


def call_errors(name, args, kwargs, got):
  """One conv kernel call's result against its plain version on the same
  arguments: ({output: max |difference|}, whether each is in tolerance)."""
  want = getattr(c3, name + "_reference")(*args, **kwargs)
  if name == "conv3x3_same":
    rtol = BF16_STEP if got.dtype == torch.bfloat16 else 0.0
    err, ok = held(got, want, rtol, TOL_F32_SUM)
    return {"y": err}, ok
  ey, oky = held(got[0], want[0], BF16_STEP, TOL_F32_SUM)
  e1, ok1 = held(got[1], want[1], 0.0, TOL_F32_SUM)
  e2, ok2 = held(got[2], want[2], TOL_S2, 0.0)
  return {"y": ey, "s1": e1, "s2": e2}, oky and ok1 and ok2


def candidates(h, w, cin, cout, chain):
  """Every plan the kernel takes at this shape."""
  chunks = cin // c3.CIN_STEP
  splits = [1] if chain else [s for s in range(1, chunks + 1)
                              if chunks % s == 0]
  return [c3.plan(h, w, cin, cout, chain=chain, wgs=g, splits=s)
          for g in (1, 2) for s in splits]


def arguments(name, args, kwargs=None):
  """A call of wrapper ``name``'s arguments by parameter name, defaults
  filled in."""
  bound = inspect.signature(getattr(c3, name + "_reference")).bind(
      *args, **(kwargs or {}))
  bound.apply_defaults()
  return bound.arguments


def kernel_call(name, args, kwargs=None, pl_=None):
  """(run, out): the conv kernel of wrapper ``name`` on that wrapper's
  arguments, launched alone by ``run()`` into ``out`` (y, or (y, Σy,
  Σy²)): weights prepared and outputs allocated here, once; nothing
  counted. ``pl_`` defaults to the wrapper's plan on this card."""
  a = arguments(name, args, kwargs)
  x, wk = a["x"], c3.prepared_weights(a["w"])
  h, w, cin = x.shape
  cout = a["w"].shape[0]
  chain = name == "conv3x3_gn_chain"
  if pl_ is None:
    pl_ = c3.plan(h, w, cin, cout, chain=chain,
                  sms=c3.sm_count(x.device.index))
  dev = x.device
  if chain:
    y = torch.empty((h, w, cout), dtype=torch.bfloat16, device=dev)
    partial = torch.empty((pl_.tiles, 2, cout), device=dev)
    s1, s2 = (torch.empty((cout,), device=dev) for _ in range(2))
    return (lambda: c3.launch_chain(x, a["scale"], a["shift"], wk, y,
                                    partial, s1, s2, a["prologue_relu"],
                                    pl_)), (y, s1, s2)
  y = torch.empty((h, w, cout), dtype=a["out_dtype"], device=dev)
  partial = (torch.empty((pl_.splits, h * w, cout), device=dev)
             if pl_.splits > 1 else None)
  return (lambda: c3.launch_same(x, wk, a["bias"], y, partial, a["relu"],
                                 pl_)), y


def time_plan(args, pl_, chain, reps):
  """(device ms, max |error|, within tolerance) of one plan: the kernel
  alone, conv3x3_same with bias, ReLU and bf16 output, the chain with its
  prologue ReLU."""
  x, wt, b, scale, shift = args
  name, call = (("conv3x3_gn_chain", (x, scale, shift, wt, True)) if chain
                else ("conv3x3_same", (x, wt, b, True, torch.bfloat16)))
  run, out = kernel_call(name, call, pl_=pl_)
  run()
  errs, ok = call_errors(name, call, {}, out)
  return graph_ms(run, reps), max(errs.values()), ok


def cudnn_ms(x, wt, reps):
  """Device ms of cuDNN's bare bf16 channels-last conv (``F.conv2d``) of
  the (h, w, cin) map x by the (cout, cin, 3, 3) weights wt."""
  xl = x.permute(2, 0, 1)[None]  # channels-last (1, C, H, W) view
  wl = wt.to(torch.bfloat16).contiguous(memory_format=torch.channels_last)
  return graph_ms(lambda: F.conv2d(xl, wl, padding=1), reps)


def survey(reps: int = 20, seed: int = 0):
  """One dict per (kernel, shape): every plan's device ms and error, the
  default plan, the bound and cuDNN's time."""
  dev = torch.device("cuda")
  kfnet_tpu_torch.set_fp32_precision()
  gen = torch.Generator(device=dev).manual_seed(seed)
  same, chain = main_path_shapes()
  rows = []
  with torch.no_grad():
    for kernel, shapes in (("conv3x3_same", same + [ODD]),
                           ("conv3x3_gn_chain", chain + [ODD])):
      is_chain = kernel == "conv3x3_gn_chain"
      for shape in shapes:
        args = inputs(gen, *shape, dev)
        default = c3.plan(*shape, chain=is_chain,
                          sms=c3.sm_count(dev.index))
        plans = []
        for pl_ in candidates(*shape, is_chain):
          ms, err, ok = time_plan(args, pl_, is_chain, reps)
          plans.append({"wgs": pl_.wgs, "splits": pl_.splits,
                        "tiles": pl_.tiles, "ms": ms, "max_abs_err": err,
                        "ok": ok, "default": pl_ == default})
        b_ms, by = bound_ms(*shape, chain=is_chain)
        rows.append({"kernel": kernel, "shape": list(shape), "plans": plans,
                     "bound_ms": b_ms, "bound_by": by,
                     "cudnn_ms": cudnn_ms(args[0], args[1], reps)})
  return rows


def nvidia_smi() -> str:
  try:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=20)
    return res.stdout.strip().splitlines()[0] if res.returncode == 0 \
        else f"nvidia-smi failed ({res.returncode})"
  except (OSError, subprocess.TimeoutExpired, IndexError) as e:
    return f"nvidia-smi failed: {e}"


def main(argv=None) -> int:
  ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  ap.add_argument("--out", default="chiprun_out/conv_tiles.json")
  ap.add_argument("--reps", type=int, default=20)
  a = ap.parse_args(argv)
  if not torch.cuda.is_available():
    print("conv_tiles: no CUDA device")
    return 1
  smi = nvidia_smi()
  print(smi, flush=True)
  rows = survey(a.reps)
  for r in rows:
    print(json.dumps(r), flush=True)
  os.makedirs(os.path.dirname(os.path.abspath(a.out)), exist_ok=True)
  with open(a.out, "w") as f:
    json.dump({"nvidia_smi": smi, "gpu": torch.cuda.get_device_name(0),
               "rows": rows}, f, indent=1)
  bad = [(r["kernel"], r["shape"], p) for r in rows for p in r["plans"]
         if not p["ok"]]
  if bad:
    print(json.dumps({"disagree": bad}), flush=True)
  return 1 if bad else 0


if __name__ == "__main__":
  raise SystemExit(main())
