"""3x3 SAME stride-1 convolutions: the CUDA kernels ``csrc/conv3x3.cu`` and
their plain PyTorch versions.

Port of the Pallas kernels of ``kfnet_tpu/kernels/conv3x3.py``:

  * ``conv3x3_same`` (body ``_kernel``): the conv of ``conv_impl="pallas_3x3"``
    layers, with an optional float32 bias and ReLU before one rounding to
    ``out_dtype``;
  * ``conv3x3_gn_chain`` (body ``_fused_kernel``): one step of SCoordNet's
    fused GroupNorm trunk (``conv_impl="pallas_fused"``). Its prologue
    applies the previous layer's per-channel GroupNorm (scale, shift) and
    ReLU to the input, its epilogue returns the raw bf16 output and the
    per-channel sums of the float32 accumulator and of its square;
  * ``gn_scale_shift``, plain PyTorch in both packages, turns those sums
    into the next prologue's (scale, shift).

Maps are (h, w, C) bfloat16, contiguous; weights are the port's
(cout, cin, 3, 3) float32. Both kernels take the weights in a bf16
layout of their own, made once per weight tensor (``prepared_weights``),
and accumulate bf16 products in float32. Each wrapper checks its
arguments, takes the plain version only for CPU tensors, launches the
kernel for CUDA tensors and raises otherwise; its ``launches`` attribute
counts the calls that launched the kernel (``kernels.launches``: under CUDA
graph capture, once per replay). Neither kernel has a backward
(nor has either Pallas kernel): a call that autograd would record raises.
"""

from __future__ import annotations

import ctypes
import functools
import weakref
from typing import NamedTuple

import torch
import torch.nn.functional as F

from kfnet_tpu_torch.kernels import launches
from kfnet_tpu_torch.nn import layers as L

LIBRARY = "kfnet_conv3x3"
SOURCES = ("conv3x3.cu",)
# The kernel's geometry (checked against the library's at load): a block
# computes TILE_W pixels of WG_ROWS map rows per consumer warpgroup by
# COUT_TILE output channels, walking K by CIN_STEP-channel chunks (all nine
# taps of a chunk). cin must be a multiple of CIN_STEP, cout of COUT_TILE.
TILE_W = 8
WG_ROWS = 8
COUT_TILE = 128
CIN_STEP = 64
# units that fill the card once where no device is named: an H100 SXM's
# 132 SMs, the card whose times set the plan rules; the wrappers pass
# their device's own count (sm_count)
FILL_BLOCKS = 132

_LIB = None


def _lib():
  global _LIB
  if _LIB is None:
    from kfnet_tpu_torch.kernels import _build
    lib = _build.load_library(LIBRARY, SOURCES)
    # pointers and the stream as c_void_p: a plain int would be cut to 32 bits
    lib.kfnet_conv3x3_same.restype = ctypes.c_int
    lib.kfnet_conv3x3_same.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [ctypes.c_void_p])
    lib.kfnet_conv3x3_gn_chain.restype = ctypes.c_int
    lib.kfnet_conv3x3_gn_chain.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.kfnet_conv3x3_geometry.restype = None
    lib.kfnet_conv3x3_geometry.argtypes = [ctypes.POINTER(ctypes.c_int)]
    lib.kfnet_conv3x3_error_string.restype = ctypes.c_char_p
    lib.kfnet_conv3x3_error_string.argtypes = [ctypes.c_int]
    geom = (ctypes.c_int * 4)()
    lib.kfnet_conv3x3_geometry(geom)
    if tuple(geom) != (TILE_W, WG_ROWS, COUT_TILE, CIN_STEP):
      raise RuntimeError(f"{LIBRARY}: kernel geometry {tuple(geom)} is not "
                         f"the wrapper's")
    _LIB = lib
  return _LIB


def build() -> None:
  """Build (or load the cached) kernel library without launching it."""
  _lib()


def _shifted_products(xb, wb):
  """Σ over the nine taps of shift(x) @ W[tap], each a (h·w, cin) @
  (cin, cout) float32 product accumulated in float32, as the Pallas bodies
  compute it. xb: (h, w, cin) and wb: (cout, cin, 3, 3), float32 holding
  bf16 values, so every product is exact and only the sums round. Returns
  the (h·w, cout) accumulator."""
  h, w, cin = xb.shape
  xp = F.pad(xb, (0, 0, 1, 1, 1, 1))  # zero pad of one pixel on each side
  acc = None
  for dy in range(3):
    for dx in range(3):
      term = xp[dy:dy + h, dx:dx + w].reshape(h * w, cin) @ wb[:, :, dy, dx].t()
      acc = term if acc is None else acc + term
  return acc


def _bf16_values(t):
  return t.to(torch.bfloat16).to(torch.float32)


def conv3x3_same_reference(x, w, bias=None, relu: bool = False,
                           out_dtype=torch.bfloat16):
  """The plain PyTorch version of ``conv3x3_same`` (no cuDNN: nine float32
  matrix products; on the card they need TF32 off, see
  ``kfnet_tpu_torch.set_fp32_precision``)."""
  h, wd, _ = x.shape
  acc = _shifted_products(_bf16_values(x), _bf16_values(w))
  if bias is not None:
    acc = acc + bias.to(torch.float32)
  if relu:
    acc = torch.relu(acc)
  return acc.reshape(h, wd, -1).to(out_dtype)


def conv3x3_gn_chain_reference(x, scale, shift, w,
                               prologue_relu: bool = True):
  """The plain PyTorch version of ``conv3x3_gn_chain``: returns (y (h, w,
  cout) bf16, s1 (cout,) f32, s2 (cout,) f32)."""
  h, wd, _ = x.shape
  xn = _bf16_values(x) * scale + shift
  if prologue_relu:
    xn = torch.relu(xn)
  # the pad is zero after the prologue: only taps inside the map are
  # normalized
  acc = _shifted_products(_bf16_values(xn), _bf16_values(w))
  y = acc.reshape(h, wd, -1).to(torch.bfloat16)
  return y, torch.sum(acc, dim=0), torch.sum(acc * acc, dim=0)


def gn_scale_shift(s1, s2, n_spatial: int, gamma, beta):
  """Per-channel conv-output sums -> the next prologue's per-channel
  (scale, shift): GroupNorm with its affine parameters folded in, in the
  arithmetic of ``nn.layers.group_norm``."""
  c = s1.shape[0]
  g = L.gn_group_count(c, L.GN_GROUPS)
  cg = c // g
  n = n_spatial * cg
  mean_g = s1.reshape(g, cg).sum(-1) / n
  var_g = torch.clamp_min(s2.reshape(g, cg).sum(-1) / n
                          - torch.square(mean_g), 0.0)
  inv_g = torch.rsqrt(var_g + L.GN_EPS)
  scale = gamma * torch.repeat_interleave(inv_g, cg)
  shift = beta - torch.repeat_interleave(mean_g, cg) * scale
  return scale, shift


def _check(name, t, shape, dtype, device):
  if t.device != device:
    raise ValueError(f"{name} is on {t.device}, expected {device}")
  if t.dtype != dtype:
    raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
  if tuple(t.shape) != tuple(shape):
    raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                     f"{tuple(shape)}")
  if not t.is_contiguous():
    raise ValueError(f"{name} must be contiguous")


def _check_conv_args(x, w):
  """Validate the (h, w, cin) bf16 map and the (cout, cin, 3, 3) float32
  weights both wrappers take; returns (h, w, cin, cout)."""
  if x.dim() != 3:
    raise ValueError(f"x must be (h, w, cin), got {tuple(x.shape)}")
  h, wd, cin = x.shape
  if w.dim() != 4:
    raise ValueError(f"w must be (cout, cin, 3, 3), got {tuple(w.shape)}")
  cout = w.shape[0]
  _check("x", x, (h, wd, cin), torch.bfloat16, x.device)
  _check("w", w, (cout, cin, 3, 3), torch.float32, x.device)
  if cin % CIN_STEP or cout % COUT_TILE:
    raise ValueError(f"cin={cin} must be a multiple of {CIN_STEP} and "
                     f"cout={cout} of {COUT_TILE}")
  if h * wd == 0:
    raise ValueError("empty map")
  if x.device.type not in ("cpu", "cuda"):
    raise ValueError(f"the conv kernels run on cuda or cpu tensors, got "
                     f"{x.device}")
  if x.device.type == "cuda" and x.data_ptr() % 16:
    raise ValueError("x must be 16-byte aligned")
  return h, wd, cin, cout


class Plan(NamedTuple):
  """How one call runs: consumer warpgroups per block (each adds WG_ROWS
  map rows to the pixel tile), K splits across blocks (a divisor of
  cin / CIN_STEP; conv3x3_same only), and the resulting pixel tiles."""
  wgs: int
  splits: int
  tiles: int


def _tiles(h: int, w: int, wgs: int) -> int:
  return -(-h // (WG_ROWS * wgs)) * -(-w // TILE_W)


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
  """The SMs of CUDA device ``index``."""
  return torch.cuda.get_device_properties(index).multi_processor_count


@functools.lru_cache(maxsize=1024)
def plan(h: int, w: int, cin: int, cout: int, chain: bool = False,
         wgs: int | None = None, splits: int | None = None,
         sms: int = FILL_BLOCKS) -> Plan:
  """The launch plan of one call on a (h, w, cin) map with cout outputs.

  The work is cut into units of one pixel tile by COUT_TILE channels (by
  one K split), which a persistent grid of blocks takes in turn. By
  default: two consumer warpgroups a block (16 x 8-pixel tiles, one block
  an SM) where one-warpgroup tiles (8 x 8 pixels, two blocks an SM) would
  give more than ``sms`` units (the card's SMs) and two-warpgroup tiles
  no more; else one. conv3x3_same splits K into its single chunks where
  there are at least four and even then the units fill the card at most
  once (the small decoder maps); two-chunk splits lose what their
  split_sum pass costs. The chain does not split: its sums come from the
  full accumulator. These rules follow the card's times of every plan
  (``tools/conv_tiles.py``, PERF.md). ``wgs`` and ``splits`` override."""
  chunks = cin // CIN_STEP
  n_tiles = cout // COUT_TILE
  if wgs is None:
    wgs = 2 if (_tiles(h, w, 1) * n_tiles > sms
                >= _tiles(h, w, 2) * n_tiles) else 1
  if wgs not in (1, 2):
    raise ValueError(f"wgs={wgs}: the kernel has 1 or 2 consumer "
                     f"warpgroups")
  tiles = _tiles(h, w, wgs)
  if splits is None:
    splits = chunks if (not chain and chunks >= 4 and
                        tiles * n_tiles * chunks <= sms) else 1
  if splits < 1 or chunks % splits or (chain and splits != 1):
    raise ValueError(f"splits={splits} must divide cin/{CIN_STEP}="
                     f"{chunks}{' and be 1 for the chain' if chain else ''}")
  return Plan(wgs, splits, tiles)


# id(w) -> (weakref to w, w._version, w.data_ptr(), prepared layout)
_prepared = {}


def prepared_weights(w):
  """(cout, cin, 3, 3) float32 -> the kernels' B operand, (cout, 9*cin)
  bf16 with K = (3*dy + dx)*cin + c, made once per weight tensor and
  reused while the tensor's version counter and storage stay the same. An
  in-place update (``copy_``, ``mul_``, item assignment, under no_grad
  too) bumps the counter and so makes a new copy; new params are new
  tensors. A write through ``w.data`` bypasses the counter and is not
  seen: update weights through the tensor itself."""
  key = id(w)
  ent = _prepared.get(key)
  if ent is not None and ent[0]() is w and ent[1] == w._version and \
      ent[2] == w.data_ptr():
    return ent[3]
  cout, cin = w.shape[:2]
  wk = torch.empty((cout, 3, 3, cin), dtype=torch.bfloat16, device=w.device)
  wk.copy_(w.detach().permute(0, 2, 3, 1))
  wk = wk.view(cout, 9 * cin)
  prepared_weights.copies += 1
  if ent is None:  # an entry dies with its tensor
    weakref.finalize(w, _prepared.pop, key, None)
  _prepared[key] = (weakref.ref(w), w._version, w.data_ptr(), wk)
  return wk


prepared_weights.copies = 0  # layout copies made: one per weight tensor


def _refuse_grad(name, *tensors):
  """The kernels have no backward, as the Pallas kernels have no VJP:
  refuse a call that autograd would record, on any device."""
  if torch.is_grad_enabled() and any(
      t is not None and t.requires_grad for t in tensors):
    raise RuntimeError(
        f"{name} has no backward (as in the JAX package, the conv kernels "
        f"are for inference): call it under torch.no_grad() or with "
        f"tensors that do not require grad, or use conv_impl='xla'")


def _raise_on(lib, err, name):
  if err != 0:
    msg = lib.kfnet_conv3x3_error_string(err).decode()
    raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def _stream(dev):
  return torch.cuda.current_stream(dev).cuda_stream


def launch_same(x, wk, bias, y, partial, relu: bool, pl_: Plan) -> None:
  """The conv3x3_same kernel on checked CUDA tensors: x (h, w, cin) bf16,
  wk from ``prepared_weights``, y (h, w, cout) bf16 or float32, partial
  (splits, h*w, cout) float32 scratch when ``pl_.splits > 1``. Counts
  nothing: ``conv3x3_same`` is the counted entry point."""
  lib = _lib()
  h, wd, cin = x.shape
  err = lib.kfnet_conv3x3_same(
      x.data_ptr(), wk.data_ptr(),
      None if bias is None else bias.data_ptr(), y.data_ptr(),
      None if partial is None else partial.data_ptr(), h, wd, cin,
      y.shape[-1], int(relu), int(y.dtype == torch.float32), pl_.wgs,
      pl_.splits, x.device.index, _stream(x.device))
  _raise_on(lib, err, "conv3x3_same")


def launch_chain(x, scale, shift, wk, y, partial, s1, s2,
                 prologue_relu: bool, pl_: Plan) -> None:
  """The conv3x3_gn_chain kernels on checked CUDA tensors: partial is
  (pl_.tiles, 2, cout) float32 scratch. Counts nothing."""
  lib = _lib()
  h, wd, cin = x.shape
  err = lib.kfnet_conv3x3_gn_chain(
      x.data_ptr(), scale.data_ptr(), shift.data_ptr(), wk.data_ptr(),
      y.data_ptr(), partial.data_ptr(), s1.data_ptr(), s2.data_ptr(), h, wd,
      cin, y.shape[-1], int(prologue_relu), pl_.wgs, x.device.index,
      _stream(x.device))
  _raise_on(lib, err, "conv3x3_gn_chain")


def conv3x3_same(x, w, bias=None, relu: bool = False,
                 out_dtype=torch.bfloat16):
  """(h, w, cin) bf16 x (cout, cin, 3, 3) -> (h, w, cout), SAME, stride 1:
  bf16 products summed in float32, + float32 ``bias``, optional ReLU, one
  rounding to ``out_dtype`` (bfloat16 or float32)."""
  h, wd, cin, cout = _check_conv_args(x, w)
  if out_dtype not in (torch.bfloat16, torch.float32):
    raise TypeError(f"out_dtype must be bfloat16 or float32, got {out_dtype}")
  if bias is not None:
    _check("bias", bias, (cout,), torch.float32, x.device)
  _refuse_grad("conv3x3_same", x, w, bias)
  if x.device.type == "cpu":
    return conv3x3_same_reference(x, w, bias, relu, out_dtype)
  dev = x.device
  pl_ = plan(h, wd, cin, cout, sms=sm_count(dev.index))
  y = torch.empty((h, wd, cout), dtype=out_dtype, device=dev)
  partial = None
  if pl_.splits > 1:
    partial = torch.empty((pl_.splits, h * wd, cout), dtype=torch.float32,
                          device=dev)
  launch_same(x, prepared_weights(w), bias, y, partial, relu, pl_)
  launches.count(conv3x3_same)
  return y


def conv3x3_gn_chain(x, scale, shift, w, prologue_relu: bool = True):
  """One fused-trunk step: normalize (+ReLU) the raw (h, w, cin) bf16 input
  with the per-channel float32 (scale, shift), convolve 3x3 SAME with the
  (cout, cin, 3, 3) weights, and return (y (h, w, cout) bf16, Σy (cout,)
  f32, Σy² (cout,) f32), the sums taken over the pixels of the float32
  accumulator."""
  h, wd, cin, cout = _check_conv_args(x, w)
  _check("scale", scale, (cin,), torch.float32, x.device)
  _check("shift", shift, (cin,), torch.float32, x.device)
  _refuse_grad("conv3x3_gn_chain", x, scale, shift, w)
  if x.device.type == "cpu":
    return conv3x3_gn_chain_reference(x, scale, shift, w, prologue_relu)
  dev = x.device
  pl_ = plan(h, wd, cin, cout, chain=True, sms=sm_count(dev.index))
  y = torch.empty((h, wd, cout), dtype=torch.bfloat16, device=dev)
  partial = torch.empty((pl_.tiles, 2, cout), dtype=torch.float32,
                        device=dev)
  s1 = torch.empty((cout,), dtype=torch.float32, device=dev)
  s2 = torch.empty((cout,), dtype=torch.float32, device=dev)
  launch_chain(x, scale, shift, prepared_weights(w), y, partial, s1, s2,
               prologue_relu, pl_)
  launches.count(conv3x3_gn_chain)
  return y, s1, s2


conv3x3_same.launches = 0
conv3x3_gn_chain.launches = 0
