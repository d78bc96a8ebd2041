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
(cout, cin, 3, 3) float32. Both kernels cast the weights to bf16 and
accumulate bf16 products in float32. Each wrapper checks its arguments,
takes the plain version only for CPU tensors, launches the kernel for CUDA
tensors and raises otherwise; its ``launches`` attribute counts the calls
that launched the kernel.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from kfnet_tpu_torch.nn import layers as L

LIBRARY = "kfnet_conv3x3"
SOURCES = ("conv3x3.cu",)
# the kernel's tiles: cin must be a multiple of CIN_STEP, cout of COUT_TILE
CIN_STEP = 32
COUT_TILE = 128

_LIB = None


def _lib():
  global _LIB
  if _LIB is None:
    from kfnet_tpu_torch.kernels import _build
    lib = _build.load_library(LIBRARY, SOURCES)
    # pointers and the stream as c_void_p: a plain int would be cut to 32 bits
    lib.kfnet_conv3x3_same.restype = ctypes.c_int
    lib.kfnet_conv3x3_same.argtypes = (
        [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p])
    lib.kfnet_conv3x3_gn_chain.restype = ctypes.c_int
    lib.kfnet_conv3x3_gn_chain.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 6 + [ctypes.c_void_p])
    lib.kfnet_conv3x3_block_m.restype = ctypes.c_int
    lib.kfnet_conv3x3_block_m.argtypes = []
    lib.kfnet_conv3x3_error_string.restype = ctypes.c_char_p
    lib.kfnet_conv3x3_error_string.argtypes = [ctypes.c_int]
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


def _kernel_weights(w):
  """(cout, cin, 3, 3) float32 -> (3, 3, cin, cout) bf16, the kernel's B
  layout: one copy kernel per call."""
  cout, cin = w.shape[:2]
  wk = torch.empty((3, 3, cin, cout), dtype=torch.bfloat16, device=w.device)
  return wk.copy_(w.permute(2, 3, 1, 0))


def _raise_on(lib, err, name):
  if err != 0:
    msg = lib.kfnet_conv3x3_error_string(err).decode()
    raise RuntimeError(f"{name} launch failed: {msg} ({err})")


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
  if x.device.type == "cpu":
    return conv3x3_same_reference(x, w, bias, relu, out_dtype)
  lib = _lib()
  dev = x.device
  wk = _kernel_weights(w)
  y = torch.empty((h, wd, cout), dtype=out_dtype, device=dev)
  err = lib.kfnet_conv3x3_same(
      x.data_ptr(), wk.data_ptr(),
      None if bias is None else bias.data_ptr(), y.data_ptr(), h, wd, cin,
      cout, int(relu), int(out_dtype == torch.float32), dev.index,
      torch.cuda.current_stream(dev).cuda_stream)
  _raise_on(lib, err, "conv3x3_same")
  conv3x3_same.launches += 1
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
  if x.device.type == "cpu":
    return conv3x3_gn_chain_reference(x, scale, shift, w, prologue_relu)
  lib = _lib()
  dev = x.device
  wk = _kernel_weights(w)
  tiles = -(-(h * wd) // lib.kfnet_conv3x3_block_m())
  y = torch.empty((h, wd, cout), dtype=torch.bfloat16, device=dev)
  partial = torch.empty((tiles, 2, cout), dtype=torch.float32, device=dev)
  s1 = torch.empty((cout,), dtype=torch.float32, device=dev)
  s2 = torch.empty((cout,), dtype=torch.float32, device=dev)
  err = lib.kfnet_conv3x3_gn_chain(
      x.data_ptr(), scale.data_ptr(), shift.data_ptr(), wk.data_ptr(),
      y.data_ptr(), partial.data_ptr(), s1.data_ptr(), s2.data_ptr(), h, wd,
      cin, cout, int(prologue_relu), dev.index,
      torch.cuda.current_stream(dev).cuda_stream)
  _raise_on(lib, err, "conv3x3_gn_chain")
  conv3x3_gn_chain.launches += 1
  return y, s1, s2


conv3x3_same.launches = 0
conv3x3_gn_chain.launches = 0
