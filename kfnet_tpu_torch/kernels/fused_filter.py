"""Fused warp + Kalman update: the CUDA kernel ``csrc/fused_filter.cu``
and its plain PyTorch version.

Port of the Pallas kernel ``kfnet_tpu/kernels/fused_filter.py::_kernel``.
Semantics: ``core.warp.warp_state_cov`` then ``core.kalman.kalman_update``,
with the sample taken at the flow clipped to [-radius, radius] and
validity judged on the raw flow (the Pallas kernel's contract; the model
clips the flow before the call, so both agree there).

``fused_warp_kalman`` launches the kernel for CUDA tensors and takes the
plain version only for CPU tensors. Its ``launches`` attribute counts the
kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from kfnet_tpu_torch.core import kalman
from kfnet_tpu_torch.core import warp as warp_lib

SOURCES = ("fused_filter.cu",)


_LIB = None


def _lib():
  global _LIB
  if _LIB is None:
    from kfnet_tpu_torch.kernels import _build
    lib = _build.load_library("kfnet_fused_filter", SOURCES)
    fn = lib.kfnet_fused_warp_kalman
    fn.restype = ctypes.c_int
    # pointers and the stream as c_void_p: a plain int would be cut to 32 bits
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 2 +
                   [ctypes.c_float] * 3 + [ctypes.c_int, ctypes.c_void_p])
    lib.kfnet_cuda_error_string.restype = ctypes.c_char_p
    lib.kfnet_cuda_error_string.argtypes = [ctypes.c_int]
    _LIB = lib
  return _LIB


def build() -> None:
  """Build (or load the cached) kernel library without launching it."""
  _lib()


def fused_warp_kalman_reference(x_prev, P_prev, flow, W, z, V, radius: int,
                                threshold: float = kalman.CHI2_3DOF_P05,
                                invalid_cov: float = 1e8):
  """The plain PyTorch version of the kernel (same arithmetic, same order).

  Returns (x_post (h,w,3) f32, P_post (h,w,1) f32, consistent (h,w,1) bool).
  """
  r = float(radius)
  x_pr, P_pr, _ = warp_lib.warp_state_cov(
      x_prev, P_prev, torch.clamp(flow, -r, r), W, invalid_cov=invalid_cov)
  # validity on the raw flow; inside the map at the raw flow implies
  # inside at the clipped one, so this only removes samples
  h, w = flow.shape[:2]
  pos = warp_lib.base_grid(h, w, dtype=flow.dtype, device=flow.device) + flow
  u, v = pos[..., 0:1], pos[..., 1:2]
  valid = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
  zero = torch.zeros((), dtype=x_pr.dtype, device=x_pr.device)
  x_pr = torch.where(valid, x_pr, zero)
  P_pr = torch.where(valid, P_pr, torch.full_like(zero, invalid_cov))
  return kalman.kalman_update(x_pr, P_pr, z, V, threshold=threshold)


def _check(name, t, shape, device):
  if t.device != device:
    raise ValueError(f"{name} is on {t.device}, expected {device}")
  if t.dtype != torch.float32:
    raise TypeError(f"{name} must be float32, got {t.dtype}")
  if tuple(t.shape) != shape:
    raise ValueError(f"{name} has shape {tuple(t.shape)}, expected {shape}")
  if not t.is_contiguous():
    raise ValueError(f"{name} must be contiguous")


def fused_warp_kalman(x_prev, P_prev, flow, W, z, V, radius: int,
                      threshold: float = kalman.CHI2_3DOF_P05,
                      invalid_cov: float = 1e8):
  """One fused filter inner step on (h, w, C) float32 maps.

  Args:
    x_prev: (h, w, 3) previous posterior; P_prev: (h, w, 1).
    flow: (h, w, 2) backward flow; W: (h, w, 1) process noise.
    z: (h, w, 3) measurement; V: (h, w, 1) measurement noise.
    radius: flow clip bound (the OFlowNet search radius).

  Returns:
    (x_post (h,w,3) f32, P_post (h,w,1) f32, consistent (h,w,1) bool).
  """
  if x_prev.device.type == "cpu":
    return fused_warp_kalman_reference(x_prev, P_prev, flow, W, z, V,
                                       radius, threshold, invalid_cov)
  if x_prev.device.type != "cuda":
    raise ValueError(f"fused_warp_kalman runs on cuda or cpu tensors, got "
                     f"{x_prev.device}")
  if x_prev.dim() != 3:
    raise ValueError(f"x_prev must be (h, w, 3), got {tuple(x_prev.shape)}")
  h, w = x_prev.shape[:2]
  dev = x_prev.device
  for name, t, c in (("x_prev", x_prev, 3), ("P_prev", P_prev, 1),
                     ("flow", flow, 2), ("W", W, 1), ("z", z, 3),
                     ("V", V, 1)):
    _check(name, t, (h, w, c), dev)
  lib = _lib()
  x_post = torch.empty((h, w, 3), dtype=torch.float32, device=dev)
  P_post = torch.empty((h, w, 1), dtype=torch.float32, device=dev)
  cons = torch.empty((h, w, 1), dtype=torch.bool, device=dev)
  stream = torch.cuda.current_stream(dev).cuda_stream
  err = lib.kfnet_fused_warp_kalman(
      x_prev.data_ptr(), P_prev.data_ptr(), flow.data_ptr(), W.data_ptr(),
      z.data_ptr(), V.data_ptr(), x_post.data_ptr(), P_post.data_ptr(),
      cons.data_ptr(), h, w, float(radius), float(threshold),
      float(invalid_cov), dev.index, stream)
  if err != 0:
    msg = lib.kfnet_cuda_error_string(err).decode()
    raise RuntimeError(f"fused_warp_kalman launch failed: {msg} ({err})")
  fused_warp_kalman.launches += 1
  return x_post, P_post, cons


fused_warp_kalman.launches = 0
