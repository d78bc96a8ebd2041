"""The fused filter update: the CUDA kernel ``csrc/fused_filter.cu`` and its
plain PyTorch versions.

Port of the Pallas kernel ``kfnet_tpu/kernels/fused_filter.py::_kernel``.
Two entries share the kernel's body:

  * ``fused_warp_kalman`` keeps the TPU kernel's contract: (x_prev, P_prev,
    flow, W, z, V) -> (x_post, P_post, consistent). Semantics:
    ``core.warp.warp_state_cov`` then ``core.kalman.kalman_update``, with
    the sample taken at the flow clipped to [-radius, radius] and validity
    judged on the flow as given.
  * ``fused_filter_step`` takes the two heads' raw float32 outputs instead,
    OFlowNet's (..., 3) and SCoordNet's (..., 4), and applies the heads'
    output steps (``core.heads``, with the clamps and scales the caller
    passes), ``w_scale`` and the flow clip, then the same update; it
    returns (flow, W, z, V) too. ``models/kfnet.filter_step`` takes it.

Both take one (h, w, C) map or a (B, h, w, C) batch, in one launch. For CPU
tensors they take their plain version; for CUDA tensors they launch the
kernel or raise. Each has a ``launches`` count (``kernels.launches``: under
CUDA graph capture a launch counts once per replay). Both are differentiable
on both devices: on the card, when autograd records the call, the launch
runs inside an ``autograd.Function`` whose backward is autograd through the
plain version, as the JAX package's custom VJP (``_fused_bwd``) is the VJP
of its XLA composition.
"""

from __future__ import annotations

import ctypes
import functools

import torch

from kfnet_tpu_torch.core import heads, kalman
from kfnet_tpu_torch.core import warp as warp_lib
from kfnet_tpu_torch.kernels import launches as launch_count

LIBRARY = "kfnet_fused_filter"
SOURCES = ("fused_filter.cu",)

_LIB = None


def _lib():
  global _LIB
  if _LIB is None:
    from kfnet_tpu_torch.kernels import _build
    lib = _build.load_library(LIBRARY, SOURCES)
    # pointers and the stream as c_void_p: a plain int would be cut to 32 bits
    fn = lib.kfnet_fused_warp_kalman
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 9 + [ctypes.c_int] * 4 +
                   [ctypes.c_float] * 2 + [ctypes.c_int] + [ctypes.c_void_p])
    fn = lib.kfnet_fused_filter_step
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 11 + [ctypes.c_int] * 4 +
                   [ctypes.c_void_p] + [ctypes.c_float] * 2 +
                   [ctypes.c_int] + [ctypes.c_void_p])
    lib.kfnet_cuda_error_string.restype = ctypes.c_char_p
    lib.kfnet_cuda_error_string.argtypes = [ctypes.c_int]
    _LIB = lib
  return _LIB


def build() -> None:
  """Build (or load the cached) kernel library without launching it."""
  _lib()


def _per_map(fn, *maps):
  """``fn`` on each map of a (B, h, w, C) batch, results stacked; on one
  (h, w, C) map, ``fn`` itself."""
  if maps[0].dim() == 3:
    return fn(*maps)
  outs = [fn(*one) for one in zip(*maps)]
  return tuple(torch.stack(parts) for parts in zip(*outs))


def fused_warp_kalman_reference(x_prev, P_prev, flow, W, z, V, radius: int,
                                threshold: float = kalman.CHI2_3DOF_P05,
                                invalid_cov: float = 1e8):
  """The plain PyTorch version of the kernel (same arithmetic, same order).

  Returns (x_post (..,3) f32, P_post (..,1) f32, consistent (..,1) bool)."""
  r = float(radius)

  def one(x_prev, P_prev, flow, W, z, V):
    x_pr, P_pr, _ = warp_lib.warp_state_cov(
        x_prev, P_prev, torch.clamp(flow, -r, r), W, invalid_cov=invalid_cov)
    # validity on the flow as given; inside the map at it implies inside
    # at the clipped one, so this only removes samples
    h, w = flow.shape[:2]
    pos = warp_lib.base_grid(h, w, dtype=flow.dtype, device=flow.device) + flow
    u, v = pos[..., 0:1], pos[..., 1:2]
    valid = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
    zero = torch.zeros((), dtype=x_pr.dtype, device=x_pr.device)
    x_pr = torch.where(valid, x_pr, zero)
    P_pr = torch.where(valid, P_pr, torch.full_like(zero, invalid_cov))
    return kalman.kalman_update(x_pr, P_pr, z, V, threshold=threshold)

  return _per_map(one, x_prev, P_prev, flow, W, z, V)


def fused_filter_step_reference(raw_flow_head, raw_coord_head, x_prev,
                                P_prev, radius: int, w_scale: float,
                                coord_scale: float, coord_offset,
                                log_w_clip, log_v_clip,
                                threshold: float = kalman.CHI2_3DOF_P05,
                                invalid_cov: float = 1e8):
  """The plain PyTorch version of ``fused_filter_step``: the heads' output
  steps (``core.heads``), ``w_scale`` and the flow clip, then
  ``fused_warp_kalman_reference``.

  Returns (x_post, P_post, consistent, flow, W, z, V)."""
  flow, W = heads.flow_output(raw_flow_head, radius, log_w_clip)
  W = W * w_scale
  r = float(radius)
  flow = torch.clamp(flow, -r, r)
  z, V = heads.coord_output(raw_coord_head, coord_scale, coord_offset,
                            log_v_clip)
  x_post, P_post, consistent = fused_warp_kalman_reference(
      x_prev, P_prev, flow, W, z, V, radius, threshold, invalid_cov)
  return x_post, P_post, consistent, flow, W, z, V


def _check(name, t, shape, device):
  if t.device != device:
    raise ValueError(f"{name} is on {t.device}, expected {device}")
  if t.dtype != torch.float32:
    raise TypeError(f"{name} must be float32, got {t.dtype}")
  if t.shape != shape:
    raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                     f"{tuple(shape)}")
  if not t.is_contiguous():
    raise ValueError(f"{name} must be contiguous")


def _check_maps(named):
  """Check (name, tensor, channels) triples against the first one's
  (B, h, w) or (h, w); returns (lead dims, device)."""
  first = named[0][1]
  if first.dim() not in (3, 4):
    raise ValueError(f"{named[0][0]} must be (h, w, C) or (B, h, w, C), got "
                     f"{tuple(first.shape)}")
  lead = first.shape[:-1]
  dev = first.device
  for name, t, c in named:
    _check(name, t, (*lead, c), dev)
  return lead, dev


def _batch(lead):
  """(b, h, w) of (h, w) or (B, h, w) leading dims."""
  return (1, *lead) if len(lead) == 2 else tuple(lead)


@functools.lru_cache(maxsize=64)
def _layout(lead: tuple, channels: tuple):
  """Where the outputs lie in one float32 buffer: for (lead dims, the
  outputs' channel counts), the buffer's length in float32 (the outputs
  one after the other, contiguous, then the mask's bytes) and each
  output's (size, stride, offset) for ``as_strided``; the mask's offset is
  in bytes."""
  n = 1
  for d in lead:
    n *= d
  outs, at = [], 0
  for c in channels:
    size = (*lead, c)
    stride = [1] * len(size)
    for i in range(len(size) - 2, -1, -1):
      stride[i] = stride[i + 1] * size[i + 1]
    outs.append((size, tuple(stride), at))
    at += c * n
  mask = ((*lead, 1), outs[1][1], 4 * at)  # P's strides: one channel
  return at + (n + 3) // 4, outs, mask


def _outputs(lead, channels, device):
  """One allocation and its views: the float32 outputs, then the mask."""
  length, outs, mask = _layout(tuple(lead), channels)
  buf = torch.empty((length,), dtype=torch.float32, device=device)
  return ([buf.as_strided(*o) for o in outs] +
          [buf.view(torch.bool).as_strided(*mask)])


def _raise_on(lib, err, name):
  if err != 0:
    msg = lib.kfnet_cuda_error_string(err).decode()
    raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def _launch(x_prev, P_prev, flow, W, z, V, radius, threshold, invalid_cov):
  """The CUDA kernel on checked float32 CUDA maps (one output buffer)."""
  lead = x_prev.shape[:-1]
  b, h, w = _batch(lead)
  dev = x_prev.device
  lib = _lib()
  x_post, P_post, cons = _outputs(lead, (3, 1), dev)
  err = lib.kfnet_fused_warp_kalman(
      x_prev.data_ptr(), P_prev.data_ptr(), flow.data_ptr(), W.data_ptr(),
      z.data_ptr(), V.data_ptr(), x_post.data_ptr(), P_post.data_ptr(),
      cons.data_ptr(), b, h, w, int(radius), float(threshold),
      float(invalid_cov), dev.index,
      torch.cuda.current_stream(dev).cuda_stream)
  _raise_on(lib, err, "fused_warp_kalman")
  launch_count.count(fused_warp_kalman)
  return x_post, P_post, cons


@functools.lru_cache(maxsize=64)
def _step_constants(w_scale, coord_scale, coord_offset: tuple,
                    log_w_clip: tuple, log_v_clip: tuple):
  """The output steps' constants, in the order the C entry reads them (the
  C entry only reads them)."""
  off = tuple(float(o) for o in coord_offset)
  if len(off) != 3:
    raise ValueError(f"coord_offset must have 3 values, got {len(off)}")
  return (ctypes.c_float * 10)(
      float(w_scale), *(float(c) for c in log_w_clip), float(coord_scale),
      *off, float(coord_scale) ** 2, *(float(c) for c in log_v_clip))


def _launch_step(raw_flow_head, raw_coord_head, x_prev, P_prev, radius,
                 w_scale, coord_scale, coord_offset, log_w_clip, log_v_clip,
                 threshold, invalid_cov):
  """The CUDA kernel's heads-in entry on checked CUDA tensors: one output
  buffer, one launch. Returns (x_post, P_post, consistent, flow, W, z, V),
  views of that buffer."""
  lead = x_prev.shape[:-1]
  b, h, w = _batch(lead)
  dev = x_prev.device
  lib = _lib()
  x_post, P_post, flow, W, z, V, cons = _outputs(
      lead, (3, 1, 2, 1, 3, 1), dev)
  err = lib.kfnet_fused_filter_step(
      raw_flow_head.data_ptr(), raw_coord_head.data_ptr(), x_prev.data_ptr(),
      P_prev.data_ptr(), x_post.data_ptr(), P_post.data_ptr(),
      cons.data_ptr(), flow.data_ptr(), W.data_ptr(), z.data_ptr(),
      V.data_ptr(), b, h, w, int(radius),
      _step_constants(w_scale, coord_scale, tuple(coord_offset),
                      tuple(log_w_clip), tuple(log_v_clip)),
      float(threshold), float(invalid_cov), dev.index,
      torch.cuda.current_stream(dev).cuda_stream)
  _raise_on(lib, err, "fused_filter_step")
  launch_count.count(fused_filter_step)
  return x_post, P_post, cons, flow, W, z, V


def _grads_through(reference, saved, grads, args):
  """Gradients of the saved inputs: autograd through ``reference`` at them,
  for the cotangents ``grads`` of its outputs (None: not differentiable)."""
  inputs = [t.detach().requires_grad_(True) for t in saved]
  with torch.enable_grad():
    out = reference(*inputs, *args)
  pairs = [(o, g) for o, g in zip(out, grads) if g is not None]
  return torch.autograd.grad([o for o, _ in pairs], inputs,
                             [g for _, g in pairs], allow_unused=True)


class FusedWarpKalman(torch.autograd.Function):
  """The kernel's launch for the outputs; autograd through
  ``fused_warp_kalman_reference``, recomputed from the saved inputs, for
  the gradients of (x_post, P_post). The mask has none.

      FusedWarpKalman.apply(x_prev, P_prev, flow, W, z, V, radius,
                            threshold, invalid_cov)
  """

  @staticmethod
  def forward(ctx, x_prev, P_prev, flow, W, z, V, radius, threshold,
              invalid_cov):
    out = _launch(x_prev, P_prev, flow, W, z, V, radius, threshold,
                  invalid_cov)
    ctx.save_for_backward(x_prev, P_prev, flow, W, z, V)
    ctx.args = (radius, threshold, invalid_cov)
    ctx.mark_non_differentiable(out[2])
    return out

  @staticmethod
  def backward(ctx, g_x, g_P, _g_mask):
    grads = _grads_through(fused_warp_kalman_reference, ctx.saved_tensors,
                           (g_x, g_P), ctx.args)
    return (*grads, None, None, None)


class FusedFilterStep(torch.autograd.Function):
  """``fused_filter_step``'s launch for the outputs; autograd through
  ``fused_filter_step_reference``, recomputed from the saved inputs, for
  the gradients of the raw heads, x_prev and P_prev. x_post, P_post, flow,
  W, z and V all carry gradients; the mask has none.

      FusedFilterStep.apply(raw_flow_head, raw_coord_head, x_prev, P_prev,
                            radius, w_scale, coord_scale, coord_offset,
                            log_w_clip, log_v_clip, threshold, invalid_cov)
  """

  @staticmethod
  def forward(ctx, raw_flow_head, raw_coord_head, x_prev, P_prev, radius,
              w_scale, coord_scale, coord_offset, log_w_clip, log_v_clip,
              threshold, invalid_cov):
    args = (radius, w_scale, coord_scale, coord_offset, log_w_clip,
            log_v_clip, threshold, invalid_cov)
    out = _launch_step(raw_flow_head, raw_coord_head, x_prev, P_prev, *args)
    ctx.save_for_backward(raw_flow_head, raw_coord_head, x_prev, P_prev)
    ctx.args = args
    ctx.mark_non_differentiable(out[2])
    return out

  @staticmethod
  def backward(ctx, g_x, g_P, _g_mask, g_flow, g_W, g_z, g_V):
    grads = _grads_through(fused_filter_step_reference, ctx.saved_tensors,
                           (g_x, g_P, None, g_flow, g_W, g_z, g_V), ctx.args)
    return (*grads, None, None, None, None, None, None, None, None)


def _wants_grad(tensors):
  return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


DEFAULT_RADIUS = 8  # radius=None: the JAX package's default search radius


def fused_warp_kalman(x_prev, P_prev, flow, W, z, V,
                      radius: int | None = None,
                      threshold: float = kalman.CHI2_3DOF_P05,
                      invalid_cov: float = 1e8):
  """One fused filter inner step on float32 maps, one (h, w, C) map or a
  (B, h, w, C) batch.

  Args:
    x_prev: (.., 3) previous posterior; P_prev: (.., 1).
    flow: (.., 2) backward flow; W: (.., 1) process noise.
    z: (.., 3) measurement; V: (.., 1) measurement noise.
    radius: flow clip bound (the OFlowNet search radius); None means
      ``DEFAULT_RADIUS``, as in the JAX package.

  Returns:
    (x_post (..,3) f32, P_post (..,1) f32, consistent (..,1) bool).
  """
  if radius is None:
    radius = DEFAULT_RADIUS
  inputs = (x_prev, P_prev, flow, W, z, V)
  if x_prev.device.type == "cpu":
    return fused_warp_kalman_reference(*inputs, radius, threshold,
                                       invalid_cov)
  if x_prev.device.type != "cuda":
    raise ValueError(f"fused_warp_kalman runs on cuda or cpu tensors, got "
                     f"{x_prev.device}")
  _check_maps(list(zip(("x_prev", "P_prev", "flow", "W", "z", "V"), inputs,
                       (3, 1, 2, 1, 3, 1))))
  if _wants_grad(inputs):
    return FusedWarpKalman.apply(*inputs, radius, threshold, invalid_cov)
  return _launch(*inputs, radius, threshold, invalid_cov)


def fused_filter_step(raw_flow_head, raw_coord_head, x_prev, P_prev, *,
                      radius: int, w_scale: float, coord_scale: float,
                      coord_offset, log_w_clip, log_v_clip,
                      threshold: float = kalman.CHI2_3DOF_P05,
                      invalid_cov: float = 1e8):
  """The filter update from the two heads' raw outputs, one (h, w, C) map
  or a (B, h, w, C) batch, float32.

  Args:
    raw_flow_head: (.., 3) OFlowNet's head: raw flow (2), raw log W (1).
    raw_coord_head: (.., 4) SCoordNet's head: raw coordinates (3), raw log
      V (1); 16-byte aligned on the card.
    x_prev: (.., 3) previous posterior; P_prev: (.., 1).
    radius: OFlowNet's search radius (the flow's bound and clip).
    w_scale: process-noise scale; coord_scale, coord_offset: SCoordNet's
      coordinate frame.
    log_w_clip, log_v_clip: (lo, hi) clamps of the raw log W and log V
      (the nets' ``LOG_VAR_CLIP``).

  Returns:
    (x_post (..,3), P_post (..,1), consistent (..,1) bool, flow (..,2),
    W (..,1), z (..,3), V (..,1)).
  """
  inputs = (raw_flow_head, raw_coord_head, x_prev, P_prev)
  args = (radius, w_scale, coord_scale, coord_offset, log_w_clip, log_v_clip,
          threshold, invalid_cov)
  if x_prev.device.type == "cpu":
    return fused_filter_step_reference(*inputs, *args)
  if x_prev.device.type != "cuda":
    raise ValueError(f"fused_filter_step runs on cuda or cpu tensors, got "
                     f"{x_prev.device}")
  _check_maps([("x_prev", x_prev, 3), ("P_prev", P_prev, 1),
               ("raw_flow_head", raw_flow_head, 3),
               ("raw_coord_head", raw_coord_head, 4)])
  if raw_coord_head.data_ptr() % 16:
    raise ValueError("raw_coord_head must be 16-byte aligned")
  if _wants_grad(inputs):
    return FusedFilterStep.apply(*inputs, *args)
  return _launch_step(*inputs, *args)


fused_warp_kalman.launches = 0
fused_filter_step.launches = 0
