"""ctypes bridge to the port's host data path, ``data/csrc/kfnet_native.cpp``
(port of ``kfnet_tpu/data/native_io.py``): PNG decode, JPEG decode (the
port's own addition, for 12-Scenes colour), fused depth -> label
generation and the multi-threaded batch loader.

The library is built from the source in the checkout at first use, with
the host's C++ compiler (``kernels/_build.py``: cached by source hash under
``build/kfnet_tpu_torch/``). There is no fallback: where the library
cannot be built or loaded, ``load_library`` raises with the compiler's
output, and every reader here raises with it.
"""

from __future__ import annotations

import ctypes
import os

import numpy as np

from kfnet_tpu_torch.kernels import _build

LIBRARY = "kfnet_native"
SOURCES = (os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                        "kfnet_native.cpp"),)

_LIB = None


def load_library() -> ctypes.CDLL:
  """The built library (built and loaded once per process)."""
  global _LIB
  if _LIB is not None:
    return _LIB
  try:
    lib = _build.load_library(LIBRARY, SOURCES, host=True)
  except (RuntimeError, OSError) as e:
    raise RuntimeError(f"the port's host data library "
                       f"(data/csrc/kfnet_native.cpp) could not be built or "
                       f"loaded: {e}") from e
  c = ctypes
  lib.kfn_png_info.restype = c.c_int
  lib.kfn_png_info.argtypes = [c.c_char_p, c.c_size_t, c.POINTER(c.c_int),
                               c.POINTER(c.c_int), c.POINTER(c.c_int),
                               c.POINTER(c.c_int)]
  lib.kfn_png_decode.restype = c.c_int
  lib.kfn_png_decode.argtypes = [c.c_char_p, c.c_size_t, c.c_void_p]
  lib.kfn_png_decode_rgb_f32.restype = c.c_int
  lib.kfn_png_decode_rgb_f32.argtypes = [c.c_char_p, c.c_size_t,
                                         c.POINTER(c.c_float)]
  lib.kfn_jpeg_info.restype = c.c_int
  lib.kfn_jpeg_info.argtypes = [c.c_char_p, c.c_size_t, c.POINTER(c.c_int),
                                c.POINTER(c.c_int), c.POINTER(c.c_int)]
  lib.kfn_jpeg_decode.restype = c.c_int
  lib.kfn_jpeg_decode.argtypes = [c.c_char_p, c.c_size_t,
                                  c.POINTER(c.c_uint8)]
  lib.kfn_depth_to_labels.restype = c.c_int
  lib.kfn_depth_to_labels.argtypes = [
      c.c_char_p, c.c_size_t, c.POINTER(c.c_float), c.POINTER(c.c_float),
      c.c_int, c.c_float, c.c_float, c.c_float, c.c_uint16,
      c.POINTER(c.c_float), c.POINTER(c.c_uint8), c.POINTER(c.c_int),
      c.POINTER(c.c_int)]
  lib.kfn_load_batch.restype = c.c_int
  lib.kfn_load_batch.argtypes = [
      c.POINTER(c.c_char_p), c.POINTER(c.c_char_p), c.c_int, c.c_int,
      c.c_int, c.POINTER(c.c_float), c.POINTER(c.c_float), c.c_int,
      c.c_float, c.c_float, c.c_float, c.c_uint16, c.c_int,
      c.POINTER(c.c_float), c.POINTER(c.c_float), c.POINTER(c.c_uint8)]
  _LIB = lib
  return _LIB


def available() -> bool:
  """True where the library builds and loads (wherever the host has a C++
  compiler and zlib's header); ``load_library`` says why not."""
  try:
    load_library()
  except RuntimeError:
    return False
  return True


def _f32p(a: np.ndarray):
  return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _png_info(data: bytes):
  """(width, height, channels, bit depth) of PNG bytes."""
  lib = load_library()
  w, h, c, b = (ctypes.c_int() for _ in range(4))
  rc = lib.kfn_png_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                        ctypes.byref(c), ctypes.byref(b))
  if rc != 0:
    raise ValueError("unsupported or corrupt PNG (palette and interlaced "
                     "files are not decoded)")
  return w.value, h.value, c.value, b.value


def decode(data: bytes) -> np.ndarray:
  """PNG bytes -> (H, W) for one channel, else (H, W, C); uint8 or uint16
  as the file's bit depth."""
  lib = load_library()
  w, h, c, bits = _png_info(data)
  out = np.empty((h, w, c), np.uint8 if bits == 8 else np.uint16)
  rc = lib.kfn_png_decode(data, len(data),
                          out.ctypes.data_as(ctypes.c_void_p))
  if rc != 0:
    raise ValueError(f"PNG decode failed ({rc})")
  return out[..., 0] if c == 1 else out


def decode_jpeg(data: bytes) -> np.ndarray:
  """JPEG bytes -> (H, W) uint8 for one component, else (H, W, 3) uint8
  RGB (the scope and arithmetic of ``image_io.decode_jpeg_plain``, which
  the tests hold it against). Raises ``image_io.jpeg_exception``'s exception
  for the library's return code."""
  from kfnet_tpu_torch.data import image_io
  lib = load_library()
  data = bytes(data)
  w, h, c = (ctypes.c_int() for _ in range(3))
  rc = lib.kfn_jpeg_info(data, len(data), ctypes.byref(w), ctypes.byref(h),
                         ctypes.byref(c))
  if rc != 0:
    raise image_io.jpeg_exception(rc, str(c.value) if rc == -3 else "")
  out = np.empty((h.value, w.value, c.value), np.uint8)
  rc = lib.kfn_jpeg_decode(data, len(data),
                           out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
  if rc != 0:
    raise image_io.jpeg_exception(rc)
  return out[..., 0] if c.value == 1 else out


def _read(path: str) -> bytes:
  with open(path, "rb") as f:
    return f.read()


def read_color(path: str) -> np.ndarray:
  """(H, W, 3) float32 in [0, 1] of an 8-bit PNG (grey broadcast, alpha
  dropped)."""
  lib = load_library()
  data = _read(path)
  w, h, _, bits = _png_info(data)
  if bits != 8:
    raise ValueError(f"{path}: a {bits}-bit colour PNG; colour frames are "
                     "8-bit")
  out = np.empty((h, w, 3), np.float32)
  rc = lib.kfn_png_decode_rgb_f32(data, len(data), _f32p(out))
  if rc != 0:
    raise ValueError(f"native decode failed ({rc}) for {path}")
  return out


def read_depth_raw(path: str) -> np.ndarray:
  """(H, W) uint16 raw depth of a 16-bit grey PNG."""
  data = _read(path)
  _, _, c, bits = _png_info(data)
  if bits != 16 or c != 1:
    raise ValueError(f"{path}: depth must be a 16-bit grey PNG, not "
                     f"{c} channel(s) of {bits} bits")
  try:
    return decode(data)
  except ValueError as e:
    raise ValueError(f"{e} for {path}") from e


def depth_png_to_labels(path: str, K: np.ndarray, T_wc: np.ndarray,
                        stride: int = 8, depth_scale: float = 1e-3,
                        min_depth: float = 0.05, max_depth: float = 20.0,
                        invalid_value: int = 65535):
  """Depth PNG file -> (coords (h, w, 3) float32, valid (h, w) bool) in one
  pass, as ``labels.generate`` of ``seven_scenes.read_depth(path)``."""
  lib = load_library()
  data = _read(path)
  w, h, _, _ = _png_info(data)
  hs, ws = h // stride, w // stride
  coords = np.empty((hs, ws, 3), np.float32)
  valid = np.empty((hs, ws), np.uint8)
  oh, ow = ctypes.c_int(), ctypes.c_int()
  Kf = np.ascontiguousarray(K, np.float32)
  Tf = np.ascontiguousarray(T_wc, np.float32)
  rc = lib.kfn_depth_to_labels(
      data, len(data), _f32p(Kf), _f32p(Tf), stride,
      ctypes.c_float(depth_scale), ctypes.c_float(min_depth),
      ctypes.c_float(max_depth), ctypes.c_uint16(invalid_value),
      _f32p(coords), valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
      ctypes.byref(oh), ctypes.byref(ow))
  if rc != 0:
    raise ValueError(f"native label generation failed ({rc}) for {path}")
  return coords, valid.astype(bool)


def load_batch(color_paths, depth_paths, poses, K,
               width: int, height: int,
               stride: int = 8, depth_scale: float = 1e-3,
               min_depth: float = 0.05, max_depth: float = 20.0,
               invalid_value: int = 65535,
               num_threads: int | None = None):
  """N frames in one GIL-free call: file read -> PNG decode -> float32 RGB
  and the fused strided labels, over a pool of ``num_threads`` threads.

  Args:
    color_paths: N colour PNGs of ``width`` x ``height``, 8-bit.
    depth_paths: N depth PNG paths; None or "" gives zero labels, valid 0.
    poses: (N, 4, 4) camera-to-world.
    K: (3, 3) shared intrinsics.

  Returns:
    dict(image (N, H, W, 3) float32, coords (N, h, w, 3) float32, valid
    (N, h, w) bool). Raises naming the first frame and file that failed.
  """
  n = len(color_paths)
  if len(depth_paths) != n or len(poses) != n:
    raise ValueError(f"{n} colour paths, {len(depth_paths)} depth paths "
                     f"and {len(poses)} poses: one of each a frame")
  lib = load_library()
  if num_threads is None:
    num_threads = min(8, os.cpu_count() or 1)
  hs, ws = height // stride, width // stride
  images = np.empty((n, height, width, 3), np.float32)
  coords = np.empty((n, hs, ws, 3), np.float32)
  valid = np.empty((n, hs, ws), np.uint8)
  c_color = (ctypes.c_char_p * n)(*[p.encode() for p in color_paths])
  c_depth = (ctypes.c_char_p * n)(
      *[(p.encode() if p else None) for p in depth_paths])
  Kf = np.ascontiguousarray(K, np.float32)
  Tf = np.ascontiguousarray(np.stack(poses), np.float32)
  rc = lib.kfn_load_batch(
      c_color, c_depth, n, width, height, _f32p(Kf), _f32p(Tf), stride,
      ctypes.c_float(depth_scale), ctypes.c_float(min_depth),
      ctypes.c_float(max_depth), ctypes.c_uint16(invalid_value),
      num_threads, _f32p(images), _f32p(coords),
      valid.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)))
  if rc != 0:
    packed = -(rc + 1)  # 2 * index + which (0: colour file, 1: depth file)
    bad, which = packed // 2, packed % 2
    paths = depth_paths if which else color_paths
    raise ValueError(
        f"native batch load failed at frame {bad} "
        f"({'depth' if which else 'color'} file "
        f"{paths[bad] if 0 <= bad < n else '?'})")
  return {"image": images, "coords": coords, "valid": valid.astype(bool)}
