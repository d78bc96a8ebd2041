"""Image files without PIL: the port's PNG codec and the resizes its loaders
need.

  * PNG decode, two routes: ``decode_png`` through the port's C++ library
    (``native_io``), which every data path takes, and ``decode_png_plain``
    (stdlib ``zlib`` and a numpy unfilter), the plain version the tests
    hold it against. Both cover the datasets' files: 8-bit grey, grey +
    alpha, RGB and RGBA, and 16-bit of each; non-interlaced; all five
    row filters. Palette and interlaced files raise.
  * PNG encode (``encode_png`` / ``write_png``): 8-bit grey, RGB and
    RGBA, and 16-bit grey, filter 0 on every row, stdlib ``zlib``, CRCs.
    The fixture writers use it.
  * JPEG is not decoded: ``read_color`` of a ``.jpg`` / ``.jpeg`` raises
    ``NotImplementedError`` (12-Scenes ships JPEG colour).
  * ``resize_bilinear`` and ``resize_nearest`` reproduce PIL's
    ``Image.BILINEAR`` (a triangle filter widened on downscale, so that it
    antialiases; within one level of 255) and ``Image.NEAREST`` (source
    index floor((i + 0.5) * in / out), exactly).
"""

from __future__ import annotations

import os
import struct
import zlib

import numpy as np
import torch

from kfnet_tpu_torch.data import native_io

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}  # PNG colour type -> channels
_COLOR_TYPE = {1: 0, 2: 4, 3: 2, 4: 6}  # channels -> PNG colour type
JPEG_SUFFIXES = (".jpg", ".jpeg")


def jpeg_error(path: str) -> NotImplementedError:
  return NotImplementedError(
      f"{path}: JPEG colour (12-Scenes ships it) is not decoded by "
      "kfnet_tpu_torch yet; the port reads PNG only. A JPEG decoder is "
      "listed in ROADMAP.md, queue 1.")


# ---- decode ---------------------------------------------------------------

# PNG bytes -> (H, W) for one channel, else (H, W, C); uint8 or uint16 as
# the file's bit depth: the C++ route
decode_png = native_io.decode


def _chunks(data: bytes):
  if data[:8] != PNG_SIGNATURE:
    raise ValueError("not a PNG file (bad signature)")
  pos = 8
  while pos + 12 <= len(data):
    (length,) = struct.unpack(">I", data[pos:pos + 4])
    kind = data[pos + 4:pos + 8]
    if pos + 12 + length > len(data):
      raise ValueError("truncated PNG chunk")
    yield kind, data[pos + 8:pos + 8 + length]
    if kind == b"IEND":
      return
    pos += 12 + length


def _paeth(a, b, c):
  p = a + b - c
  pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
  return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _unfilter(raw: np.ndarray, height: int, width: int, bpp: int):
  """Undo each row's filter: (height, width * bpp) uint8."""
  rows = raw.reshape(height, width * bpp + 1)
  out = np.empty((height, width * bpp), np.uint8)
  up = np.zeros((width, bpp), np.int32)
  for y in range(height):
    kind = int(rows[y, 0])
    line = rows[y, 1:].reshape(width, bpp).astype(np.int32)
    if kind == 0:
      cur = line
    elif kind == 1:    # Sub: a running sum along the row, lane by lane
      cur = np.cumsum(line, axis=0) & 255
    elif kind == 2:    # Up
      cur = (line + up) & 255
    elif kind in (3, 4):  # Average, Paeth: each pixel needs its left one
      cur = np.empty_like(line)
      left = np.zeros(bpp, np.int32)
      upleft = np.zeros(bpp, np.int32)
      for x in range(width):
        if kind == 3:
          pred = (left + up[x]) >> 1
        else:
          pred = _paeth(left, up[x], upleft)
        left = cur[x] = (line[x] + pred) & 255
        upleft = up[x]
    else:
      raise ValueError(f"bad PNG row filter {kind} in row {y}")
    out[y] = cur.reshape(-1)
    up = cur
  return out


def decode_png_plain(data: bytes) -> np.ndarray:
  """``decode_png`` in plain Python: stdlib ``zlib`` and a numpy unfilter."""
  chunks = list(_chunks(data))
  if not chunks or chunks[0][0] != b"IHDR":
    raise ValueError("PNG does not start with IHDR")
  width, height, bits, color, _, _, interlace = struct.unpack(
      ">IIBBBBB", chunks[0][1][:13])
  if color not in _CHANNELS or bits not in (8, 16) or interlace:
    raise ValueError(f"unsupported PNG (colour type {color}, {bits} bits, "
                     f"interlace {interlace})")
  ch = _CHANNELS[color]
  bpp = ch * bits // 8
  raw = np.frombuffer(zlib.decompress(
      b"".join(body for kind, body in chunks if kind == b"IDAT")), np.uint8)
  if raw.size != (width * bpp + 1) * height:
    raise ValueError("PNG image data of the wrong size")
  px = _unfilter(raw, height, width, bpp)
  if bits == 16:
    px = px.view(">u2").astype(np.uint16)
  out = px.reshape(height, width, ch)
  return out[..., 0] if ch == 1 else out


# ---- encode ---------------------------------------------------------------

def _chunk(kind: bytes, body: bytes) -> bytes:
  return (struct.pack(">I", len(body)) + kind + body
          + struct.pack(">I", zlib.crc32(kind + body) & 0xFFFFFFFF))


def encode_png(image: np.ndarray, level: int = 6) -> bytes:
  """(H, W) or (H, W, C) uint8 (C = 1, 2, 3, 4), or (H, W) uint16 -> PNG
  bytes, filter 0 on every row."""
  a = np.asarray(image)
  if a.ndim == 2:
    a = a[..., None]
  h, w, ch = a.shape
  if a.dtype == np.uint8 and ch in _COLOR_TYPE:
    bits, body = 8, a
  elif a.dtype == np.uint16 and ch == 1:
    bits, body = 16, a.astype(">u2").view(np.uint8)
  else:
    raise ValueError(f"cannot write a PNG of {a.dtype} with {ch} channels")
  rows = body.reshape(h, -1)
  raw = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
  ihdr = struct.pack(">IIBBBBB", w, h, bits, _COLOR_TYPE[ch], 0, 0, 0)
  return (PNG_SIGNATURE + _chunk(b"IHDR", ihdr)
          + _chunk(b"IDAT", zlib.compress(raw.tobytes(), level))
          + _chunk(b"IEND", b""))


def write_png(path: str, image: np.ndarray):
  with open(path, "wb") as f:
    f.write(encode_png(image))


# ---- files ------------------------------------------------------------------

def _is_jpeg(path: str) -> bool:
  return os.path.splitext(path)[1].lower() in JPEG_SUFFIXES


def read_png(path: str) -> np.ndarray:
  """A PNG file's pixels (``decode_png``)."""
  if _is_jpeg(path):
    raise jpeg_error(path)
  with open(path, "rb") as f:
    data = f.read()
  try:
    return decode_png(data)
  except ValueError as e:
    raise ValueError(f"{e}: {path}") from e


def read_color(path: str) -> np.ndarray:
  """(H, W, 3) float32 in [0, 1]; grey broadcast, alpha dropped. JPEG
  raises ``NotImplementedError``."""
  if _is_jpeg(path):
    raise jpeg_error(path)
  return native_io.read_color(path)


def to_rgb(pixels: np.ndarray) -> np.ndarray:
  """8-bit pixels as (H, W, 3) RGB, as PIL's ``convert("RGB")``: grey
  broadcast, alpha dropped."""
  if pixels.ndim == 2:
    pixels = pixels[..., None]
  if pixels.shape[-1] in (1, 2):
    return np.repeat(pixels[..., :1], 3, axis=-1)
  return np.ascontiguousarray(pixels[..., :3])


# ---- resizes ----------------------------------------------------------------

def resize_bilinear(image: np.ndarray, size) -> np.ndarray:
  """(H, W, C) uint8 -> (h, w, C) uint8 as PIL's ``resize((w, h),
  Image.BILINEAR)``: bilinear with antialiasing on downscale, on the float
  image, rounded to the nearest integer."""
  h, w = size
  x = torch.from_numpy(np.ascontiguousarray(image)).permute(2, 0, 1)[None]
  y = torch.nn.functional.interpolate(x.float(), size=(h, w),
                                      mode="bilinear", align_corners=False,
                                      antialias=True)
  y = torch.floor(y.clamp(0.0, 255.0) + 0.5).to(torch.uint8)
  return y[0].permute(1, 2, 0).contiguous().numpy()


def _nearest_indices(n_in: int, n_out: int) -> np.ndarray:
  """PIL's NEAREST source indices: floor of (i + 0.5) * n_in / n_out, the
  position summed step by step in float64 from 0.5 * scale, as PIL sums
  it (the product (i + 0.5) * scale rounds otherwise at some i, and
  then differs from PIL by a pixel)."""
  scale = n_in / n_out
  steps = np.full(n_out, scale)
  steps[0] = 0.5 * scale
  idx = np.floor(np.add.accumulate(steps)).astype(np.int64)
  return np.minimum(idx, n_in - 1)


def resize_nearest(image: np.ndarray, size) -> np.ndarray:
  """(H, W[, C]) of any dtype -> (h, w[, C]) as PIL's ``resize((w, h),
  Image.NEAREST)``: ``nearest-exact`` indexing, summed as PIL sums it."""
  h, w = size
  rows = _nearest_indices(image.shape[0], h)
  cols = _nearest_indices(image.shape[1], w)
  return np.ascontiguousarray(image[rows][:, cols])
