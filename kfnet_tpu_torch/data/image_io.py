"""Image files without PIL: the port's PNG and JPEG codecs and the resizes
its loaders need.

  * PNG decode, two routes: ``decode_png`` through the port's C++ library
    (``native_io``), which every data path takes, and ``decode_png_plain``
    (stdlib ``zlib`` and a numpy unfilter), the plain version the tests
    hold it against. Both cover the datasets' files: 8-bit grey, grey +
    alpha, RGB and RGBA, and 16-bit of each; non-interlaced; all five
    row filters. Palette and interlaced files raise.
  * PNG encode (``encode_png`` / ``write_png``): 8-bit grey, RGB and
    RGBA, and 16-bit grey, filter 0 on every row, stdlib ``zlib``, CRCs.
    The fixture writers use it.
  * JPEG decode (12-Scenes colour), two routes with one arithmetic:
    ``decode_jpeg`` through the C++ library, which ``read_color`` takes,
    and ``decode_jpeg_plain`` (numpy), the plain version the tests hold it
    against. Scope: baseline and extended 8-bit sequential Huffman files
    (SOF0 / SOF1), 1 or 3 components, luma sampled 1x1, 2x1 or 2x2 over
    1x1 chroma (4:4:4, 4:2:2, 4:2:0), interleaved or one scan a
    component, restart intervals; APPn and COM segments are skipped. The
    arithmetic is libjpeg's, so that the pixels land within a unit of
    libjpeg(-turbo)'s: the integer "islow" IDCT (``jidctint.c``), the
    "fancy" triangle upsampling of 2x1 and 2x2 chroma (``jdsample.c``) and
    the fixed-point YCbCr -> RGB tables (``jdcolor.c``). Progressive,
    lossless, hierarchical and arithmetic-coded files, and 12-bit ones,
    raise ``NotImplementedError`` naming what they are.
  * JPEG encode (``encode_jpeg`` / ``write_jpeg``): baseline, 4:4:4 or
    4:2:0, the Annex K tables scaled to a quality as libjpeg scales them
    and the standard Huffman tables; the 12-Scenes fixture writer uses it
    (quality 95, 4:4:4, as the JAX package's fixture writes with PIL).
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


# ---- decode ---------------------------------------------------------------

# PNG bytes -> (H, W) for one channel, else (H, W, C); uint8 or uint16 as
# the file's bit depth: the C++ route
decode_png = native_io.decode
# JPEG bytes -> (H, W) uint8 grey or (H, W, 3) uint8 RGB: the C++ route
decode_jpeg = native_io.decode_jpeg


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


# ---- JPEG -----------------------------------------------------------------

# zigzag position -> natural (row-major) index of an 8x8 block
ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])

# the frame types this decoder does not take, by SOFn / DAC marker
_UNSUPPORTED_MARKERS = {
    0xC2: "progressive (SOF2)", 0xC3: "lossless (SOF3)",
    0xC5: "differential sequential (SOF5)",
    0xC6: "differential progressive (SOF6)",
    0xC7: "differential lossless (SOF7)",
    0xC9: "arithmetic-coded sequential (SOF9)",
    0xCA: "arithmetic-coded progressive (SOF10)",
    0xCB: "arithmetic-coded lossless (SOF11)",
    0xCC: "arithmetic-coding conditioning (DAC)",
    0xCD: "arithmetic-coded differential sequential (SOF13)",
    0xCE: "arithmetic-coded differential progressive (SOF14)",
    0xCF: "arithmetic-coded differential lossless (SOF15)",
}
# the C++ route's return codes (data/csrc/kfnet_native.cpp): -1 a corrupt
# or truncated file; -2 a component count or sampling outside the scope;
# -3 a sample precision other than 8 bits; -(256 + m) an unsupported
# frame marker m (_UNSUPPORTED_MARKERS)
JPEG_CORRUPT, JPEG_SAMPLING, JPEG_PRECISION = -1, -2, -3


def jpeg_exception(code: int, detail: str = "") -> Exception:
  """The exception both JPEG decoders raise for ``code`` (the C++ route's
  return code): ``NotImplementedError`` naming a frame type or property
  outside the decoder's scope, ``ValueError`` for a corrupt file."""
  if code <= -256:
    marker = -code - 256
    name = _UNSUPPORTED_MARKERS.get(marker, f"marker 0x{marker:02X}")
    return NotImplementedError(
        f"{name} JPEG is not decoded: the port decodes baseline and "
        "extended sequential Huffman JPEG (SOF0 / SOF1) only")
  if code == JPEG_PRECISION:
    return NotImplementedError(
        f"JPEG of {detail or 'other than 8'}-bit samples (12-bit?) is not "
        "decoded: 8-bit samples only")
  if code == JPEG_SAMPLING:
    return NotImplementedError(
        f"JPEG sampling not decoded ({detail or 'components/factors'}): 1 "
        "or 3 components, luma 1x1, 2x1 or 2x2 over 1x1 chroma")
  return ValueError(f"corrupt or truncated JPEG{': ' + detail if detail else ''}")


class _JpegFrame:
  """What a JPEG's headers say: size, components (id, h, v, quant table)
  and, once scans are read, each component's coefficient blocks."""

  def __init__(self):
    self.width = self.height = 0
    self.comps: list = []
    self.qt: dict = {}
    self.dc: dict = {}
    self.ac: dict = {}
    self.restart = 0
    self.adobe_transform = None
    self.sof = None


def _segments(data: bytes):
  """(marker, payload, end) of each marker segment up to the first SOS
  and after each scan; the entropy-coded data follows an SOS payload."""
  if data[:2] != b"\xff\xd8":
    raise jpeg_exception(JPEG_CORRUPT, "no SOI marker")
  pos = 2
  n = len(data)
  while pos < n:
    if data[pos] != 0xFF:
      raise jpeg_exception(JPEG_CORRUPT, f"expected a marker at byte {pos}")
    while pos < n and data[pos] == 0xFF:  # fill bytes
      pos += 1
    if pos >= n:
      break
    marker = data[pos]
    pos += 1
    if marker == 0xD9:  # EOI
      return
    if 0xD0 <= marker <= 0xD7 or marker == 0x01:
      continue  # a stray RSTn or TEM carries no payload
    if pos + 2 > n:
      raise jpeg_exception(JPEG_CORRUPT, "truncated segment")
    length = (data[pos] << 8) | data[pos + 1]
    if length < 2 or pos + length > n:
      raise jpeg_exception(JPEG_CORRUPT, "truncated segment")
    payload = data[pos + 2:pos + length]
    pos += length
    pos = yield marker, payload, pos
  raise jpeg_exception(JPEG_CORRUPT, "no EOI marker")


def _read_dqt(frame, p):
  i = 0
  while i < len(p):
    pq, tq = p[i] >> 4, p[i] & 15
    i += 1
    if pq:
      vals = np.frombuffer(p[i:i + 128], ">u2").astype(np.int64)
      i += 128
    else:
      vals = np.frombuffer(p[i:i + 64], np.uint8).astype(np.int64)
      i += 64
    if vals.size != 64:
      raise jpeg_exception(JPEG_CORRUPT, "short DQT")
    table = np.empty(64, np.int64)
    table[ZIGZAG] = vals
    frame.qt[tq] = table


def _huffman_lookup(bits, vals):
  """A 16-bit peek -> (code length << 8 | symbol) table (0: no code)."""
  lookup = np.zeros(1 << 16, np.int64)
  code = 0
  k = 0
  for length in range(1, 17):
    for _ in range(bits[length - 1]):
      if code >= (1 << length):
        raise jpeg_exception(JPEG_CORRUPT, "bad Huffman table")
      lo = code << (16 - length)
      lookup[lo:lo + (1 << (16 - length))] = (length << 8) | vals[k]
      code += 1
      k += 1
    code <<= 1
  return lookup.tolist()


def _read_dht(frame, p):
  i = 0
  while i < len(p):
    tc, th = p[i] >> 4, p[i] & 15
    bits = list(p[i + 1:i + 17])
    total = sum(bits)
    vals = list(p[i + 17:i + 17 + total])
    if len(bits) != 16 or len(vals) != total or total > 256:
      raise jpeg_exception(JPEG_CORRUPT, "short DHT")
    (frame.ac if tc else frame.dc)[th] = _huffman_lookup(bits, vals)
    i += 17 + total


def _read_sof(frame, marker, p):
  if marker not in (0xC0, 0xC1):
    raise jpeg_exception(-256 - marker)
  if len(p) < 6:
    raise jpeg_exception(JPEG_CORRUPT, "short SOF")
  if p[0] != 8:
    raise jpeg_exception(JPEG_PRECISION, str(p[0]))
  frame.sof = marker
  frame.height = (p[1] << 8) | p[2]
  frame.width = (p[3] << 8) | p[4]
  nf = p[5]
  if len(p) < 6 + 3 * nf:
    raise jpeg_exception(JPEG_CORRUPT, "short SOF")
  frame.comps = [{"id": p[6 + 3 * c], "h": p[7 + 3 * c] >> 4,
                  "v": p[7 + 3 * c] & 15, "tq": p[8 + 3 * c]}
                 for c in range(nf)]
  _check_scope(frame)


def _check_scope(frame):
  comps = frame.comps
  if frame.width == 0 or frame.height == 0:
    raise jpeg_exception(JPEG_SAMPLING, "no size in the frame header (DNL)")
  if len(comps) not in (1, 3):
    raise jpeg_exception(JPEG_SAMPLING, f"{len(comps)} components")
  if any(c["h"] not in (1, 2, 3, 4) or c["v"] not in (1, 2, 3, 4)
         for c in comps):
    raise jpeg_exception(JPEG_CORRUPT, "bad sampling factors")
  if len(comps) == 3:
    luma = (comps[0]["h"], comps[0]["v"])
    chroma = [(c["h"], c["v"]) for c in comps[1:]]
    if luma not in ((1, 1), (2, 1), (2, 2)) or chroma != [(1, 1), (1, 1)]:
      raise jpeg_exception(JPEG_SAMPLING, f"factors {luma} / {chroma}")
  hmax = max(c["h"] for c in comps)
  vmax = max(c["v"] for c in comps)
  frame.hmax, frame.vmax = hmax, vmax
  frame.mcux = -(-frame.width // (8 * hmax))
  frame.mcuy = -(-frame.height // (8 * vmax))
  for c in comps:
    c["width"] = -(-frame.width * c["h"] // hmax)
    c["height"] = -(-frame.height * c["v"] // vmax)
    c["coef"] = np.zeros((frame.mcuy * c["v"], frame.mcux * c["h"], 64),
                         np.int64)
    c["q"] = None


def _entropy_segments(data: bytes, pos: int):
  """The scan's entropy-coded bytes from ``pos``: the restart segments
  with their stuffed zeros taken out, and the position of the marker
  that ends the scan."""
  segs = []
  start = pos
  n = len(data)
  while True:
    i = data.find(b"\xff", pos)
    if i < 0 or i + 1 >= n:
      raise jpeg_exception(JPEG_CORRUPT, "scan runs past the end of the file")
    nxt = data[i + 1]
    if nxt == 0x00:
      pos = i + 2
      continue
    if nxt == 0xFF:  # fill bytes before a marker
      pos = i + 1
      continue
    segs.append(data[start:i].replace(b"\xff\x00", b"\xff"))
    if 0xD0 <= nxt <= 0xD7:
      start = pos = i + 2
      continue
    return segs, i


class _Bits:
  """MSB-first bits of one restart segment; reads past its end give 0s
  (so that a peek at the segment's last code can look 16 bits ahead) and
  are caught by ``check``."""

  def __init__(self, seg: bytes):
    a = np.frombuffer(seg + b"\x00" * 4, np.uint8).astype(np.int64)
    self.words = ((a[:-3] << 24) | (a[1:-2] << 16) | (a[2:-1] << 8)
                  | a[3:]).tolist()
    self.pos = 0
    self.nbits = 8 * len(seg)

  def check(self):
    if self.pos > self.nbits:
      raise jpeg_exception(JPEG_CORRUPT, "entropy-coded data ends early")


def _decode_block(bits, coef, dc_lut, ac_lut, pred):
  """One block's 64 coefficients (zigzag order in ``coef``); returns the
  new DC prediction."""
  words = bits.words
  p = bits.pos
  # DC
  w = words[p >> 3]
  e = dc_lut[((w << (p & 7)) >> 16) & 0xFFFF]
  if not e:
    raise jpeg_exception(JPEG_CORRUPT, "bad Huffman code")
  p += e >> 8
  s = e & 15
  diff = 0
  if s:
    w = words[p >> 3]
    diff = ((w << (p & 7)) & 0xFFFFFFFF) >> (32 - s)
    p += s
    if diff < (1 << (s - 1)):
      diff -= (1 << s) - 1
  pred += diff
  coef[0] = pred
  k = 1
  while k < 64:
    w = words[p >> 3]
    e = ac_lut[((w << (p & 7)) >> 16) & 0xFFFF]
    if not e:
      raise jpeg_exception(JPEG_CORRUPT, "bad Huffman code")
    p += e >> 8
    rs = e & 0xFF
    r, s = rs >> 4, rs & 15
    if s:
      k += r
      if k > 63:
        raise jpeg_exception(JPEG_CORRUPT, "AC index past 63")
      w = words[p >> 3]
      v = ((w << (p & 7)) & 0xFFFFFFFF) >> (32 - s)
      p += s
      if v < (1 << (s - 1)):
        v -= (1 << s) - 1
      coef[k] = v
      k += 1
    elif r == 15:
      k += 16
    else:
      break
  bits.pos = p
  return pred


def _read_scan(frame, p, data, pos):
  """Decode one scan's blocks into the components' coefficients; returns
  the position of the marker after it."""
  ns = p[0]
  if frame.sof is None or len(p) < 1 + 2 * ns + 3:
    raise jpeg_exception(JPEG_CORRUPT, "SOS before SOF, or short")
  ids = {c["id"]: c for c in frame.comps}
  scomps = []
  for j in range(ns):
    c = ids.get(p[1 + 2 * j])
    if c is None:
      raise jpeg_exception(JPEG_CORRUPT, "scan names an unknown component")
    td, ta = p[2 + 2 * j] >> 4, p[2 + 2 * j] & 15
    if td not in frame.dc or ta not in frame.ac:
      raise jpeg_exception(JPEG_CORRUPT, "scan uses an undefined table")
    if c["q"] is None:  # latched at the component's first scan
      if c["tq"] not in frame.qt:
        raise jpeg_exception(JPEG_CORRUPT, "undefined quantization table")
      c["q"] = frame.qt[c["tq"]]
    scomps.append((c, frame.dc[td], frame.ac[ta]))
  ss, se = p[1 + 2 * ns], p[2 + 2 * ns]
  if ss != 0 or se != 63 or p[3 + 2 * ns] != 0:
    raise jpeg_exception(JPEG_CORRUPT, "spectral selection in a sequential scan")
  segs, end = _entropy_segments(data, pos)
  if ns == 1:
    c = scomps[0][0]
    units = [[(0, by, bx)] for by in range(-(-c["height"] // 8))
             for bx in range(-(-c["width"] // 8))]
  else:
    units = [[(j, my * c["v"] + v, mx * c["h"] + h)
              for j, (c, _, _) in enumerate(scomps)
              for v in range(c["v"]) for h in range(c["h"])]
             for my in range(frame.mcuy) for mx in range(frame.mcux)]
  per_seg = frame.restart or len(units)
  if -(-len(units) // per_seg) != len(segs):
    raise jpeg_exception(JPEG_CORRUPT, f"{len(segs)} restart segments for "
                     f"{len(units)} MCUs at interval {frame.restart}")
  zz = np.empty(64, np.int64)
  for si, seg in enumerate(segs):
    bits = _Bits(seg)
    preds = [0] * ns
    try:
      for unit in units[si * per_seg:(si + 1) * per_seg]:
        for j, by, bx in unit:
          c, dc_lut, ac_lut = scomps[j]
          blk = [0] * 64
          preds[j] = _decode_block(bits, blk, dc_lut, ac_lut, preds[j])
          zz[:] = blk
          c["coef"][by, bx, ZIGZAG] = zz
    except IndexError:  # read past the segment's padding
      raise jpeg_exception(JPEG_CORRUPT,
                           "entropy-coded data ends early") from None
    bits.check()
  return end


# jidctint.c's constants: FIX(x) = round(x * 2^13)
_FIX = {k: int(round(v * 8192)) for k, v in {
    "0_298631336": 0.298631336, "0_390180644": 0.390180644,
    "0_541196100": 0.541196100, "0_765366865": 0.765366865,
    "0_899976223": 0.899976223, "1_175875602": 1.175875602,
    "1_501321110": 1.501321110, "1_847759065": 1.847759065,
    "1_961570560": 1.961570560, "2_053119869": 2.053119869,
    "2_562915447": 2.562915447, "3_072711026": 3.072711026}.items()}
_CONST_BITS, _PASS1_BITS = 13, 2


def _idct_1d(v, shift):
  """jidctint.c's 1-D pass on the 8 inputs ``v`` (arrays of int64), each
  output descaled by ``shift`` bits."""
  F = _FIX
  z2, z3 = v[2], v[6]
  z1 = (z2 + z3) * F["0_541196100"]
  tmp2 = z1 - z3 * F["1_847759065"]
  tmp3 = z1 + z2 * F["0_765366865"]
  tmp0 = (v[0] + v[4]) << _CONST_BITS
  tmp1 = (v[0] - v[4]) << _CONST_BITS
  tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
  tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
  t0, t1, t2, t3 = v[7], v[5], v[3], v[1]
  z1, z2, z3, z4 = t0 + t3, t1 + t2, t0 + t2, t1 + t3
  z5 = (z3 + z4) * F["1_175875602"]
  t0 = t0 * F["0_298631336"]
  t1 = t1 * F["2_053119869"]
  t2 = t2 * F["3_072711026"]
  t3 = t3 * F["1_501321110"]
  z1 = -z1 * F["0_899976223"]
  z2 = -z2 * F["2_562915447"]
  z3 = -z3 * F["1_961570560"] + z5
  z4 = -z4 * F["0_390180644"] + z5
  t0 += z1 + z3
  t1 += z2 + z4
  t2 += z2 + z3
  t3 += z1 + z4
  half = 1 << (shift - 1)
  return [(x + half) >> shift for x in (
      tmp10 + t3, tmp11 + t2, tmp12 + t1, tmp13 + t0,
      tmp13 - t0, tmp12 - t1, tmp11 - t2, tmp10 - t3)]


def _idct_islow(coef, q):
  """(..., 64) natural-order coefficients and their quant table -> (...,
  8, 8) uint8 samples, as libjpeg's ``jpeg_idct_islow``: columns, then
  rows, then the range limit (which wraps outside [-512, 511])."""
  b = (coef * q).reshape(coef.shape[:-1] + (8, 8))
  cols = _idct_1d([b[..., k, :] for k in range(8)],
                  _CONST_BITS - _PASS1_BITS)
  ws = np.stack(cols, axis=-2)          # [..., row k, column]
  rows = _idct_1d([ws[..., :, k] for k in range(8)],
                  _CONST_BITS + _PASS1_BITS + 3)
  x = np.stack(rows, axis=-1)           # [..., row, column]
  x = ((x + 512) & 1023) - 512
  return np.clip(x + 128, 0, 255).astype(np.uint8)


def _plane(c):
  """A component's samples, (height, width) of its own sampling."""
  if c["q"] is None:
    raise jpeg_exception(JPEG_CORRUPT, f"component {c['id']} is in no scan")
  px = _idct_islow(c["coef"], c["q"])
  by, bx = px.shape[:2]
  px = px.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8)
  return px[:c["height"], :c["width"]].astype(np.int64)


def _fancy_h2(p, v2):
  """libjpeg's fancy upsampling of a (h, w) chroma plane: 2x across
  (triangle weights 3:1) and, with ``v2``, 2x down as well, the edge
  samples (and the rows above the first and below the last) repeated."""
  left = np.concatenate([p[:, :1], p[:, :-1]], axis=1)
  right = np.concatenate([p[:, 1:], p[:, -1:]], axis=1)
  if not v2:  # h2v1_fancy_upsample
    even = (3 * p + left + 1) >> 2
    odd = (3 * p + right + 2) >> 2
    return np.stack([even, odd], axis=-1).reshape(p.shape[0], -1)
  above = np.concatenate([p[:1], p[:-1]], axis=0)
  below = np.concatenate([p[1:], p[-1:]], axis=0)
  out = []
  for ctx in (above, below):  # h2v2_fancy_upsample: upper, then lower row
    c = 3 * p + ctx
    cl = np.concatenate([c[:, :1], c[:, :-1]], axis=1)
    cr = np.concatenate([c[:, 1:], c[:, -1:]], axis=1)
    out.append(np.stack([(3 * c + cl + 8) >> 4, (3 * c + cr + 7) >> 4],
                        axis=-1).reshape(p.shape[0], -1))
  return np.stack(out, axis=1).reshape(2 * p.shape[0], -1)


# jdcolor.c's fixed-point YCbCr -> RGB tables (SCALEBITS 16)
def _fix16(x: float) -> int:
  return int(x * 65536 + 0.5)


_CX = np.arange(256, dtype=np.int64) - 128
_CR_R = (_fix16(1.40200) * _CX + (1 << 15)) >> 16
_CB_B = (_fix16(1.77200) * _CX + (1 << 15)) >> 16
_CR_G = -_fix16(0.71414) * _CX
_CB_G = -_fix16(0.34414) * _CX + (1 << 15)


def _ycc_to_rgb(y, cb, cr):
  r = y + _CR_R[cr]
  g = y + ((_CB_G[cb] + _CR_G[cr]) >> 16)
  b = y + _CB_B[cb]
  return np.clip(np.stack([r, g, b], axis=-1), 0, 255).astype(np.uint8)


def _read_app14(frame, p):
  if p[:5] == b"Adobe" and len(p) >= 12:
    frame.adobe_transform = p[11]


def decode_jpeg_plain(data: bytes) -> np.ndarray:
  """``decode_jpeg`` in numpy: (H, W) uint8 for one component, else (H, W,
  3) RGB. Huffman decoding runs in Python, so it is for tests, not for a
  data path."""
  frame = _JpegFrame()
  gen = _segments(bytes(data))
  try:
    marker, payload, pos = next(gen)
    while True:
      if marker == 0xDB:
        _read_dqt(frame, payload)
      elif marker == 0xC4:
        _read_dht(frame, payload)
      elif 0xC0 <= marker <= 0xCF:
        _read_sof(frame, marker, payload)
      elif marker == 0xDD:
        frame.restart = (payload[0] << 8) | payload[1]
      elif marker == 0xEE:
        _read_app14(frame, payload)
      elif marker == 0xDA:
        pos = _read_scan(frame, payload, data, pos)
      elif marker == 0xDC:
        raise jpeg_exception(JPEG_SAMPLING, "DNL marker")
      marker, payload, pos = gen.send(pos)
  except StopIteration:
    pass
  if frame.sof is None:
    raise jpeg_exception(JPEG_CORRUPT, "no frame header")
  planes = [_plane(c) for c in frame.comps]
  h, w = frame.height, frame.width
  if len(planes) == 1:
    return planes[0][:h, :w].astype(np.uint8)
  luma = frame.comps[0]
  if (luma["h"], luma["v"]) != (1, 1):
    planes[1:] = [_fancy_h2(p, luma["v"] == 2) for p in planes[1:]]
  y, cb, cr = (p[:h, :w] for p in planes)
  if _is_rgb(frame):
    return np.stack([y, cb, cr], axis=-1).astype(np.uint8)
  return _ycc_to_rgb(y, cb, cr)


def _is_rgb(frame) -> bool:
  """Three components stored as RGB, not YCbCr: an Adobe marker with
  transform 0, or (without one) components named 'R', 'G', 'B', as
  libjpeg decides."""
  if frame.adobe_transform is not None:
    return frame.adobe_transform == 0
  return [c["id"] for c in frame.comps] == [82, 71, 66]


# Annex K.1's quantization tables (natural order) and K.3's Huffman tables
_STD_LUMA_Q = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99])
_STD_CHROMA_Q = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32)
_DC_LUMA = ([0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0], list(range(12)))
_DC_CHROMA = ([0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0],
              list(range(12)))
_AC_LUMA = ([0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7D], [
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06,
    0x13, 0x51, 0x61, 0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xA1, 0x08,
    0x23, 0x42, 0xB1, 0xC1, 0x15, 0x52, 0xD1, 0xF0, 0x24, 0x33, 0x62, 0x72,
    0x82, 0x09, 0x0A, 0x16, 0x17, 0x18, 0x19, 0x1A, 0x25, 0x26, 0x27, 0x28,
    0x29, 0x2A, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59,
    0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74, 0x75,
    0x76, 0x77, 0x78, 0x79, 0x7A, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89,
    0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A, 0xA2, 0xA3,
    0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4, 0xB5, 0xB6,
    0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7, 0xC8, 0xC9,
    0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA, 0xE1, 0xE2,
    0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF1, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])
_AC_CHROMA = ([0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77], [
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41,
    0x51, 0x07, 0x61, 0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91,
    0xA1, 0xB1, 0xC1, 0x09, 0x23, 0x33, 0x52, 0xF0, 0x15, 0x62, 0x72, 0xD1,
    0x0A, 0x16, 0x24, 0x34, 0xE1, 0x25, 0xF1, 0x17, 0x18, 0x19, 0x1A, 0x26,
    0x27, 0x28, 0x29, 0x2A, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3A, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4A, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58,
    0x59, 0x5A, 0x63, 0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6A, 0x73, 0x74,
    0x75, 0x76, 0x77, 0x78, 0x79, 0x7A, 0x82, 0x83, 0x84, 0x85, 0x86, 0x87,
    0x88, 0x89, 0x8A, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99, 0x9A,
    0xA2, 0xA3, 0xA4, 0xA5, 0xA6, 0xA7, 0xA8, 0xA9, 0xAA, 0xB2, 0xB3, 0xB4,
    0xB5, 0xB6, 0xB7, 0xB8, 0xB9, 0xBA, 0xC2, 0xC3, 0xC4, 0xC5, 0xC6, 0xC7,
    0xC8, 0xC9, 0xCA, 0xD2, 0xD3, 0xD4, 0xD5, 0xD6, 0xD7, 0xD8, 0xD9, 0xDA,
    0xE2, 0xE3, 0xE4, 0xE5, 0xE6, 0xE7, 0xE8, 0xE9, 0xEA, 0xF2, 0xF3, 0xF4,
    0xF5, 0xF6, 0xF7, 0xF8, 0xF9, 0xFA])


def quant_table(std: np.ndarray, quality: int) -> np.ndarray:
  """An Annex K table scaled to ``quality`` (1..100) as libjpeg's
  ``jpeg_quality_scaling`` and ``jpeg_add_quant_table`` scale it (baseline:
  each entry within 1..255)."""
  quality = min(max(int(quality), 1), 100)
  scale = 5000 // quality if quality < 50 else 200 - 2 * quality
  return np.clip((std * scale + 50) // 100, 1, 255)


def _codes(spec):
  """symbol -> code and symbol -> code length of a (bits, values) spec."""
  bits, vals = spec
  code_of = np.zeros(256, np.int64)
  len_of = np.zeros(256, np.int64)
  code, k = 0, 0
  for length in range(1, 17):
    for _ in range(bits[length - 1]):
      code_of[vals[k]], len_of[vals[k]] = code, length
      code += 1
      k += 1
    code <<= 1
  return code_of, len_of


def _dct_matrix() -> np.ndarray:
  """The orthonormal 8-point DCT-II: F = M f M^T for an 8x8 block f."""
  u = np.arange(8)[:, None]
  x = np.arange(8)[None, :]
  m = np.cos((2 * x + 1) * u * np.pi / 16) * np.sqrt(2 / 8)
  m[0] /= np.sqrt(2)
  return m


def _dht(tc: int, th: int, spec) -> bytes:
  bits, vals = spec
  return _segment(0xC4, bytes([(tc << 4) | th, *bits, *vals]))


def _segment(marker: int, body: bytes) -> bytes:
  return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


def _category(v: np.ndarray) -> np.ndarray:
  """Bits of |v| (a coefficient's size category), 0 for 0."""
  a = np.abs(v)
  s = np.zeros(a.shape, np.int64)
  while True:
    more = (a >> s) > 0
    if not more.any():
      return s
    s += more


def _with_extra(code, length, v, s):
  """(value, bits) of a code followed by the s extra bits of v (negative
  values as v - 1 in s bits)."""
  extra = np.where(v < 0, v + (1 << s) - 1, v) & ((1 << s) - 1)
  return (code << s) | extra, length + s


def _pack(values: np.ndarray, lengths: np.ndarray) -> bytes:
  """Concatenate codes MSB first, pad the last byte with 1s and stuff a
  zero after every 0xFF."""
  total = int(lengths.sum())
  pad = -total % 8
  values = np.append(values, (1 << pad) - 1)
  lengths = np.append(lengths, pad)
  idx = np.repeat(np.arange(values.size), lengths)
  starts = np.cumsum(lengths) - lengths
  j = np.arange(total + pad) - starts[idx]
  bits = (values[idx] >> (lengths[idx] - 1 - j)) & 1
  out = np.packbits(bits.astype(np.uint8))
  return np.insert(out, np.nonzero(out == 0xFF)[0] + 1, 0).tobytes()


def _entropy_code(zz: np.ndarray, tab: np.ndarray, comp: np.ndarray,
                  specs) -> bytes:
  """The Huffman-coded bytes of a scan: ``zz`` (n, 64)
  quantized coefficients in zigzag order, in coding order; ``tab`` each
  block's table set (0 luma, 1 chroma); ``comp`` its component (each
  component predicts its DC from its own previous block). Every code of
  the scan (DC difference; each AC's ZRLs and run/size; EOB) is laid
  out as one array, sorted into block order, and packed at once."""
  n = zz.shape[0]
  keys, values, lengths = [], [], []
  dc = zz[:, 0]
  pred = np.zeros(n, np.int64)
  for c in np.unique(comp):
    at = np.nonzero(comp == c)[0]
    pred[at[1:]] = dc[at[:-1]]
  diff = dc - pred
  s = _category(diff)
  dcode = [_codes(spec[0]) for spec in specs]
  acode = [_codes(spec[1]) for spec in specs]
  code = np.where(tab == 0, dcode[0][0][s], dcode[-1][0][s])
  clen = np.where(tab == 0, dcode[0][1][s], dcode[-1][1][s])
  v, ln = _with_extra(code, clen, diff, s)
  keys.append(np.arange(n) * 256)
  values.append(v)
  lengths.append(ln)

  b, k = np.nonzero(zz[:, 1:])
  k = k + 1
  prev = np.zeros_like(k)
  same = np.nonzero(b[1:] == b[:-1])[0] + 1
  prev[same] = k[same - 1]
  run = k - prev - 1
  a = zz[b, k]
  s = _category(a)
  rs = ((run % 16) << 4) | s
  tb = tab[b]
  code = np.where(tb == 0, acode[0][0][rs], acode[-1][0][rs])
  clen = np.where(tb == 0, acode[0][1][rs], acode[-1][1][rs])
  v, ln = _with_extra(code, clen, a, s)
  keys.append(b * 256 + 2 * k + 1)
  values.append(v)
  lengths.append(ln)
  nzrl = run // 16
  zb = np.repeat(b, nzrl)
  ztb = tab[zb]
  keys.append(np.repeat(b * 256 + 2 * k, nzrl))
  values.append(np.where(ztb == 0, acode[0][0][0xF0], acode[-1][0][0xF0]))
  lengths.append(np.where(ztb == 0, acode[0][1][0xF0], acode[-1][1][0xF0]))
  last = np.zeros(n, np.int64)
  np.maximum.at(last, b, k)
  eob = np.nonzero(last < 63)[0]
  keys.append(eob * 256 + 255)
  values.append(np.where(tab[eob] == 0, acode[0][0][0], acode[-1][0][0]))
  lengths.append(np.where(tab[eob] == 0, acode[0][1][0], acode[-1][1][0]))
  order = np.argsort(np.concatenate(keys), kind="stable")
  return _pack(np.concatenate(values)[order], np.concatenate(lengths)[order])


_SUBSAMPLING = {"4:4:4": (1, 1), "4:2:0": (2, 2)}


def encode_jpeg(image: np.ndarray, quality: int = 95,
                subsampling: str = "4:4:4") -> bytes:
  """(H, W) grey or (H, W, 3) RGB uint8 -> baseline JPEG bytes: JFIF,
  YCbCr (BT.601, full range) with luma sampled 1x1 (4:4:4) or 2x2
  (4:2:0, chroma the mean of each 2x2), the Annex K tables scaled to
  ``quality`` as libjpeg scales them, the standard Huffman tables and a
  float DCT, in one interleaved scan."""
  a = np.asarray(image)
  if a.dtype != np.uint8 or a.ndim not in (2, 3) or (
      a.ndim == 3 and a.shape[2] != 3):
    raise ValueError(f"cannot write a JPEG of {a.dtype} {a.shape}")
  h, w = a.shape[:2]
  f = a.astype(np.float64)
  if a.ndim == 2:
    planes, hv = [f], [(1, 1)]
  else:
    r, g, b = f[..., 0], f[..., 1], f[..., 2]
    planes = [0.299 * r + 0.587 * g + 0.114 * b,
              -0.168735892 * r - 0.331264108 * g + 0.5 * b + 128.0,
              0.5 * r - 0.418687589 * g - 0.081312411 * b + 128.0]
    planes = [np.clip(np.round(p), 0, 255) for p in planes]
    hv = [_SUBSAMPLING[subsampling], (1, 1), (1, 1)]
  hmax, vmax = hv[0]
  mcux, mcuy = -(-w // (8 * hmax)), -(-h // (8 * vmax))
  qts = [quant_table(_STD_LUMA_Q, quality),
         quant_table(_STD_CHROMA_Q, quality)]
  dct = _dct_matrix()
  zzs = []
  for ci, (p, (hc, vc)) in enumerate(zip(planes, hv)):
    full = np.pad(p, ((0, mcuy * 8 * vmax - h), (0, mcux * 8 * hmax - w)),
                  mode="edge")
    if (hc, vc) != (hmax, vmax):  # a 1x1 chroma under 2x2 luma
      full = full.reshape(full.shape[0] // 2, 2, full.shape[1] // 2,
                          2).mean(axis=(1, 3))
    by, bx = full.shape[0] // 8, full.shape[1] // 8
    blk = full.reshape(by, 8, bx, 8).transpose(0, 2, 1, 3) - 128.0
    coef = dct @ blk @ dct.T
    q = qts[min(ci, 1)].reshape(8, 8)
    zzs.append(np.round(coef / q).astype(np.int64).reshape(by, bx, 64)[
        ..., ZIGZAG])
  # coding order: MCUs in raster order, each component's blocks within
  units, tab, comp = [], [], []
  for ci, (hc, vc) in enumerate(hv):
    zz = zzs[ci].reshape(mcuy, vc, mcux, hc, 64).transpose(0, 2, 1, 3, 4)
    units.append(zz.reshape(mcuy * mcux, vc * hc, 64))
    tab.append(np.full((mcuy * mcux, vc * hc), min(ci, 1)))
    comp.append(np.full((mcuy * mcux, vc * hc), ci))
  units = np.concatenate(units, axis=1)
  tab = np.concatenate(tab, axis=1)
  comp = np.concatenate(comp, axis=1)
  specs = [(_DC_LUMA, _AC_LUMA), (_DC_CHROMA, _AC_CHROMA)]
  scan = _entropy_code(units.reshape(-1, 64), tab.reshape(-1),
                       comp.reshape(-1), specs)
  ncomp = len(planes)
  out = [b"\xff\xd8",
         _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")]
  for t in range(min(ncomp, 2)):
    out.append(_segment(0xDB, bytes([t]) + bytes(
        qts[t][ZIGZAG].astype(np.uint8).tolist())))
  sof = struct.pack(">BHHB", 8, h, w, ncomp) + b"".join(
      bytes([ci + 1, (hc << 4) | vc, min(ci, 1)])
      for ci, (hc, vc) in enumerate(hv))
  out.append(_segment(0xC0, sof))
  for t in range(min(ncomp, 2)):
    out += [_dht(0, t, specs[t][0]), _dht(1, t, specs[t][1])]
  sos = bytes([ncomp]) + b"".join(
      bytes([ci + 1, (min(ci, 1) << 4) | min(ci, 1)]) for ci in range(ncomp))
  out.append(_segment(0xDA, sos + b"\x00\x3f\x00"))
  out += [scan, b"\xff\xd9"]
  return b"".join(out)


def write_jpeg(path: str, image: np.ndarray, **kwargs):
  with open(path, "wb") as f:
    f.write(encode_jpeg(image, **kwargs))


# ---- files ------------------------------------------------------------------

def _is_jpeg(path: str) -> bool:
  return os.path.splitext(path)[1].lower() in JPEG_SUFFIXES


def _read(path: str) -> bytes:
  with open(path, "rb") as f:
    return f.read()


def read_png(path: str) -> np.ndarray:
  """A PNG file's pixels (``decode_png``)."""
  data = _read(path)
  try:
    return decode_png(data)
  except ValueError as e:
    raise ValueError(f"{e}: {path}") from e


def read_jpeg(path: str) -> np.ndarray:
  """A JPEG file's pixels (``decode_jpeg``)."""
  data = _read(path)
  try:
    return decode_jpeg(data)
  except (ValueError, NotImplementedError) as e:
    raise type(e)(f"{e}: {path}") from e


def read_image(path: str) -> np.ndarray:
  """A PNG or (by its suffix) JPEG file's pixels."""
  return read_jpeg(path) if _is_jpeg(path) else read_png(path)


def read_color(path: str) -> np.ndarray:
  """(H, W, 3) float32 in [0, 1]; grey broadcast, alpha dropped. JPEG
  files (by suffix) decode through the C++ JPEG route."""
  if _is_jpeg(path):
    # a division, as the C++ PNG route divides: the same float32 values
    return to_rgb(read_jpeg(path)).astype(np.float32) / np.float32(255.0)
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
