"""The port's image I/O without PIL (kfnet_tpu_torch/data/image_io.py and
its C++ library data/csrc/kfnet_native.cpp) against PIL, which the tests
alone use.

Held bit for bit: both PNG decoders (the C++ route and the plain numpy
route) on 8-bit grey, RGB and RGBA and 16-bit grey, under each of the
five row filters, a mix of them, and PIL's own files; the port's encoder
read back by PIL; the nearest resize against PIL's NEAREST. Held within
one level of 255: the bilinear resize against PIL's BILINEAR. A
progressive JPEG, a palette PNG and a library that does not build raise
by name (the JPEG codec's own tests: tests/test_torch_jpeg.py).
"""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from kfnet_tpu_torch.data import fixture, image_io, native_io

FORMATS = {
    "grey8": ((37, 45), np.uint8),
    "rgb8": ((37, 45, 3), np.uint8),
    "rgba8": ((37, 45, 4), np.uint8),
    "grey16": ((37, 45), np.uint16),
}
FILTERS = {"none": 0, "sub": 1, "up": 2, "average": 3, "paeth": 4,
           "mixed": None}


def pixels(fmt, seed=0):
  shape, dtype = FORMATS[fmt]
  rng = np.random.default_rng(seed)
  # smooth ramps plus noise, so that the predictors see both runs and
  # jumps, and the 8-bit sums wrap
  ramp = np.add.outer(np.arange(shape[0]), np.arange(shape[1])) * 7
  if len(shape) == 3:
    ramp = ramp[..., None] * np.arange(1, shape[2] + 1)
  top = np.iinfo(dtype).max
  noise = rng.integers(0, top // 8, shape)
  return ((ramp * (top // 255) + noise) % (top + 1)).astype(dtype)


def _paeth(a, b, c):
  p = a + b - c
  pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
  return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filtered_png(a, ftype):
  """A PNG of ``a`` whose every row is filtered with ``ftype`` (None: the
  five types in turn), written here independently of the port."""
  a3 = a if a.ndim == 3 else a[..., None]
  h, w, ch = a3.shape
  bits = 8 * a.dtype.itemsize
  raw = (a3.astype(">u2").view(np.uint8) if bits == 16 else a3)
  raw = raw.reshape(h, -1).astype(np.int32)
  bpp = ch * bits // 8
  color = {1: 0, 2: 4, 3: 2, 4: 6}[ch]
  lines = []
  for y in range(h):
    cur = raw[y]
    up = raw[y - 1] if y else np.zeros_like(cur)
    left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
    upleft = np.concatenate([np.zeros(bpp, np.int32), up[:-bpp]])
    k = y % 5 if ftype is None else ftype
    pred = [0, left, up, (left + up) >> 1, _paeth(left, up, upleft)][k]
    lines.append(np.concatenate([[k], (cur - pred) & 255]).astype(np.uint8))
  chunk = lambda t, b: (struct.pack(">I", len(b)) + t + b +
                        struct.pack(">I", zlib.crc32(t + b) & 0xFFFFFFFF))
  return (b"\x89PNG\r\n\x1a\n"
          + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, bits, color, 0, 0,
                                       0))
          + chunk(b"IDAT", zlib.compress(np.concatenate(lines).tobytes()))
          + chunk(b"IEND", b""))


def pil_decode(data):
  return np.asarray(Image.open(io.BytesIO(data)))


@pytest.mark.parametrize("ftype", list(FILTERS))
@pytest.mark.parametrize("fmt", list(FORMATS))
def test_both_decoders_equal_pil_under_each_filter(fmt, ftype):
  a = pixels(fmt)
  data = filtered_png(a, FILTERS[ftype])
  want = pil_decode(data)
  np.testing.assert_array_equal(want, a)  # the file is what it should be
  for route in (image_io.decode_png, image_io.decode_png_plain):
    got = route(data)
    assert got.dtype == want.dtype and got.shape == want.shape, route
    np.testing.assert_array_equal(got, want, err_msg=route.__name__)


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_both_decoders_read_pils_own_files(fmt):
  a = pixels(fmt, seed=1)
  buf = io.BytesIO()
  Image.fromarray(a).save(buf, format="PNG")
  data = buf.getvalue()
  for route in (image_io.decode_png, image_io.decode_png_plain):
    np.testing.assert_array_equal(route(data), pil_decode(data))


@pytest.mark.parametrize("fmt", list(FORMATS))
def test_encoder_read_back_by_pil(fmt, tmp_path):
  a = pixels(fmt, seed=2)
  path = str(tmp_path / "x.png")
  image_io.write_png(path, a)
  img = Image.open(path)
  img.verify()  # chunk CRCs
  np.testing.assert_array_equal(np.asarray(Image.open(path)), a)
  np.testing.assert_array_equal(image_io.read_png(path), a)


def test_read_color_matches_pil_conversion(tmp_path):
  """8-bit grey broadcast and alpha dropped, as PIL's convert("RGB"), then
  / 255 in float32, as the JAX loaders compute it."""
  for fmt in ("grey8", "rgb8", "rgba8"):
    a = pixels(fmt, seed=3)
    path = str(tmp_path / f"{fmt}.png")
    Image.fromarray(a).save(path)
    want = np.asarray(Image.open(path).convert("RGB"), np.float32) / 255.0
    np.testing.assert_array_equal(image_io.read_color(path), want)
    np.testing.assert_array_equal(
        image_io.to_rgb(image_io.read_png(path)).astype(np.float32) / 255.0,
        want)


@pytest.mark.parametrize("size", [(272, 480), (100, 130), (61, 47),
                                  (300, 500)])
def test_resize_bilinear_within_one_level_of_pil(size):
  rng = np.random.default_rng(4)
  # a 270x450 picture of smooth ramps with noise
  base = pixels("rgb8", seed=4).repeat(8, 0).repeat(10, 1)[:270, :450]
  img = np.clip(base.astype(int) + rng.integers(-20, 20, base.shape), 0,
                255).astype(np.uint8)
  want = np.asarray(Image.fromarray(img).resize((size[1], size[0]),
                                                Image.BILINEAR))
  got = image_io.resize_bilinear(img, size)
  assert got.dtype == np.uint8 and got.shape == want.shape
  assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


@pytest.mark.parametrize("size", [(272, 480), (100, 130), (61, 47),
                                  (540, 961)])
def test_resize_nearest_equals_pil(size):
  d = np.random.default_rng(5).uniform(0.1, 80.0, (270, 480)).astype(
      np.float32)
  want = np.asarray(Image.fromarray(d).resize((size[1], size[0]),
                                              Image.NEAREST))
  np.testing.assert_array_equal(image_io.resize_nearest(d, size), want)


def test_jpeg_raises_by_name(tmp_path):
  """JPEG is decoded now (tests/test_torch_jpeg.py); what stays outside
  the decoder's scope raises naming it: a progressive file through
  read_color, and a JPEG handed to the PNG reader, which is not a PNG."""
  path = str(tmp_path / "frame-000000.color.jpg")
  Image.fromarray(pixels("rgb8")).save(path, quality=95, progressive=True)
  with pytest.raises(NotImplementedError, match=r"progressive \(SOF2\)"):
    image_io.read_color(path)
  with pytest.raises(ValueError, match="corrupt PNG"):
    image_io.read_png(path)
  gt = fixture.write_twelve_scenes_fixture(str(tmp_path / "fx"),
                                           train_frames=1, test_frames=1,
                                           height=16, width=16, device="cpu")
  assert gt["apt1/kitchen"]["seq-01"]["images"].shape == (1, 16, 16, 3)


def test_unsupported_pngs_raise(tmp_path):
  buf = io.BytesIO()
  Image.fromarray(pixels("grey8")).convert("P").save(buf, format="PNG")
  for route in (image_io.decode_png, image_io.decode_png_plain):
    with pytest.raises(ValueError):
      route(buf.getvalue())
    with pytest.raises(ValueError):
      route(b"not a png at all, not even close to one")
  bad = bytearray(filtered_png(pixels("rgb8"), 0))
  bad[-20] ^= 0xFF  # inside the deflate stream
  for route in (image_io.decode_png, image_io.decode_png_plain):
    with pytest.raises((ValueError, zlib.error)):
      route(bytes(bad))


def test_a_library_that_does_not_build_raises_with_the_compiler_output(
    tmp_path, monkeypatch):
  src = tmp_path / "kfnet_native.cpp"
  src.write_text("extern \"C\" int kfn_png_info( { this does not compile\n")
  monkeypatch.setattr(native_io, "SOURCES", (str(src),))
  monkeypatch.setattr(native_io, "_LIB", None)
  with pytest.raises(RuntimeError, match="could not be built.*failed"):
    native_io.load_library()
  assert not native_io.available()
  with pytest.raises(RuntimeError, match="could not be built"):
    image_io.decode_png(filtered_png(pixels("grey8"), 0))
