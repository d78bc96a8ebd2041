"""The port's JPEG codec (kfnet_tpu_torch/data/image_io.py and the C++
route in data/csrc/kfnet_native.cpp) against PIL (libjpeg-turbo here),
which the tests alone use, and 12-Scenes colour through the port's loaders
against the JAX package's.

Held: the plain numpy decoder against PIL on PIL-written files at 4:4:4,
4:2:2 and 4:2:0, grey and colour, with and without restart markers, odd
sizes included: max |difference| <= 1 at 4:4:4 and <= 2 with subsampled
chroma (the share of exactly equal samples is recorded; both decoders
follow libjpeg's integer arithmetic); the C++ route bit-equal to the numpy
route on every file; the port's encoder read back by PIL bit-equal to the
port's decoders and within a quality-95 bound of its source; the named
errors of progressive, lossless, arithmetic-coded and 12-bit files; the
12-Scenes loaders (tests/test_data.py::test_twelve_scenes_loader_jpg and
tests/test_acceptance.py::test_twelve_scenes_fixture_loaders) in the port.
"""

import io
import os

import numpy as np
import pytest
from PIL import Image

from kfnet_tpu.data import seven_scenes as js7
from kfnet_tpu.data import twelve_scenes as js12
from kfnet_tpu_torch.data import fixture, image_io, native_io
from kfnet_tpu_torch.data import seven_scenes as ts7
from kfnet_tpu_torch.data import twelve_scenes as ts12

SHAPES = [(48, 64), (37, 45), (17, 9)]
# PIL save options: (name, options, largest |difference| allowed)
MODES = [
    ("444_q95", dict(quality=95, subsampling=0), 1),
    ("422_q90", dict(quality=90, subsampling=1), 2),
    ("420_q75", dict(quality=75, subsampling=2), 2),
    ("444_q95_restart", dict(quality=95, subsampling=0,
                             restart_marker_blocks=3), 1),
    ("420_q85_restart", dict(quality=85, subsampling=2,
                             restart_marker_rows=1), 2),
]


def picture(shape, seed=0, grey=False):
  """Smooth colour ramps plus noise: both flat and busy blocks."""
  h, w = shape
  rng = np.random.default_rng(seed)
  y, x = np.mgrid[0:h, 0:w]
  base = np.stack([np.sin(x / 7.0 + seed), np.cos(y / 5.0),
                   np.sin((x + y) / 11.0)], -1) * 100 + 128
  a = np.clip(base + rng.normal(0, 25, (h, w, 3)), 0, 255).astype(np.uint8)
  return a[..., 0] if grey else a


def pil_jpeg(a, **options):
  buf = io.BytesIO()
  Image.fromarray(a).save(buf, format="JPEG", **options)
  return buf.getvalue()


def pil_decode(data, grey):
  return np.asarray(Image.open(io.BytesIO(data)).convert(
      "L" if grey else "RGB"))


@pytest.mark.parametrize("grey", [False, True], ids=["rgb", "grey"])
@pytest.mark.parametrize("shape", SHAPES, ids=[f"{h}x{w}" for h, w in SHAPES])
@pytest.mark.parametrize("mode,options,bound", MODES,
                         ids=[m[0] for m in MODES])
def test_decoders_against_pil(mode, options, bound, shape, grey,
                              record_property):
  data = pil_jpeg(picture(shape, grey=grey), **options)
  want = pil_decode(data, grey)
  got = image_io.decode_jpeg_plain(data)
  assert got.dtype == np.uint8 and got.shape == want.shape
  diff = np.abs(got.astype(int) - want.astype(int))
  record_property("exact_share", float((diff == 0).mean()))
  assert diff.max() <= bound
  np.testing.assert_array_equal(image_io.decode_jpeg(data), got)


@pytest.mark.parametrize("options", [
    dict(), dict(subsampling="4:2:0"), dict(quality=75),
    dict(quality=75, subsampling="4:2:0")],
    ids=["444", "420", "444_q75", "420_q75"])
@pytest.mark.parametrize("grey", [False, True], ids=["rgb", "grey"])
def test_encoder_read_back_by_pil(options, grey):
  a = picture((37, 45), seed=3, grey=grey)
  data = image_io.encode_jpeg(a, **options)
  got = pil_decode(data, grey)
  np.testing.assert_array_equal(image_io.decode_jpeg_plain(data), got)
  np.testing.assert_array_equal(image_io.decode_jpeg(data), got)
  if options.get("subsampling", "4:4:4") == "4:4:4" and not options.get(
      "quality"):
    # quality 95: a few levels off the source on average
    err = np.abs(got.astype(int) - a.astype(int))
    assert err.mean() < 5.0 and err.max() < 40


def test_encoder_quant_tables_are_libjpegs():
  """The quality scaling of libjpeg's jpeg_quality_scaling: PIL's file at
  the same quality carries the same tables."""
  a = picture((16, 16))
  for q in (50, 75, 95):
    pil = Image.open(io.BytesIO(pil_jpeg(a, quality=q, subsampling=0)))
    luma = np.asarray(pil.quantization[0])
    chroma = np.asarray(pil.quantization[1])
    # PIL reports the tables in natural (row-major) order
    np.testing.assert_array_equal(
        image_io.quant_table(image_io._STD_LUMA_Q, q), luma)
    np.testing.assert_array_equal(
        image_io.quant_table(image_io._STD_CHROMA_Q, q), chroma)


def _patched(data, offset_of, value):
  b = bytearray(data)
  b[offset_of(b)] = value
  return bytes(b)


def _sof(b):
  return bytes(b).index(b"\xff\xc0")


@pytest.mark.parametrize("name,make,exc,match", [
    ("progressive", lambda d: pil_jpeg(picture((48, 64)), progressive=True),
     NotImplementedError, r"progressive \(SOF2\)"),
    ("lossless", lambda d: _patched(d, lambda b: _sof(b) + 1, 0xC3),
     NotImplementedError, r"lossless \(SOF3\)"),
    ("arithmetic", lambda d: _patched(d, lambda b: _sof(b) + 1, 0xC9),
     NotImplementedError, r"arithmetic-coded sequential \(SOF9\)"),
    ("12bit", lambda d: _patched(d, lambda b: _sof(b) + 4, 12),
     NotImplementedError, "12-bit"),
    ("truncated", lambda d: d[:len(d) // 2], ValueError, "JPEG"),
    ("scan_cut_short",
     lambda d: d[:d.index(b"\xff\xda") + 40] + b"\xff\xd9", ValueError,
     "JPEG"),
    ("not_a_jpeg", lambda d: b"\x89PNG not a jpeg", ValueError, "JPEG"),
])
def test_named_errors(name, make, exc, match):
  data = make(pil_jpeg(picture((48, 64)), quality=90))
  for route in (image_io.decode_jpeg, image_io.decode_jpeg_plain):
    with pytest.raises(exc, match=match):
      route(data)


def test_read_color_of_a_jpeg_is_the_cpp_route(tmp_path):
  a = picture((37, 45), seed=5)
  path = str(tmp_path / "frame-000000.color.jpg")
  with open(path, "wb") as f:
    f.write(pil_jpeg(a, quality=90))
  with open(path, "rb") as f:
    pixels = image_io.decode_jpeg(f.read())
  img = image_io.read_color(path)
  assert img.dtype == np.float32 and img.shape == (37, 45, 3)
  np.testing.assert_array_equal(img, pixels.astype(np.float32) / 255.0)
  # a grey JPEG broadcasts to three channels, as PIL's convert("RGB")
  grey = str(tmp_path / "grey.jpeg")
  with open(grey, "wb") as f:
    f.write(pil_jpeg(picture((17, 9), grey=True)))
  g = image_io.read_color(grey)
  assert g.shape == (17, 9, 3) and (g[..., 0] == g[..., 2]).all()


def test_twelve_scenes_loader_jpg(tmp_path):
  """tests/test_data.py's 12-Scenes case (nested scene directory, JPEG
  colour at PIL's defaults: quality 75, 4:2:0) in the port, the colour
  within two levels of the JAX package's PIL-decoded frame."""
  rng = np.random.default_rng(0)
  sdir = os.path.join(str(tmp_path), "apt1", "kitchen", "seq-01")
  os.makedirs(sdir)
  for name in ("TrainSplit.txt", "TestSplit.txt"):
    with open(os.path.join(str(tmp_path), "apt1", "kitchen", name),
              "w") as f:
      f.write("sequence1\n")
  for i in range(2):
    img = rng.integers(0, 255, (48, 64, 3)).astype(np.uint8)
    Image.fromarray(img).save(os.path.join(sdir, f"frame-{i:06d}.color.jpg"))
    d = rng.integers(500, 4000, (48, 64)).astype(np.uint16)
    Image.fromarray(d).save(os.path.join(sdir, f"frame-{i:06d}.depth.png"))
    np.savetxt(os.path.join(sdir, f"frame-{i:06d}.pose.txt"), np.eye(4))
  split = ts12.load_split(str(tmp_path), "apt1/kitchen", "train")
  assert len(split.frames) == 2
  assert split.intrinsics[0, 0] == 572.0
  fr = ts12.load_frame(split.frames[0])
  assert fr["image"].shape == (48, 64, 3)
  assert fr["depth"].shape == (48, 64)
  want = js12.load_frame(js12.load_split(str(tmp_path), "apt1/kitchen",
                                         "train").frames[0])
  np.testing.assert_allclose(fr["image"], want["image"], atol=2.0 / 255)
  np.testing.assert_array_equal(fr["depth"], want["depth"])


@pytest.fixture(scope="module")
def twelve_scenes_root(tmp_path_factory):
  root = str(tmp_path_factory.mktemp("twelvescenes"))
  gt = fixture.write_twelve_scenes_fixture(
      root, scenes=("apt1/kitchen",), train_frames=3, test_frames=2,
      height=96, width=128, device="cpu")
  return root, gt


def test_twelve_scenes_fixture_loaders(twelve_scenes_root):
  """tests/test_acceptance.py's 12-Scenes fixture case in the port: the
  port's writer (its JPEG encoder, quality 95, 4:4:4) read back through
  the port's loaders, JPEG within the JAX test's lossy bounds."""
  root, gt = twelve_scenes_root
  train = ts12.load_split(root, "apt1/kitchen", "train")
  assert len(train.frames) == 3
  assert train.frames[0].color_path.endswith(
      "seq-01/data/frame-000000.color.jpg")
  assert train.intrinsics[0, 0] == 572.0
  ref = gt["apt1/kitchen"]["seq-01"]
  assert ref["K"][0, 0] == pytest.approx(572.0 * 128 / 640)
  fr = ts12.load_frame(train.frames[1])
  err = np.abs(fr["image"] - ref["images"][1])
  assert err.mean() < 0.02 and err.max() < 0.15
  np.testing.assert_allclose(fr["pose"], ref["poses"][1], atol=1e-6)
  np.testing.assert_allclose(fr["depth"], ref["depths"][1], atol=2e-3)


def test_twelve_scenes_fixture_read_by_jax_and_pil(twelve_scenes_root):
  """The port's fixture files through the JAX package's loaders (PIL):
  colour equal to the port's decode, depth and poses equal."""
  root, _ = twelve_scenes_root
  for t, j in zip(ts12.load_split(root, "apt1/kitchen", "test").frames,
                  js12.load_split(root, "apt1/kitchen", "test").frames):
    a, b = ts12.load_frame(t), js12.load_frame(j)
    np.testing.assert_array_equal(a["image"], b["image"])
    np.testing.assert_array_equal(a["depth"], b["depth"])
    np.testing.assert_array_equal(a["pose"], b["pose"])
  assert js7.read_pose is not None and ts7.read_pose is not None


def test_twelve_scenes_frame_at_420(tmp_path):
  """A fixture frame encoded at 4:2:0 (as chip_smoke.py's data phase writes
  one beside the fixture): the file carries 2x2 luma sampling, decodes
  alike by both routes and PIL, and loses about what PIL's own 4:2:0
  file of the same frame at the same quality loses (the synthetic
  texture's chroma is busy at 48x64, so neither is close)."""
  gt = fixture.write_twelve_scenes_fixture(
      str(tmp_path), train_frames=1, test_frames=1, height=48, width=64,
      device="cpu")
  src = gt["apt1/kitchen"]["seq-01"]["images"][0]
  rgb = np.clip(src * 255.0 + 0.5, 0, 255).astype(np.uint8)
  data = image_io.encode_jpeg(rgb, subsampling="4:2:0")
  sof = data.index(b"\xff\xc0")
  assert data[sof + 11] == 0x22  # component 1: h 2, v 2
  got = image_io.decode_jpeg(data)
  np.testing.assert_array_equal(got, image_io.decode_jpeg_plain(data))
  np.testing.assert_array_equal(got, pil_decode(data, grey=False))
  pil = pil_decode(pil_jpeg(rgb, quality=95, subsampling=2), grey=False)
  ours = np.abs(got / 255.0 - src).mean()
  assert ours < 1.25 * np.abs(pil / 255.0 - src).mean()


def test_cpp_route_is_the_ports_host_library():
  assert native_io.available()
  lib = native_io.load_library()
  assert hasattr(lib, "kfn_jpeg_decode") and hasattr(lib, "kfn_jpeg_info")
