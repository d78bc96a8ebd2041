"""The port's hand-written decoders under corrupt input: the PNG and JPEG
decoders of kfnet_tpu_torch/data/csrc/kfnet_native.cpp and the zstd
frame decoder of kfnet_tpu_torch/utils/csrc/zstd_decode.cpp (the
checkpoint reader's), whose contract is "a non-zero return on any
malformed input, no crash, no write outside the caller's buffer".

  * In-process: crafted corruptions through the real ctypes surface
    (data/native_io.py, utils/ocdbt.py) raise ValueError; a decoder crash
    here would kill the pytest process, which is the failure signal.
  * Sanitized fuzz: kfnet_tpu_torch/data/csrc/fuzz_native.cpp, compiled
    with the two decoders' sources under ASan + UBSan by the host's C++
    compiler (kernels/_build.find_cxx), replays 1500 deterministic
    mutations (tests/test_native_fuzz.py's count for the JAX package's
    PNG decoder) of PNG, JPEG and zstd seeds; any out-of-bounds access
    aborts. It skips only where the compiler has no sanitizer runtime.
"""

import os
import pathlib
import struct
import subprocess

import numpy as np
import pytest
import zstandard

from kfnet_tpu_torch.data import image_io, native_io
from kfnet_tpu_torch.kernels import _build
from kfnet_tpu_torch.utils import checkpoint as ckpt_lib
from kfnet_tpu_torch.utils import ocdbt

ROOT = pathlib.Path(__file__).resolve().parent.parent
PKG = ROOT / "kfnet_tpu_torch"
FUZZ_SOURCES = [PKG / "data" / "csrc" / "fuzz_native.cpp",
                PKG / "data" / "csrc" / "kfnet_native.cpp",
                PKG / "utils" / "csrc" / "zstd_decode.cpp"]
SANITIZE = ["-O1", "-g", "-std=c++17", "-Wall",
            "-fsanitize=address,undefined", "-fno-sanitize-recover=all"]
ITERS = 1500
SYNTHETIC = ROOT / "artifacts" / "pretrained_synthetic" / "stage1_sceneA"


def _seed_images():
  rng = np.random.default_rng(0)
  color = rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)
  depth = rng.integers(300, 5000, (48, 64)).astype(np.uint16)
  return (image_io.encode_png(color), image_io.encode_png(depth),
          image_io.encode_jpeg(color))


def _seed_frames():
  """zstd frames of every block and table kind the decoder reads: raw
  and RLE blocks, Huffman literals with FSE-coded sequences (levels 1 and
  19, with and without the checksum), several blocks, and the frame of a
  real OCDBT B-tree node (written by tensorstore)."""
  rng = np.random.default_rng(1)
  text = b"".join(b"key%05d/.zarray value %d; " % (i, i % 7)
                  for i in range(6000))
  noise = rng.integers(0, 256, 3000, dtype=np.uint8).tobytes()
  skewed = rng.integers(0, 6, 200_000, dtype=np.uint8).tobytes()
  frames = [
      zstandard.ZstdCompressor(level=1).compress(text),
      zstandard.ZstdCompressor(level=19, write_checksum=True).compress(text),
      zstandard.ZstdCompressor(level=3).compress(noise),
      zstandard.ZstdCompressor(level=3, write_checksum=True).compress(
          bytes(5000)),
      zstandard.ZstdCompressor(level=1).compress(skewed),
  ]
  node = next((SYNTHETIC / "params" / "d").iterdir()).read_bytes()
  frames.append(node[14:-4])  # the node's body: one zstd frame
  return frames


def _write(tmp_path, blobs, stem):
  paths = []
  for i, b in enumerate(blobs):
    p = tmp_path / f"{stem}{i}"
    p.write_bytes(b)
    paths.append(str(p))
  return paths


# ---- in-process corruptions through ctypes ----

def test_truncated_images_raise_or_decode_identically(tmp_path):
  png, depth, jpeg = _seed_images()
  for data, reader in ((png, native_io.decode), (depth, native_io.decode),
                       (jpeg, native_io.decode_jpeg)):
    full = reader(data)
    for cut in (0, 7, 16, 33, len(data) // 2, len(data) - 1):
      try:
        out = reader(data[:cut])
      except ValueError:
        continue
      np.testing.assert_array_equal(out, full)


@pytest.mark.parametrize("width,height", [
    (0xFFFFFFFF, 0xFFFFFFFF), (0x80000000, 2), (2, 0x80000000),
    (16385, 48), (64, 16385), (0, 48), (64, 0)])
def test_huge_png_dims_raise(width, height):
  png = bytearray(_seed_images()[0])
  png[16:24] = struct.pack(">II", width, height)
  with pytest.raises(ValueError):
    native_io.decode(bytes(png))


def test_corrupt_jpeg_sof_and_scan_raise():
  jpeg = _seed_images()[2]
  sof = jpeg.index(b"\xff\xc0")
  # a zero size defers the height to a DNL marker: not decoded, and said
  # so; a size over the 16384 cap is corrupt
  for h, w, err in ((0, 64, NotImplementedError),
                    (48, 0, NotImplementedError), (16385, 64, ValueError),
                    (65535, 65535, ValueError)):
    bad = bytearray(jpeg)
    bad[sof + 5:sof + 9] = struct.pack(">HH", h, w)
    with pytest.raises(err):
      native_io.decode_jpeg(bytes(bad))
  rng = np.random.default_rng(7)
  failed = 0
  for _ in range(100):
    bad = bytearray(jpeg)
    for _ in range(int(rng.integers(1, 9))):
      i = int(rng.integers(2, len(bad)))
      bad[i] ^= int(rng.integers(1, 256))
    try:
      native_io.decode_jpeg(bytes(bad))
    except (ValueError, NotImplementedError):  # a flipped sampling factor
      failed += 1                              # is an unsupported feature
  assert failed > 0


def test_corrupt_zstd_frames_raise():
  data = b"".join(b"%d," % i for i in range(20000))
  frame = zstandard.ZstdCompressor(level=3, write_checksum=True).compress(
      data)
  assert ocdbt.zstd_decompress(frame) == data
  bad = bytearray(frame)
  bad[-1] ^= 0x40  # the content checksum
  with pytest.raises(ValueError, match="checksum"):
    ocdbt.zstd_decompress(bytes(bad))
  for cut in (0, 3, 5, len(frame) // 2, len(frame) - 1):
    with pytest.raises(ValueError):
      ocdbt.zstd_decompress(frame[:cut])
  with pytest.raises(ValueError, match="magic"):
    ocdbt.zstd_decompress(b"\x00" + frame[1:])
  rng = np.random.default_rng(3)
  for _ in range(200):
    bad = bytearray(frame)
    for _ in range(int(rng.integers(1, 9))):
      i = int(rng.integers(0, len(bad)))
      bad[i] ^= int(rng.integers(1, 256))
    try:
      out = ocdbt.zstd_decompress(bytes(bad))
    except ValueError:
      continue
    assert out == data  # a flip the checksum cannot see changes nothing


@pytest.mark.parametrize("victim,damage", [
    ("manifest.ocdbt", "flip"),      # the CRC-32C
    ("d", "flip"),                   # the root B-tree node's CRC-32C
    ("ocdbt.process_0/d", "cut"),    # a chunk runs past the data file
    ("ocdbt.process_0/d", "magic")])  # a chunk that is not a zstd frame
def test_corrupt_checkpoint_files_raise_with_no_partial_tree(
    tmp_path, victim, damage):
  import shutil
  stage = tmp_path / "stage"
  shutil.copytree(SYNTHETIC, stage)
  target = stage / "params" / victim
  if target.is_dir():  # the largest file there
    target = max(target.iterdir(), key=lambda p: p.stat().st_size)
  data = bytearray(target.read_bytes())
  if damage == "flip":
    data[len(data) // 2] ^= 0xFF
  elif damage == "cut":
    del data[len(data) // 2:]
  else:  # every zstd magic number in the file
    at = data.find(b"\x28\xb5\x2f\xfd")
    assert at >= 0
    while at >= 0:
      data[at] ^= 0xFF
      at = data.find(b"\x28\xb5\x2f\xfd", at + 1)
  target.write_bytes(bytes(data))
  with pytest.raises(ValueError):
    ckpt_lib.load_params_values(str(stage))


# ---- the sanitized fuzz harness ----

def _has_sanitizer(cxx, tmp_path) -> bool:
  src = tmp_path / "probe.cpp"
  src.write_text("int main() { return 0; }\n")
  res = subprocess.run([cxx, *SANITIZE, "-o", str(tmp_path / "probe"),
                        str(src)], capture_output=True, text=True,
                       timeout=120)
  return res.returncode == 0


def test_asan_mutation_fuzz(tmp_path):
  cxx = _build.find_cxx()
  if not _has_sanitizer(cxx, tmp_path):
    pytest.skip(f"{cxx} has no ASan/UBSan runtime")
  exe = str(tmp_path / "fuzz_native")
  build = subprocess.run([cxx, *SANITIZE, "-o", exe,
                          *map(str, FUZZ_SOURCES), "-lz"],
                         capture_output=True, text=True, timeout=300)
  assert build.returncode == 0, build.stderr
  seeds = (_write(tmp_path, _seed_images(), "img")
           + _write(tmp_path, _seed_frames(), "zst"))
  env = dict(os.environ, ASAN_OPTIONS="detect_leaks=1")
  run = subprocess.run([exe, str(ITERS), *seeds], capture_output=True,
                       text=True, timeout=600, env=env)
  assert run.returncode == 0, (run.stdout, run.stderr[-4000:])
  assert f"ok {ITERS} iterations over {len(seeds)} seeds" in run.stdout
