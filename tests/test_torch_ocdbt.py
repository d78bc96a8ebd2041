"""The port's reader of the JAX package's checkpoints
(kfnet_tpu_torch/utils/ocdbt.py, utils/checkpoint.py) against the JAX
package, orbax, tensorstore and zstandard, on the CPU.

  * The hand-written zstd decoder (utils/csrc/zstd_decode.cpp) against
    zstandard's output: empty and 1-byte content, random and repetitive
    buffers at levels 1, 3 and 19, several blocks, raw and RLE blocks,
    with and without the checksum, two frames in a row; a flipped
    checksum raises.
  * ``load_params_values`` bit for bit against
    ``kfnet_tpu.utils.checkpoint.load_params_values`` on every shipped
    orbax stage (the three synthetic ones and the four full-size ones,
    each read once), on exports that JAX's ``export_params`` and
    ``save_params`` write (float32, bf16, int32, uint8, bool, shape (),
    an array sharded over the 8-device CPU mesh: a zarr array of several
    chunks), and ``load_params`` on a JAX ``Checkpointer`` directory of
    two steps (the latest step's params; a template of another structure
    refused).
  * OCDBT and zarr details against tensorstore: a B-tree of several
    levels with inline and indirect values, absent chunks read as the
    fill value; what the reader does not know raises ValueError.
  * ``has_params``, ``load_meta`` of a training directory's export, and
    the cache manifest's digest of an orbax stage equal to JAX's.
"""

import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import tensorstore as ts
import zstandard

from kfnet_tpu.tools import cache_manifest as jcache_manifest
from kfnet_tpu.train import trainer as jtrainer
from kfnet_tpu.utils import checkpoint as jckpt
from kfnet_tpu_torch.tools import cache_manifest
from kfnet_tpu_torch.utils import checkpoint as tckpt
from kfnet_tpu_torch.utils import ocdbt

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), os.pardir)
SYNTHETIC = ("stage1_sceneA", "stage2_indoor", "stage3_sceneA")
FULL = ("pretrained_full/stage3_sceneA",
        "pretrained_full/stage3_outdoor_train",
        "pretrained_full_nonorm/stage3_sceneA",
        "pretrained_full_nonorm/stage3_outdoor_train")


def _leaves(tree, path=""):
  if isinstance(tree, dict):
    return [x for k in sorted(tree) for x in _leaves(tree[k], f"{path}/{k}")]
  if isinstance(tree, (list, tuple)):
    return [x for i, v in enumerate(tree)
            for x in _leaves(v, f"{path}/{i}")]
  return [(path, tree)]


def _structure(tree):
  if isinstance(tree, dict):
    return {k: _structure(v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return [_structure(v) for v in tree]
  return None if tree is None else "*"


def assert_bit_equal(got, want):
  """The port's tree against the JAX loader's: the same structure (dicts,
  lists, empty containers) and every leaf's bits; a bf16 leaf comes back
  as the float32 that holds it exactly."""
  want = jax.tree_util.tree_map(np.asarray, want)
  assert _structure(got) == _structure(want)
  g, w = _leaves(got), _leaves(want)
  assert [p for p, _ in g] == [p for p, _ in w]
  for (path, gv), (_, wv) in zip(g, w):
    if wv is None:
      assert gv is None, path
      continue
    assert gv.shape == wv.shape, path
    if wv.dtype.name == "bfloat16":
      assert gv.dtype == np.float32, path
      wv = wv.astype(np.float32)
    else:
      assert gv.dtype == wv.dtype, path
    np.testing.assert_array_equal(
        np.ascontiguousarray(gv).reshape(-1).view(np.uint8),
        np.ascontiguousarray(wv).reshape(-1).view(np.uint8), err_msg=path)


# ---- the zstd decoder ----

def _buffers():
  rng = np.random.default_rng(0)
  return {
      "empty": b"",
      "one_byte": b"k",
      "random": rng.integers(0, 256, 5000, dtype=np.uint8).tobytes(),
      "repetitive": b"".join(b"oflownet.down1.%d.0.w/.zarray " % (i % 9)
                             for i in range(3000)),
      "skewed": rng.integers(0, 7, 20000, dtype=np.uint8).tobytes(),
      "multi_block": rng.integers(0, 40, 300_000,
                                  dtype=np.uint8).tobytes(),
      "zeros": bytes(200_000),
  }


@pytest.mark.parametrize("checksum", [False, True], ids=["plain", "xxh64"])
@pytest.mark.parametrize("level", [1, 3, 19])
@pytest.mark.parametrize("name", list(_buffers()))
def test_zstd_decoder_matches_zstandard(name, level, checksum):
  data = _buffers()[name]
  frame = zstandard.ZstdCompressor(
      level=level, write_checksum=checksum).compress(data)
  assert ocdbt.zstd_decompress(frame) == data


def test_zstd_several_blocks_raw_and_rle():
  """A frame over 128 KiB has several blocks; incompressible content is
  stored in raw blocks and a run of one byte in RLE blocks (the block
  types read from each block header)."""
  rng = np.random.default_rng(1)
  parts = [rng.integers(0, 256, 140_000, dtype=np.uint8).tobytes(),
           b"\x07" * 300_000]
  for data in parts + [b"".join(parts)]:
    frame = zstandard.ZstdCompressor(level=3).compress(data)
    types = _block_types(frame)
    assert len(types) > 1
    assert ocdbt.zstd_decompress(frame) == data
  assert 0 in _block_types(zstandard.ZstdCompressor(level=3).compress(
      parts[0]))
  assert 1 in _block_types(zstandard.ZstdCompressor(level=19).compress(
      parts[1]))


def _block_types(frame):
  fhd = frame[4]
  fcs, single, did = fhd >> 6, (fhd >> 5) & 1, fhd & 3
  pos = 5 + (0 if single else 1) + (4 if did == 3 else did) + (
      (1 if single else 0) if fcs == 0 else 1 << fcs)
  types = []
  while True:
    bh = int.from_bytes(frame[pos:pos + 3], "little")
    kind, size = (bh >> 1) & 3, bh >> 3
    types.append(kind)
    pos += 3 + (1 if kind == 1 else size)
    if bh & 1:
      return types


def test_zstd_two_frames_and_a_bad_checksum():
  a, b = b"first frame " * 100, bytes(range(256)) * 40
  c = zstandard.ZstdCompressor(level=3, write_checksum=True)
  both = c.compress(a) + c.compress(b)
  assert ocdbt.zstd_decompress(both) == a + b
  bad = bytearray(c.compress(a))
  bad[-2] ^= 0x10
  with pytest.raises(ValueError, match="checksum"):
    ocdbt.zstd_decompress(bytes(bad))
  samples = [b"oflownet.down%d.%d.w/.zarray %d" % (i % 3, i % 7, i * 31)
             for i in range(2000)]
  zdict = zstandard.train_dictionary(2048, samples)
  assert zdict.dict_id() != 0
  with pytest.raises(ValueError, match="dictionary"):
    ocdbt.zstd_decompress(zstandard.ZstdCompressor(
        dict_data=zdict).compress(samples[5]))


# ---- the shipped orbax stages ----

@pytest.mark.parametrize("stage", SYNTHETIC)
def test_synthetic_stages_bit_for_bit(stage):
  path = os.path.join(ROOT, "artifacts", "pretrained_synthetic", stage)
  assert_bit_equal(tckpt.load_params_values(path),
                   jckpt.load_params_values(path))
  assert tckpt.load_meta(path) == jckpt.load_meta(path)


@pytest.fixture(scope="module", params=FULL)
def full_stage(request):
  path = os.path.join(ROOT, "artifacts", request.param)
  return path, tckpt.load_params_values(path)


def test_full_stages_bit_for_bit(full_stage):
  path, got = full_stage
  assert_bit_equal(got, jckpt.load_params_values(path))
  assert tckpt.load_meta(path) == jckpt.load_meta(path)
  assert tckpt.has_params(path)


# ---- exports JAX writes ----

def _mixed_tree():
  rng = np.random.default_rng(2)
  mesh = jax.sharding.Mesh(np.array(jax.devices()), ("x",))
  big = jax.device_put(
      jnp.asarray(rng.standard_normal((64, 6)), jnp.float32),
      jax.sharding.NamedSharding(mesh, jax.sharding.PartitionSpec("x")))
  return {"w": jnp.asarray(rng.standard_normal((3, 3, 4, 5)), jnp.float32),
          "b16": jnp.asarray(rng.standard_normal((7,)), jnp.bfloat16),
          "ints": [jnp.arange(12, dtype=jnp.int32).reshape(3, 4),
                   jnp.asarray(rng.integers(0, 256, (9,)), jnp.uint8)],
          "flags": {"mask": jnp.asarray([True, False, True]),
                    "scalar": jnp.float32(2.5)},
          "sharded": big, "empty": {}}


def test_jax_exports_bit_for_bit(tmp_path):
  tree = _mixed_tree()
  exp = str(tmp_path / "export_dir")
  jckpt.export_params(exp, tree, {"scene": "x"})
  bare = str(tmp_path / "bare")
  jckpt.save_params(bare, tree)
  for path in (exp, bare):
    assert_bit_equal(tckpt.load_params_values(path),
                     jckpt.load_params_values(path))
  spec = json.loads(ocdbt.Store(os.path.join(exp, "params")).items()[
      b"sharded/.zarray"])
  assert spec["chunks"][0] < spec["shape"][0]  # several chunks
  assert tckpt.load_meta(exp) == {"scene": "x"}
  assert tckpt.has_params(exp) and tckpt.has_params(bare)
  # a training directory whose run wrote an export below it
  run = tmp_path / "run"
  shutil.copytree(exp, run / "export")
  assert tckpt.has_params(str(run))
  assert tckpt.load_meta(str(run)) == jckpt.load_meta(str(run)) == {
      "scene": "x"}
  assert_bit_equal(tckpt.load_params(str(run)),
                   jckpt.load_params_values(str(run)))
  assert not tckpt.has_params(str(tmp_path / "nothing"))
  with pytest.raises(FileNotFoundError):
    tckpt.load_params_values(str(tmp_path / "nothing"))


def test_checkpointer_latest_params_and_template(tmp_path):
  """A JAX Checkpointer (CheckpointManager) directory of two steps of a
  full TrainState (step, params, Adam's state): load_params returns the
  latest step's params subtree, as JAX's does, and refuses a template of
  another structure."""
  params = {"w": [jnp.ones((2, 3)), {"b": jnp.arange(3.0)}], "e": {}}
  opt = jtrainer.make_optimizer(jtrainer.OptimizerConfig())
  state = jtrainer.create_state(params, opt)
  ck = jckpt.Checkpointer(str(tmp_path / "ckpt"))
  ck.save(1, state)
  later = jax.tree_util.tree_map(lambda x: x + 1, state)
  ck.save(2, later)
  ck.wait()
  got = tckpt.load_params(str(tmp_path / "ckpt"))
  assert_bit_equal(got, jckpt.load_params(str(tmp_path / "ckpt")))
  np.testing.assert_array_equal(got["w"][0], np.full((2, 3), 2.0))
  template = jax.tree_util.tree_map(np.asarray, later.params)
  assert_bit_equal(tckpt.load_params(str(tmp_path / "ckpt"), template),
                   got)
  with pytest.raises(ValueError, match="do not match the template"):
    tckpt.load_params(str(tmp_path / "ckpt"),
                      template={"w": [np.zeros((2, 3))]})
  with pytest.raises(ValueError):
    jckpt.load_params(str(tmp_path / "ckpt"),
                      template={"w": [np.zeros((2, 3))]})


# ---- OCDBT and zarr against tensorstore ----

def test_multi_level_btree_inline_and_indirect_values(tmp_path):
  kv = ts.KvStore.open({
      "driver": "ocdbt", "base": f"file://{tmp_path}/kv/",
      "config": {"max_decoded_node_bytes": 300,
                 "max_inline_value_bytes": 16}}).result()
  with ts.Transaction() as txn:
    for i in range(200):
      kv.with_transaction(txn)[f"k{i:04d}/v"] = (b"x%d" % i) * (1 + i % 5)
  want = {k: kv.read(k).result().value for k in kv.list().result()}
  store = ocdbt.Store(str(tmp_path / "kv"))
  assert store.height > 1
  assert store.items() == want


def _zarr(tmp_path, name, **spec):
  return ts.open({"driver": "zarr", "kvstore": {
      "driver": "ocdbt", "base": f"file://{tmp_path}/z/", "path": name},
      "metadata": spec, "create": True}).result()


def test_zarr_chunks_fill_value_and_refusals(tmp_path):
  a = _zarr(tmp_path, "a", shape=[5, 7], chunks=[2, 3], dtype="<f4",
            fill_value=1.5, compressor={"id": "zstd", "level": 3})
  a[0:2, 0:3] = np.arange(6, dtype=np.float32).reshape(2, 3)
  a[4:5, 3:7] = -np.ones((1, 4), np.float32)
  b = _zarr(tmp_path, "b", shape=[4], chunks=[4], dtype="<i8",
            fill_value=0, compressor=None)
  b[...] = np.arange(4, dtype=np.int64) - 2
  c = _zarr(tmp_path, "c", shape=[3, 2], chunks=[3, 2], dtype="<f4",
            order="F", fill_value=0, compressor=None)
  c[...] = np.ones((3, 2), np.float32)
  items = ocdbt.Store(str(tmp_path / "z")).items()
  name, got = ocdbt.read_array(items, "a")
  assert name == "float32"
  np.testing.assert_array_equal(got, a.read().result())
  assert (got == 1.5).sum() > 0  # absent chunks hold the fill value
  np.testing.assert_array_equal(ocdbt.read_array(items, "b")[1],
                                b.read().result())
  with pytest.raises(ValueError, match="order"):
    ocdbt.read_array(items, "c")
  with pytest.raises(ValueError, match="no .zarray"):
    ocdbt.read_array(items, "missing")
  spec = json.loads(items[b"b/.zarray"])
  for key, value, match in (("dtype", "<c8", "dtype"),
                            ("filters", [{"id": "delta"}], "filters"),
                            ("compressor", {"id": "blosc"}, "compressor")):
    bad = dict(items)
    bad[b"b/.zarray"] = json.dumps({**spec, key: value}).encode()
    with pytest.raises(ValueError, match=match):
      ocdbt.read_array(bad, "b")


def test_unknown_metadata_and_frames_raise(tmp_path):
  src = os.path.join(ROOT, "artifacts", "pretrained_synthetic",
                     "stage1_sceneA", "params")
  dst = tmp_path / "params"
  shutil.copytree(src, dst)
  meta = json.loads((dst / "_METADATA").read_text())
  (dst / "_METADATA").write_text(json.dumps({**meta, "use_zarr3": True}))
  with pytest.raises(ValueError, match="zarr v3"):
    ocdbt.read_tree(str(dst))
  (dst / "_METADATA").write_text(json.dumps(meta))
  raw = bytearray((dst / "manifest.ocdbt").read_bytes())
  raw[12] = 1  # format version 1
  (dst / "manifest.ocdbt").write_bytes(bytes(raw))
  with pytest.raises(ValueError):  # the CRC, then the version
    ocdbt.read_tree(str(dst))


# ---- the cache manifest over an orbax stage ----

def test_cache_manifest_digest_of_an_orbax_stage_equals_jax(tmp_path):
  stage = os.path.join(ROOT, "artifacts", "pretrained_synthetic",
                       "stage3_sceneA")
  assert cache_manifest._stage_hash(stage) == jcache_manifest._stage_hash(
      stage)
  exp = str(tmp_path / "stage_x")
  jckpt.export_params(exp, _mixed_tree(), {"seed": 3})
  assert cache_manifest._stage_hash(exp) == jcache_manifest._stage_hash(exp)
  work = tmp_path / "work"
  shutil.copytree(stage, work / "stage3_sceneA")
  assert cache_manifest.build_manifest(str(work)) == \
      jcache_manifest.build_manifest(str(work))
