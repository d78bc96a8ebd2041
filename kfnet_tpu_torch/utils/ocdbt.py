"""The read side of the JAX package's checkpoint format, without orbax,
tensorstore or a zstd package: OCDBT key-value stores holding zarr v2
arrays, every file zstd-compressed.

An orbax export (``<stage>/params``) is one OCDBT store:

* ``manifest.ocdbt``: the store's configuration and its versions, the
  newest last; each version names the root B-tree node of the keys it
  holds (a data file, an offset and a length).
* B-tree nodes: a leaf maps keys to values, stored inline or as a
  (data file, offset, length) reference; an interior node maps the first
  key of each child (with the prefix its keys share) to that child.
  Nodes and manifests are framed: a big-endian magic number
  (``0x0cdb3a2a`` a manifest, ``0x0cdb20de`` a node), a little-endian
  u64 length (the frame's size), a version (0) and a compression (0
  none, 1 zstd) as varints, the body, and a CRC-32C of all before it.
  Every data file named in a node or manifest is relative to the store's
  root (orbax writes each process's files under ``ocdbt.process_<i>/``
  and a combined root tree beside them).
* keys ``<leaf name>/.zarray`` (the zarr v2 array's JSON) and
  ``<leaf name>/<i>.<j>...`` (its chunks, each compressed as the array's
  ``compressor`` says), where the leaf name is the tree path joined by
  ``.``.
* ``_METADATA``: JSON whose ``tree_metadata`` gives each leaf's key path
  (``key_type`` 2 a dict key, 1 a sequence index), and empty containers.

``read_tree`` returns the nested dict/list tree of numpy arrays (bf16
leaves as float32, which holds them exactly). The decompression is
``csrc/zstd_decode.cpp`` (RFC 8878, decoding only), built at first use
as its own library, ``kfnet_ckpt``, linking nothing but libc. Anything
this reader does not know (a format version, a compression, a zarr
filter, order "F", a dtype, a corrupt frame) raises ``ValueError``;
nothing is skipped and no tree is returned in part.
"""

from __future__ import annotations

import ctypes
import json
import os
import struct

import numpy as np

from kfnet_tpu_torch.kernels import _build

LIBRARY = "kfnet_ckpt"
SOURCES = (os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc",
                        "zstd_decode.cpp"),)

MANIFEST_MAGIC = 0x0CDB3A2A
NODE_MAGIC = 0x0CDB20DE
MANIFEST_FILE = "manifest.ocdbt"
METADATA_FILE = "_METADATA"
_NO_ROOT = 2 ** 64 - 1  # the offset and length of an empty tree's root
# the largest frame decoded: orbax splits an array into chunks of at most
# 2 GiB, so a frame that states more is corrupt
MAX_DECODED = 2 ** 31

_LIB = None


def load_library() -> ctypes.CDLL:
  """The built decoder (built and loaded once per process)."""
  global _LIB
  if _LIB is not None:
    return _LIB
  try:
    lib = _build.load_library(LIBRARY, SOURCES, host=True, libs=())
  except (RuntimeError, OSError) as e:
    raise RuntimeError(f"the checkpoint reader's zstd decoder "
                       f"(utils/csrc/zstd_decode.cpp) could not be built "
                       f"or loaded: {e}") from e
  c = ctypes
  lib.kfn_zstd_frame_size.restype = c.c_int
  lib.kfn_zstd_frame_size.argtypes = [c.c_char_p, c.c_size_t,
                                      c.POINTER(c.c_uint64)]
  lib.kfn_zstd_decompress.restype = c.c_int
  lib.kfn_zstd_decompress.argtypes = [c.c_char_p, c.c_size_t, c.c_void_p,
                                      c.c_size_t, c.POINTER(c.c_uint64)]
  lib.kfn_zstd_error.restype = c.c_char_p
  lib.kfn_zstd_error.argtypes = [c.c_int]
  _LIB = lib
  return _LIB


def zstd_decompress(data: bytes, what: str = "zstd data") -> bytes:
  """Every zstd frame of ``data``, decoded; ``what`` names the source in
  the ``ValueError`` a malformed frame raises."""
  lib = load_library()
  data = bytes(data)
  bound = ctypes.c_uint64()
  rc = lib.kfn_zstd_frame_size(data, len(data), ctypes.byref(bound))
  if rc:
    raise ValueError(f"{what}: {lib.kfn_zstd_error(rc).decode()}")
  if bound.value > MAX_DECODED:
    raise ValueError(f"{what}: states a decoded size of {bound.value} "
                     f"bytes, over the reader's {MAX_DECODED}")
  out = np.empty(max(int(bound.value), 1), np.uint8)
  written = ctypes.c_uint64()
  rc = lib.kfn_zstd_decompress(data, len(data), out.ctypes.data, out.size,
                               ctypes.byref(written))
  if rc:
    raise ValueError(f"{what}: {lib.kfn_zstd_error(rc).decode()}")
  return out[:written.value].tobytes()


def _crc32c_table():
  table = []
  for i in range(256):
    c = i
    for _ in range(8):
      c = (c >> 1) ^ 0x82F63B78 if c & 1 else c >> 1
    table.append(c)
  return table


_CRC32C = _crc32c_table()


def crc32c(data: bytes) -> int:
  crc = 0xFFFFFFFF
  table = _CRC32C
  for b in data:
    crc = table[(crc ^ b) & 0xFF] ^ (crc >> 8)
  return crc ^ 0xFFFFFFFF


class _Reader:
  """A cursor over a decoded body; reading past its end raises."""

  def __init__(self, data: bytes, what: str):
    self.data, self.pos, self.what = data, 0, what

  def take(self, n: int) -> bytes:
    if self.pos + n > len(self.data):
      raise ValueError(f"{self.what}: truncated")
    out = self.data[self.pos:self.pos + n]
    self.pos += n
    return out

  def byte(self) -> int:
    return self.take(1)[0]

  def varint(self) -> int:
    value, shift = 0, 0
    while True:
      b = self.byte()
      value |= (b & 0x7F) << shift
      if b < 0x80:
        return value
      shift += 7
      if shift > 63:
        raise ValueError(f"{self.what}: varint too long")

  def varints(self, n: int) -> list:
    return [self.varint() for _ in range(n)]

  def end(self):
    if self.pos != len(self.data):
      raise ValueError(f"{self.what}: {len(self.data) - self.pos} bytes "
                       f"after the end")


def _unframe(raw: bytes, magic: int, what: str) -> _Reader:
  """The body of a manifest or B-tree node, checked and decoded."""
  if len(raw) < 18:
    raise ValueError(f"{what}: truncated")
  got_magic, length = struct.unpack(">I", raw[:4])[0], struct.unpack(
      "<Q", raw[4:12])[0]
  if got_magic != magic:
    raise ValueError(f"{what}: magic {got_magic:#010x}, expected "
                     f"{magic:#010x}")
  if length != len(raw):
    raise ValueError(f"{what}: length field {length}, frame {len(raw)} bytes")
  if struct.unpack("<I", raw[-4:])[0] != crc32c(raw[:-4]):
    raise ValueError(f"{what}: CRC-32C mismatch")
  head = _Reader(raw[12:-4], what)
  version, compression = head.varint(), head.varint()
  if version != 0:
    raise ValueError(f"{what}: unknown format version {version}")
  body = head.data[head.pos:]
  if compression == 1:
    body = zstd_decompress(body, what)
  elif compression != 0:
    raise ValueError(f"{what}: unknown compression {compression}")
  return _Reader(body, what)


def _data_file_table(r: _Reader) -> list:
  """The data files a manifest or node refers to, as paths relative to
  the store's root (each prefix-compressed against the one before)."""
  n = r.varint()
  prefix = [0] + r.varints(n - 1) if n else []
  suffix = r.varints(n)
  base = r.varints(n)
  paths = []
  for i in range(n):
    prev = paths[-1] if paths else b""
    if prefix[i] > len(prev):
      raise ValueError(f"{r.what}: bad data file table")
    path = prev[:prefix[i]] + r.take(suffix[i])
    if base[i] > len(path):
      raise ValueError(f"{r.what}: bad data file table")
    paths.append(path)
  return [p.decode() for p in paths]


class Store:
  """An OCDBT store on disk, read at its newest version."""

  def __init__(self, root: str):
    self.root = root
    what = os.path.join(root, MANIFEST_FILE)
    with open(what, "rb") as f:
      r = _unframe(f.read(), MANIFEST_MAGIC, what)
    r.take(16)  # the store's uuid
    kind = r.varint()
    if kind != 0:
      raise ValueError(f"{what}: manifest kind {kind} (only single-file "
                       f"manifests are read)")
    r.varint()  # max_inline_value_bytes
    r.varint()  # max_decoded_node_bytes
    r.byte()    # version_tree_arity_log2
    method = r.varint()
    if method == 1:
      r.take(4)  # zstd level
    elif method != 0:
      raise ValueError(f"{what}: unknown compression method {method}")
    files = _data_file_table(r)
    n = r.varint()
    if n == 0:
      raise ValueError(f"{what}: no version")
    r.varints(n)  # generation numbers
    heights = list(r.take(n))
    fid, off, length = r.varints(n), r.varints(n), r.varints(n)
    self.height = heights[-1]
    if off[-1] == _NO_ROOT:
      self.root_ref = None  # an empty tree
    else:
      if fid[-1] >= len(files):
        raise ValueError(f"{what}: data file {fid[-1]} out of range")
      self.root_ref = (files[fid[-1]], off[-1], length[-1])
    self._files = {}

  def _read(self, ref) -> bytes:
    path, offset, length = ref
    full = os.path.join(self.root, path)
    if full not in self._files:
      self._files[full] = os.open(full, os.O_RDONLY)
    data = os.pread(self._files[full], length, offset)
    if len(data) != length:
      raise ValueError(f"{full}: {length} bytes at {offset} expected, "
                       f"{len(data)} there")
    return data

  def close(self):
    for fd in self._files.values():
      os.close(fd)
    self._files = {}

  def items(self) -> dict:
    """Every key of the newest version with its value, as bytes."""
    out: dict = {}
    try:
      if self.root_ref is not None:
        self._node(self.root_ref, self.height, b"", out)
    finally:
      self.close()
    return out

  def _keys(self, r: _Reader, n: int, interior: bool):
    prefix = [0] + r.varints(n - 1) if n else []
    suffix = r.varints(n)
    subtree = r.varints(n) if interior else None
    keys = []
    for i in range(n):
      prev = keys[-1] if keys else b""
      if prefix[i] > len(prev):
        raise ValueError(f"{r.what}: bad key prefix")
      keys.append(prev[:prefix[i]] + r.take(suffix[i]))
    return keys, subtree

  def _node(self, ref, height: int, key_prefix: bytes, out: dict):
    what = f"{os.path.join(self.root, ref[0])} (B-tree node at {ref[1]})"
    r = _unframe(self._read(ref), NODE_MAGIC, what)
    if r.byte() != height:
      raise ValueError(f"{what}: height differs from its reference's")
    files = _data_file_table(r)
    n = r.varint()
    keys, subtree = self._keys(r, n, height > 0)

    def file_of(i):
      if i >= len(files):
        raise ValueError(f"{what}: data file {i} out of range")
      return files[i]

    if height > 0:
      fid, off, length = r.varints(n), r.varints(n), r.varints(n)
      r.varints(3 * n)  # statistics: keys, tree bytes, value bytes
      r.end()
      for i in range(n):
        if subtree[i] > len(keys[i]):
          raise ValueError(f"{what}: bad subtree prefix")
        self._node((file_of(fid[i]), off[i], length[i]), height - 1,
                   key_prefix + keys[i][:subtree[i]], out)
      return
    lengths = r.varints(n)
    kinds = r.varints(n)
    if any(k not in (0, 1) for k in kinds):
      raise ValueError(f"{what}: unknown value kind")
    indirect = [i for i in range(n) if kinds[i] == 1]
    fid = r.varints(len(indirect))
    off = r.varints(len(indirect))
    refs = dict(zip(indirect, zip(fid, off)))
    for i in range(n):
      key = key_prefix + keys[i]
      if kinds[i] == 0:
        out[key] = r.take(lengths[i])
      else:
        f, o = refs[i]
        out[key] = self._read((file_of(f), o, lengths[i]))
    r.end()


# ---- zarr v2 ----

_DTYPES = {"bfloat16": np.dtype("<u2"), "<f4": np.dtype("<f4"),
           "<f8": np.dtype("<f8"), "<i4": np.dtype("<i4"),
           "<i8": np.dtype("<i8"), "|u1": np.dtype("u1"),
           "|b1": np.dtype("?")}


def _fill(spec, dtype: np.dtype, what: str):
  fill = spec.get("fill_value")
  if fill is None:
    return 0
  if isinstance(fill, str):  # "NaN", "Infinity", "-Infinity"
    if spec["dtype"] == "bfloat16" or dtype.kind != "f":
      raise ValueError(f"{what}: fill_value {fill!r} for {spec['dtype']}")
    return float(fill)
  if spec["dtype"] == "bfloat16":
    return int(np.float32(fill).view(np.uint32) >> 16)
  return fill


def to_host(dtype_name: str, stored: np.ndarray) -> np.ndarray:
  """A leaf as ``read_tree`` returns it by default: bf16 (stored as its
  uint16 bits) as float32, every other dtype as stored."""
  if dtype_name == "bfloat16":
    return (stored.astype(np.uint32) << 16).view(np.float32)
  return stored


def read_array(items: dict, name: str):
  """The zarr v2 array ``name`` of ``items`` (a store's keys and values):
  its chunks, decompressed and placed, an absent chunk holding the fill
  value. Returns (dtype name, array as stored): a bf16 array as its
  uint16 bits under the name ``bfloat16``."""
  what = f"array {name!r}"
  key = f"{name}/.zarray".encode()
  if key not in items:
    raise ValueError(f"{what}: no .zarray")
  spec = json.loads(items[key])
  if spec.get("zarr_format") != 2:
    raise ValueError(f"{what}: zarr_format {spec.get('zarr_format')}")
  if spec.get("order", "C") != "C":
    raise ValueError(f"{what}: order {spec['order']!r} is not read")
  if spec.get("filters"):
    raise ValueError(f"{what}: zarr filters {spec['filters']} are not read")
  if spec["dtype"] not in _DTYPES:
    raise ValueError(f"{what}: dtype {spec['dtype']!r} is not read")
  comp = spec.get("compressor")
  if comp is not None and comp.get("id") != "zstd":
    raise ValueError(f"{what}: compressor {comp} is not read")
  dtype = _DTYPES[spec["dtype"]]
  shape, chunks = tuple(spec["shape"]), tuple(spec["chunks"])
  if len(chunks) != len(shape):
    raise ValueError(f"{what}: chunks {chunks} for shape {shape}")
  sep = spec.get("dimension_separator", ".")
  out = np.full(shape, _fill(spec, dtype, what), dtype)
  grid = [-(-s // c) if c else 0 for s, c in zip(shape, chunks)]
  for idx in np.ndindex(*grid):
    ckey = f"{name}/{sep.join(map(str, idx)) if idx else '0'}".encode()
    if ckey not in items:
      continue
    raw = items[ckey]
    data = raw if comp is None else zstd_decompress(raw, f"{what} chunk "
                                                    f"{ckey.decode()}")
    n = int(np.prod(chunks)) * dtype.itemsize
    if len(data) != n:
      raise ValueError(f"{what}: chunk {ckey.decode()} holds {len(data)} "
                       f"bytes, {n} expected")
    block = np.frombuffer(data, dtype).reshape(chunks)
    sel = tuple(slice(i * c, min((i + 1) * c, s))
                for i, c, s in zip(idx, chunks, shape))
    out[sel] = block[tuple(slice(0, s.stop - s.start) for s in sel)]
  return ("bfloat16" if spec["dtype"] == "bfloat16" else dtype.name), out


# ---- the params tree ----

_EMPTY = {"Dict": dict, "List": list, "Tuple": list, "None": lambda: None}


class _Seq(dict):
  """A sequence while the tree is built: its items by index."""


def _insert(root: dict, keys, value, what):
  """Place ``value`` at ``keys`` ((key, key_type) pairs) under ``root``."""
  node = root
  for depth, (key, ktype) in enumerate(keys):
    if ktype not in (1, 2):
      raise ValueError(f"{what}: unknown key_type {ktype}")
    if isinstance(node, _Seq) != (ktype == 1):
      raise ValueError(f"{what}: {keys} mixes dict keys and indices at "
                       f"one level")
    k = int(key) if ktype == 1 else key
    if depth == len(keys) - 1:
      if k in node:
        raise ValueError(f"{what}: {keys} twice")
      node[k] = value
    else:
      nxt = _Seq() if keys[depth + 1][1] == 1 else {}
      node = node.setdefault(k, nxt)
      if not isinstance(node, dict):
        raise ValueError(f"{what}: {keys} passes through a leaf")


def _finish(tree, what):
  """Dicts in JAX's order (keys sorted); sequences as lists, 0..n-1."""
  if isinstance(tree, _Seq):
    if sorted(tree) != list(range(len(tree))):
      raise ValueError(f"{what}: a sequence with a missing index")
    return [_finish(tree[i], what) for i in range(len(tree))]
  if isinstance(tree, dict):
    return {k: _finish(tree[k], what) for k in sorted(tree)}
  return tree


def is_checkpoint(path: str) -> bool:
  """True where ``path`` holds an orbax OCDBT checkpoint's two index
  files."""
  return (os.path.isfile(os.path.join(path, METADATA_FILE)) and
          os.path.isfile(os.path.join(path, MANIFEST_FILE)))


def read_tree(path: str, leaf=to_host):
  """The params tree of the orbax checkpoint directory ``path`` (one with
  ``_METADATA`` and ``manifest.ocdbt``): dicts (keys sorted, as JAX
  orders them), lists, the empty containers and Nones the metadata
  records, and each array as ``leaf(dtype name, stored array)`` makes
  it."""
  meta_path = os.path.join(path, METADATA_FILE)
  with open(meta_path) as f:
    meta = json.load(f)
  if meta.get("use_zarr3"):
    raise ValueError(f"{meta_path}: zarr v3 arrays are not read")
  if meta.get("use_ocdbt") is False:
    raise ValueError(f"{meta_path}: a checkpoint without OCDBT is not read")
  tree_meta = meta.get("tree_metadata")
  if not isinstance(tree_meta, dict):
    raise ValueError(f"{meta_path}: no tree_metadata")
  items = Store(path).items()
  root = None
  for entry in tree_meta.values():
    keys = [(k["key"], k["key_type"]) for k in entry["key_metadata"]]
    vtype = entry["value_metadata"]["value_type"]
    if vtype in _EMPTY:
      value = _EMPTY[vtype]()
    elif vtype in ("jax.Array", "np.ndarray", "scalar"):
      value = leaf(*read_array(items, ".".join(k for k, _ in keys)))
    else:
      raise ValueError(f"{meta_path}: value_type {vtype!r} is not read")
    if not keys:
      raise ValueError(f"{meta_path}: a leaf with no key path")
    if root is None:
      root = _Seq() if keys[0][1] == 1 else {}
    _insert(root, keys, value, meta_path)
  return _finish({} if root is None else root, meta_path)
