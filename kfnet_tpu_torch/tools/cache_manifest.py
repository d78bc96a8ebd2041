"""Checksum manifest of a protocol stage cache (port of
``kfnet_tpu/tools/cache_manifest.py``).

The protocol's stage caches (``tools/protocol.py --work_dir``) back the
study tools' results but are hours of training and live outside git. This
tool makes the link auditable both ways:

  * ``write``  — walk a cache and emit a manifest: per stage, a content
    hash over the stage's parameter values and its meta.json, plus sizes.
    Kept next to the results, it records exactly WHICH weights produced
    them.
  * ``verify`` — re-walk a cache and compare against a manifest: a
    regenerated or restored cache either reproduces the recorded hashes
    (same weights → the results remain valid) or fails loudly.

    python -m kfnet_tpu_torch.tools.cache_manifest write .protocol_cache/full \
        --out CACHE_MANIFEST_S1.json
    python -m kfnet_tpu_torch.tools.cache_manifest verify .protocol_cache/full \
        --manifest CACHE_MANIFEST_S1.json

A stage is a directory holding ``params.npz`` or the JAX package's orbax
export (``checkpoint.has_params``).
Hashes are over the parameter VALUES — each leaf's path, dtype, shape and
raw bytes, leaves in the JAX package's tree order (dict keys sorted, list
items by index), each path spelled as ``jax.tree_util.keystr`` spells it
(``['scoordnet'][0]['w']``) — plus the stage's meta.json, so the same
float32 params and meta give the JAX package's digest. A bf16 leaf is
hashed as its bf16 bytes under the dtype name ``bfloat16``, as there. The
tool reads files only and touches no device.
"""

from __future__ import annotations

import argparse
import hashlib
import json
import os

import numpy as np

from kfnet_tpu_torch.utils import checkpoint as ckpt_lib
from kfnet_tpu_torch.utils import ocdbt


def _leaves(node, path=""):
  """(keystr path, the ``__tree__`` leaf node) of each leaf under ``node``,
  in the JAX package's flattening order."""
  if "leaf" in node:
    yield path, node
    return
  (kind, body), = node.items()
  if kind == "dict":
    for k in sorted(body):
      yield from _leaves(body[k], f"{path}[{k!r}]")
  else:
    for i, v in enumerate(body):
      yield from _leaves(v, f"{path}[{i}]")


def _tree_leaves(tree, path=""):
  """(keystr path, leaf) of each (dtype name, array) leaf of a read
  orbax tree, in the JAX package's flattening order (Nones and empty
  containers have none)."""
  if isinstance(tree, dict):
    for k in sorted(tree):
      yield from _tree_leaves(tree[k], f"{path}[{k!r}]")
  elif isinstance(tree, list):
    for i, v in enumerate(tree):
      yield from _tree_leaves(v, f"{path}[{i}]")
  elif tree is not None:
    yield path, tree


def stage_leaves(stage_dir: str):
  """The leaves of a stage's export (``params.npz``, else the orbax one)
  as (path, dtype name, array): an array as stored (a bf16 leaf as its
  uint16 bits). Raises where the export is missing or unreadable, or
  names arrays it lacks or lacks names for arrays it holds."""
  p = os.path.join(stage_dir, ckpt_lib.PARAMS_FILE)
  src = None if os.path.isfile(p) else ckpt_lib.orbax_dir(stage_dir)
  if src is not None:
    tree = ocdbt.read_tree(src, leaf=lambda name, a: (name, a))
    return [(path, name, a) for path, (name, a) in _tree_leaves(tree)]
  with np.load(p, allow_pickle=False) as f:
    stored = {k: f[k] for k in f.files}
  tree = json.loads(str(stored.pop(ckpt_lib.TREE_KEY)))
  leaves = list(_leaves(tree))
  named = {node["leaf"] for _, node in leaves}
  if named != set(stored):
    raise ValueError(f"{p}: the tree and the arrays differ: "
                     f"{sorted(named ^ set(stored))[:8]}")
  return [(path, node["dtype"], stored[node["leaf"]])
          for path, node in leaves]


def _stage_hash(stage_dir: str):
  """Value hash of one stage export. Returns (hexdigest, n_leaves,
  total_param_bytes)."""
  h = hashlib.sha256()
  total = 0
  leaves = stage_leaves(stage_dir)
  for path, dtype, leaf in leaves:
    arr = np.ascontiguousarray(leaf)
    h.update(path.encode())
    h.update(dtype.encode())
    h.update(str(arr.shape).encode())
    h.update(arr.tobytes())
    total += arr.nbytes
  meta = ckpt_lib.load_meta(stage_dir)
  if meta is not None:
    h.update(json.dumps(meta, sort_keys=True).encode())
  return h.hexdigest(), len(leaves), total


def build_manifest(work_dir: str) -> dict:
  stages = {}
  for name in sorted(os.listdir(work_dir)):
    d = os.path.join(work_dir, name)
    if os.path.isdir(d) and ckpt_lib.has_params(d):
      digest, n, size = _stage_hash(d)
      stages[name] = {"sha256": digest, "leaves": n, "param_bytes": size}
  if not stages:
    raise FileNotFoundError(f"no stage exports under {work_dir!r}")
  return {"work_dir_basename": os.path.basename(os.path.abspath(work_dir)),
          "stages": stages}


def verify_manifest(work_dir: str, manifest: dict) -> list[str]:
  """Returns mismatch descriptions (empty = cache matches manifest)."""
  problems = []
  for name, want in manifest["stages"].items():
    d = os.path.join(work_dir, name)
    if not ckpt_lib.has_params(d):
      problems.append(f"{name}: missing from cache")
      continue
    try:
      digest, n, size = _stage_hash(d)
    except Exception as e:  # corrupt export: zip, npy and json all raise
      problems.append(f"{name}: unreadable ({type(e).__name__}: {e})")
      continue
    if digest != want["sha256"]:
      problems.append(f"{name}: hash mismatch ({digest[:12]}… != "
                      f"{want['sha256'][:12]}…)")
  return problems


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("mode", choices=("write", "verify"))
  p.add_argument("work_dir")
  p.add_argument("--out", default="", help="write: manifest output path")
  p.add_argument("--manifest", default="", help="verify: manifest to check")
  args = p.parse_args(argv)
  if args.mode == "verify" and not args.manifest:
    p.error("verify requires --manifest <manifest.json>")
  if args.mode == "write":
    m = build_manifest(args.work_dir)
    text = json.dumps(m, indent=2)
    if args.out:
      with open(args.out, "w") as f:
        f.write(text + "\n")
    print(text)
    return 0
  with open(args.manifest) as f:
    m = json.load(f)
  problems = verify_manifest(args.work_dir, m)
  for pr in problems:
    print(pr)
  print("OK" if not problems else f"{len(problems)} mismatches")
  return 0 if not problems else 1


if __name__ == "__main__":
  raise SystemExit(main())
