"""Exported weights as ``<stage>/params.npz`` + ``<stage>/meta.json`` (the
read side of ``kfnet_tpu/utils/checkpoint.py``'s exports, without orbax).

``params.npz`` holds one array per leaf of the params tree, in the JAX
package's layouts (NHWC / HWIO) and the dtypes it saved, under the leaf's
path (``scoordnet/3/0/w``), and one more entry, ``__tree__``: a JSON
description of the tree, so that dicts, lists and tuples, empty dicts
included, come back exactly as they were saved. numpy has no bfloat16: a
bf16 leaf is stored as its uint16 bit pattern and marked so in the tree.

``save_params`` writes the format (the exporter calls it);
``load_params_values`` reads it back to the same tree of numpy arrays
(bf16 leaves as float32, which holds them exactly) and raises when an
array the tree names is missing, or the file holds one it does not name.
``convert.params_from_jax`` then makes the port's params of it.
"""

from __future__ import annotations

import json
import os

import numpy as np

PARAMS_FILE = "params.npz"
META_FILE = "meta.json"
TREE_KEY = "__tree__"


def _describe(node, path, arrays):
  """The JSON node of ``node``; its leaves go into ``arrays`` by path."""
  if isinstance(node, dict):
    return {"dict": {str(k): _describe(v, f"{path}/{k}", arrays)
                     for k, v in node.items()}}
  if isinstance(node, (list, tuple)):
    kind = "list" if isinstance(node, list) else "tuple"
    return {kind: [_describe(v, f"{path}/{i}", arrays)
                   for i, v in enumerate(node)]}
  a = np.asarray(node)
  key = path.lstrip("/")
  if a.dtype.name == "bfloat16":
    arrays[key] = a.view(np.uint16)
    return {"leaf": key, "dtype": "bfloat16"}
  arrays[key] = a
  return {"leaf": key, "dtype": a.dtype.name}


def save_params(directory: str, params, meta: dict | None = None):
  """Write ``params`` (a tree of dicts, lists and tuples with array
  leaves) as ``<directory>/params.npz``, and ``meta`` as ``meta.json``."""
  os.makedirs(directory, exist_ok=True)
  arrays: dict = {}
  tree = _describe(params, "", arrays)
  if TREE_KEY in arrays:
    raise ValueError(f"a leaf path may not be {TREE_KEY!r}")
  np.savez(os.path.join(directory, PARAMS_FILE),
           **{TREE_KEY: np.asarray(json.dumps(tree))}, **arrays)
  if meta is not None:
    save_meta(directory, meta)


def save_meta(directory: str, meta: dict):
  os.makedirs(directory, exist_ok=True)
  with open(os.path.join(directory, META_FILE), "w") as f:
    json.dump(meta, f, indent=2)


def load_meta(path: str) -> dict | None:
  """``<path>/meta.json``, or None where there is none."""
  p = os.path.join(path, META_FILE)
  if not os.path.exists(p):
    return None
  with open(p) as f:
    return json.load(f)


def has_params(path: str) -> bool:
  return os.path.isfile(os.path.join(path, PARAMS_FILE))


def _bf16_to_f32(bits: np.ndarray) -> np.ndarray:
  return (bits.astype(np.uint32) << 16).view(np.float32)


def load_params_values(path: str):
  """The params tree of ``<path>/params.npz`` with numpy leaves, in the
  saved layouts; bf16 leaves come back as float32 (exactly). Raises
  ``FileNotFoundError`` without the file and ``ValueError`` when a leaf
  the tree names is missing or the file holds arrays it does not name."""
  p = os.path.join(path, PARAMS_FILE)
  if not os.path.isfile(p):
    raise FileNotFoundError(f"no {PARAMS_FILE} under {path!r}")
  with np.load(p, allow_pickle=False) as f:
    stored = {k: f[k] for k in f.files}
  if TREE_KEY not in stored:
    raise ValueError(f"{p}: no {TREE_KEY} entry (not a params export)")
  tree = json.loads(str(stored.pop(TREE_KEY)))
  named = set()

  def build(node):
    if "leaf" in node:
      key = node["leaf"]
      if key not in stored:
        raise ValueError(f"{p}: leaf {key!r} is missing")
      named.add(key)
      a = stored[key]
      return _bf16_to_f32(a) if node["dtype"] == "bfloat16" else a
    (kind, body), = node.items()
    if kind == "dict":
      return {k: build(v) for k, v in body.items()}
    items = [build(v) for v in body]
    return items if kind == "list" else tuple(items)

  params = build(tree)
  extra = sorted(set(stored) - named)
  if extra:
    raise ValueError(f"{p}: arrays the tree does not name: {extra[:8]}")
  return params
