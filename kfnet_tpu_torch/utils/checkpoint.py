"""The JAX package's exports read without orbax, and the port's own
``<stage>/params.npz`` + ``<stage>/meta.json`` (the read side of
``kfnet_tpu/utils/checkpoint.py``).

Layouts read, as the JAX module's docstring lists them:

  1. ``<path>/params`` + ``<path>/meta.json``: an export;
  2. ``<path>/export/params``: a training directory whose run wrote an
     export;
  3. ``<path>/<step>/...``: the orbax ``CheckpointManager`` layout of a
     whole TrainState; ``load_params`` returns the latest step's
     ``params`` subtree;
  4. a bare ``StandardCheckpointer`` directory.

Each orbax directory is read by ``utils/ocdbt.py`` (OCDBT, zarr v2 and a
hand-written zstd decoder; no orbax, tensorstore or zstd package). The
port writes ``.npz`` only:

``params.npz`` holds one array per leaf of the params tree, in the JAX
package's layouts (NHWC / HWIO) and the dtypes it saved, under the leaf's
path (``scoordnet/3/0/w``), and one more entry, ``__tree__``: a JSON
description of the tree, so that dicts, lists and tuples, empty dicts
included, come back exactly as they were saved. numpy has no bfloat16: a
bf16 leaf is stored as its uint16 bit pattern and marked so in the tree.

``save_params`` writes the format (the exporter calls it);
``load_params_values`` reads either format back to the same tree of
numpy arrays (bf16 leaves as float32, which holds them exactly) and
raises when an array the tree names is missing, or the file holds one it
does not name. ``convert.params_from_jax`` then makes the port's params
of it; ``export_params`` writes the port's params back in that form.

Training checkpoints (the write side of the JAX package's orbax
``Checkpointer``, without orbax): ``Checkpointer`` keeps a trainer's
state, step, params and optimizer moments, as one ``params.npz`` per step
directory (``<directory>/<step>/``) in the port's own layouts, and
restores it against a template state. The JAX package's training
checkpoints are read by ``load_params`` (their params only).
"""

from __future__ import annotations

import dataclasses
import json
import os
import shutil

import numpy as np
import torch

from kfnet_tpu_torch.utils import ocdbt

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
  key = path.lstrip("/")
  if isinstance(node, torch.Tensor):
    node = node.detach().cpu()
    if node.dtype == torch.bfloat16:  # numpy has none: its bit pattern
      arrays[key] = node.view(torch.int16).numpy().view(np.uint16)
      return {"leaf": key, "dtype": "bfloat16"}
    node = node.numpy()
  a = np.asarray(node)
  if a.dtype.name == "bfloat16":
    arrays[key] = a.view(np.uint16)
    return {"leaf": key, "dtype": "bfloat16"}
  arrays[key] = a
  return {"leaf": key, "dtype": a.dtype.name}


def save_params(directory: str, params, meta: dict | None = None,
                compressed: bool = False):
  """Write ``params`` (a tree of dicts, lists and tuples with array
  leaves: numpy arrays or host tensors, bf16 tensors stored as their bit
  pattern) as ``<directory>/params.npz``, and ``meta`` as ``meta.json``.
  ``compressed`` deflates the arrays (``np.savez_compressed``); the
  reader takes both forms."""
  os.makedirs(directory, exist_ok=True)
  arrays: dict = {}
  tree = _describe(params, "", arrays)
  if TREE_KEY in arrays:
    raise ValueError(f"a leaf path may not be {TREE_KEY!r}")
  save = np.savez_compressed if compressed else np.savez
  save(os.path.join(directory, PARAMS_FILE),
       **{TREE_KEY: np.asarray(json.dumps(tree))}, **arrays)
  if meta is not None:
    save_meta(directory, meta)


def save_meta(directory: str, meta: dict):
  os.makedirs(directory, exist_ok=True)
  with open(os.path.join(directory, META_FILE), "w") as f:
    json.dump(meta, f, indent=2)


def load_meta(path: str) -> dict | None:
  """``<path>/meta.json``, else ``<path>/export/meta.json``, else None."""
  for d in (path, os.path.join(path, "export")):
    p = os.path.join(d, META_FILE)
    if os.path.exists(p):
      with open(p) as f:
        return json.load(f)
  return None


def orbax_dir(path: str) -> str | None:
  """The orbax export of ``path``: ``<path>/params``, then
  ``<path>/export/params``, then ``path`` itself; None where none
  holds one."""
  for sub in ("params", os.path.join("export", "params"), ""):
    p = os.path.join(path, sub) if sub else path
    if ocdbt.is_checkpoint(p):
      return p
  return None


def has_params(path: str) -> bool:
  """True where ``path`` holds an export: ``params.npz`` or an orbax
  one."""
  return (os.path.isfile(os.path.join(path, PARAMS_FILE)) or
          orbax_dir(path) is not None)


def load_params_values(path: str, dtype=None):
  """The params tree of the export at ``path`` (``<path>/params.npz``,
  else the orbax export ``orbax_dir`` finds) with numpy leaves, in the
  saved layouts; bf16 leaves come back as float32 (exactly), and every
  leaf is cast to ``dtype`` where one is given (a numpy dtype or its
  name; ``"bfloat16"`` is not one, numpy having no bf16). Raises
  ``FileNotFoundError`` where there is neither, and ``ValueError`` when a
  leaf the tree names is missing, the file holds arrays it does not name,
  or an orbax file is corrupt or of a kind this reader does not know."""
  p = os.path.join(path, PARAMS_FILE)
  if not os.path.isfile(p):
    src = orbax_dir(path)
    if src is None:
      raise FileNotFoundError(f"no {PARAMS_FILE} or orbax export under "
                              f"{path!r}")
    if dtype is None:
      return ocdbt.read_tree(src)
    return ocdbt.read_tree(
        src, leaf=lambda name, a: ocdbt.to_host(name, a).astype(dtype))
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
      a = ocdbt.to_host(node["dtype"], a)
      return a if dtype is None else a.astype(dtype)
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


def _manager_steps(path: str) -> list:
  try:
    return sorted(int(d) for d in os.listdir(path) if d.isdigit())
  except FileNotFoundError:
    return []


def load_params(path: str, template=None):
  """The params of any layout in the module docstring, with numpy leaves
  in the saved layouts (bf16 as float32). Of a ``CheckpointManager``
  directory, the latest step's ``params`` subtree. Where ``template`` is
  given (a tree of tensors or arrays), the params come back in its
  structure, devices and dtypes, and a tree of another structure or
  shape raises ``ValueError``."""
  path = os.path.abspath(path)
  if has_params(path):
    return _restored(load_params_values(path), template, path)
  steps = _manager_steps(path)
  if not steps:
    raise FileNotFoundError(f"no export or orbax checkpoint at {path!r}")
  step = os.path.join(path, str(steps[-1]))
  item = next((p for p in (os.path.join(step, "default"), step)
               if ocdbt.is_checkpoint(p)), None)
  if item is None:
    raise FileNotFoundError(f"step {steps[-1]} of {path!r} holds no orbax "
                            f"checkpoint")
  state = ocdbt.read_tree(item)
  if not isinstance(state, dict) or "params" not in state:
    raise ValueError(f"step {steps[-1]} of {path!r} has no params")
  return _restored(state["params"], template, f"{path} (step {steps[-1]})")


def _restored(params, template, where):
  if template is None:
    return params
  try:
    return _like(template, params, "")
  except ValueError as e:
    raise ValueError(f"checkpoint params at {where} do not match the "
                     f"template: {e}") from None


def export_params(directory: str, params, meta: dict | None = None):
  """Release-format export of the port's params: ``params.npz`` in the JAX
  package's layouts (``convert.params_to_jax``) + ``meta.json``."""
  from kfnet_tpu_torch import convert
  save_params(directory, convert.params_to_jax(params), meta)


def _host_tree(node):
  """A state (dataclasses, dicts, lists, tensors, numbers) as a tree of
  dicts, lists and numpy arrays; bf16 tensors as float32 (exact)."""
  if dataclasses.is_dataclass(node):
    return {f.name: _host_tree(getattr(node, f.name))
            for f in dataclasses.fields(node)}
  if isinstance(node, dict):
    return {k: _host_tree(v) for k, v in node.items()}
  if isinstance(node, (list, tuple)):
    return [_host_tree(v) for v in node]
  if isinstance(node, torch.Tensor):
    t = node.detach().cpu()
    return (t.float() if t.dtype == torch.bfloat16 else t).numpy()
  return np.asarray(node)


def _like(template, saved, path):
  """``saved`` (numpy leaves) in the structure, devices and dtypes of
  ``template``; raises where the two differ in structure or shape."""
  where = path or "/"
  if dataclasses.is_dataclass(template):
    names = [f.name for f in dataclasses.fields(template)]
    if not isinstance(saved, dict) or sorted(saved) != sorted(names):
      raise ValueError(f"checkpoint at {where}: fields {names} expected")
    return dataclasses.replace(template, **{
        n: _like(getattr(template, n), saved[n], f"{path}/{n}")
        for n in names})
  if isinstance(template, dict):
    if not isinstance(saved, dict) or sorted(saved) != sorted(template):
      raise ValueError(f"checkpoint at {where}: keys {sorted(template)} "
                       f"expected")
    return {k: _like(v, saved[k], f"{path}/{k}") for k, v in template.items()}
  if isinstance(template, (list, tuple)):
    if not isinstance(saved, (list, tuple)) or len(saved) != len(template):
      raise ValueError(f"checkpoint at {where}: {len(template)} items "
                       f"expected")
    return type(template)(_like(t, s, f"{path}/{i}")
                          for i, (t, s) in enumerate(zip(template, saved)))
  if template is None or saved is None:
    if template is not None or saved is not None:
      raise ValueError(f"checkpoint at {where}: None against a leaf")
    return None
  if isinstance(template, (torch.Tensor, np.ndarray)):
    if not isinstance(saved, np.ndarray):
      raise ValueError(f"checkpoint at {where}: an array expected")
    if tuple(saved.shape) != tuple(template.shape):
      raise ValueError(f"checkpoint at {where}: shape {tuple(saved.shape)}, "
                       f"expected {tuple(template.shape)}")
    if isinstance(template, np.ndarray):
      return saved.astype(template.dtype)
    return torch.from_numpy(np.ascontiguousarray(saved)).to(
        device=template.device, dtype=template.dtype)
  return type(template)(saved.item())


class Checkpointer:
  """A trainer's states by step under ``directory``: ``<step>/params.npz``,
  the newest ``max_to_keep`` kept. A step is written to a temporary
  directory and renamed into place, so a step directory is always whole.
  Saves are synchronous (``wait`` is there for the JAX package's
  signature)."""

  def __init__(self, directory: str, max_to_keep: int = 3):
    self._dir = os.path.abspath(directory)
    os.makedirs(self._dir, exist_ok=True)
    self._keep = max_to_keep
    self._last_saved = -1

  def all_steps(self) -> list:
    return sorted(int(d) for d in os.listdir(self._dir)
                  if d.isdigit() and has_params(os.path.join(self._dir, d)))

  def save(self, step: int, state, force: bool = False):
    """Write ``state`` at ``step`` unless that step exists. ``force`` is
    the JAX package's override of a save interval, which this writer does
    not have: every call writes."""
    del force
    if step == self._last_saved or step in self.all_steps():
      return
    tmp = os.path.join(self._dir, f".{step}.tmp")
    shutil.rmtree(tmp, ignore_errors=True)
    save_params(tmp, _host_tree(state))
    os.replace(tmp, os.path.join(self._dir, str(step)))
    self._last_saved = step
    for old in self.all_steps()[:-self._keep]:
      shutil.rmtree(os.path.join(self._dir, str(old)))

  def restore(self, step: int, template):
    """The state saved at ``step``, shaped, placed and typed as
    ``template``."""
    return _like(template,
                 load_params_values(os.path.join(self._dir, str(step))), "")

  def restore_latest(self, template):
    step = self.latest_step()
    return None if step is None else self.restore(step, template)

  def latest_step(self):
    steps = self.all_steps()
    return steps[-1] if steps else None

  def wait(self):
    pass
