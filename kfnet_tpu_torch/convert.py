"""Weight bridge: the JAX package's params pytree -> the port's params.

The JAX params are nested lists and dicts (``nn.layers.serial`` lists of
per-layer dicts; OFlowNet's dict of named parts). ``params_from_jax``
takes that tree with numpy arrays at the leaves (for example
``jax.tree_util.tree_map(np.asarray, params)``) and returns the same tree
of torch tensors in the port's layouts:

  * a conv's HWIO ``w`` becomes (out, in, kh, kw);
  * a transposed conv's HWIO ``w`` (OFlowNet's ``up0`` and ``up1``)
    becomes (in, out, kh, kw) flipped in both spatial axes
    (see ``nn.layers.conv_transpose``);
  * GroupNorm ``scale`` / ``bias``, conv ``b`` and the weight-standardized
    conv's ``gain`` are copied as they are.

``params_to_jax`` is its inverse: the port's params as the JAX package's
tree of float32 numpy arrays (what ``utils/checkpoint.export_params``
writes, so that the export reads back through ``params_from_jax``).
"""

from __future__ import annotations

import numpy as np
import torch

# OFlowNet decoder parts that are transposed convs (models/oflownet.py)
TRANSPOSED = frozenset({"up0", "up1"})


def _leaf(key: str, value, transposed: bool, device, dtype):
  a = np.asarray(value, dtype=np.float32)  # bf16 checkpoints included
  if key == "w" and a.ndim == 4:
    if transposed:
      a = a[::-1, ::-1].transpose(2, 3, 0, 1)
    else:
      a = a.transpose(3, 2, 0, 1)
  return torch.tensor(np.ascontiguousarray(a), dtype=dtype,
                      device=device)


def _map_leaves(tree, leaf):
  """``leaf(key, value, transposed)`` at each leaf of a params tree, where
  ``key`` is the leaf's dict key and ``transposed`` whether it lies under
  a transposed conv; tuples become lists."""

  def walk(node, key, transposed):
    if isinstance(node, dict):
      return {k: walk(v, k, transposed or k in TRANSPOSED)
              for k, v in node.items()}
    if isinstance(node, (list, tuple)):
      return [walk(v, key, transposed) for v in node]
    return leaf(key, node, transposed)

  return walk(tree, None, False)


def params_from_jax(tree, device="cpu", dtype=torch.float32):
  """Convert a JAX params tree (numpy leaves) to the port's params."""
  return _map_leaves(
      tree, lambda key, v, transposed: _leaf(key, v, transposed, device,
                                              dtype))


def _jax_leaf(key: str, value: torch.Tensor, transposed: bool) -> np.ndarray:
  a = value.detach().to("cpu", torch.float32).numpy()
  if key == "w" and a.ndim == 4:
    if transposed:
      a = a.transpose(2, 3, 0, 1)[::-1, ::-1]
    else:
      a = a.transpose(2, 3, 1, 0)
  return np.ascontiguousarray(a)


def params_to_jax(tree):
  """The port's params -> the JAX package's tree (float32 numpy leaves)."""
  return _map_leaves(tree, _jax_leaf)
