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


def params_from_jax(tree, device="cpu", dtype=torch.float32):
  """Convert a JAX params tree (numpy leaves) to the port's params."""

  def walk(node, key, transposed):
    if isinstance(node, dict):
      return {k: walk(v, k, transposed or k in TRANSPOSED)
              for k, v in node.items()}
    if isinstance(node, (list, tuple)):
      return [walk(v, key, transposed) for v in node]
    return _leaf(key, node, transposed, device, dtype)

  return walk(tree, None, False)
