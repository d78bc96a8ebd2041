"""The weight bridge: every leaf of the full default KFNet config converts
to the layout of the port's own init, and the per-layer mappings are the
right ones. Full-size shapes come from jax.eval_shape, so nothing
full-size is computed in JAX; the port's tree is made on the CPU.
"""

import jax
import numpy as np
import pytest
import torch

from kfnet_tpu.models import kfnet as jkfnet
from kfnet_tpu_torch import convert
from kfnet_tpu_torch.models import kfnet as tkfnet
from kfnet_tpu_torch.nn import layers as tL


def _shapes(tree):
  if isinstance(tree, dict):
    return {k: _shapes(v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return [_shapes(v) for v in tree]
  return tuple(tree.shape)


@pytest.fixture(scope="module")
def full_trees():
  jshapes = jax.eval_shape(
      lambda k: jkfnet.init(k, jkfnet.KFNetConfig()), jax.random.key(0))
  # zero-stride arrays of each leaf's shape: no full-size memory in numpy
  jtree = jax.tree_util.tree_map(
      lambda s: np.broadcast_to(np.zeros((), np.float32), s.shape), jshapes)
  converted = convert.params_from_jax(jtree)
  native = tkfnet.init(0, tkfnet.KFNetConfig(), device="cpu")
  return jshapes, converted, native


def test_full_config_converts_to_the_ports_layout(full_trees):
  _, converted, native = full_trees
  assert _shapes(converted) == _shapes(native)


def test_full_config_leaf_count_and_size(full_trees):
  jshapes, converted, _ = full_trees
  jleaves = jax.tree_util.tree_leaves(jshapes)
  tleaves = tL.tree_leaves(converted)
  assert len(tleaves) == len(jleaves)
  n = sum(int(np.prod(s.shape)) for s in jleaves)
  assert tL.param_count(converted) == n
  assert all(t.dtype == torch.float32 for t in tleaves)


def test_full_config_head_and_transposed_shapes(full_trees):
  _, converted, _ = full_trees
  sc = converted["scoordnet"]
  assert tuple(sc[0][0]["w"].shape) == (64, 12, 3, 3)  # s2d stem input
  assert tuple(sc[-1]["w"].shape) == (4, 512, 1, 1)    # f32 1x1 head
  of = converted["oflownet"]
  assert tuple(of["enc0"][0][0]["w"].shape) == (128, 81, 3, 3)
  # transposed convs are (in, out, kh, kw)
  assert tuple(of["up1"]["w"].shape) == (256, 128, 4, 4)
  assert tuple(of["up0"]["w"].shape) == (128, 128, 4, 4)
  assert tuple(of["head"]["w"].shape) == (3, 128, 3, 3)


def test_leaf_mappings():
  rng = np.random.default_rng(0)
  w = rng.normal(size=(3, 3, 4, 5)).astype(np.float32)  # HWIO
  tree = {"plain": [{"w": w, "b": np.arange(5, dtype=np.float32)},
                    {"scale": np.ones(5, np.float32),
                     "bias": np.zeros(5, np.float32)}, {}],
          "up0": {"w": w, "b": np.zeros(5, np.float32)},
          "ws": {"w": w, "gain": np.full(5, 2.0, np.float32)}}
  out = convert.params_from_jax(tree)
  np.testing.assert_array_equal(out["plain"][0]["w"].numpy(),
                                w.transpose(3, 2, 0, 1))
  np.testing.assert_array_equal(out["up0"]["w"].numpy(),
                                w[::-1, ::-1].transpose(2, 3, 0, 1))
  np.testing.assert_array_equal(out["ws"]["gain"].numpy(), np.full(5, 2.0))
  np.testing.assert_array_equal(out["plain"][0]["b"].numpy(), np.arange(5))
  assert out["plain"][2] == {}
  # leaves are copies: the source stays untouched
  out["plain"][0]["w"].zero_()
  assert w.any()


def test_bf16_leaves_convert_to_f32():
  import jax.numpy as jnp
  w = jnp.ones((1, 1, 2, 3), jnp.bfloat16)
  out = convert.params_from_jax({"w": np.asarray(w)})
  assert out["w"].dtype == torch.float32
  assert tuple(out["w"].shape) == (3, 2, 1, 1)
