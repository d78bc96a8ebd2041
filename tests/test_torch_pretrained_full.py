"""The full-size shipped weights in the port: the committed ``.npz`` export
under kfnet_tpu_torch/assets/pretrained_full/stage3_sceneA against the
orbax release under artifacts/pretrained_full, ``pretrained.load`` of it
against the JAX package's (the spec of
tests/test_pretrained_artifact.py:82-116), and the float32 filter over it.

Tolerances: the export leaf for leaf, bit for bit (the same bf16 values);
the loaded config exactly; run_filter with both nets in float32 at the
goldens' rtol 5e-4 / atol 5e-5 (tests/test_goldens.py:61).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfnet_tpu import pretrained as jpre
from kfnet_tpu.data import synthetic as jsyn
from kfnet_tpu.filter import sequence as jseq
from kfnet_tpu.utils import checkpoint as jckpt
from kfnet_tpu_torch import convert
from kfnet_tpu_torch import pretrained as tpre
from kfnet_tpu_torch.filter import sequence as tseq
from kfnet_tpu_torch.nn import layers as L
from kfnet_tpu_torch.utils import checkpoint as tckpt

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
ORBAX = os.path.join(ROOT, "artifacts", "pretrained_full")
STAGE = "stage3_sceneA"
TOL = dict(rtol=5e-4, atol=5e-5)


@pytest.fixture(scope="module")
def jax_full():
  return jpre.load(ORBAX, scene="sceneA")


@pytest.fixture(scope="module")
def port_full():
  return tpre.load(tpre.FULL_ASSETS, scene="sceneA", device="cpu")


def _leaves(tree, path=""):
  if isinstance(tree, dict):
    return [x for k in sorted(tree) for x in _leaves(tree[k], f"{path}/{k}")]
  if isinstance(tree, (list, tuple)):
    return [x for i, v in enumerate(tree)
            for x in _leaves(v, f"{path}/{i}")]
  return [(path, tree)]


def test_export_equals_orbax_bit_for_bit():
  want = jckpt.load_params_values(os.path.join(ORBAX, STAGE))
  got = tckpt.load_params_values(os.path.join(tpre.FULL_ASSETS, STAGE))
  w, g = _leaves(jax.tree_util.tree_map(np.asarray, want)), _leaves(got)
  assert [p for p, _ in g] == [p for p, _ in w]
  for (path, gv), (_, wv) in zip(g, w):
    assert wv.dtype.name == "bfloat16", path
    assert gv.dtype == np.float32 and gv.shape == wv.shape, path
    # the bf16 bits, compared as the float32 that holds them exactly
    np.testing.assert_array_equal(gv.view(np.uint32),
                                  wv.astype(np.float32).view(np.uint32),
                                  err_msg=path)
  assert tckpt.load_meta(os.path.join(tpre.FULL_ASSETS, STAGE)) == \
      jckpt.load_meta(os.path.join(ORBAX, STAGE))
  with np.load(os.path.join(tpre.FULL_ASSETS, STAGE, "params.npz")) as f:
    assert f["scoordnet/0/0/w"].dtype == np.uint16  # stored as bf16 bits


def test_load_full_matches_jax_config_and_params(jax_full, port_full):
  jcfg, jparams = jax_full
  tcfg, tparams = port_full
  assert tcfg.scoordnet.norm == jcfg.scoordnet.norm == "group"
  assert tcfg.w_scale == jcfg.w_scale == 16.0
  assert dataclasses.asdict(tcfg.scoordnet) == dataclasses.asdict(
      jcfg.scoordnet)
  assert dataclasses.asdict(tcfg.oflownet) == dataclasses.asdict(
      jcfg.oflownet)
  for f in ("chi2_threshold", "invalid_cov", "adaptive_alpha_max"):
    assert getattr(tcfg, f) == getattr(jcfg, f), f
  meta = tckpt.load_meta(os.path.join(tpre.FULL_ASSETS, STAGE))
  assert meta["full_size"] and meta["params_dtype"] == "bfloat16"
  assert (int(meta["height"]), int(meta["width"])) == (480, 640)
  leaves = L.tree_leaves(tparams)
  assert all(p.dtype == torch.float32 for p in leaves)
  assert all(p.device.type == "cpu" for p in leaves)
  want = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
  for (path, g), (_, w) in zip(_leaves(tparams), _leaves(want)):
    assert torch.equal(g, w), path


def test_full_export_of_another_geometry_is_refused(tmp_path):
  """The full stage with one leaf of another width (SCoordNet's head fed
  by 256 channels, not 512): the tree matches, the shapes do not, and the
  loader says so."""
  params = tckpt.load_params_values(os.path.join(tpre.FULL_ASSETS, STAGE))
  head = params["scoordnet"][-1]
  head["w"] = np.zeros((1, 1, 256) + head["w"].shape[3:], np.float32)
  meta = tckpt.load_meta(os.path.join(tpre.FULL_ASSETS, STAGE))
  tckpt.save_params(str(tmp_path / STAGE), params, meta)
  with pytest.raises(ValueError, match="wrong-geometry"):
    tpre.load(str(tmp_path), scene="sceneA", device="cpu")


def test_run_filter_float32_matches_jax(jax_full, port_full):
  """Both nets in float32 in both packages, 3 frames of sceneA's held-out
  trajectory at 96x128 (a frame size the full nets accept)."""
  jcfg, jparams = jax_full
  tcfg, tparams = port_full
  f32 = lambda c: dataclasses.replace(
      c, scoordnet=dataclasses.replace(c.scoordnet, compute_dtype="float32"),
      oflownet=dataclasses.replace(c.oflownet, compute_dtype="float32"))
  jcfg, tcfg = f32(jcfg), f32(tcfg)
  data = jsyn.make_sequence(3, height=96, width=128, seed=0, traj_seed=99,
                            duration=3 / 48.0)
  images = np.asarray(data["images"])
  jxs, jPs, _ = jax.jit(lambda p, im: jseq.run_filter(p, jcfg, im))(
      jparams, jnp.asarray(images))
  txs, tPs, _ = tseq.run_filter(tparams, tcfg, images)
  assert txs.shape == (3, 12, 16, 3)
  np.testing.assert_allclose(txs.numpy(), np.asarray(jxs), **TOL)
  np.testing.assert_allclose(tPs.numpy(), np.asarray(jPs), **TOL)
