"""The four full-size shipped stages in the port, read from the JAX
package's orbax releases under artifacts/ by the port's own reader
(tests/test_torch_ocdbt.py holds every leaf of them bit for bit against
the JAX loader's): ``pretrained.load`` of each against the JAX package's
(the spec of tests/test_pretrained_artifact.py:82-116: norm, the serving
w_scale 16 or 2, coordinate normalisation), and the float32 filter over
each.

Tolerances: the loaded config exactly; run_filter with both nets in
float32 at the goldens' rtol 5e-4 / atol 5e-5 (tests/test_goldens.py:61).
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


# the three other stages: (export root, scene) -> norm, serving w_scale
OTHERS = {("pretrained_full_nonorm", "sceneA"): ("none", 2.0),
          ("pretrained_full", "outdoor_train"): ("group", 16.0),
          ("pretrained_full_nonorm", "outdoor_train"): ("none", 2.0)}


@pytest.fixture(scope="module", params=sorted(OTHERS),
                ids=lambda k: f"{k[0]}-{k[1]}")
def other_stage(request):
  """JAX's config of the stage (pretrained.load's: the meta's nets and
  serving point) and its params cast to the float32 masters, as
  pretrained.load returns them, without the template's init; the port's
  pretrained.load."""
  from kfnet_tpu.models import kfnet as jkfnet
  name, scene = request.param
  root = os.path.join(ROOT, "artifacts", name)
  stage = os.path.join(root, f"stage3_{scene}")
  meta = jckpt.load_meta(stage)
  jcfg = jpre._apply_serving(jkfnet.KFNetConfig(
      scoordnet=jpre._scoordnet_config(meta),
      oflownet=jpre._oflownet_config(meta)), meta)
  jparams = jax.tree_util.tree_map(lambda x: jnp.asarray(x, jnp.float32),
                                   jckpt.load_params_values(stage))
  return (request.param, (jcfg, jparams),
          tpre.load(root, scene=scene, device="cpu"))


def test_other_stages_load_as_jax_does(other_stage):
  (name, scene), (jcfg, jparams), (tcfg, tparams) = other_stage
  norm, w_scale = OTHERS[(name, scene)]
  assert tcfg.scoordnet.norm == jcfg.scoordnet.norm == norm
  assert tcfg.w_scale == jcfg.w_scale == w_scale
  assert dataclasses.asdict(tcfg.scoordnet) == dataclasses.asdict(
      jcfg.scoordnet)
  assert dataclasses.asdict(tcfg.oflownet) == dataclasses.asdict(
      jcfg.oflownet)
  for f in ("chi2_threshold", "invalid_cov", "adaptive_alpha_max"):
    assert getattr(tcfg, f) == getattr(jcfg, f), f
  assert all(p.dtype == torch.float32 for p in L.tree_leaves(tparams))
  want = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jparams))
  for (path, g), (_, w) in zip(_leaves(tparams), _leaves(want)):
    assert torch.equal(g, w), path


def test_other_stages_run_filter_float32_matches_jax(other_stage):
  """Both nets in float32 in both packages, 3 frames of the stage's
  scene at 96x128 (its row of the protocol table, trajectory seed + 99)."""
  (name, scene), (jcfg, jparams), (tcfg, tparams) = other_stage
  f32 = lambda c: dataclasses.replace(
      c, scoordnet=dataclasses.replace(c.scoordnet, compute_dtype="float32"),
      oflownet=dataclasses.replace(c.oflownet, compute_dtype="float32"))
  jcfg, tcfg = f32(jcfg), f32(tcfg)
  from kfnet_tpu.tools import protocol as jprotocol
  spec = {s.name: s for s in jprotocol.DEFAULT_SCENES}[scene]
  data = jsyn.make_sequence(3, height=96, width=128, seed=spec.seed,
                            scale=spec.scale, traj_seed=spec.seed + 99,
                            duration=3 / 48.0)
  images = np.asarray(data["images"])
  jxs, jPs, _ = jax.jit(lambda p, im: jseq.run_filter(p, jcfg, im))(
      jparams, jnp.asarray(images))
  txs, tPs, _ = tseq.run_filter(tparams, tcfg, images)
  np.testing.assert_allclose(txs.numpy(), np.asarray(jxs), **TOL)
  np.testing.assert_allclose(tPs.numpy(), np.asarray(jPs), **TOL)

