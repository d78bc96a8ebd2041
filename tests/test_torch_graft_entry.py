"""The port's root entry points (kfnet_tpu_torch/graft_entry.py) on the CPU,
against the root __graft_entry__.py.

entry(): its config, its frames (bit-equal to the JAX package's example
args) and its params' shapes; the full-size 480x640 step from the JAX
entry's params, converted, against the JAX package's step, both in
float32, at the goldens' rtol 5e-4 / atol 5e-5 (tests/test_goldens.py:61);
the bf16 step as entry() returns it finite; no CUDA and no device given
raises. dryrun_multichip(n): its three parts (the data-parallel joint
step, the width-sharded filter, the fleet) on a CPU mesh, and the same
parts fed the JAX package's params against its single-device train step's
loss and its unsharded run_filter per stream, at the goldens' tolerance;
the refusals.
"""

import dataclasses
import unittest.mock as mock

import jax
import numpy as np
import pytest
import torch

import __graft_entry__ as jentry
from kfnet_tpu.filter import sequence as jsequence
from kfnet_tpu.models import kfnet as jkfnet
from kfnet_tpu.models import oflownet as joflow
from kfnet_tpu.models import scoordnet as jscoord
from kfnet_tpu.train import objectives as jobjectives
from kfnet_tpu.train import trainer as jtrainer
from kfnet_tpu_torch import convert, graft_entry
from kfnet_tpu_torch.models import kfnet
from kfnet_tpu_torch.parallel import mesh as tmesh
from tests.test_torch_models import port_config

GOLDEN = dict(rtol=5e-4, atol=5e-5)
# the mesh of the dry-run parts held against JAX: its spatial frames are
# then as wide as its fleet's, so the JAX side compiles one init and one
# run_filter
N_PARTS = 4


def f32(cfg):
  """``cfg`` with both nets in float32."""
  return dataclasses.replace(
      cfg, scoordnet=dataclasses.replace(cfg.scoordnet,
                                         compute_dtype="float32"),
      oflownet=dataclasses.replace(cfg.oflownet, compute_dtype="float32"))


@pytest.fixture(scope="module")
def jax_entry():
  """The JAX entry's (params, img_prev, img_cur), numpy leaves."""
  _, args = jentry.entry()
  return jax.tree_util.tree_map(np.asarray, args)


@pytest.fixture(scope="module")
def port_entry():
  return graft_entry.entry(device="cpu")


def _shapes(tree):
  leaves, _ = jax.tree_util.tree_flatten_with_path(tree)
  return [(jax.tree_util.keystr(p), np.shape(v)) for p, v in leaves]


def test_entry_config_frames_and_param_shapes(jax_entry, port_entry):
  fn, (params, img_prev, img_cur) = port_entry
  assert fn.config == kfnet.KFNetConfig(use_fused_kernel=False)
  jparams, jprev, jcur = jax_entry
  for got, want in ((img_prev, jprev), (img_cur, jcur)):
    assert got.device.type == "cpu" and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
  assert _shapes(convert.params_to_jax(params)) == _shapes(jparams)


def test_entry_step_matches_jax_in_float32(jax_entry):
  """The full-size step from the JAX entry's params, both sides float32."""
  jparams, jprev, jcur = jax_entry
  jcfg = f32(jkfnet.KFNetConfig())

  def jstep(params, img_prev, img_cur):
    x0, P0, feat0 = jkfnet.first_step(params, jcfg, img_prev)
    x1, P1, _, aux = jkfnet.filter_step(params, jcfg, x0, P0, feat0, img_cur)
    return x1, P1, aux["flow"]

  want = jax.jit(jstep)(jparams, jprev, jcur)
  step = graft_entry.Step(f32(kfnet.KFNetConfig(use_fused_kernel=False)))
  got = step(convert.params_from_jax(jparams),
             *(torch.from_numpy(a.copy()) for a in (jprev, jcur)))
  for name, g, w in zip(("x1", "P1", "flow"), got, want):
    np.testing.assert_allclose(g.numpy(), np.asarray(w), err_msg=name,
                               **GOLDEN)


def test_entry_fn_as_returned_is_finite(port_entry):
  fn, args = port_entry
  x1, P1, flow = fn(*args)
  assert (x1.shape, P1.shape, flow.shape) == ((60, 80, 3), (60, 80, 1),
                                              (60, 80, 2))
  for t in (x1, P1, flow):
    assert t.dtype == torch.float32 and torch.isfinite(t).all()
    assert not t.requires_grad
  assert (P1 > 0).all()


def test_entry_without_cuda_raises():
  with mock.patch.object(torch.cuda, "is_available", return_value=False):
    with pytest.raises(RuntimeError, match="device='cpu'"):
      graft_entry.entry()


@pytest.mark.parametrize("n", [1, 8])
def test_dryrun_multichip_on_a_cpu_mesh(n):
  graft_entry.dryrun_multichip(n, device="cpu")


@pytest.fixture(scope="module")
def dryrun_against_jax():
  """The dry run's parts over a N_PARTS-entry CPU mesh from the JAX
  package's three param trees (converted), beside the JAX package's
  single-device answers on the same data."""
  n, img = N_PARTS, graft_entry.DRYRUN_IMAGE
  wimg = (img[0], 16 * n, 3)
  jcfg = jkfnet.KFNetConfig(
      scoordnet=jscoord.SCoordNetConfig(
          channels=(8, 8, 16, 16, 16, 16), strides=(1, 2, 1, 2, 1, 2),
          head_channels=16, compute_dtype="float32"),
      oflownet=joflow.OFlowNetConfig(
          encoder_channels=(8, 8, 16), encoder_strides=(2, 2, 2),
          search_radius=2, unet_channels=(8, 8, 16),
          compute_dtype="float32"))
  assert port_config(jcfg, use_fused_kernel=False) == \
      graft_entry.dryrun_config()
  init = jax.jit(jkfnet.init, static_argnums=(1, 2))
  jparams = [init(jax.random.key(s), jcfg, shape)
             for s, shape in ((0, img), (1, wimg), (2, img))]
  params = [convert.params_from_jax(jax.tree_util.tree_map(np.asarray, p))
            for p in jparams]
  got = graft_entry.dryrun_parts(tmesh.Mesh(["cpu"] * n), *params)

  # the same draws as the dry run's, in its order
  rng = np.random.default_rng(0)
  B = max(n, 2)
  batch = {"image_prev": rng.uniform(0, 1, (B,) + img).astype(np.float32),
           "image": rng.uniform(0, 1, (B,) + img).astype(np.float32),
           "coords": rng.normal(size=(B, 6, 8, 3)).astype(np.float32),
           "valid": np.ones((B, 6, 8), bool)}
  optimizer = jtrainer.make_optimizer(jtrainer.OptimizerConfig())
  step = jtrainer.make_train_step(jobjectives.kfnet_objective(jcfg),
                                  optimizer)
  _, metrics = step(jtrainer.create_state(jparams[0], optimizer), batch)
  run_filter = jax.jit(lambda p, frames: jsequence.run_filter(
      p, jcfg, frames)[:2])
  seq = rng.uniform(0, 1, (2,) + wimg).astype(np.float32)
  spatial = run_filter(jparams[1], seq)
  fleet = rng.uniform(0, 1, (2, n) + img).astype(np.float32)
  streams = [run_filter(jparams[2], fleet[:, b]) for b in range(n)]
  return got, float(metrics["loss"]), spatial, streams


def test_dryrun_train_step_matches_jax(dryrun_against_jax):
  (loss, steps, *_), want, _, _ = dryrun_against_jax
  assert steps == 1
  np.testing.assert_allclose(loss, want, **GOLDEN)


def test_dryrun_spatial_filter_matches_jax(dryrun_against_jax):
  (_, _, xs, Ps, _, _), _, (jxs, jPs), _ = dryrun_against_jax
  assert len(xs.shards) == len(Ps.shards) == N_PARTS
  np.testing.assert_allclose(xs.full().numpy(), np.asarray(jxs), **GOLDEN)
  np.testing.assert_allclose(Ps.full().numpy(), np.asarray(jPs), **GOLDEN)


def test_dryrun_fleet_matches_jax_per_stream(dryrun_against_jax):
  (*_, fxs, fPs), _, _, streams = dryrun_against_jax
  assert len(fxs.shards) == len(fPs.shards) == N_PARTS
  xs, Ps = fxs.full().numpy(), fPs.full().numpy()
  for b, (jx, jP) in enumerate(streams):
    np.testing.assert_allclose(xs[:, b], np.asarray(jx), err_msg=str(b),
                               **GOLDEN)
    np.testing.assert_allclose(Ps[:, b], np.asarray(jP), err_msg=str(b),
                               **GOLDEN)


def test_dryrun_parts_leave_the_params_unchanged():
  cfg = graft_entry.dryrun_config()
  img = graft_entry.DRYRUN_IMAGE
  trees = [kfnet.init(s, cfg, shape, "cpu")
           for s, shape in ((0, img), (1, (img[0], 32, 3)), (2, img))]
  before = [convert.params_to_jax(t) for t in trees]
  graft_entry.dryrun_parts(tmesh.Mesh(["cpu"] * 2), *trees)
  for tree, want in zip(trees, before):
    jax.tree_util.tree_map(np.testing.assert_array_equal,
                           convert.params_to_jax(tree), want)


def test_dryrun_refuses_fewer_than_one_entry():
  with pytest.raises(ValueError, match="n_devices >= 1"):
    graft_entry.dryrun_multichip(0, device="cpu")


def test_dryrun_without_cuda_raises():
  with mock.patch.object(torch.cuda, "is_available", return_value=False):
    with pytest.raises(RuntimeError, match="device='cpu'"):
      graft_entry.dryrun_multichip(2)


def test_dryrun_refuses_an_invisible_card():
  with mock.patch.object(torch.cuda, "device_count", return_value=1):
    with pytest.raises(RuntimeError, match="1 CUDA device"):
      graft_entry.dryrun_multichip(2, device="cuda:1")
