"""The port's OnlineRelocalizer against the JAX package's, on the tiny
config over four frames with JAX-initialised, converted weights.

The carry (x, P, features) and consistent_frac must match the JAX
OnlineRelocalizer(solve_pose=False) at the goldens' tolerance (rtol 5e-4,
atol 5e-5). Without a device, on a host without CUDA, it must raise.
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kfnet_tpu.eval.online import OnlineRelocalizer as JaxRelocalizer
from kfnet_tpu.models import kfnet as jkfnet
from kfnet_tpu_torch import convert
from kfnet_tpu_torch.eval.online import OnlineRelocalizer
from kfnet_tpu_torch.models import kfnet as tkfnet
from kfnet_tpu_torch.models import oflownet as toflow
from kfnet_tpu_torch.models import scoordnet as tscoord
from kfnet_tpu_torch.pose import ransac
from tests import tiny_configs as tc

K = np.asarray([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)
TOL = dict(rtol=5e-4, atol=5e-5)


def port_config(jcfg, **kw):
  return tkfnet.KFNetConfig(
      scoordnet=tscoord.SCoordNetConfig(**dataclasses.asdict(jcfg.scoordnet)),
      oflownet=toflow.OFlowNetConfig(**dataclasses.asdict(jcfg.oflownet)),
      **kw)


@pytest.fixture(scope="module")
def setup():
  jcfg = tc.tiny_kfnet()
  jparams = jkfnet.init(jax.random.key(5), jcfg, tc.IMG)
  tparams = convert.params_from_jax(
      jax.tree_util.tree_map(np.asarray, jparams))
  return jcfg, jparams, tparams


@pytest.mark.parametrize("use_fused_kernel", [True, False])
@pytest.mark.parametrize("uint8", [False, True])
def test_carry_matches_jax(setup, use_fused_kernel, uint8):
  jcfg, jparams, tparams = setup
  imgs = np.asarray(tc.random_images(4, seed=6))
  if uint8:
    imgs = (imgs * 255).astype(np.uint8)
  want = JaxRelocalizer(jparams, jcfg, K, solve_pose=False)
  got = OnlineRelocalizer(tparams, port_config(
      jcfg, use_fused_kernel=use_fused_kernel), K, solve_pose=False,
                          device="cpu")
  for i in range(4):
    pose, info = got.process(imgs[i])
    _, jinfo = want.process(imgs[i])
    assert pose is None and info["frame"] == jinfo["frame"] == i
    np.testing.assert_allclose(info["consistent_frac"],
                               jinfo["consistent_frac"], atol=1e-6)
    for g, w in zip(got.state, want.state):
      np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)


def test_pose_solve_runs_and_reset(setup):
  jcfg, _, tparams = setup
  imgs = np.asarray(tc.random_images(2, seed=8))
  reloc = OnlineRelocalizer(
      tparams, port_config(jcfg), K, device="cpu",
      ransac_config=ransac.RansacConfig(num_hypotheses=16, top_k=32))
  pose, info = reloc.process(imgs[0])
  assert pose.shape == (4, 4) and np.isfinite(pose).all()
  np.testing.assert_allclose(pose[3], [0, 0, 0, 1])
  assert 0 <= info["inlier_ratio"] <= 1 and "num_inliers" in info
  packed = reloc.tick(imgs[1])
  assert packed.shape == (19,) and packed.dtype == torch.float32
  reloc.reset()
  _, info2 = reloc.process(imgs[1])
  assert info2["consistent_frac"] == 0.0  # measurement-only after reset


def test_raises_without_device_and_cuda(setup, monkeypatch):
  jcfg, _, tparams = setup
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    OnlineRelocalizer(tparams, port_config(jcfg), K)


def test_graph_needs_a_cuda_device(setup):
  # the CPU path is eager: graph=True on the CPU raises, the default is off
  jcfg, _, tparams = setup
  with pytest.raises(ValueError, match="CUDA"):
    OnlineRelocalizer(tparams, port_config(jcfg), K, device="cpu",
                      graph=True)
  reloc = OnlineRelocalizer(tparams, port_config(jcfg), K, device="cpu",
                            solve_pose=False)
  imgs = np.asarray(tc.random_images(2, seed=9))
  for img in imgs:
    reloc.process(img)
  assert reloc._graphs == {} and reloc.state[0].shape == (6, 8, 3)
