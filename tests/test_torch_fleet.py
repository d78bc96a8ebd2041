"""The port's FleetRelocalizer and OnlineRelocalizer(smoother=...) on the
CPU, at the tiny float32 config of tests/tiny_configs.py: the cases of
tests/test_online.py without the mesh (the mesh's are in
tests/test_torch_mesh.py), and the fleet against the JAX package's.

Tolerances: a fleet slot against a lone stream rtol 1e-5 / atol 2e-5 (as
tests/test_online.py: the batch sums its convs in another order); the
fleet's filter state against the JAX fleet's at the goldens' rtol 5e-4 /
atol 5e-5; the poses of both, solved from the same index sets, at the DLT
parity test's atol 1e-3; pipelined against sync and smoothed against
offline smoothing exactly as the JAX tests hold them (atol 1e-9).
"""

import dataclasses
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfnet_tpu.eval.online import FleetRelocalizer as JaxFleet
from kfnet_tpu.models import kfnet as jkfnet
from kfnet_tpu.pose import ransac as jransac
from kfnet_tpu_torch import convert
from kfnet_tpu_torch.core import geometry as tgeo
from kfnet_tpu_torch.eval.online import FleetRelocalizer, OnlineRelocalizer
from kfnet_tpu_torch.filter import sequence as tseq
from kfnet_tpu_torch.kernels import conv3x3 as tc3
from kfnet_tpu_torch.models import kfnet as tkfnet
from kfnet_tpu_torch.models import oflownet as toflow
from kfnet_tpu_torch.models import scoordnet as tscoord
from kfnet_tpu_torch.parallel import mesh as tmesh
from kfnet_tpu_torch.pose import ransac as transac
from kfnet_tpu_torch.pose import smoothing
from tests import tiny_configs as tc

K = np.asarray([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)
RCFG = transac.RansacConfig(num_hypotheses=16, top_k=32)
SLOT = dict(rtol=1e-5, atol=2e-5)
GOLDEN = dict(rtol=5e-4, atol=5e-5)


def port_config(jcfg, **kw):
  return tkfnet.KFNetConfig(
      scoordnet=tscoord.SCoordNetConfig(**dataclasses.asdict(jcfg.scoordnet)),
      oflownet=toflow.OFlowNetConfig(**dataclasses.asdict(jcfg.oflownet)),
      **kw)


@pytest.fixture(scope="module")
def setup():
  jcfg = tc.tiny_kfnet()
  jparams = jkfnet.init(jax.random.key(9), jcfg, tc.IMG)
  tparams = convert.params_from_jax(
      jax.tree_util.tree_map(np.asarray, jparams))
  return jcfg, jparams, port_config(jcfg), tparams


def streams(n, T, seed):
  return np.stack([np.asarray(tc.random_images(T, seed=seed + b))
                   for b in range(n)])  # (B, T, H, W, 3)


@pytest.mark.parametrize("use_fused_kernel", [True, False])
def test_fleet_matches_independent_streams(setup, use_fused_kernel):
  """B slots in lockstep track B lone streams, slot 2 restarting its
  session at frame 2 as a fresh stream from there."""
  _, _, cfg, params = setup
  cfg = dataclasses.replace(cfg, use_fused_kernel=use_fused_kernel)
  s = streams(3, 4, 30)
  fleet = FleetRelocalizer(params, cfg, K, batch_size=3, solve_pose=False,
                           device="cpu")
  lone = [OnlineRelocalizer(params, cfg, K, solve_pose=False, device="cpu")
          for _ in range(3)]
  for t in range(4):
    reset = np.array([False, False, t == 2])
    _, info = fleet.process(s[:, t], reset=reset)
    for b in range(3):
      if reset[b]:
        lone[b].reset()
      _, linfo = lone[b].process(s[b, t])
      for got, want in zip(fleet.state, lone[b].state):
        np.testing.assert_allclose(got[b].numpy(), want.numpy(), **SLOT)
      assert info["consistent_frac"][b] == pytest.approx(
          linfo["consistent_frac"], abs=1e-6)
  assert info["consistent_frac"].shape == (3,)
  # slot 2 is a fresh sequence from its frame 2
  xs, Ps, _ = tseq.run_filter(params, cfg, s[2, 2:])
  np.testing.assert_allclose(fleet.state[0][2].numpy(), xs[-1].numpy(), **SLOT)
  np.testing.assert_allclose(fleet.state[1][2].numpy(), Ps[-1].numpy(), **SLOT)


def test_reset_tick_reports_no_consistency(setup):
  _, _, cfg, params = setup
  s = streams(2, 3, 50)
  fleet = FleetRelocalizer(params, cfg, K, batch_size=2, solve_pose=False,
                           device="cpu")
  _, info = fleet.process(s[:, 0], reset=[True, True])  # first tick: ignored
  assert info["consistent_frac"].tolist() == [0.0, 0.0]
  fleet.process(s[:, 1])
  _, info = fleet.process(s[:, 2], reset=[True, False])
  assert info["consistent_frac"][0] == 0.0 and info["consistent_frac"][1] > 0
  with pytest.raises(ValueError, match="reset mask"):
    fleet.process(s[:, 2], reset=[True])
  with pytest.raises(ValueError, match="batch"):
    fleet.process(s[:1, 2])


def test_fleet_state_matches_jax_and_poses_through_indices(setup):
  jcfg, jparams, cfg, params = setup
  s = streams(2, 4, 40)
  jfleet = JaxFleet(jparams, jcfg, K, batch_size=2, solve_pose=False)
  fleet = FleetRelocalizer(params, cfg, K, batch_size=2, solve_pose=False,
                           device="cpu")
  for t in range(4):
    reset = np.array([t == 3, False])
    _, jinfo = jfleet.process(s[:, t], reset=reset)
    _, info = fleet.process(s[:, t], reset=reset)
    np.testing.assert_allclose(info["consistent_frac"],
                               jinfo["consistent_frac"], atol=1e-6)
    for got, want in zip(fleet.state, jfleet.state):
      np.testing.assert_allclose(got.numpy(), np.asarray(want), **GOLDEN)
  # the poses differ by the generators only: solve each slot's maps from
  # the same index sets
  grid = tgeo.cell_center_grid(6, 8, 8).reshape(-1, 2).numpy()
  x, P = fleet.state[:2]
  jx, jP = (np.asarray(a) for a in jfleet.state[:2])
  jcfg_r = jransac.RansacConfig(num_hypotheses=16, top_k=32)
  for b in range(2):
    key = jax.random.key(b)
    args = (grid, jx[b].reshape(-1, 3), jP[b].reshape(-1),
            np.ones(48, bool))
    want = jransac.solve_pnp_ransac(*(jnp.asarray(a) for a in args),
                                    jnp.asarray(K), key, jcfg_r)
    _, _, jw = jransac.select_confident(*(jnp.asarray(a) for a in args), 32)
    logits = jnp.where(jnp.any(jw > 0), jnp.where(jw > 0, 0.0, -jnp.inf),
                       jnp.zeros_like(jw))
    idx = jax.vmap(lambda k: jax.random.choice(
        k, 32, shape=(6,), replace=False, p=jax.nn.softmax(logits)))(
            jax.random.split(key, 16))
    uv, X, w = transac.select_confident(
        torch.from_numpy(grid), x[b].reshape(-1, 3), P[b].reshape(-1),
        torch.ones(48, dtype=torch.bool), 32)
    got = transac.solve_with_indices(uv, X, w, torch.from_numpy(K),
                                     torch.from_numpy(np.array(idx)).long(),
                                     RCFG)
    np.testing.assert_allclose(got["T_wc"].numpy(), np.asarray(want["T_wc"]),
                               atol=1e-3)


def test_packed_layout(setup):
  _, _, cfg, params = setup
  s = streams(2, 2, 60)
  a = FleetRelocalizer(params, cfg, K, batch_size=2, ransac_config=RCFG,
                       seed=3, device="cpu")
  b = FleetRelocalizer(params, cfg, K, batch_size=2, ransac_config=RCFG,
                       seed=3, device="cpu")
  for t in range(2):
    packed = a.tick(s[:, t]).numpy()
    poses, info = b.process(s[:, t])
    assert packed.shape == (2, 19) and packed.dtype == np.float32
    np.testing.assert_array_equal(packed[:, 0], info["consistent_frac"])
    np.testing.assert_array_equal(packed[:, 1:17].reshape(2, 4, 4), poses)
    np.testing.assert_array_equal(packed[:, 17], info["num_inliers"])
    np.testing.assert_array_equal(packed[:, 18], info["inlier_ratio"])
    np.testing.assert_array_equal(poses[:, 3], [[0, 0, 0, 1]] * 2)
  assert info["tick"] == 1
  assert FleetRelocalizer(params, cfg, K, batch_size=2, solve_pose=False,
                          device="cpu").tick(s[:, 0]).shape == (2, 1)


@pytest.mark.parametrize("depth", [1, 2])
def test_fleet_pipelined_matches_sync_shifted(setup, depth):
  """pipeline_depth=d: the same results a tick, d calls late; flush()
  drains the tail; reset() drops what is in flight."""
  _, _, cfg, params = setup
  s = streams(2, 5, 70)
  scfg = smoothing.SmootherConfig(beta=0.4)
  resets = [None, None, np.array([False, True]), None, None]

  def run(d):
    fleet = FleetRelocalizer(params, cfg, K, batch_size=2, seed=11,
                             ransac_config=RCFG, smoother=scfg,
                             pipeline_depth=d, device="cpu")
    out = []
    for t in range(5):
      poses, info = fleet.process(s[:, t], reset=resets[t])
      if poses is None:
        assert info["pending"] and info["lag"] == d and t < d
      else:
        out.append((info["tick"], poses, info))
    out += [(info["tick"], poses, info) for poses, info in fleet.flush()]
    return out

  sync_out, pipe_out = run(0), run(depth)
  assert len(sync_out) == len(pipe_out) == 5
  for (ts, ps, infs), (tp, pp, infp) in zip(sync_out, pipe_out):
    assert ts == tp
    np.testing.assert_allclose(pp, ps, atol=1e-9)
    np.testing.assert_allclose(infp["consistent_frac"],
                               infs["consistent_frac"], atol=1e-7)
  fleet = FleetRelocalizer(params, cfg, K, batch_size=2, seed=11,
                           ransac_config=RCFG, pipeline_depth=1,
                           device="cpu")
  poses, info = fleet.process(s[:, 0])
  assert poses is None and info["pending"]
  fleet.reset()
  assert fleet.flush() == []
  poses, info = fleet.process(s[:, 0])  # a fresh session refills
  assert poses is None and info["tick"] == 1


def test_fleet_smoother_per_slot_reset(setup):
  _, _, cfg, params = setup
  s = streams(2, 4, 60)
  scfg = smoothing.SmootherConfig(beta=0.4)

  def run(smoother):
    fleet = FleetRelocalizer(params, cfg, K, batch_size=2, seed=11,
                             ransac_config=RCFG, smoother=smoother,
                             device="cpu")
    return np.stack([fleet.process(s[:, t], reset=[False, t == 2])[0]
                     for t in range(4)])

  got, raw = run(scfg), run(None)
  np.testing.assert_allclose(
      got[:, 0], smoothing.smooth_trajectory(raw[:, 0], scfg), atol=1e-9)
  np.testing.assert_allclose(
      got[:, 1], smoothing.smooth_trajectory(
          raw[:, 1], scfg, reset=np.array([False, False, True, False])),
      atol=1e-9)


def test_online_smoother_and_reset(setup):
  _, _, cfg, params = setup
  imgs = np.asarray(tc.random_images(5, seed=8))
  scfg = smoothing.SmootherConfig(beta=0.4)
  raw = OnlineRelocalizer(params, cfg, K, ransac_config=RCFG, device="cpu")
  smo = OnlineRelocalizer(params, cfg, K, ransac_config=RCFG, device="cpu",
                          smoother=scfg)
  raw_poses = [raw.process(f)[0] for f in imgs]
  smo_poses = [smo.process(f)[0] for f in imgs]
  np.testing.assert_allclose(smo_poses[0], raw_poses[0], atol=1e-12)
  np.testing.assert_allclose(
      np.stack(smo_poses),
      smoothing.smooth_trajectory(np.stack(raw_poses), scfg), atol=1e-9)
  smo.reset()
  pose, info = smo.process(imgs[0])
  assert info["consistent_frac"] == 0.0 and pose.shape == (4, 4)
  assert smo._smoother._prev is not None and smo._smoother._prev2 is None


def test_mesh_and_bad_depth_raise(setup):
  """A mesh that does not divide the slots, a mesh beside a device and an
  axis the mesh does not name raise, as a bad pipeline depth does (the
  mesh itself is served: tests/test_torch_mesh.py)."""
  _, _, cfg, params = setup
  mesh = tmesh.Mesh(["cpu"] * 3)
  with pytest.raises(ValueError, match="divisible"):
    FleetRelocalizer(params, cfg, K, batch_size=2, mesh=mesh)
  with pytest.raises(ValueError, match="not both"):
    FleetRelocalizer(params, cfg, K, batch_size=3, mesh=mesh, device="cpu")
  with pytest.raises(ValueError, match="axis"):
    FleetRelocalizer(params, cfg, K, batch_size=3, mesh=mesh,
                     axis_name="model")
  with pytest.raises(ValueError, match="pipeline_depth"):
    FleetRelocalizer(params, cfg, K, batch_size=2, pipeline_depth=-1,
                     device="cpu")


def test_kernel_nets_run_frame_by_frame_on_a_batch():
  """With kernel convs a batched filter step runs each net frame by frame
  (the JAX package vmaps the step, and each frame takes the kernels): the
  same bits as one frame at a time, and kernel_shapes' calls times B."""
  cfg = tkfnet.KFNetConfig(
      scoordnet=tscoord.SCoordNetConfig(
          channels=(8, 16, 128, 128), strides=(2, 2, 2, 1),
          head_channels=128, stem_s2d=1, conv_impl="pallas_fused"),
      oflownet=toflow.OFlowNetConfig(
          encoder_channels=(8, 16, 128, 128), encoder_strides=(2, 2, 2, 1),
          search_radius=2, stem_s2d=1, conv_impl="pallas_3x3"))
  shape = (48, 80, 3)
  params = tkfnet.init(0, cfg, shape, device="cpu")
  frames = torch.from_numpy(np.random.default_rng(0).uniform(
      0, 1, (2, 2) + shape).astype(np.float32))
  first = tkfnet.kernel_shapes(cfg, shape, first=True)
  later = tkfnet.kernel_shapes(cfg, shape)
  assert len(later["conv3x3_gn_chain"]) == 2 and later["conv3x3_same"]

  def spies():
    return (mock.patch.object(tc3, "conv3x3_same", wraps=tc3.conv3x3_same),
            mock.patch.object(tc3, "conv3x3_gn_chain",
                              wraps=tc3.conv3x3_gn_chain))

  same, chain = spies()
  with same as s, chain as c:
    carry = tkfnet.first_step(params, cfg, frames[0])
    assert (s.call_count, c.call_count) == (
        2 * len(first["conv3x3_same"]), 2 * len(first["conv3x3_gn_chain"]))
    x1, P1, _, _ = tkfnet.filter_step(params, cfg, *carry, frames[1])
  assert s.call_count == 2 * (len(first["conv3x3_same"])
                              + len(later["conv3x3_same"]))
  assert c.call_count == 2 * (len(first["conv3x3_gn_chain"])
                              + len(later["conv3x3_gn_chain"]))
  for b in range(2):
    one = tkfnet.first_step(params, cfg, frames[0, b])
    for got, want in zip(carry, one):
      assert torch.equal(got[b], want)
    x, P, _, _ = tkfnet.filter_step(params, cfg, *one, frames[1, b])
    assert torch.equal(x1[b], x) and torch.equal(P1[b], P)


def test_batch_invariance_tool_on_the_cpu():
  from kfnet_tpu_torch.bench import tiny_config
  from kfnet_tpu_torch.tools import batch_invariance
  res = batch_invariance.run(3, "cpu", 48, 64, tiny_config())
  for key in ("bf16", "bf16_cudnn_deterministic", "float32"):
    r = res[key]
    # on the CPU every op of a batch gives slot 0 a lone frame's bits (on
    # the card GroupNorm's sums and cuDNN's convs do not)
    assert r["ops"] == r["ops_lone"] == r["ops_compared"] > 100, key
    assert r["slots_equal_each_other"] and r["first_differing_op"] is None
    assert r["z_max_abs_diff"] == 0.0 == r["V_max_rel_diff"], key
    assert set(r) >= {"first_differing_op", "differing_ops_by_name",
                      "z_max_abs_diff", "V_max_rel_diff"}
