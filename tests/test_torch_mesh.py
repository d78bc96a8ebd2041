"""The port's device mesh (kfnet_tpu_torch/parallel/mesh.py) and what runs
over it: run_filter_fleet, FleetRelocalizer(mesh=), fit(mesh=) and the
train scripts, on an 8-entry CPU mesh (``Mesh(["cpu"] * 8)``, the
counterpart of the JAX package's virtual 8-device CPU mesh of
tests/conftest.py), against the JAX package on that mesh and against the
port on one device: the cases of tests/test_sharding.py, of
tests/test_online.py's mesh fleet, of tests/test_train.py's K = 2 under
the mesh and of tests/test_train_cli.py's multi-scene data-parallel run.

Tolerances: the DP step against the single-device step loss rtol 1e-5,
params atol 1e-5 (tests/test_sharding.py); the fleet against the
single-device batch x atol 2e-5, P atol 1e-5 (the same file); the port
against the JAX package at the goldens' rtol 5e-4 / atol 5e-5, as
tests/test_torch_train.py and tests/test_torch_fleet.py hold them (and
gradients at tests/test_torch_train.py's rtol 2e-3, atol 1e-5 plus 5e-4
of the leaf's largest |value|); the
mesh fleet's poses against the one-device fleet's at the DLT parity
test's atol 1e-3 (tests/test_torch_fleet.py), its filter state at the
fleet test's slot tolerance rtol 1e-5 / atol 2e-5.
"""

import dataclasses
import inspect
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfnet_tpu.filter import sequence as jseq
from kfnet_tpu.models import kfnet as jkfnet
from kfnet_tpu.models import scoordnet as jscoord
from kfnet_tpu.parallel import mesh as jmesh
from kfnet_tpu.train import objectives as jobj
from kfnet_tpu.train import trainer as jtrainer
from kfnet_tpu_torch import convert
from kfnet_tpu_torch.eval.online import FleetRelocalizer
from kfnet_tpu_torch.filter import sequence as tseq
from kfnet_tpu_torch.models import scoordnet as tscoord
from kfnet_tpu_torch.nn import layers as L
from kfnet_tpu_torch.parallel import mesh as tmesh
from kfnet_tpu_torch.pose import ransac as transac
from kfnet_tpu_torch.train import objectives as tobj
from kfnet_tpu_torch.train import trainer as ttrainer
from kfnet_tpu_torch.utils import logging as tlog
from tests import tiny_configs as tc
from tests.test_torch_models import port_config
from tests.test_train import synth_batch

GOLDEN = dict(rtol=5e-4, atol=5e-5)
SLOT = dict(rtol=1e-5, atol=2e-5)
GRAD_RTOL, GRAD_ATOL, GRAD_LEAF = 2e-3, 1e-5, 5e-4
K = np.asarray([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)
RCFG = transac.RansacConfig(num_hypotheses=16, top_k=32)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mesh():
  return tmesh.Mesh(["cpu"] * 8)


@pytest.fixture(scope="module")
def jax_mesh():
  assert len(jax.devices()) >= 8, "conftest must fake 8 CPU devices"
  return jmesh.make_mesh(8)


class Recorder(tlog.MetricLogger):
  def __init__(self):
    super().__init__(stream=open(os.devnull, "w"))
    self.rows = []

  def log_metrics(self, step, metrics):
    self.rows.append(dict(metrics))


def host(batch):
  return {k: np.asarray(v) for k, v in batch.items()}


def to_port(tree):
  return convert.params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


@pytest.fixture(scope="module")
def kfnet_setup():
  jcfg = tc.tiny_kfnet()
  jparams = jkfnet.init(jax.random.key(7), jcfg, tc.IMG)
  return jcfg, jparams, port_config(jcfg), to_port(jparams)


def test_batch_shards_over_mesh(mesh):
  sharded = tmesh.shard_batch(mesh, host(synth_batch(n=8)))
  img = sharded["image"]
  assert len(img.shards) == 8
  assert all(s.shape[0] == 1 for s in img.shards)
  assert [d.type for d in img.devices] == ["cpu"] * 8
  assert all(s.device == d for s, d in zip(img.shards, img.devices))
  assert img.shape == (8,) + tc.IMG
  assert torch.equal(tmesh.entry_batch(sharded, 3)["image"][0],
                     torch.tensor(host(synth_batch(n=8))["image"][3]))
  with pytest.raises(ValueError, match="divisible"):
    tmesh.shard_batch(mesh, host(synth_batch(n=4)))


def test_replicate_tree_copies_per_entry(mesh):
  params = {"w": torch.ones(3), "b": [torch.zeros(2)]}
  reps = tmesh.replicate_tree(mesh, params)
  assert len(reps) == 8
  assert len({r["w"].data_ptr() for r in reps}) == 8
  assert all(torch.equal(r["b"][0], params["b"][0]) for r in reps)


def test_replica_tree_is_not_named_as_the_jax_sharding():
  """JAX's replicated(mesh) returns a sharding; the port's helper that
  joins per-entry copies has a name of its own, so no caller of the JAX
  signature reaches it."""
  assert hasattr(jmesh, "replicated")
  assert not hasattr(tmesh, "replicated")
  devices = [torch.device("cpu")] * 2
  tree = tmesh.replica_tree([{"w": [torch.ones(2)]}, {"w": [torch.zeros(2)]}],
                            devices)
  leaf = tree["w"][0]
  assert isinstance(leaf, tmesh.Replicated) and leaf.devices == devices
  assert [c.tolist() for c in leaf.copies] == [[1.0, 1.0], [0.0, 0.0]]


def sc_setup(seed):
  cfg = tc.tiny_scoordnet()
  jparams = jscoord.init(jax.random.key(seed), cfg, tc.IMG)
  tcfg = tscoord.SCoordNetConfig(**dataclasses.asdict(cfg))
  return cfg, jparams, tcfg, to_port(jparams)


def test_dp_train_step_matches_single_device_and_jax(mesh, jax_mesh):
  """One step, batch 8 over 8 entries, against the port's single-device
  step and against the JAX package's step on its 8-device mesh."""
  cfg, jparams, tcfg, params = sc_setup(0)
  batch = host(synth_batch(n=8, seed=1))
  loss_fn = tobj.scoordnet_objective(tcfg)
  opt = ttrainer.make_optimizer(ttrainer.OptimizerConfig())
  s0 = ttrainer.create_state(ttrainer.clone_params(params, "cpu"), opt)
  s0, m0 = ttrainer.make_train_step(loss_fn, opt)(
      s0, ttrainer.to_device(batch, "cpu"))
  s1 = ttrainer.create_state(ttrainer.clone_params(params, "cpu"), opt)
  reps = [s1.params] + tmesh.replicate_tree(tmesh.Mesh(["cpu"] * 7),
                                            s1.params)
  step = ttrainer.make_dp_train_step(loss_fn, opt, mesh, reps)
  s1, m1 = step(s1, [tmesh.entry_batch(tmesh.shard_batch(mesh, batch), i)
                     for i in range(8)])
  np.testing.assert_allclose(float(m1["loss"]), float(m0["loss"]),
                             rtol=1e-5)
  np.testing.assert_allclose(float(m1["grad_norm"]), float(m0["grad_norm"]),
                             rtol=1e-5)
  for a, b in zip(L.tree_leaves(s0.params), L.tree_leaves(s1.params)):
    np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-5)
  for rep in reps[1:]:  # every replica holds the updated params
    assert all(torch.equal(a, b) for a, b in zip(L.tree_leaves(rep),
                                                 L.tree_leaves(s1.params)))
  jopt = jtrainer.make_optimizer(jtrainer.OptimizerConfig())
  jstate = jmesh.replicate_tree(jax_mesh, jtrainer.create_state(
      jax.tree_util.tree_map(lambda x: jnp.array(x, copy=True), jparams),
      jopt))
  _, jm = jtrainer.make_train_step(jobj.scoordnet_objective(cfg), jopt)(
      jstate, jmesh.shard_batch(jax_mesh, synth_batch(n=8, seed=1)))
  np.testing.assert_allclose(float(m1["loss"]), float(jm["loss"]), **GOLDEN)
  np.testing.assert_allclose(float(m1["grad_norm"]), float(jm["grad_norm"]),
                             **GOLDEN)


def fed_grads(loss_fn, params, batch, mesh):
  """The metrics of one fit step, and the grads the optimizer is given."""
  update, fed, rec = ttrainer.Adam.update, [], Recorder()

  def recording(self, grads, state, p):
    fed.append([g.clone() for g in grads])
    return update(self, grads, state, p)

  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(ttrainer.Adam, "update", recording)
    ttrainer.fit(loss_fn, params, iter([batch]),
                 loop_cfg=ttrainer.TrainLoopConfig(max_steps=1, log_every=1),
                 mesh=mesh, logger=rec,
                 device="cpu" if mesh is None else None)
  return rec.rows[0], fed[0]


def drop_valid(valid, fracs, seed):
  """A different share of each row's valid pixels dropped."""
  rng = np.random.default_rng(seed)
  out = valid.copy()
  for i, f in enumerate(fracs):
    out[i] &= rng.uniform(size=out[i].shape) >= f
  return out


@pytest.mark.parametrize("stage", ["scoordnet", "oflownet"])
def test_dp_pools_masked_means_over_the_batch(mesh, kfnet_setup, stage):
  """Stages 1 and 2 pool the batch into one masked mean: with valid counts
  that differ from shard to shard (and, in stage 2, the warp's mask),
  the DP step's loss, metrics and gradient are the whole batch's, not a
  mean of shard means."""
  _, _, cfg, params = kfnet_setup
  batch = host(synth_batch(n=8, seed=3, pairs=True))
  fracs = (0.0, 0.6, 0.1, 0.3, 0.0, 0.8, 0.2, 0.5)
  batch["valid"] = drop_valid(batch["valid"], fracs, 1)
  batch["valid_prev"] = drop_valid(batch["valid_prev"], fracs[::-1], 2)
  if stage == "scoordnet":
    loss_fn = tobj.scoordnet_objective(cfg.scoordnet)
    batch = {k: batch[k] for k in ("image", "coords", "valid")}
  else:
    loss_fn = tobj.oflownet_objective(cfg.oflownet, flow_reg_weight=0.01)
  (m0, g0), (m1, g1) = (fed_grads(loss_fn, params[stage], batch, m)
                        for m in (None, mesh))
  assert set(m0) == set(m1)
  for k in set(m0) - {"steps_per_sec"}:
    np.testing.assert_allclose(m1[k], m0[k], rtol=1e-5, err_msg=k)
  for a, b in zip(g0, g1):
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL + GRAD_LEAF * a.abs().max())


def test_dp_step_refuses_a_loss_that_hides_its_pooling(mesh):
  """A wrapped loss (here a lambda) does not say how it pools the batch:
  the data-parallel step raises instead of guessing."""
  _, _, tcfg, params = sc_setup(0)
  loss_fn = tobj.scoordnet_objective(tcfg)
  opt = ttrainer.make_optimizer(ttrainer.OptimizerConfig())
  with pytest.raises(ValueError, match="forward and loss_of"):
    ttrainer.make_dp_train_step(lambda p, b: loss_fn(p, b), opt, mesh,
                                [params] * 8)


def test_dp_multi_step_loss_decreases(mesh):
  _, _, tcfg, params = sc_setup(1)
  batch = host(synth_batch(n=8, seed=2))
  loss_fn = tobj.scoordnet_objective(tcfg)
  l0, _ = loss_fn(params, ttrainer.to_device(batch, "cpu"))
  state = ttrainer.fit(
      loss_fn, params, iter([batch] * 15),
      optimizer_cfg=ttrainer.OptimizerConfig(learning_rate=3e-3),
      loop_cfg=ttrainer.TrainLoopConfig(max_steps=15, log_every=1000),
      mesh=mesh)
  assert state.step == 15
  l1, _ = loss_fn(state.params, ttrainer.to_device(batch, "cpu"))
  assert float(l1) < float(l0)


def test_fit_multi_step_dispatch_dp_mesh(mesh):
  """K = 2 under the mesh (tests/test_train.py's case): stacked (K, B, ...)
  batches split on the batch axis; exactly 4 steps, and the same params
  as K = 1 under the mesh (the same steps)."""
  _, _, tcfg, params = sc_setup(3)
  batch = host(synth_batch(n=8, seed=5))
  loss_fn = tobj.scoordnet_objective(tcfg)
  states = [ttrainer.fit(loss_fn, params, iter([batch] * 4),
                         loop_cfg=ttrainer.TrainLoopConfig(
                             max_steps=4, log_every=1000,
                             steps_per_dispatch=k), mesh=mesh)
            for k in (2, 1)]
  assert [s.step for s in states] == [4, 4]
  assert states[0].opt_state.count == 4
  for a, b in zip(*(L.tree_leaves(s.params) for s in states)):
    assert torch.equal(a, b)
  loss, _ = loss_fn(states[0].params, ttrainer.to_device(batch, "cpu"))
  assert np.isfinite(float(loss))


def test_window_objective_under_the_mesh(kfnet_setup):
  """One step of the stage-3 window objective (fused kernel's path, T = 3,
  batch 4) over a 4-entry mesh against one device: per-sequence means,
  so the mean over equal shards is the batch's. Held: the loss and the
  grad norm (rtol 1e-5) and the gradient the optimizer is given, at
  tests/test_torch_train.py's gradient tolerance (the params after Adam's
  first step are not: it turns a near-zero gradient's sign into a full
  step)."""
  _, _, cfg, params = kfnet_setup
  seqs = [tc.random_images(3, seed=40 + b) for b in range(4)]
  rng = np.random.default_rng(0)
  batch = {"images": np.stack([np.asarray(s) for s in seqs]),
           "coords": rng.normal(size=(4, 3, 6, 8, 3)).astype(np.float32),
           "valid": rng.uniform(size=(4, 3, 6, 8)) > 0.2}
  loss_fn = tobj.kfnet_window_objective(cfg)
  runs = [fed_grads(loss_fn, params, batch, m)
          for m in (None, tmesh.Mesh(["cpu"] * 4))]
  (m0, g0), (m1, g1) = runs
  np.testing.assert_allclose(m1["loss"], m0["loss"], rtol=1e-5)
  np.testing.assert_allclose(m1["grad_norm"], m0["grad_norm"], rtol=1e-5)
  for a, b in zip(g0, g1):
    np.testing.assert_allclose(b.numpy(), a.numpy(), rtol=GRAD_RTOL,
                               atol=GRAD_ATOL + GRAD_LEAF * a.abs().max())


def test_fleet_filter_matches_single_device_and_jax(mesh, jax_mesh,
                                                    kfnet_setup):
  jcfg, jparams, cfg, params = kfnet_setup
  streams = [tc.random_images(4, seed=20 + b) for b in range(8)]
  batch = np.asarray(jnp.stack(streams, axis=1))  # (T, B=8, H, W, 3)
  xs0, Ps0 = tseq.run_filter_batched(params, cfg, batch, device="cpu")
  xs1, Ps1 = tseq.run_filter_fleet(params, cfg, batch, mesh)
  # each stream lives on exactly one entry; no cross-stream collectives
  assert len(xs1.shards) == 8
  assert all(s.shape[1] == 1 for s in xs1.shards)
  assert all(s.device == d for s, d in zip(xs1.shards, xs1.devices))
  np.testing.assert_allclose(xs1.full().numpy(), xs0.numpy(), atol=2e-5)
  np.testing.assert_allclose(Ps1.full().numpy(), Ps0.numpy(), atol=1e-5)
  jxs, jPs = jseq.run_filter_fleet(jparams, jcfg, jnp.asarray(batch),
                                   jax_mesh)
  np.testing.assert_allclose(xs1.full().numpy(), np.asarray(jxs), **GOLDEN)
  np.testing.assert_allclose(Ps1.full().numpy(), np.asarray(jPs), **GOLDEN)


def test_fleet_repeat_call_places_and_captures_nothing_again(kfnet_setup):
  """A repeat call finds the params placed: no copy, the cache hit."""
  _, _, cfg, params = kfnet_setup
  mesh2 = tmesh.Mesh(["cpu"] * 2)
  batch = np.stack([np.asarray(tc.random_images(2, seed=b))
                    for b in range(2)], axis=1)
  cache = tseq._fleet_params
  a = tseq.run_filter_fleet(params, cfg, batch, mesh2)
  copies, hits = cache.copies, cache.hits
  b = tseq.run_filter_fleet(params, cfg, batch, mesh2)
  assert cache.copies == copies and cache.hits == hits + 2
  assert torch.equal(a[0].full(), b[0].full())


def test_fleet_filter_rejects_indivisible_batch(mesh, kfnet_setup):
  _, _, cfg, params = kfnet_setup
  batch = np.stack([np.asarray(tc.random_images(3, seed=1))] * 3, axis=1)
  with pytest.raises(ValueError, match="divisible"):
    tseq.run_filter_fleet(params, cfg, batch, mesh)
  with pytest.raises(ValueError, match="divisible"):
    FleetRelocalizer(params, cfg, K, batch_size=3, mesh=mesh)


def test_make_mesh_validates_device_count(monkeypatch):
  """0 must not silently mean 'all devices'; too many must say why."""
  with pytest.raises(ValueError, match="need 1"):
    tmesh.make_mesh(0)
  with pytest.raises(ValueError, match="visible devices"):
    tmesh.make_mesh(torch.cuda.device_count() + 1)
  monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
  m = tmesh.make_mesh()
  assert m.devices == tuple(torch.device("cuda", i) for i in range(4))
  assert m.axis_name == "data" and m.size == 4
  with pytest.raises(ValueError, match="need 1..4"):
    tmesh.make_mesh(-1)


def test_default_mesh_over_the_gpus_that_divide_the_batch(monkeypatch):
  monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
  assert tmesh.default_mesh(8).size == 4
  assert tmesh.default_mesh(6).size == 3
  assert tmesh.default_mesh(7) is None
  assert tmesh.default_mesh(8, "cuda:0") is None
  assert tmesh.default_mesh(8, "cpu") is None
  assert ttrainer.default_mesh is tmesh.default_mesh


def test_axis_name_defaults_to_data(mesh, kfnet_setup):
  for fn in (FleetRelocalizer.__init__, tseq.run_filter_fleet,
             tmesh.shard_batch, tmesh.Mesh.__init__):
    assert inspect.signature(fn).parameters["axis_name"].default == "data"
  _, _, cfg, params = kfnet_setup
  with pytest.raises(ValueError, match="axis"):
    FleetRelocalizer(params, cfg, K, batch_size=8, mesh=mesh,
                     axis_name="model")


@pytest.mark.parametrize("depth", [0, 1])
def test_fleet_relocalizer_on_the_mesh(mesh, kfnet_setup, depth):
  """8 slots over 8 entries (tests/test_online.py's mesh fleet), slot 2
  restarting at tick 2: poses finite and equal to the one-device fleet's
  (the hypotheses drawn once for all slots), states equal, each slot's
  state on its entry's device."""
  _, _, cfg, params = kfnet_setup
  ticks = np.stack([np.asarray(tc.random_images(4, seed=60 + b))
                    for b in range(8)], axis=1)  # (T, B, H, W, 3)
  one = FleetRelocalizer(params, cfg, K, batch_size=8, ransac_config=RCFG,
                         device="cpu")
  split = FleetRelocalizer(params, cfg, K, batch_size=8, ransac_config=RCFG,
                           mesh=mesh, pipeline_depth=depth)
  outs = []
  for t in range(4):
    reset = np.arange(8) == 2 if t == 2 else None
    want = one.process(ticks[t], reset=reset)
    outs.append((want, split.process(ticks[t], reset=reset)))
    for got, ref in zip(split.state, one.state):
      assert len(got.shards) == 8
      assert all(s.device == d and s.shape[0] == 1
                 for s, d in zip(got.shards, got.devices))
      np.testing.assert_allclose(got.full().numpy(), ref.numpy(), **SLOT)
  got_outs = [o for _, o in outs if not o[1].get("pending")]
  got_outs += split.flush()
  assert len(got_outs) == 4
  for (want, _), got in zip(outs, got_outs):
    assert got[1]["tick"] == want[1]["tick"]
    assert np.isfinite(got[0]).all() and got[0].shape == (8, 4, 4)
    np.testing.assert_allclose(got[0], want[0], atol=1e-3)
    np.testing.assert_allclose(got[1]["consistent_frac"],
                               want[1]["consistent_frac"], atol=1e-6)
  assert got_outs[2][1]["consistent_frac"][2] == 0.0


def test_train_cli_multiscene_dp(monkeypatch, tmp_path):
  """tests/test_train_cli.py's multi-scene data-parallel case: batch 8
  split over an 8-entry mesh (``default_mesh`` returns it, as it would
  with eight visible GPUs), two scenes, two steps; the same step count
  through train_scoordnet and train_kfnet (ten frames a scene: a batch
  of 8 needs as many frames, or windows, in the scene)."""
  from kfnet_tpu_torch.data import fixture
  from kfnet_tpu_torch.train import train_kfnet, train_oflownet
  from kfnet_tpu_torch.train import train_scoordnet
  root, models = str(tmp_path / "data"), str(tmp_path / "models")
  fixture.write_seven_scenes_fixture(root, scenes=("chess", "fire"),
                                     train_frames=10, test_frames=2,
                                     height=48, width=64, device="cpu")
  seen = []

  def eight_entries(batch_size, device):
    seen.append(batch_size)
    return tmesh.Mesh(["cpu"] * 8)

  monkeypatch.setattr(ttrainer, "default_mesh", eight_entries)
  common = ["--input_folder", root, "--model_folder", models,
            "--net_scale", "tiny", "--batch_size", "8", "--max_steps", "2",
            "--device", "cpu"]
  states = [train_oflownet.main(common + ["--scenes", "chess,fire"]),
            train_scoordnet.main(common + ["--scene", "chess"]),
            train_kfnet.main(common + [
                "--scene", "chess", "--window_size", "3",
                "--scoordnet_ckpt", f"{models}/scoordnet_chess",
                "--oflownet_ckpt", f"{models}/oflownet_7scenes"])]
  assert seen == [8, 8, 8]
  for s in states:
    assert s.step == 2 and s.opt_state.count == 2
    assert all(torch.isfinite(p).all() for p in L.tree_leaves(s.params))
