"""The port's training (kfnet_tpu_torch/train/, utils/checkpoint.py's
Checkpointer, utils/logging.py, tools/demo.py) against the JAX package's on
the CPU, on the tiny configs of tests/tiny_configs.py (float32, 48x64).

The same numpy inputs (a synthetic sequence rendered by the JAX package,
its labels, and per-sequence validity drops drawn with numpy) and the same
JAX-initialised weights (convert.params_from_jax) go through both. The JAX
objectives run with use_pallas=False, their differentiable composition; the
port's with the fused kernel's path on (on the CPU its plain version) and
off. JAX's results are computed once per module (module-scoped fixtures).

Tolerances: losses and metrics at the goldens' rtol 5e-4 / atol 5e-5
(tests/test_goldens.py:61); gradients at tests/test_train.py:101-104's
rtol 2e-3 and an atol of 1e-5 plus 5e-4 of the leaf's largest |value|.
That atol is wider than the JAX test's 1e-5, which holds one framework
against itself: here XLA and ATen sum each weight's gradient, thousands
of float32 terms, in other orders, and where the terms cancel to near
zero the difference is a fraction of the terms' scale, not of the result
(measured: up to 1.24e-4 of the leaf's largest value, 1.4e-5 absolute on
an element of 5e-4); the optimizer against optax on fed gradients at
rtol 1e-5 (the same float32 arithmetic, fused and ordered otherwise); the
port's own forms against each other exactly where they do the same
arithmetic (K steps a call against one, a resumed run against an
uninterrupted one, the card's route of the fused step on the CPU).
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from kfnet_tpu.data import labels as jlabels
from kfnet_tpu.data import synthetic as jsynth
from kfnet_tpu.models import kfnet as jkfnet
from kfnet_tpu.train import device_fit as jdevice_fit
from kfnet_tpu.train import objectives as jobj
from kfnet_tpu.train import trainer as jtrainer
from kfnet_tpu.utils import logging as jlog
from kfnet_tpu_torch import convert
from kfnet_tpu_torch.kernels import fused_filter as tff
from kfnet_tpu_torch.models import oflownet as toflow
from kfnet_tpu_torch.models import scoordnet as tscoord
from kfnet_tpu_torch.nn import layers as L
from kfnet_tpu_torch.train import device_fit as tdevice_fit
from kfnet_tpu_torch.train import objectives as tobj
from kfnet_tpu_torch.train import trainer as ttrainer
from kfnet_tpu_torch.utils import checkpoint as tckpt
from kfnet_tpu_torch.utils import logging as tlog
from tests import tiny_configs as tc
from tests.test_torch_models import port_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GOLDEN = dict(rtol=5e-4, atol=5e-5)
GRAD_RTOL, GRAD_ATOL, GRAD_LEAF = 2e-3, 1e-5, 5e-4
T_WIN, B_WIN = 4, 2


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
  """Small tensors on one thread (the suite runs in several processes)."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def seq():
  """Six 48x64 frames of the synthetic scene with their labels (numpy)."""
  s = jsynth.make_sequence(6, height=48, width=64, seed=7)
  coords, valid = jax.vmap(
      lambda d, T: jlabels.generate(d, s["K"], T, stride=8))(
          s["depths"], s["poses"])
  return {"images": np.asarray(s["images"]), "coords": np.asarray(coords),
          "valid": np.asarray(valid)}


def drop_valid(valid, fracs, seed):
  """Drop a fraction of each row's valid pixels, a different one a row,
  so that the rows' valid counts differ."""
  rng = np.random.default_rng(seed)
  out = valid.copy()
  for i, f in enumerate(fracs):
    out[i] &= rng.uniform(size=out[i].shape) >= f
  return out


def sc_batch(seq):
  return {"image": seq["images"][:4], "coords": seq["coords"][:4],
          "valid": drop_valid(seq["valid"][:4], (0.0, 0.3, 0.6, 0.1), 1)}


def pair_batch(seq):
  return {"image_prev": seq["images"][:4], "image": seq["images"][1:5],
          "coords_prev": seq["coords"][:4], "coords": seq["coords"][1:5],
          "valid_prev": drop_valid(seq["valid"][:4], (0.2, 0.0, 0.5, 0.0), 2),
          "valid": drop_valid(seq["valid"][1:5], (0.0, 0.4, 0.0, 0.3), 3)}


def window_batch(seq):
  """B_WIN windows of T_WIN frames (frames 0-3 and 2-5), valid counts
  that differ per sequence."""
  rows = [np.arange(T_WIN), np.arange(2, 2 + T_WIN)]
  valid = np.stack([drop_valid(seq["valid"][r], [f] * T_WIN, 4 + i)
                    for i, (r, f) in enumerate(zip(rows, (0.0, 0.5)))])
  return {"images": np.stack([seq["images"][r] for r in rows]),
          "coords": np.stack([seq["coords"][r] for r in rows]),
          "valid": valid}


def t(batch):
  return {k: torch.from_numpy(np.array(v)) for k, v in batch.items()}


@functools.lru_cache(maxsize=None)
def jax_kfnet_params():
  # jitted: op by op, the draws take several times as long
  return jax.jit(lambda key: jkfnet.init(key, tc.tiny_kfnet(), tc.IMG))(
      jax.random.key(2))


def jax_params(net):
  """The JAX-initialised weights of the tiny KFNet, or of one subnet."""
  jp = jax_kfnet_params()
  return jp if net == "kfnet" else jp[net]


def port_params(net):
  return convert.params_from_jax(
      jax.tree_util.tree_map(np.asarray, jax_params(net)))


def jax_value_and_grad(loss_fn, params, batch):
  (loss, metrics), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(
      params, {k: jnp.asarray(v) for k, v in batch.items()})
  return (float(loss), {k: float(v) for k, v in metrics.items()},
          convert.params_from_jax(jax.tree_util.tree_map(np.asarray, grads)))


def port_value_and_grad(loss_fn, params, batch):
  loss, metrics, grads = ttrainer.value_and_grad(loss_fn, params, t(batch))
  by_leaf = dict(zip(map(id, L.tree_leaves(params)), grads))
  return (loss.item(), {k: v.item() for k, v in metrics.items()},
          L.tree_map(lambda p: by_leaf[id(p)], params))


def assert_matches(got, want):
  (l, m, g), (jl, jm, jg) = got, want
  np.testing.assert_allclose(l, jl, **GOLDEN)
  assert sorted(m) == sorted(jm)
  for k in jm:
    np.testing.assert_allclose(m[k], jm[k], err_msg=k, **GOLDEN)
  gl, jgl = L.tree_leaves(g), L.tree_leaves(jg)
  assert len(gl) == len(jgl)
  for i, (a, b) in enumerate(zip(gl, jgl)):
    atol = GRAD_ATOL + GRAD_LEAF * b.abs().max().item()
    np.testing.assert_allclose(a.numpy(), b.numpy(), err_msg=f"leaf {i}",
                               rtol=GRAD_RTOL, atol=atol)
  assert sum(float(torch.sum(a * a)) for a in gl) > 0


# --------------------------------------------------------------- objectives


@pytest.fixture(scope="module")
def jax_results(seq):
  """Every objective's (loss, metrics, grads) on the JAX side, once."""
  jcfg = tc.tiny_kfnet()  # use_pallas=False: the composition
  out = {
      "scoordnet": jax_value_and_grad(
          jobj.scoordnet_objective(jcfg.scoordnet),
          jax_params("scoordnet"), sc_batch(seq)),
      "window": jax_value_and_grad(
          jobj.kfnet_window_objective(jcfg), jax_params("kfnet"),
          window_batch(seq)),
      "pairs": jax_value_and_grad(
          jobj.kfnet_objective(jcfg), jax_params("kfnet"),
          {k: v for k, v in pair_batch(seq).items()
           if k not in ("coords_prev", "valid_prev")}),
  }
  out["oflownet"] = jax_value_and_grad(
      jobj.oflownet_objective(jcfg.oflownet, flow_reg_weight=0.01),
      jax_params("oflownet"), pair_batch(seq))
  return out


def test_scoordnet_objective_matches_jax(seq, jax_results):
  cfg = tscoord.SCoordNetConfig(**dataclasses.asdict(tc.tiny_scoordnet()))
  got = port_value_and_grad(tobj.scoordnet_objective(cfg),
                            port_params("scoordnet"), sc_batch(seq))
  assert_matches(got, jax_results["scoordnet"])


def test_oflownet_objective_matches_jax(seq, jax_results):
  cfg = toflow.OFlowNetConfig(**dataclasses.asdict(tc.tiny_oflownet()))
  got = port_value_and_grad(
      tobj.oflownet_objective(cfg, flow_reg_weight=0.01),
      port_params("oflownet"), pair_batch(seq))
  assert_matches(got, jax_results["oflownet"])
  assert 0.0 < got[1]["supervised_frac"] < 1.0


def test_oflownet_smoothness_is_along_width_and_height():
  """The flow regulariser differences NHWC flow along W (dim -2) and H (dim
  -3): a flow that changes only along W by 1 a column costs exactly the
  weight times its mean |dx| (1) plus 0 along H."""
  of = tobj.oflownet_objective(
      toflow.OFlowNetConfig(**dataclasses.asdict(tc.tiny_oflownet())),
      flow_reg_weight=0.5)
  h, w = 6, 8
  ramp = torch.arange(w, dtype=torch.float32)[None, None, :, None].expand(
      1, h, w, 2)
  zero = torch.zeros(1, h, w, 3)
  batch = {"image_prev": torch.zeros(1, 48, 64, 3),
           "image": torch.zeros(1, 48, 64, 3), "coords_prev": zero,
           "coords": zero, "valid_prev": torch.zeros(1, h, w, dtype=bool),
           "valid": torch.zeros(1, h, w, dtype=bool)}
  with pytest.MonkeyPatch.context() as mp:
    mp.setattr(toflow, "apply", lambda *a: (ramp, torch.ones(1, h, w, 1)))
    loss, _ = of(None, batch)
  assert loss.item() == pytest.approx(0.5 * 1.0)


def card_route(monkeypatch, launches):
  """The fused step as the card runs it, on the CPU: through the
  ``FusedFilterStep`` autograd node (its backward: autograd through the
  plain version) with the launch replaced by the plain version; each
  'launch' counted."""

  def launch(*a):
    launches.append(1)
    return tff.fused_filter_step_reference(*a)

  def step(fh, ch, x, P, **kw):
    args = (kw["radius"], kw["w_scale"], kw["coord_scale"],
            kw["coord_offset"], kw["log_w_clip"], kw["log_v_clip"],
            kw["threshold"], kw["invalid_cov"])
    if tff._wants_grad((fh, ch, x, P)):
      return tff.FusedFilterStep.apply(fh, ch, x, P, *args)
    return launch(fh, ch, x, P, *args)

  monkeypatch.setattr(tff, "_launch_step", launch)
  monkeypatch.setattr(tff, "fused_filter_step", step)


@pytest.mark.parametrize("fused,remat", [(True, False), (False, False),
                                         (True, True), (False, True)],
                         ids=["kernel", "composition", "kernel_remat",
                              "composition_remat"])
def test_window_objective_matches_jax(seq, jax_results, fused, remat):
  cfg = port_config(tc.tiny_kfnet(), use_fused_kernel=fused)
  got = port_value_and_grad(tobj.kfnet_window_objective(cfg, remat=remat),
                            port_params("kfnet"), window_batch(seq))
  assert_matches(got, jax_results["window"])


@pytest.mark.parametrize("remat", [False, True], ids=["bptt", "bptt_remat"])
def test_window_objective_through_the_cards_autograd_node(
    seq, monkeypatch, remat):
  """BPTT through FusedFilterStep, as on the card: the same loss and grads
  as the plain path, bit for bit (its backward is autograd through the
  same plain version); one launch a filter step, two under remat (the
  recompute runs the step's forward again; the backward launches
  nothing)."""
  cfg = port_config(tc.tiny_kfnet(), use_fused_kernel=True)
  params, batch = port_params("kfnet"), window_batch(seq)
  loss_fn = tobj.kfnet_window_objective(cfg, remat=remat)
  plain = port_value_and_grad(loss_fn, params, batch)
  launches = []
  card_route(monkeypatch, launches)
  got = port_value_and_grad(loss_fn, params, batch)
  assert len(launches) == (T_WIN - 1) * (2 if remat else 1)
  assert got[0] == plain[0]
  for a, b in zip(L.tree_leaves(got[2]), L.tree_leaves(plain[2])):
    torch.testing.assert_close(a, b, rtol=0, atol=0)


def test_pair_objective_matches_jax(seq, jax_results):
  cfg = port_config(tc.tiny_kfnet(), use_fused_kernel=False)
  batch = {k: v for k, v in pair_batch(seq).items()
           if k not in ("coords_prev", "valid_prev")}
  got = port_value_and_grad(tobj.kfnet_objective(cfg),
                            port_params("kfnet"), batch)
  assert_matches(got, jax_results["pairs"])
  assert 0.0 < got[1]["consistent_frac"] <= 1.0


def test_pair_objective_refuses_the_fused_kernel():
  with pytest.raises(ValueError, match="use_fused_kernel=False"):
    tobj.kfnet_objective(port_config(tc.tiny_kfnet(), use_fused_kernel=True))


@pytest.mark.parametrize("impl", ["pallas_3x3", "pallas_fused"])
def test_conv_kernel_configs_refuse_training(impl):
  cfg = port_config(tc.tiny_kfnet(), use_fused_kernel=False)
  cfg = dataclasses.replace(
      cfg, scoordnet=dataclasses.replace(cfg.scoordnet, conv_impl=impl))
  for make in (lambda: tobj.scoordnet_objective(cfg.scoordnet),
               lambda: tobj.kfnet_window_objective(cfg),
               lambda: tobj.kfnet_objective(cfg)):
    with pytest.raises(ValueError, match="no backward"):
      make()
  if impl == "pallas_3x3":
    of = dataclasses.replace(cfg.oflownet, conv_impl=impl)
    with pytest.raises(ValueError, match="no backward"):
      tobj.oflownet_objective(of)


def test_training_dynamics_pin_the_paper_filter():
  cfg = port_config(tc.tiny_kfnet(), use_fused_kernel=True)
  cfg = dataclasses.replace(cfg, chi2_threshold=2.0, w_scale=16.0,
                            adaptive_alpha_max=3.0)
  d = tobj._training_dynamics(cfg)
  assert (d.chi2_threshold, d.w_scale, d.adaptive_alpha_max) == (
      7.814728, 1.0, 0.0)
  assert d.use_fused_kernel


# ---------------------------------------------------------------- optimizer


def test_adam_matches_optax_on_fed_grads():
  """Six updates of optax's chain and the port's Adam from the same params
  and grads: a step whose global norm triggers the clip (step 2) and a
  staircase boundary every two updates."""
  rng = np.random.default_rng(0)
  shapes = {"a": [(3, 4), (5,)], "b": {"c": (2, 3, 3, 1)}}
  params = jax.tree_util.tree_map(
      lambda s: rng.normal(size=s).astype(np.float32), shapes,
      is_leaf=lambda s: isinstance(s, tuple))
  scales = [0.1, 0.5, 10.0, 0.2, 1e-4, 0.3]
  grads = [jax.tree_util.tree_map(
      lambda p, s=s: (rng.normal(size=p.shape) * s).astype(np.float32),
      params) for s in scales]
  norms = [float(optax.global_norm(g)) for g in grads]
  assert norms[2] > 5.0 and all(n < 5.0 for i, n in enumerate(norms)
                                if i != 2)
  cfg = dict(learning_rate=1e-2, decay_steps=2, decay_rate=0.5)
  jopt = jtrainer.make_optimizer(jtrainer.OptimizerConfig(**cfg))
  jstate = jopt.init(params)
  jp = params
  topt = ttrainer.make_optimizer(ttrainer.OptimizerConfig(**cfg))
  tp = L.tree_map(lambda a: torch.from_numpy(a.copy()), params)
  tstate = topt.init(tp)
  for g in grads:
    updates, jstate = jopt.update(g, jstate, jp)
    jp = optax.apply_updates(jp, updates)
    tg = L.tree_leaves(L.tree_map(lambda a: torch.from_numpy(a.copy()), g))
    topt.update(tg, tstate, tp)
  adam = jstate[1][0]
  assert tstate.count == int(adam.count) == 6
  for got, want in ((tp, jp), (tstate.mu, adam.mu), (tstate.nu, adam.nu)):
    for a, b in zip(L.tree_leaves(got), jax.tree_util.tree_leaves(want)):
      np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5,
                                 atol=0)


def test_learning_rate_is_optax_exponential_decay():
  for staircase in (True, False):
    cfg = ttrainer.OptimizerConfig(learning_rate=3e-4, decay_rate=0.5,
                                   decay_steps=3, staircase=staircase)
    sched = optax.exponential_decay(3e-4, 3, 0.5, staircase=staircase)
    opt = ttrainer.make_optimizer(cfg)
    got = [opt.learning_rate(k) for k in range(8)]
    want = [float(sched(k)) for k in range(8)]
    if staircase:  # integer powers: exact
      assert got == want
    else:  # float32 pow in numpy and in XLA: one ulp apart
      np.testing.assert_allclose(got, want, rtol=1e-6)


def test_clip_passes_below_and_scales_at_the_norm():
  for scale, want in ((1.0, 1.0), (5.0, 1.0), (10.0, 0.5)):
    g = [torch.full((4,), 0.5 * scale), torch.full((1,), 0.0)]
    # norm of [0.5·s]*4 is s
    ttrainer.clip_by_global_norm(g, 5.0)
    np.testing.assert_allclose(g[0].numpy(), 0.5 * scale * want, rtol=1e-7)


# -------------------------------------------------------------------- fit


class Recorder(tlog.MetricLogger):
  def __init__(self):
    super().__init__(stream=open(os.devnull, "w"))
    self.rows = []

  def log_metrics(self, step, metrics):
    self.rows.append((step, dict(metrics)))


class JRecorder(jlog.MetricLogger):
  def __init__(self):
    super().__init__(stream=open(os.devnull, "w"))
    self.rows = []

  def log_metrics(self, step, metrics):
    self.rows.append((step, dict(metrics)))


def sc_batches(seq, n):
  """n batches of two frames, cycling through the sequence."""
  return [{"image": seq["images"][[i % 6, (i + 3) % 6]],
           "coords": seq["coords"][[i % 6, (i + 3) % 6]],
           "valid": seq["valid"][[i % 6, (i + 3) % 6]]} for i in range(n)]


def sc_loss():
  return tobj.scoordnet_objective(
      tscoord.SCoordNetConfig(**dataclasses.asdict(tc.tiny_scoordnet())))


def port_fit(seq, n, **loop):
  rec = Recorder()
  state = ttrainer.fit(sc_loss(), port_params("scoordnet"),
                       iter(sc_batches(seq, n)),
                       ttrainer.OptimizerConfig(learning_rate=1e-3),
                       ttrainer.TrainLoopConfig(**loop), logger=rec,
                       device="cpu")
  return state, rec


def assert_same_state(a, b):
  assert a.step == b.step and a.opt_state.count == b.opt_state.count
  for x, y in zip(L.tree_leaves([a.params, a.opt_state.mu, a.opt_state.nu]),
                  L.tree_leaves([b.params, b.opt_state.mu, b.opt_state.nu])):
    assert torch.equal(x, y)


def test_fit_losses_match_jax_fit(seq):
  """Six steps on the same batches: the logged losses at the loss
  tolerance (params are not compared: Adam turns near-zero grad noise
  into full steps; the update is held on fed grads above)."""
  jrec = JRecorder()
  jtrainer.fit(jobj.scoordnet_objective(tc.tiny_scoordnet()),
               jax_params("scoordnet"), iter(sc_batches(seq, 6)),
               jtrainer.OptimizerConfig(learning_rate=1e-3),
               jtrainer.TrainLoopConfig(max_steps=6, log_every=1),
               logger=jrec)
  state, rec = port_fit(seq, 6, max_steps=6, log_every=1)
  assert state.step == 6
  assert [s for s, _ in rec.rows] == [s for s, _ in jrec.rows] == [
      1, 2, 3, 4, 5, 6]
  np.testing.assert_allclose([m["loss"] for _, m in rec.rows],
                             [m["loss"] for _, m in jrec.rows], **GOLDEN)
  assert rec.rows[-1][1]["loss"] < rec.rows[0][1]["loss"]


def test_fit_k_steps_a_call_equals_one(seq):
  s1, r1 = port_fit(seq, 6, max_steps=6, log_every=3)
  s3, r3 = port_fit(seq, 6, max_steps=6, log_every=3, steps_per_dispatch=3)
  assert_same_state(s1, s3)
  assert [s for s, _ in r3.rows] == [3, 6]
  assert r3.rows[-1][1]["loss"] == r1.rows[-1][1]["loss"]


@pytest.mark.parametrize("unroll", [1, 2, 3])
def test_multi_train_step_unroll_is_the_same_steps(seq, unroll):
  """``unroll`` (the JAX package's scan unroll) changes nothing in the
  eager loop: K = 3 steps equal three single steps at any unroll."""
  opt = ttrainer.make_optimizer(ttrainer.OptimizerConfig(learning_rate=1e-3))
  batches = [ttrainer.to_device(b, "cpu") for b in sc_batches(seq, 3)]
  one = ttrainer.create_state(port_params("scoordnet"), opt)
  step = ttrainer.make_train_step(sc_loss(), opt)
  for b in batches:
    one, m1 = step(one, b)
  multi = ttrainer.create_state(port_params("scoordnet"), opt)
  multi, m3 = ttrainer.make_multi_train_step(sc_loss(), opt, unroll=unroll)(
      multi, ttrainer._stack(batches))
  assert_same_state(one, multi)
  assert torch.equal(m1["loss"], m3["loss"])


@pytest.mark.parametrize("unroll", [0, -1])
def test_multi_train_step_refuses_a_non_positive_unroll(unroll):
  opt = ttrainer.make_optimizer(ttrainer.OptimizerConfig())
  with pytest.raises(ValueError, match="unroll"):
    ttrainer.make_multi_train_step(sc_loss(), opt, unroll=unroll)


def test_fit_max_steps_exact_and_tail_trained(seq):
  s, _ = port_fit(seq, 10, max_steps=6, log_every=1000,
                  steps_per_dispatch=4)
  assert s.step == 6
  s1, _ = port_fit(seq, 6, max_steps=6, log_every=1000)
  assert_same_state(s, s1)
  # a finite stream shorter than max_steps, not a multiple of K: the
  # tail group is trained
  s2, _ = port_fit(seq, 5, max_steps=100, log_every=1000,
                   steps_per_dispatch=4)
  s5, _ = port_fit(seq, 5, max_steps=100, log_every=1000)
  assert s2.step == 5
  assert_same_state(s2, s5)


def test_fit_logs_and_saves_on_window_crossings(seq, tmp_path):
  # K = 2 over 7 steps: dispatches end at 2, 4, 6, 7
  _, rec = port_fit(seq, 7, max_steps=7, log_every=3, steps_per_dispatch=2,
                    checkpoint_every=5, checkpoint_dir=str(tmp_path))
  assert [s for s, _ in rec.rows] == [4, 6]
  assert tckpt.Checkpointer(str(tmp_path)).all_steps() == [6, 7]


def test_fit_resume_equals_uninterrupted(seq, tmp_path):
  whole, _ = port_fit(seq, 6, max_steps=6, log_every=1000)
  ck = str(tmp_path / "ck")
  first, _ = port_fit(seq, 3, max_steps=3, log_every=1000,
                      checkpoint_every=3, checkpoint_dir=ck)
  assert first.step == 3
  # the resumed run is fed only the three missing batches: a restart from
  # scratch would end at step 3
  rec = Recorder()
  resumed = ttrainer.fit(sc_loss(), port_params("scoordnet"),
                         iter(sc_batches(seq, 6)[3:]),
                         ttrainer.OptimizerConfig(learning_rate=1e-3),
                         ttrainer.TrainLoopConfig(
                             max_steps=6, log_every=1000, checkpoint_every=3,
                             checkpoint_dir=ck),
                         logger=rec, device="cpu")
  assert_same_state(resumed, whole)
  assert tckpt.Checkpointer(ck).all_steps() == [3, 6]


def test_fit_leaves_the_callers_params_alone(seq):
  params = port_params("scoordnet")
  before = [p.clone() for p in L.tree_leaves(params)]
  state = ttrainer.fit(sc_loss(), params, iter(sc_batches(seq, 2)),
                       loop_cfg=ttrainer.TrainLoopConfig(max_steps=2),
                       logger=Recorder(), device="cpu")
  for p, b, q in zip(L.tree_leaves(params), before,
                     L.tree_leaves(state.params)):
    assert torch.equal(p, b) and not p.requires_grad
    assert p.data_ptr() != q.data_ptr()
  assert not all(torch.equal(p, q) for p, q in
                 zip(L.tree_leaves(params), L.tree_leaves(state.params)))


def test_fit_on_a_mesh_is_not_ported(seq):
  """fit(mesh=) is ported now (its cases: tests/test_torch_mesh.py): on a
  2-entry CPU mesh it takes its steps, its state on the first entry; a
  batch the mesh does not divide raises."""
  from kfnet_tpu_torch.parallel import mesh as tmesh
  mesh = tmesh.Mesh(["cpu"] * 2)
  state = ttrainer.fit(sc_loss(), port_params("scoordnet"),
                       iter(sc_batches(seq, 2)),
                       loop_cfg=ttrainer.TrainLoopConfig(max_steps=2),
                       mesh=mesh, logger=Recorder())
  assert state.step == state.opt_state.count == 2
  assert all(p.device.type == "cpu" for p in L.tree_leaves(state.params))
  with pytest.raises(ValueError, match="divisible"):
    ttrainer.fit(sc_loss(), port_params("scoordnet"),
                 iter(sc_batches(seq, 1)), mesh=tmesh.Mesh(["cpu"] * 3),
                 logger=Recorder())


def test_entry_points_default_to_cuda(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError, match="device='cpu'"):
    ttrainer.fit(sc_loss(), {}, iter([]))
  with pytest.raises(RuntimeError, match="device='cpu'"):
    tdevice_fit.fit_on_device(sc_loss(), {}, {"x": np.zeros(2)}, 1, 1e-3)


# ------------------------------------------------------- checkpoint, logger


def test_checkpointer_keeps_restores_and_refuses(tmp_path):
  p = {"a": [torch.arange(6.0).reshape(2, 3)], "b": {"c": torch.ones(2)}}
  opt = ttrainer.make_optimizer(ttrainer.OptimizerConfig())
  ck = tckpt.Checkpointer(str(tmp_path), max_to_keep=2)
  assert ck.latest_step() is None and ck.restore_latest(None) is None
  for step in (1, 2, 3):
    state = ttrainer.create_state(L.tree_map(lambda x: x * step, p), opt)
    state.step = step
    state.opt_state.count = 10 * step
    ck.save(step, state)
  ck.save(3, ttrainer.create_state(p, opt))  # an existing step: kept
  assert ck.all_steps() == [2, 3] and ck.latest_step() == 3
  template = ttrainer.create_state(L.tree_map(torch.zeros_like, p), opt)
  got = ck.restore_latest(template)
  assert got.step == 3 and got.opt_state.count == 30
  assert torch.equal(got.params["a"][0], p["a"][0] * 3)
  assert got.params["a"][0].dtype == torch.float32
  assert ck.restore(2, template).step == 2
  bad = ttrainer.create_state({"a": [torch.zeros(2, 3)]}, opt)
  with pytest.raises(ValueError, match="keys"):
    ck.restore(3, bad)
  bad = ttrainer.create_state({"a": [torch.zeros(3, 2)], "b": {
      "c": torch.ones(2)}}, opt)
  with pytest.raises(ValueError, match="shape"):
    ck.restore(3, bad)


def test_export_params_reads_back_through_the_bridge(tmp_path):
  params = port_params("kfnet")
  tckpt.export_params(str(tmp_path), params, meta={"height": 48})
  back = convert.params_from_jax(tckpt.load_params_values(str(tmp_path)))
  for a, b in zip(L.tree_leaves(back), L.tree_leaves(params)):
    assert torch.equal(a, b)
  assert tckpt.load_meta(str(tmp_path)) == {"height": 48}
  want = jax.tree_util.tree_leaves(jax_params("kfnet"))
  got = jax.tree_util.tree_leaves(tckpt.load_params_values(str(tmp_path)))
  for a, b in zip(got, want):
    np.testing.assert_array_equal(a, np.asarray(b))


def test_metric_logger_coerces_scalars_as_jax(tmp_path):
  import io
  metrics = {"loss": torch.tensor(1.5), "np": np.float32(2.0), "i": 3,
             "arr": torch.ones(3), "none": None, "text": "4.0",
             "one": torch.ones(1)}
  jsonl = tmp_path / "m.jsonl"
  out = io.StringIO()
  tlog.MetricLogger(jsonl_path=str(jsonl), stream=out).log_metrics(
      7, metrics)
  jout = io.StringIO()
  jlog.MetricLogger(stream=jout).log_metrics(
      7, {k: (np.asarray(v) if isinstance(v, torch.Tensor) else v)
          for k, v in metrics.items()})
  assert out.getvalue() == jout.getvalue() == (
      "[step 7] i=3 loss=1.5 np=2 one=1\n")
  rec = json.loads(jsonl.read_text())
  assert rec["step"] == 7 and rec["loss"] == 1.5 and "arr" not in rec


# ------------------------------------------------------------ fit_on_device


POWERS = 8.0 ** np.arange(8, dtype=np.float32)


def coded_loss(torch_side):
  """A loss whose value spells the gathered rows: Σ row·8^position, exact
  in float32 below 2^24; the log line shows it."""

  def loss_fn(params, batch):
    flat = batch["i"].reshape(-1)
    w = POWERS[:flat.shape[0]]
    code = (torch.sum(flat * torch.from_numpy(w)) if torch_side
            else jnp.sum(flat * jnp.asarray(w)))
    return params["w"] * code, {"loss": code}

  return loss_fn


@pytest.mark.parametrize("window,batch", [(0, 3), (3, 2)],
                         ids=["rows", "windows"])
def test_fit_on_device_draws_the_jax_rows(window, batch):
  data = {"i": np.arange(8, dtype=np.float32)}
  kw = dict(steps=5, lr=1e-3, batch=batch, chunk=1, seed=3, tag="t",
            window=window)
  jlog_lines, tlog_lines = [], []
  jdevice_fit.fit_on_device(coded_loss(False), {"w": jnp.ones(())}, data,
                            log=jlog_lines.append, **kw)
  state, m = tdevice_fit.fit_on_device(
      coded_loss(True), {"w": torch.ones(())}, data,
      log=tlog_lines.append, device="cpu", **kw)
  assert len(tlog_lines) == 5 and tlog_lines == jlog_lines
  assert state.step == 5


def test_fit_on_device_chunks_logs_and_refuses_long_windows(seq):
  cfg = port_config(tc.tiny_kfnet(), use_fused_kernel=True)
  loss_fn = tobj.kfnet_window_objective(cfg, remat=True)
  data = {"images": seq["images"], "coords": seq["coords"],
          "valid": seq["valid"]}
  lines = []
  state, m = tdevice_fit.fit_on_device(
      loss_fn, port_params("kfnet"), data, steps=3, lr=1e-3, batch=2,
      chunk=2, window=4, log=lines.append, tag="joint", device="cpu")
  assert state.step == 3 and np.isfinite(m["loss"].item())
  assert [ln.split(":")[0] for ln in lines] == ["joint step 2",
                                                "joint step 3"]
  assert np.isfinite(m["grad_norm"].item())
  with pytest.raises(ValueError, match="window"):
    tdevice_fit.fit_on_device(loss_fn, port_params("kfnet"), data,
                              steps=1, lr=1e-3, batch=1, window=7, log=None,
                              device="cpu")


def test_gather_takes_windows_without_building_them():
  data = {"x": torch.arange(10.0)[:, None] * torch.ones(1, 2)}
  idx = torch.tensor([[1, 2, 3], [5, 6, 7]])
  got = tdevice_fit.gather(data, idx)["x"]
  assert got.shape == (2, 3, 2)
  assert torch.equal(got[..., 0], idx.float())


# ------------------------------------------------------------------- demo


def json_objects(text):
  """The indented JSON objects a run printed, between its log lines."""
  out, block = [], None
  for line in text.splitlines():
    if line == "{":
      block = []
    if block is not None:
      block.append(line)
      if line == "}":
        out.append(json.loads("\n".join(block)))
        block = None
  return out


def test_demo_cli_on_the_cpu(tmp_path):
  """The demo end to end at 48x64 on the CPU: all three stages (stage 3 on
  3-frame windows), the two evaluation reports, the consistency report
  and the saved params, which read back through the bridge."""
  save = tmp_path / "params"
  cmd = [sys.executable, "-m", "kfnet_tpu_torch.tools.demo", "--device",
         "cpu", "--steps", "3", "--oflownet_steps", "2", "--joint_steps",
         "2", "--joint_window", "3", "--height", "48", "--width", "64",
         "--train_frames", "12", "--test_frames", "6", "--consistency",
         "--save", str(save)]
  res = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                       timeout=300, env=dict(os.environ,
                                             OMP_NUM_THREADS="2"))
  assert res.returncode == 0, res.stdout[-2000:] + res.stderr[-4000:]
  reports = json_objects(res.stdout)
  scenes = [r["scene"] for r in reports]
  assert scenes == ["synthetic(measurement-only)", "synthetic(filtered)",
                    "synthetic(consistency: chi2 reset on vs off)"]
  for r in reports[:2]:
    assert np.isfinite(r["median_translation_m"]) and r["valid_pixels"] > 0
  assert "scoordnet step 3" in res.stdout
  assert "joint-bptt step 2" in res.stdout
  assert tckpt.has_params(str(save))
