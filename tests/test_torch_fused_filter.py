"""The port's fused warp + Kalman step against the JAX package.

On the CPU ``fused_warp_kalman`` takes its plain PyTorch version, which is
held here against the Pallas kernel in interpret mode and against the XLA
composition warp_state_cov ∘ kalman_update, on the cases of
tests/test_pallas_fused.py plus the main path's 60x80 map at r=4 with the
serving gate. Tolerances are those of tests/test_pallas_fused.py: atol
2e-5 on x, rtol 2e-5 on P, the consistency mask equal. The CUDA kernel
itself is held against the plain version on the card
(tests/test_torch_cuda.py and chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfnet_tpu.core import kalman as jkalman
from kfnet_tpu.core import warp as jwarp
from kfnet_tpu.kernels import fused_filter as jff
from kfnet_tpu.models import oflownet as joflow
from kfnet_tpu.models import scoordnet as jscoord
from kfnet_tpu_torch.core import kalman as tkalman
from kfnet_tpu_torch.core import warp as twarp
from kfnet_tpu_torch.kernels import fused_filter as tff
from kfnet_tpu_torch.models import oflownet as toflow
from kfnet_tpu_torch.models import scoordnet as tscoord


def make_inputs(seed=0, h=12, w=16, r=3, oob=False):
  """The inputs of tests/test_pallas_fused.py, as numpy float32."""
  rng = np.random.default_rng(seed)
  x = rng.normal(size=(h, w, 3)).astype(np.float32)
  P = rng.uniform(0.05, 2.0, (h, w, 1)).astype(np.float32)
  if oob:
    flow = rng.uniform(-r, r, (h, w, 2)).astype(np.float32)
  else:
    flow = rng.uniform(-1.5, 1.5, (h, w, 2)).astype(np.float32)
  W = rng.uniform(0.01, 0.5, (h, w, 1)).astype(np.float32)
  z = x + rng.normal(size=(h, w, 3)).astype(np.float32) * 0.3
  V = rng.uniform(0.05, 2.0, (h, w, 1)).astype(np.float32)
  return x, P, flow, W, z, V


def _t(args):
  return [torch.from_numpy(a) for a in args]


def _assert_close(got, want, P_atol=1e-6):
  x_g, P_g, c_g = (np.asarray(a) for a in got)
  x_w, P_w, c_w = (np.asarray(a) for a in want)
  np.testing.assert_allclose(x_g, x_w, atol=2e-5)
  np.testing.assert_allclose(P_g, P_w, rtol=2e-5, atol=P_atol)
  np.testing.assert_array_equal(c_g, c_w)


CASES = [
    # seed, oob, h, w, radius, threshold
    (0, False, 12, 16, 3, jkalman.CHI2_3DOF_P05),
    (1, True, 12, 16, 3, jkalman.CHI2_3DOF_P05),
    (2, True, 17, 23, 3, jkalman.CHI2_3DOF_P05),  # odd, non-tile-aligned
    (5, True, 60, 80, 4, jkalman.CHI2_3DOF_P50),  # the main path's map
]


@pytest.mark.parametrize("seed,oob,h,w,r,thr", CASES)
def test_plain_matches_pallas_interpret(seed, oob, h, w, r, thr):
  args = make_inputs(seed=seed, oob=oob, h=h, w=w, r=r)
  want = jff.fused_warp_kalman(*(jnp.asarray(a) for a in args), radius=r,
                               threshold=thr, interpret=True)
  got = tff.fused_warp_kalman(*_t(args), radius=r, threshold=thr)
  _assert_close(got, want)


def test_radius_none_means_eight_as_in_jax():
  """``radius=None`` is the JAX package's default search radius, 8
  (kfnet_tpu/kernels/fused_filter.py:189,211): flows up to ±9 are clipped
  at 8 on both sides."""
  args = make_inputs(seed=3, h=12, w=16, r=9, oob=True)
  want = jff.fused_warp_kalman(*(jnp.asarray(a) for a in args),
                               interpret=True)
  got = tff.fused_warp_kalman(*_t(args))
  _assert_close(got, want)
  _assert_close(got, tff.fused_warp_kalman(*_t(args), radius=8))
  assert tff.DEFAULT_RADIUS == 8


@pytest.mark.parametrize("seed,oob,h,w,r,thr", CASES)
def test_plain_matches_xla_composition(seed, oob, h, w, r, thr):
  args = make_inputs(seed=seed, oob=oob, h=h, w=w, r=r)
  ja = [jnp.asarray(a) for a in args]
  x_pr, P_pr, _ = jwarp.warp_state_cov(ja[0], ja[1], ja[2], ja[3])
  want = jkalman.kalman_update(x_pr, P_pr, ja[4], ja[5], threshold=thr)
  got = tff.fused_warp_kalman_reference(*_t(args), radius=r, threshold=thr)
  _assert_close(got, want)


def test_zero_flow_reduces_to_plain_kalman():
  x, P, flow, W, z, V = _t(make_inputs(seed=3))
  got = tff.fused_warp_kalman(x, P, torch.zeros_like(flow), W, z, V,
                              radius=2)
  want = tkalman.kalman_update(x, P + W, z, V)
  _assert_close(got, want, P_atol=0.0)


def test_all_oob_collapses_to_measurement():
  x, P, flow, W, z, V = _t(make_inputs(seed=4))
  got = tff.fused_warp_kalman(x, P, torch.full_like(flow, 50.0), W, z, V,
                              radius=3)
  np.testing.assert_allclose(got[0].numpy(), z.numpy(), atol=1e-4)
  np.testing.assert_allclose(got[1].numpy(), V.numpy(), rtol=1e-4)


def test_validity_uses_raw_flow_sample_uses_clipped():
  # a flow beyond the radius: the Pallas kernel samples at the clipped
  # flow but judges validity on the raw one; so does the port
  args = list(make_inputs(seed=6, h=10, w=12))
  args[2] = (args[2] * 4.0).astype(np.float32)  # |flow| up to 6 > r = 2
  want = jff.fused_warp_kalman(*(jnp.asarray(a) for a in args), radius=2,
                               interpret=True)
  got = tff.fused_warp_kalman(*_t(args), radius=2)
  _assert_close(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_kalman_and_warp_match_jax(seed):
  x, P, flow, W, z, V = make_inputs(seed=seed, h=9, w=11, oob=True)
  want = jkalman.kalman_update(jnp.asarray(x), jnp.asarray(P),
                               jnp.asarray(z), jnp.asarray(V))
  got = tkalman.kalman_update(*_t([x, P, z, V]))
  _assert_close(got, want)
  wx, wP, wv = jwarp.warp_state_cov(*(jnp.asarray(a) for a in
                                      (x, P, flow, W)))
  gx, gP, gv = twarp.warp_state_cov(*_t([x, P, flow, W]))
  np.testing.assert_allclose(gx.numpy(), np.asarray(wx), atol=1e-6)
  np.testing.assert_allclose(gP.numpy(), np.asarray(wP), rtol=1e-6)
  np.testing.assert_array_equal(gv.numpy(), np.asarray(wv))
  np.testing.assert_allclose(
      tkalman.kalman_gain(*_t([P, V])).numpy(),
      np.asarray(jkalman.kalman_gain(jnp.asarray(P), jnp.asarray(V))),
      rtol=1e-6)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
  args = _t(make_inputs(seed=7))
  before = tff.fused_warp_kalman.launches
  got = tff.fused_warp_kalman(*args, radius=3)
  want = tff.fused_warp_kalman_reference(*args, radius=3)
  for g, w in zip(got, want):
    assert torch.equal(g, w)
  assert tff.fused_warp_kalman.launches == before
  assert got[2].dtype == torch.bool


def test_other_devices_raise():
  args = [a.to("meta") for a in _t(make_inputs(seed=8))]
  with pytest.raises(ValueError):
    tff.fused_warp_kalman(*args, radius=3)


# ---------------------------------------------------------------- gradients
# FusedWarpKalman is the autograd node the wrapper records on the card. Here
# the launch (``_launch``) is patched to the plain version, which has its
# signature, so the CPU drives the node's backward. Gradients are
# held at the golden tolerance (rtol 5e-4, atol 5e-5) against torch autograd
# through fused_warp_kalman_reference and against jax.grad through the
# Pallas kernel in interpret mode (its custom VJP). Flows stay within the
# radius, where clipping is the identity and the JAX VJP (on the raw flow)
# and the port's (on the clipped one) agree; the χ² gate is kept away from
# ties (checked).

GRAD_CASES = [
    # seed, oob, h, w, radius, threshold
    (10, False, 12, 16, 3, jkalman.CHI2_3DOF_P05),
    (11, True, 12, 16, 3, jkalman.CHI2_3DOF_P05),
    (12, True, 17, 23, 3, jkalman.CHI2_3DOF_P50),
]


def _gate_margin(args, r, thr):
  """Smallest |χ² - threshold| / threshold over the valid pixels."""
  x, P, flow, W, z, V = _t(args)
  x_pr, P_pr, valid = twarp.warp_state_cov(x, P, torch.clamp(flow, -r, r), W)
  chi2 = torch.sum(torch.square(z - x_pr), -1, keepdim=True) / (P_pr + V)
  return float(((chi2 - thr).abs() / thr)[valid].min())


def _loss_cotangents(seed, h, w):
  rng = np.random.default_rng(seed + 100)
  return (rng.normal(size=(h, w, 3)).astype(np.float32),
          rng.normal(size=(h, w, 1)).astype(np.float32))


def _torch_grads(fn, args, gx, gP):
  ts = [t.requires_grad_(True) for t in _t(args)]
  x, P, _ = fn(*ts)
  loss = torch.sum(x * torch.from_numpy(gx)) + torch.sum(
      P * torch.from_numpy(gP))
  return [g.numpy() for g in torch.autograd.grad(loss, ts)]


@pytest.mark.parametrize("seed,oob,h,w,r,thr", GRAD_CASES)
def test_autograd_function_grads_match_reference_and_jax(monkeypatch, seed,
                                                         oob, h, w, r, thr):
  import jax
  args = make_inputs(seed=seed, oob=oob, h=h, w=w, r=r)
  assert np.abs(args[2]).max() < r  # clipping is the identity
  assert _gate_margin(args, r, thr) > 1e-3
  gx, gP = _loss_cotangents(seed, h, w)

  monkeypatch.setattr(tff, "_launch", tff.fused_warp_kalman_reference)
  got = _torch_grads(
      lambda *t: tff.FusedWarpKalman.apply(*t, r, thr, 1e8), args, gx, gP)
  plain = _torch_grads(
      lambda *t: tff.fused_warp_kalman_reference(*t, radius=r, threshold=thr),
      args, gx, gP)

  def jloss(*a):
    x, P, _ = jff.fused_warp_kalman(*a, radius=r, threshold=thr,
                                    interpret=True)
    return jnp.sum(x * gx) + jnp.sum(P * gP)

  want = jax.grad(jloss, argnums=tuple(range(6)))(
      *(jnp.asarray(a) for a in args))
  names = ("x_prev", "P_prev", "flow", "W", "z", "V")
  for name, g, p, j in zip(names, got, plain, want):
    assert np.abs(g).max() > 0, name  # every input gets a gradient
    np.testing.assert_allclose(g, p, rtol=5e-4, atol=5e-5, err_msg=name)
    np.testing.assert_allclose(g, np.asarray(j), rtol=5e-4, atol=5e-5,
                               err_msg=name)


def test_autograd_function_mask_has_no_grad_and_forward_is_the_hook(
    monkeypatch):
  args = _t(make_inputs(seed=13))
  calls = []

  def hook(*a):  # stands in for the launch
    calls.append(len(a))
    return tff.fused_warp_kalman_reference(*a)

  monkeypatch.setattr(tff, "_launch", hook)
  ts = [t.requires_grad_(True) for t in args]
  x, P, cons = tff.FusedWarpKalman.apply(*ts, 3, 7.814728, 1e8)
  assert calls == [9]  # six maps, radius, threshold, invalid_cov
  assert x.requires_grad and P.requires_grad and not cons.requires_grad
  assert cons.dtype == torch.bool
  # only x_post feeds the loss: P_post's cotangent is taken as zero
  (g_P,) = torch.autograd.grad(x.sum(), [ts[1]])
  assert torch.isfinite(g_P).all()


def test_cpu_path_stays_differentiable():
  # a CPU tensor takes the plain version, which autograd records itself
  ts = [t.requires_grad_(True) for t in _t(make_inputs(seed=14))]
  x, P, _ = tff.fused_warp_kalman(*ts, radius=3)
  grads = torch.autograd.grad(x.sum() + P.sum(), ts)
  assert all(torch.isfinite(g).all() for g in grads)


# ------------------------------------------------------- the heads-in entry
# fused_filter_step takes the two heads' raw outputs. Its plain version is
# held against the JAX package's composition: OFlowNet decode's output step
# (r·tanh, exp(clip(±12))), w_scale, SCoordNet apply's output step (raw ·
# coord_scale + offset, exp(clip(±12)) · coord_scale²), the model's flow
# clip, then the Pallas kernel in interpret mode. The update at the fused
# kernel's tolerances (atol 2e-5 on x, rtol 2e-5 on P, the mask equal away
# from χ² ties); the output steps' maps at rtol 1e-5 / atol 1e-6 (float32
# tanh and exp of two libraries).

STEP_KW = dict(w_scale=16.0, coord_scale=1.5, coord_offset=(0.5, -1.0, 2.0),
               log_w_clip=toflow.LOG_VAR_CLIP, log_v_clip=tscoord.LOG_VAR_CLIP)


def make_heads(seed=0, h=12, w=16, batch=None, extreme=True):
  """Raw heads and a previous state, numpy float32: flows and variances
  near the previous state; with ``extreme``, raw flows deep in tanh's
  saturation (flow at ±r) and log-variances past ±12."""
  rng = np.random.default_rng(seed)
  lead = (h, w) if batch is None else (batch, h, w)
  x = rng.normal(size=lead + (3,)).astype(np.float32)
  P = rng.uniform(0.05, 2.0, lead + (1,)).astype(np.float32)
  fl = rng.normal(size=lead + (2,)).astype(np.float32) * 0.4
  lw = np.log(rng.uniform(0.01, 0.5, lead + (1,)) / 16.0).astype(np.float32)
  off = np.asarray(STEP_KW["coord_offset"], np.float32)
  z = x + rng.normal(size=lead + (3,)).astype(np.float32) * 0.3
  rc = ((z - off) / STEP_KW["coord_scale"]).astype(np.float32)
  lv = np.log(rng.uniform(0.05, 2.0, lead + (1,)) / 2.25).astype(np.float32)
  if extreme:
    fl.reshape(-1)[::11] = 30.0
    fl.reshape(-1)[5::13] = -30.0
    lw.reshape(-1)[::7] = 20.0
    lw.reshape(-1)[3::7] = -20.0
    lv.reshape(-1)[::5] = 15.0
    lv.reshape(-1)[2::9] = -15.0
  return (np.concatenate([fl, lw], -1), np.concatenate([rc, lv], -1), x, P)


def jax_step(fh, ch, x, P, r, thr):
  """The JAX package's composition around its kernel, on raw heads."""
  fh, ch = jnp.asarray(fh), jnp.asarray(ch)
  flow = float(r) * jnp.tanh(fh[..., :2])
  W = jnp.exp(jnp.clip(fh[..., 2:3], joflow.LOG_VAR_MIN,
                       joflow.LOG_VAR_MAX)) * STEP_KW["w_scale"]
  flow = jnp.clip(flow, -float(r), float(r))
  cs = STEP_KW["coord_scale"]
  z = ch[..., :3] * cs + jnp.asarray(STEP_KW["coord_offset"], jnp.float32)
  V = jnp.exp(jnp.clip(ch[..., 3:4], jscoord.LOG_VAR_MIN,
                       jscoord.LOG_VAR_MAX)) * (cs ** 2)
  xo, Po, cons = jff.fused_warp_kalman(jnp.asarray(x), jnp.asarray(P), flow,
                                       W, z, V, radius=r, threshold=thr,
                                       interpret=True)
  return xo, Po, cons, flow, W, z, V


def _step_margin(heads, r, thr):
  """Smallest |χ² - threshold| / threshold over the valid pixels."""
  flow, W = toflow.output_step(torch.from_numpy(heads[0]), r)
  z, V = tscoord.output_step(torch.from_numpy(heads[1]),
                             STEP_KW["coord_scale"], STEP_KW["coord_offset"])
  args = (heads[2], heads[3], flow.numpy(), (W * STEP_KW["w_scale"]).numpy(),
          z.numpy(), V.numpy())
  return _gate_margin(args, r, thr)


@pytest.mark.parametrize("seed,h,w,r,thr", [
    (20, 12, 16, 3, jkalman.CHI2_3DOF_P05),
    (21, 17, 23, 3, jkalman.CHI2_3DOF_P50),
    (22, 60, 80, 4, jkalman.CHI2_3DOF_P50),  # the main path's map
])
def test_step_reference_matches_jax(seed, h, w, r, thr):
  heads = make_heads(seed, h, w)
  assert _step_margin(heads, r, thr) > 1e-4
  got = tff.fused_filter_step(*_t(heads), radius=r, threshold=thr, **STEP_KW)
  want = jax_step(*heads, r, thr)
  _assert_close(got[:3], want[:3])
  for name, g, j in zip(("flow", "W", "z", "V"), got[3:], want[3:]):
    np.testing.assert_allclose(g.numpy(), np.asarray(j), rtol=1e-5,
                               atol=1e-6, err_msg=name)
  flow = got[3].numpy()
  assert np.abs(flow).max() == r  # saturated heads reach the bound
  assert got[4].max() == torch.exp(torch.tensor(12.0)) * 16.0


def test_step_reference_is_the_output_steps_then_the_update():
  heads = _t(make_heads(23))
  got = tff.fused_filter_step_reference(*heads, radius=3, **STEP_KW)
  flow, W = toflow.output_step(heads[0], 3)
  z, V = tscoord.output_step(heads[1], STEP_KW["coord_scale"],
                             STEP_KW["coord_offset"])
  want = tff.fused_warp_kalman_reference(heads[2], heads[3], flow,
                                         W * STEP_KW["w_scale"], z, V, 3)
  for g, w in zip(got, (*want, flow, W * STEP_KW["w_scale"], z, V)):
    assert torch.equal(g, w)


@pytest.mark.parametrize("entry", ["fused_warp_kalman", "fused_filter_step"])
def test_batched_equals_per_map(entry):
  heads = _t(make_heads(24, batch=3))
  if entry == "fused_filter_step":
    run = lambda *a: tff.fused_filter_step(*a, radius=3, **STEP_KW)
    args = heads
  else:
    flow, W = toflow.output_step(heads[0], 3)
    z, V = tscoord.output_step(heads[1], 1.0, (0.0, 0.0, 0.0))
    run = lambda *a: tff.fused_warp_kalman(*a, radius=3)
    args = (heads[2], heads[3], flow, W, z, V)
  got = run(*args)
  for i in range(3):
    for g, w in zip(got, run(*(a[i] for a in args))):
      assert g.shape[0] == 3
      assert torch.equal(g[i], w)


def test_step_cpu_takes_the_plain_version_and_launches_nothing():
  heads = _t(make_heads(25))
  before = tff.fused_filter_step.launches
  got = tff.fused_filter_step(*heads, radius=3, **STEP_KW)
  want = tff.fused_filter_step_reference(*heads, radius=3, **STEP_KW)
  assert all(torch.equal(g, w) for g, w in zip(got, want))
  assert tff.fused_filter_step.launches == before
  assert got[2].dtype == torch.bool
  with pytest.raises(ValueError):
    tff.fused_filter_step(*(a.to("meta") for a in heads), radius=3,
                          **STEP_KW)


# Gradients through FusedFilterStep (its launch patched to the plain
# version, as above) into both raw heads, x_prev and P_prev, for a loss on
# all six differentiable outputs, against torch autograd through the plain
# version and jax.grad through the JAX composition with the Pallas kernel
# in interpret mode, at the golden tolerance (rtol 5e-4, atol 5e-5). The
# heads stay off tanh's saturation and inside the ±12 clamps, where both
# are smooth.

@pytest.mark.parametrize("seed,h,w,r,thr", [
    (30, 12, 16, 3, jkalman.CHI2_3DOF_P05),
    (31, 17, 23, 3, jkalman.CHI2_3DOF_P50),
])
def test_step_grads_match_reference_and_jax(monkeypatch, seed, h, w, r, thr):
  import jax
  heads = make_heads(seed, h, w, extreme=False)
  assert _step_margin(heads, r, thr) > 1e-3
  rng = np.random.default_rng(seed + 100)
  cots = [rng.normal(size=(h, w, c)).astype(np.float32)
          for c in (3, 1, 2, 1, 3, 1)]
  kw = dict(radius=r, threshold=thr, **STEP_KW)

  def torch_grads(fn):
    ts = [t.requires_grad_(True) for t in _t(heads)]
    out = fn(*ts)
    diff = [o for i, o in enumerate(out) if i != 2]
    loss = sum(torch.sum(o * torch.from_numpy(c)) for o, c in zip(diff, cots))
    return [g.numpy() for g in torch.autograd.grad(loss, ts)]

  monkeypatch.setattr(tff, "_launch_step", tff.fused_filter_step_reference)
  got = torch_grads(lambda *t: tff.FusedFilterStep.apply(
      *t, r, *STEP_KW.values(), thr, 1e8))
  plain = torch_grads(
      lambda *t: tff.fused_filter_step_reference(*t, **kw))

  def jloss(*a):
    out = jax_step(*a, r, thr)
    diff = [o for i, o in enumerate(out) if i != 2]
    return sum(jnp.sum(o * c) for o, c in zip(diff, cots))

  want = jax.grad(jloss, argnums=(0, 1, 2, 3))(
      *(jnp.asarray(a) for a in heads))
  for name, g, p, j in zip(("raw_flow_head", "raw_coord_head", "x_prev",
                            "P_prev"), got, plain, want):
    assert np.abs(g).max() > 0, name
    np.testing.assert_allclose(g, p, rtol=5e-4, atol=5e-5, err_msg=name)
    np.testing.assert_allclose(g, np.asarray(j), rtol=5e-4, atol=5e-5,
                               err_msg=name)


def test_step_function_mask_has_no_grad_and_forward_is_the_hook(monkeypatch):
  heads = _t(make_heads(32, extreme=False))
  calls = []

  def hook(*a):  # stands in for the launch
    calls.append(len(a))
    return tff.fused_filter_step_reference(*a)

  monkeypatch.setattr(tff, "_launch_step", hook)
  ts = [t.requires_grad_(True) for t in heads]
  out = tff.FusedFilterStep.apply(*ts, 3, 16.0, 1.0, (0.0, 0.0, 0.0),
                                  (-12.0, 12.0), (-12.0, 12.0), 7.814728, 1e8)
  assert calls == [12]  # four maps and eight constants
  assert [o.requires_grad for o in out] == [True, True, False, True, True,
                                            True, True]
  # only z feeds the loss: the other cotangents are taken as zero
  (g_c,) = torch.autograd.grad(out[5].sum(), [ts[1]])
  np.testing.assert_array_equal(g_c[..., :3].numpy(), 1.0)
  assert torch.equal(g_c[..., 3], torch.zeros_like(g_c[..., 3]))


def test_information_form_and_p01_gate_match_jax():
  """fuse_information_form against the JAX package's (and against the
  Kalman update's posterior where every pixel is consistent), and the
  p = 0.01 χ² constant."""
  assert tkalman.CHI2_3DOF_P01 == jkalman.CHI2_3DOF_P01
  rng = np.random.default_rng(11)
  xp = rng.normal(size=(5, 6, 3)).astype(np.float32)
  z = (xp + 0.1 * rng.normal(size=(5, 6, 3))).astype(np.float32)
  Pp = rng.uniform(0.01, 2.0, (5, 6, 1)).astype(np.float32)
  V = rng.uniform(0.01, 2.0, (5, 6, 1)).astype(np.float32)
  jx, jP = jkalman.fuse_information_form(*map(jnp.asarray, (xp, Pp, z, V)))
  tx, tP = tkalman.fuse_information_form(
      *map(torch.from_numpy, (xp, Pp, z, V)))
  np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=5e-4,
                             atol=5e-5)
  np.testing.assert_allclose(tP.numpy(), np.asarray(jP), rtol=5e-4,
                             atol=5e-5)
  kx, kP, ok = tkalman.kalman_update(*map(torch.from_numpy, (xp, Pp, z, V)),
                                     threshold=1e9)
  assert bool(ok.all())
  np.testing.assert_allclose(tx.numpy(), kx.numpy(), rtol=1e-5, atol=1e-5)
  np.testing.assert_array_equal(tP.numpy(), kP.numpy())
