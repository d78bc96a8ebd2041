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
from kfnet_tpu_torch.core import kalman as tkalman
from kfnet_tpu_torch.core import warp as twarp
from kfnet_tpu_torch.kernels import fused_filter as tff


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
