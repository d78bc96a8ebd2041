"""The port's NLL losses (kfnet_tpu_torch/losses/nll.py) against the JAX
package's (kfnet_tpu/losses/nll.py) on the same numpy-drawn inputs, and
their gradients against jax.grad. Tolerance: rtol 1e-6 / atol 1e-6 on the
values (the same float32 arithmetic, summed in another order), the
goldens' rtol 5e-4 / atol 5e-5 (tests/test_goldens.py) on the gradients.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfnet_tpu.losses import nll as jnll
from kfnet_tpu_torch.losses import nll as tnll

TOL = dict(rtol=1e-6, atol=1e-6)


def inputs(seed, shape=(2, 6, 8), mask="channel", valid_frac=0.6):
  rng = np.random.default_rng(seed)
  pred = rng.normal(size=shape + (3,)).astype(np.float32)
  target = rng.normal(size=shape + (3,)).astype(np.float32)
  # variances over many decades, some below eps's clamp
  var = np.exp(rng.uniform(-8, 4, shape + (1,))).astype(np.float32)
  var.reshape(-1)[:2] = 0.0
  if mask is None:
    m = None
  else:
    m = rng.uniform(size=shape) < valid_frac
    if mask == "channel":
      m = m[..., None]
  return pred, target, var, m


def t(a):
  return None if a is None else torch.from_numpy(np.array(a))


@pytest.mark.parametrize("mask,frac", [("channel", 0.6), ("plain", 0.6),
                                       (None, 1.0), ("plain", 0.0),
                                       ("channel", 0.0)],
                         ids=["mask_h_w_1", "mask_h_w", "no_mask",
                              "empty_mask", "empty_mask_channel"])
def test_gaussian_nll_and_coord_error_match_jax(mask, frac):
  pred, target, var, m = inputs(0, mask=mask, valid_frac=frac)
  got = tnll.gaussian_nll(t(pred), t(target), t(var), t(m))
  want = jnll.gaussian_nll(pred, target, var,
                           None if m is None else jnp.asarray(m))
  np.testing.assert_allclose(got.item(), float(want), **TOL)
  got = tnll.l2_coord_error(t(pred), t(target), t(m))
  want = jnll.l2_coord_error(pred, target,
                             None if m is None else jnp.asarray(m))
  np.testing.assert_allclose(got.item(), float(want), **TOL)
  if frac == 0.0:  # max(count, 1): an empty mask gives 0, not NaN
    assert got.item() == 0.0


@pytest.mark.parametrize("frac", [0.5, 0.0], ids=["mask", "empty_mask"])
def test_masked_mean_broadcasts_as_jax(frac):
  rng = np.random.default_rng(1)
  x = rng.normal(size=(3, 4, 5, 2)).astype(np.float32)
  m = rng.uniform(size=(3, 4, 5, 1)) < frac
  got = tnll.masked_mean(t(x), t(m))
  want = jnll.masked_mean(jnp.asarray(x), jnp.asarray(m))
  np.testing.assert_allclose(got.item(), float(want), **TOL)


def test_nll_gradients_match_jax():
  pred, target, var, m = inputs(2)
  args = [t(pred).requires_grad_(), t(target), t(var).requires_grad_()]
  tnll.gaussian_nll(*args, t(m)).backward()
  jg = jax.grad(lambda p, v: jnll.gaussian_nll(p, target, v, m),
                argnums=(0, 1))(pred, var)
  for got, want in zip((args[0].grad, args[2].grad), jg):
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=5e-4,
                               atol=5e-5)
