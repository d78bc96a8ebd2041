"""The port's Winograd F(2x2, 3x3) convolution (kfnet_tpu_torch/kernels/
winograd.py, nn/layers.conv(impl="winograd")) against the JAX package's
(kfnet_tpu/kernels/winograd.py) on the cases of tests/test_winograd.py,
on the CPU, and against the direct conv at that file's bounds.

Tolerances: float32 at the goldens' rtol 5e-4 / atol 5e-5 against JAX's
Winograd, and at tests/test_winograd.py's rtol 1e-4 / atol 1e-4 against
the direct conv; bf16 within one bf16 rounding step of JAX's Winograd
(the same adds in the same order; the contraction's float32 sums may
round the last bit either way) and at 0.015 of the largest |y| of the
direct bf16 conv; gradients at rtol 1e-3 / atol 1e-4; SCoordNet's (z, V)
at tests/test_winograd.py:116-118.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfnet_tpu.kernels import winograd as jwin
from kfnet_tpu.models import scoordnet as jscoord
from kfnet_tpu.nn import layers as jL
from kfnet_tpu_torch import convert
from kfnet_tpu_torch.kernels import winograd as twin
from kfnet_tpu_torch.models import scoordnet as tscoord
from kfnet_tpu_torch.nn import layers as tL
from tests import tiny_configs as tc

GOLDEN = dict(rtol=5e-4, atol=5e-5)
BF16_STEP = 2.0 ** -7


def _x_t(x):  # (..., H, W, C) numpy -> (..., C, H, W) torch
  return torch.from_numpy(np.moveaxis(x, -1, -3).copy())


def _w_t(k):  # HWIO -> (O, I, 3, 3)
  return torch.from_numpy(np.ascontiguousarray(k.transpose(3, 2, 0, 1)))


def _y_np(y):  # (..., C, H, W) torch -> (..., H, W, C) float32 numpy
  return np.moveaxis(y.to(torch.float32).numpy(), -3, -1)


def _jwin(x, k, b=None, dtype=jnp.float32):
  """JAX's conv3x3_winograd, jitted (one compile, not one per op)."""
  return np.asarray(jax.jit(lambda x, k, b: jwin.conv3x3_winograd(
      x, k, b, compute_dtype=dtype))(x, k, b), np.float32)


def _direct(x, k, bias=None, dtype=jnp.float32):
  xb = x.reshape((-1,) + x.shape[-3:]).astype(dtype)
  y = jax.lax.conv_general_dilated(
      xb, k.astype(dtype), window_strides=(1, 1), padding="SAME",
      dimension_numbers=("NHWC", "HWIO", "NHWC"))
  if bias is not None:
    y = y.astype(jnp.float32) + bias
  return np.asarray(y.astype(dtype).reshape(x.shape[:-3] + y.shape[1:]),
                    np.float32)


@pytest.mark.parametrize("h,w,cin,cout", [(8, 10, 5, 7), (6, 6, 16, 8),
                                          (60, 80, 8, 8)])
def test_winograd_f32_matches_jax_and_direct(h, w, cin, cout):
  rng = np.random.default_rng(0)
  x = rng.normal(size=(h, w, cin)).astype(np.float32)
  k = rng.normal(size=(3, 3, cin, cout)).astype(np.float32)
  want = _jwin(jnp.asarray(x), jnp.asarray(k))
  got = _y_np(twin.conv3x3_winograd(_x_t(x), _w_t(k),
                                    compute_dtype=torch.float32))
  assert got.shape == (h, w, cout)
  np.testing.assert_allclose(got, want, **GOLDEN)
  np.testing.assert_allclose(got, _direct(jnp.asarray(x), jnp.asarray(k)),
                             rtol=1e-4, atol=1e-4)


def test_winograd_bias_and_batch_dims():
  rng = np.random.default_rng(1)
  x = rng.normal(size=(2, 3, 8, 12, 4)).astype(np.float32)
  k = rng.normal(size=(3, 3, 4, 6)).astype(np.float32)
  b = rng.normal(size=(6,)).astype(np.float32)
  want = _jwin(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b))
  got = _y_np(twin.conv3x3_winograd(_x_t(x), _w_t(k), torch.from_numpy(b),
                                    compute_dtype=torch.float32))
  assert got.shape == (2, 3, 8, 12, 6)
  np.testing.assert_allclose(got, want, **GOLDEN)
  np.testing.assert_allclose(got, _direct(jnp.asarray(x), jnp.asarray(k),
                                          jnp.asarray(b)),
                             rtol=1e-4, atol=1e-4)


def test_winograd_bf16_matches_jax_and_stays_near_direct():
  rng = np.random.default_rng(2)
  x = rng.normal(size=(12, 16, 32)).astype(np.float32)
  k = (rng.normal(size=(3, 3, 32, 32)) / 17).astype(np.float32)
  b = rng.normal(size=(32,)).astype(np.float32)
  want = _jwin(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                dtype=jnp.bfloat16)
  y = twin.conv3x3_winograd(_x_t(x), _w_t(k), torch.from_numpy(b),
                            compute_dtype=torch.bfloat16)
  assert y.dtype == torch.bfloat16
  got = _y_np(y)
  np.testing.assert_allclose(got, want, rtol=BF16_STEP, atol=BF16_STEP)
  ref = _direct(jnp.asarray(x), jnp.asarray(k), jnp.asarray(b),
                dtype=jnp.bfloat16)
  np.testing.assert_allclose(got, ref, atol=0.015 * np.abs(ref).max())
  wt = twin.transform_weights(_w_t(k), torch.float32)
  np.testing.assert_allclose(
      wt.numpy(), np.asarray(jwin.transform_weights(jnp.asarray(k),
                                                    jnp.float32)),
      **GOLDEN)


def test_winograd_gradients_match_direct_and_jax():
  rng = np.random.default_rng(3)
  x = rng.normal(size=(6, 8, 4)).astype(np.float32)
  k = rng.normal(size=(3, 3, 4, 4)).astype(np.float32)
  jg = jax.jit(jax.grad(lambda k_: jnp.sum(jnp.sin(jwin.conv3x3_winograd(
      jnp.asarray(x), k_, compute_dtype=jnp.float32)))))(jnp.asarray(k))
  wt = _w_t(k).requires_grad_(True)
  torch.sum(torch.sin(twin.conv3x3_winograd(
      _x_t(x), wt, compute_dtype=torch.float32))).backward()
  got = wt.grad.numpy().transpose(2, 3, 1, 0)
  np.testing.assert_allclose(got, np.asarray(jg), rtol=1e-3, atol=1e-4)
  wd = _w_t(k).requires_grad_(True)
  torch.sum(torch.sin(torch.nn.functional.conv2d(
      _x_t(x)[None], wd, padding=1))).backward()
  np.testing.assert_allclose(wt.grad.numpy(), wd.grad.numpy(), rtol=1e-3,
                             atol=1e-4)
  # the bf16 route differentiates too (its operands upcast)
  wb = _w_t(k).requires_grad_(True)
  twin.conv3x3_winograd(_x_t(x), wb).float().sum().backward()
  assert torch.isfinite(wb.grad).all()


@pytest.mark.parametrize("h,w", [(8, 10), (7, 9), (8, 9)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_impl_winograd_and_odd_size_route(h, w, dtype):
  """layers.conv(impl="winograd") against the JAX layer of the same impl:
  even sizes through Winograd, odd ones through the direct conv; the same
  params either way."""
  jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
  lay_j = jL.conv(6, 3, 1, use_bias=True, compute_dtype=jd, impl="winograd")
  lay_t = tL.conv(6, 3, 1, use_bias=True, compute_dtype=dtype,
                  impl="winograd")
  params, out_shape = lay_j.init(jax.random.key(0), (h, w, 5))
  assert out_shape == (h, w, 6)
  params = jax.tree_util.tree_map(np.asarray, params)
  params["b"] = np.random.default_rng(9).normal(size=6).astype(np.float32)
  rng = np.random.default_rng(4)
  x = rng.normal(size=(h, w, 5)).astype(np.float32)
  want = np.asarray(jax.jit(lay_j.apply)(params, jnp.asarray(x)),
                    np.float32)
  got = _y_np(lay_t.apply(convert.params_from_jax(params), _x_t(x)[None]))[0]
  tol = GOLDEN if dtype == "float32" else dict(rtol=BF16_STEP,
                                                atol=BF16_STEP)
  np.testing.assert_allclose(got, want, **tol)
  xla = tL.conv(6, 3, 1, use_bias=True, compute_dtype=dtype)
  ref = _y_np(xla.apply(convert.params_from_jax(params), _x_t(x)[None]))[0]
  if dtype == "float32":
    np.testing.assert_allclose(got, ref, rtol=1e-4, atol=1e-4)
  else:
    np.testing.assert_allclose(got, ref, atol=0.015 * np.abs(ref).max())


def test_scoordnet_winograd_matches_jax_and_xla():
  """The tiny SCoordNet forward with conv_impl="winograd" (float32)
  against JAX's winograd forward, and against the port's xla forward at
  tests/test_winograd.py:116-118's bounds."""
  cfg = dataclasses.replace(tc.tiny_scoordnet(), compute_dtype="float32")
  cfg_w = dataclasses.replace(cfg, conv_impl="winograd")
  params = jscoord.init(jax.random.key(0), cfg, (48, 64, 3))
  rng = np.random.default_rng(5)
  img = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
  jc, jv = jax.jit(lambda p, im: jscoord.apply(p, cfg_w, im))(
      params, jnp.asarray(img))
  tparams = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                           params))
  tcfg = tscoord.SCoordNetConfig(**dataclasses.asdict(cfg))
  tc_w, tv_w = tscoord.apply(tparams, dataclasses.replace(
      tcfg, conv_impl="winograd"), torch.from_numpy(img))
  tc_x, tv_x = tscoord.apply(tparams, tcfg, torch.from_numpy(img))
  np.testing.assert_allclose(tc_w.numpy(), np.asarray(jc), **GOLDEN)
  np.testing.assert_allclose(tv_w.numpy(), np.asarray(jv), rtol=1e-3,
                             atol=1e-6)
  np.testing.assert_allclose(tc_w.numpy(), tc_x.numpy(), rtol=1e-3,
                             atol=1e-4)
  np.testing.assert_allclose(tv_w.numpy(), tv_x.numpy(), rtol=1e-2,
                             atol=1e-6)
