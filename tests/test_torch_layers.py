"""The port's layer toolkit against the JAX package's (kfnet_tpu_torch/nn
vs kfnet_tpu/nn), weights converted with convert.params_from_jax.

Tolerances: float32 layers agree to atol 1e-5 (summation order only);
bfloat16 layers to one bf16 rounding step (rtol 2^-7 ≈ 7.8e-3), since a
different f32 accumulation order can round the last bit either way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfnet_tpu.nn import layers as jL
from kfnet_tpu_torch import convert
from kfnet_tpu_torch.nn import layers as tL

BF16_RTOL = 2.0 ** -7


def _nhwc_to_torch(x):
  return torch.from_numpy(np.asarray(x)).permute(0, 3, 1, 2)


def _torch_to_nhwc(y):
  return y.permute(0, 2, 3, 1).to(torch.float32).numpy()


def _pair(jlayer, tlayer, shape, seed, bias=False, transposed=False):
  """Init the JAX layer, convert its params, run both on one float32
  input (each layer casts it to its compute dtype). ``transposed``
  converts the params as OFlowNet's transposed convs are converted."""
  params, _ = jlayer.init(jax.random.key(seed), shape)
  if bias:  # non-zero biases, so the bias path is exercised
    rng = np.random.default_rng(seed + 100)
    params = jax.tree_util.tree_map(np.asarray, params)
    for p in (params if isinstance(params, list) else [params]):
      if isinstance(p, dict) and "b" in p:
        p["b"] = rng.normal(size=p["b"].shape).astype(np.float32)
  rng = np.random.default_rng(seed)
  x = rng.normal(size=(2,) + shape).astype(np.float32)
  want = np.asarray(jlayer.apply(params, jnp.asarray(x)), np.float32)
  tree = jax.tree_util.tree_map(np.asarray, params)
  if transposed:
    tparams = convert.params_from_jax({"up0": tree})["up0"]
  else:
    tparams = convert.params_from_jax(tree)
  got = _torch_to_nhwc(tlayer.apply(tparams, _nhwc_to_torch(x)))
  return got, want


@pytest.mark.parametrize("size", [(8, 10), (7, 9), (8, 9)])
@pytest.mark.parametrize("stride", [1, 2])
def test_conv_same_padding_matches_xla(size, stride):
  shape = size + (5,)
  got, want = _pair(jL.conv(6, 3, stride, compute_dtype=jnp.float32),
                    tL.conv(6, 3, stride, compute_dtype="float32"),
                    shape, seed=stride + size[0], bias=True)
  assert got.shape == want.shape
  np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_same_pads_follow_xla():
  # stride 2: even inputs pad (0, 1), odd inputs (1, 1); stride 1: (1, 1)
  assert tL.same_pads(8, 3, 2) == (0, 1)
  assert tL.same_pads(7, 3, 2) == (1, 1)
  assert tL.same_pads(8, 3, 1) == (1, 1)
  assert tL.same_pads(8, 1, 1) == (0, 0)


@pytest.mark.parametrize("size", [(3, 4), (5, 3)])
def test_conv_transpose_matches_lax(size):
  shape = size + (6,)
  got, want = _pair(jL.conv_transpose(4, 4, 2, compute_dtype=jnp.float32),
                    tL.conv_transpose(4, 4, 2, compute_dtype="float32"),
                    shape, seed=3, bias=True, transposed=True)
  assert got.shape == want.shape == (2, 2 * size[0], 2 * size[1], 4)
  np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_conv_transpose_pads():
  assert tL.conv_transpose_pads(4, 2) == (1, 0)


@pytest.mark.parametrize("c", [8, 16, 48, 64])
def test_group_norm_matches(c):
  # c < 32 gives c groups of 1; 48 gives 24 groups of 2
  params, _ = jL.group_norm().init(jax.random.key(0), (6, 7, c))
  rng = np.random.default_rng(c)
  params = {"scale": rng.normal(size=c).astype(np.float32),
            "bias": rng.normal(size=c).astype(np.float32)}
  x = (rng.normal(size=(2, 6, 7, c)) * 3 + 1.5).astype(np.float32)
  want = np.asarray(jL.group_norm().apply(params, jnp.asarray(x)))
  got = _torch_to_nhwc(tL.group_norm().apply(
      convert.params_from_jax(params), _nhwc_to_torch(x)))
  np.testing.assert_allclose(got, want, atol=1e-5, rtol=1e-5)


def test_group_norm_keeps_bf16():
  p = {"scale": torch.ones(8), "bias": torch.zeros(8)}
  y = tL.group_norm().apply(p, torch.randn(1, 8, 4, 4).bfloat16())
  assert y.dtype == torch.bfloat16


def test_gn_group_count_matches():
  for c in range(1, 130):
    assert tL.gn_group_count(c) == jL.gn_group_count(c)


def test_space_to_depth_channel_order():
  rng = np.random.default_rng(0)
  x = rng.integers(0, 255, (2, 8, 6, 3)).astype(np.uint8)
  want = np.asarray(jL.space_to_depth(2).apply({}, jnp.asarray(x)))
  got = tL.space_to_depth(2).apply({}, torch.from_numpy(x)).numpy()
  np.testing.assert_array_equal(got, want)
  # channel (fy·f+fx)·C + c, which is not pixel_unshuffle's c·f²+fy·f+fx
  unshuffled = torch.pixel_unshuffle(
      torch.from_numpy(x).permute(0, 3, 1, 2), 2).permute(0, 2, 3, 1)
  assert not np.array_equal(unshuffled.numpy(), want)
  assert got[0, 1, 2, 1 * 3 + 2] == x[0, 2, 5, 2]  # fy=0, fx=1, c=2


def test_bf16_conv_rounds_then_adds_bias_in_f32():
  layer = tL.conv(8, 3, 1, compute_dtype="bfloat16")
  gen = torch.Generator().manual_seed(0)
  params, _ = layer.init(gen, (6, 6, 4), "cpu")
  params["b"] = torch.randn(8, generator=gen)
  x = torch.randn(1, 4, 6, 6, generator=gen)
  y = layer.apply(params, x)
  assert y.dtype == torch.bfloat16
  raw = torch.nn.functional.conv2d(x.bfloat16(), params["w"].bfloat16(),
                                   padding=1)
  assert raw.dtype == torch.bfloat16
  want = (raw.float() + params["b"][:, None, None]).bfloat16()
  assert torch.equal(y, want)


def test_bf16_conv_matches_jax_within_one_rounding():
  got, want = _pair(jL.conv(16, 3, 1, compute_dtype=jnp.bfloat16),
                    tL.conv(16, 3, 1, compute_dtype="bfloat16"),
                    (8, 8, 16), seed=5, bias=True)
  np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=BF16_RTOL)


@pytest.mark.parametrize("norm", ["group", "none", "ws"])
def test_conv_block_matches(norm):
  got, want = _pair(
      jL.conv_block(32, 3, 2, norm=norm, compute_dtype=jnp.float32),
      tL.conv_block(32, 3, 2, norm=norm, compute_dtype="float32"),
      (9, 10, 8), seed=7)
  np.testing.assert_allclose(got, want, atol=2e-5, rtol=1e-5)


def test_unported_conv_impl_raises():
  with pytest.raises(NotImplementedError):
    tL.conv(8, 3, 1, impl="pallas_3x3")
