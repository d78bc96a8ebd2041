"""The port's conv kernels (kfnet_tpu_torch/kernels/conv3x3.py) against the
JAX package's Pallas kernels (kfnet_tpu/kernels/conv3x3.py) in interpret
mode, kernel by kernel, layer by layer and model by model. On the CPU the
port's wrappers run their plain versions; weights are JAX-initialised and
converted with convert.params_from_jax.

Tolerances, each with its reason:
  * kernels: both sides sum exact bf16 products in float32, in another
    order. float32 outputs and Σy agree to 1e-5 of their largest magnitude,
    Σy² to rtol 1e-5; bf16 outputs to one bf16 rounding step (rtol and
    atol 2^-7), since the reordered sum can round the last bit either way.
  * ineligible or batched inputs take the "xla" path and must equal it
    exactly; a fused trunk with nothing to fuse equals the serial path to
    1e-6, as in tests/test_fused_trunk.py (its f32 head reads another
    memory layout).
  * models at bf16 on identical inputs (SCoordNet, OFlowNet's encoder and
    decoder): about 3x the deviation measured on these inputs, and never
    looser than tests/test_fused_trunk.py (coords atol 2e-2, variance rtol
    2e-2).
  * the whole slice in float32: the kernels round their inputs to bf16, so
    a float32 difference of one part in 1e7 flips a bf16 rounding now and
    then, and a flip grows through the random-weight nets. Measured over
    seeds 0-4 of this test's config (my CPU runs): z 4.9e-3, V rel 4.9e-3,
    flow 1.1e-2, W rel 6.1e-3, x 4.9e-3, P rel 4.9e-3 at most. The bounds
    are about 3x those: 1.5e-2 for z, V, x and P (inside
    test_fused_trunk.py's 2e-2), 2e-2 for W, and 3.5e-2 for the flow
    (under 1% of its [-2, 2] range).
"""

import contextlib
import dataclasses
import unittest.mock as mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfnet_tpu.kernels import conv3x3 as jc3
from kfnet_tpu.models import kfnet as jkfnet
from kfnet_tpu.models import oflownet as joflow
from kfnet_tpu.models import scoordnet as jscoord
from kfnet_tpu.nn import layers as jL
from kfnet_tpu_torch import convert
from kfnet_tpu_torch.kernels import conv3x3 as tc3
from kfnet_tpu_torch.models import kfnet as tkfnet
from kfnet_tpu_torch.models import oflownet as toflow
from kfnet_tpu_torch.models import scoordnet as tscoord
from kfnet_tpu_torch.nn import layers as tL

BF16_STEP = 2.0 ** -7


@contextlib.contextmanager
def pallas_interpret():
  """Route the JAX package's Pallas conv kernels through interpret mode, as
  tests/test_pallas_conv.py and tests/test_fused_trunk.py do."""
  same, chain = jc3.conv3x3_same, jc3.conv3x3_gn_chain

  def interp_same(*a, **kw):
    return same(*a, **dict(kw, interpret=True))

  def interp_chain(*a, **kw):
    return chain(*a, **dict(kw, interpret=True))

  with mock.patch.object(jc3, "conv3x3_same", side_effect=interp_same), \
      mock.patch.object(jc3, "conv3x3_gn_chain", side_effect=interp_chain):
    yield


@contextlib.contextmanager
def kernel_spies():
  """Count the port's kernel-wrapper calls (on the CPU they run the plain
  versions, which the wrappers' ``launches`` counters do not count)."""
  with mock.patch.object(tc3, "conv3x3_same",
                         wraps=tc3.conv3x3_same) as same, \
      mock.patch.object(tc3, "conv3x3_gn_chain",
                        wraps=tc3.conv3x3_gn_chain) as chain:
    yield {"conv3x3_same": same, "conv3x3_gn_chain": chain}


def to_port(tree):
  return convert.params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def oihw(k_hwio):
  return torch.from_numpy(np.ascontiguousarray(k_hwio.transpose(3, 2, 0, 1)))


def f32(a):
  return a.to(torch.float32).numpy() if isinstance(a, torch.Tensor) else \
      np.asarray(a, np.float32)


def assert_f32_sums_close(got, want):
  want = f32(want)
  np.testing.assert_allclose(f32(got), want, rtol=0,
                             atol=1e-5 * np.abs(want).max())


# ---------------------------------------------------------------- kernels


@pytest.mark.parametrize("h,w,cin,cout,bias,relu,out", [
    (8, 16, 128, 128, True, True, "float32"),
    (8, 16, 128, 128, True, True, "bfloat16"),
    (6, 10, 256, 128, False, False, "bfloat16"),
    (7, 9, 128, 256, True, False, "float32"),
    (5, 11, 128, 128, False, True, "bfloat16"),
])
def test_conv3x3_same_matches_pallas(h, w, cin, cout, bias, relu, out):
  rng = np.random.default_rng(h * w + cin)
  x = rng.normal(size=(h, w, cin)).astype(np.float32)
  k = (rng.normal(size=(3, 3, cin, cout)) * 0.05).astype(np.float32)
  b = rng.normal(size=(cout,)).astype(np.float32) if bias else None
  want = jc3.conv3x3_same(jnp.asarray(x), jnp.asarray(k),
                          None if b is None else jnp.asarray(b), relu=relu,
                          out_dtype=jnp.dtype(out), interpret=True)
  got = tc3.conv3x3_same(torch.from_numpy(x).bfloat16(), oihw(k),
                         None if b is None else torch.from_numpy(b),
                         relu=relu, out_dtype=tL.as_dtype(out))
  assert got.dtype == tL.as_dtype(out) and got.shape == (h, w, cout)
  if out == "float32":
    assert_f32_sums_close(got, want)
  else:
    np.testing.assert_allclose(f32(got), f32(want), rtol=BF16_STEP,
                               atol=BF16_STEP)


@pytest.mark.parametrize("h,w,cin,cout,cin_tile,relu", [
    (8, 16, 256, 128, 128, True),   # cin tiled in the Pallas grid
    (7, 9, 128, 256, 512, False),   # odd map, the trunk's first call
    (6, 8, 1024, 128, 512, True),   # 1024 channels, two Pallas cin tiles
])
def test_gn_chain_matches_pallas(h, w, cin, cout, cin_tile, relu):
  rng = np.random.default_rng(cin + cout)
  x = rng.normal(size=(h, w, cin)).astype(np.float32)
  scale = rng.uniform(0.5, 1.5, cin).astype(np.float32)
  shift = (rng.normal(size=cin) * 0.3).astype(np.float32)
  k = (rng.normal(size=(3, 3, cin, cout)) * 0.05).astype(np.float32)
  yj, s1j, s2j = jc3.conv3x3_gn_chain(
      jnp.asarray(x), jnp.asarray(scale), jnp.asarray(shift), jnp.asarray(k),
      prologue_relu=relu, cin_tile=cin_tile, interpret=True)
  yt, s1t, s2t = tc3.conv3x3_gn_chain(
      torch.from_numpy(x).bfloat16(), torch.from_numpy(scale),
      torch.from_numpy(shift), oihw(k), prologue_relu=relu)
  assert yt.dtype == torch.bfloat16 and yt.shape == (h, w, cout)
  np.testing.assert_allclose(f32(yt), f32(yj), rtol=BF16_STEP,
                             atol=BF16_STEP)
  assert_f32_sums_close(s1t, s1j)
  np.testing.assert_allclose(f32(s2t), f32(s2j), rtol=1e-5)


def test_gn_chain_pad_stays_zero():
  # a shift that makes every normalized value 1: the interior of a ones
  # kernel's output counts the taps inside the map (corner 4, edge 6,
  # interior 9), so a normalized pad would show as 9 everywhere
  x = torch.zeros((4, 5, 64), dtype=torch.bfloat16)
  w = torch.zeros((128, 64, 3, 3))
  w[:, 0] = 1.0
  y, s1, _ = tc3.conv3x3_gn_chain(x, torch.ones(64), torch.ones(64), w)
  taps = torch.tensor([[4, 6, 6, 6, 4], [6, 9, 9, 9, 6], [6, 9, 9, 9, 6],
                       [4, 6, 6, 6, 4]], dtype=torch.float32)
  assert torch.equal(y[..., 0].float(), taps)
  assert s1[0].item() == taps.sum().item()


@pytest.mark.parametrize("c", [128, 256, 48])
def test_gn_scale_shift_matches(c):
  rng = np.random.default_rng(c)
  n = 6 * 8
  acc = rng.normal(size=(n, c)).astype(np.float32) * 3 + 1
  s1, s2 = acc.sum(0), (acc * acc).sum(0)
  gamma = rng.normal(size=c).astype(np.float32)
  beta = rng.normal(size=c).astype(np.float32)
  want = jc3.gn_scale_shift(jnp.asarray(s1), jnp.asarray(s2), n,
                            jnp.asarray(gamma), jnp.asarray(beta))
  got = tc3.gn_scale_shift(*(torch.from_numpy(a) for a in (s1, s2)), n,
                           torch.from_numpy(gamma), torch.from_numpy(beta))
  for g, w in zip(got, want):
    np.testing.assert_allclose(f32(g), f32(w), rtol=1e-5, atol=1e-6)


def test_wrappers_check_their_arguments():
  x = torch.zeros((4, 5, 128), dtype=torch.bfloat16)
  w = torch.zeros((128, 128, 3, 3))
  with pytest.raises(TypeError):
    tc3.conv3x3_same(x.float(), w)
  with pytest.raises(ValueError, match="contiguous"):
    tc3.conv3x3_same(x.transpose(0, 1), w.transpose(2, 3))
  with pytest.raises(ValueError, match="multiple"):
    tc3.conv3x3_same(x[..., :80].contiguous(), w[:, :80].contiguous())
  with pytest.raises(ValueError, match="multiple"):
    tc3.conv3x3_same(x, w[:96].contiguous())
  with pytest.raises(ValueError, match="shape"):
    tc3.conv3x3_gn_chain(x, torch.ones(64), torch.zeros(128), w)
  with pytest.raises(TypeError):
    tc3.conv3x3_gn_chain(x, torch.ones(128).double(), torch.zeros(128), w)


def test_no_cpu_fallback_off_the_cpu():
  # only a CPU tensor takes the plain version: any other device launches
  # the kernel (cuda) or raises, never falls back
  x = torch.zeros((4, 5, 128), dtype=torch.bfloat16, device="meta")
  w = torch.zeros((128, 128, 3, 3), device="meta")
  with pytest.raises(ValueError, match="cuda or cpu"):
    tc3.conv3x3_same(x, w)
  with pytest.raises(ValueError, match="cuda or cpu"):
    tc3.conv3x3_gn_chain(x, torch.ones(128, device="meta"),
                         torch.zeros(128, device="meta"), w)


# ----------------------------------------------------------------- layers


def _layer_pair(impl, shape, out_ch, bias=True, dtype="bfloat16", seed=0):
  jl = jL.conv(out_ch, 3, 1, use_bias=bias, compute_dtype=jnp.dtype(dtype),
               impl=impl)
  tl = tL.conv(out_ch, 3, 1, use_bias=bias, compute_dtype=dtype, impl=impl)
  params, _ = jl.init(jax.random.key(seed), shape)
  rng = np.random.default_rng(seed)
  params = jax.tree_util.tree_map(np.asarray, params)
  if bias:
    params["b"] = rng.normal(size=(out_ch,)).astype(np.float32)
  x = rng.normal(size=shape).astype(np.float32)
  return jl, tl, params, x


def _port_apply(tl, params, x):
  y = tl.apply(convert.params_from_jax(params),
               torch.from_numpy(x)[None].permute(0, 3, 1, 2))
  return y[0].permute(1, 2, 0)


@pytest.mark.parametrize("shape,out_ch,dtype", [
    ((8, 16, 128), 128, "bfloat16"),
    ((7, 9, 256), 128, "bfloat16"),
    ((6, 10, 128), 256, "float32"),
])
def test_conv_layer_pallas_matches_jax(shape, out_ch, dtype):
  jl, tl, params, x = _layer_pair("pallas_3x3", shape, out_ch, dtype=dtype)
  with pallas_interpret():
    want = jl.apply(params, jnp.asarray(x))
  with kernel_spies() as spy:
    got = _port_apply(tl, params, x)
  assert spy["conv3x3_same"].call_count == 1
  assert got.dtype == tL.as_dtype(dtype)
  # one rounding: to the output dtype after the bias (bf16: one step)
  tol = BF16_STEP if dtype == "bfloat16" else 1e-5
  np.testing.assert_allclose(f32(got), f32(want), rtol=tol, atol=tol)


@pytest.mark.parametrize("shape,dtype", [
    ((8, 16, 12), "bfloat16"),     # cin 12: not a multiple of 128
    ((36, 36, 2048), "float32"),   # past the byte bound (12.3 MB > 11 MiB)
])
def test_conv_layer_ineligible_is_xla(shape, dtype):
  assert not tL._pallas_conv_eligible(shape[0], shape[1], shape[2], 128, 3,
                                      1, 1, "SAME")
  _, tl, params, x = _layer_pair("pallas_3x3", shape, 128, dtype=dtype)
  _, tx, _, _ = _layer_pair("xla", shape, 128, dtype=dtype)
  with kernel_spies() as spy:
    got = _port_apply(tl, params, x)
  assert spy["conv3x3_same"].call_count == 0
  assert torch.equal(got, _port_apply(tx, params, x))


def test_pallas_eligibility_is_jax_rule():
  for args in [(60, 80, 128, 128), (60, 80, 256, 128), (60, 80, 512, 512),
               (15, 20, 256, 256), (8, 16, 12, 64), (36, 36, 2048, 128),
               (60, 80, 256, 512)]:
    for stride in (1, 2):
      assert tL._pallas_conv_eligible(*args, 3, stride, 1, "SAME") == \
          jL._pallas_conv_eligible(*args, 3, stride, 1, "SAME")


def test_conv_impl_names():
  assert tL.frame_impl("pallas_3x3", single_frame=False) == "xla"
  assert tL.frame_impl("pallas_3x3", single_frame=True) == "pallas_3x3"
  assert tL.frame_impl("pallas_fused", single_frame=False) == "pallas_fused"
  with pytest.raises(ValueError):
    tL.conv(8, impl="cudnn")


# ------------------------------------------------------------- SCoordNet


def small_scoord(module, conv_impl="xla", **kw):
  # test_fused_trunk.py's config
  return module.SCoordNetConfig(
      channels=(128, 128), strides=(1, 1), head_channels=128, stem_s2d=1,
      compute_dtype="bfloat16", conv_impl=conv_impl, norm="group", **kw)


@pytest.mark.parametrize("impl,calls", [("pallas_fused", 2),
                                        ("pallas_3x3", 2)])
def test_scoordnet_kernel_impls_match_jax(impl, calls):
  jparams = jscoord.init(jax.random.key(0), small_scoord(jscoord), (16, 16, 3))
  img = np.random.default_rng(0).uniform(0, 1, (16, 16, 3)).astype(
      np.float32)
  with pallas_interpret():
    cj, vj = jscoord.apply(jparams, small_scoord(jscoord, impl),
                           jnp.asarray(img))
  tcfg = small_scoord(tscoord, impl)
  with kernel_spies() as spy:
    ct, vt = tscoord.apply(to_port(jparams), tcfg, torch.from_numpy(img))
  shapes = tkfnet.kernel_shapes(tkfnet.KFNetConfig(scoordnet=tcfg),
                                (16, 16, 3))
  for name, mock_fn in spy.items():
    assert mock_fn.call_count == len(shapes[name])
  assert len(shapes["conv3x3_gn_chain" if impl == "pallas_fused"
                    else "conv3x3_same"]) == calls
  # measured: coords 1.2e-5, variance rel 1.0e-6 (my CPU run)
  np.testing.assert_allclose(f32(ct), f32(cj), rtol=0, atol=5e-5)
  np.testing.assert_allclose(f32(vt), f32(vj), rtol=5e-6, atol=1e-7)


def test_scoordnet_fused_suffix_start_matches_jax():
  for kw in ({}, {"head_channels": 96}, {"stem_s2d": 2},
             {"channels": (64, 128, 256), "strides": (2, 1, 1)}):
    jcfg = dataclasses.replace(small_scoord(jscoord, "pallas_fused"), **kw)
    tcfg = dataclasses.replace(small_scoord(tscoord, "pallas_fused"), **kw)
    assert tscoord._fused_suffix_start(tcfg) == \
        jscoord._fused_suffix_start(jcfg)
  assert tscoord._fused_suffix_start(tscoord.SCoordNetConfig()) == 4


def test_scoordnet_fused_ineligible_head_is_serial():
  tx = dataclasses.replace(small_scoord(tscoord), head_channels=96)
  tp = dataclasses.replace(tx, conv_impl="pallas_fused")
  assert tscoord._fused_suffix_start(tp) == len(tp.channels) + 1
  jparams = jscoord.init(jax.random.key(1), dataclasses.replace(
      small_scoord(jscoord), head_channels=96), (16, 16, 3))
  params = to_port(jparams)
  img = torch.from_numpy(np.random.default_rng(2).uniform(
      size=(16, 16, 3)).astype(np.float32))
  with kernel_spies() as spy:
    cp, vp = tscoord.apply(params, tp, img)
  assert spy["conv3x3_gn_chain"].call_count == 0
  cx, vx = tscoord.apply(params, tx, img)
  # the f32 head sees the same values in another memory layout, so its sums
  # may run in another order: test_fused_trunk.py's 1e-6
  np.testing.assert_allclose(f32(cp), f32(cx), atol=1e-6)
  np.testing.assert_allclose(f32(vp), f32(vx), rtol=1e-6)


@pytest.mark.parametrize("impl", ["pallas_fused", "pallas_3x3"])
def test_scoordnet_batched_is_xla(impl):
  params = to_port(jscoord.init(jax.random.key(0), small_scoord(jscoord),
                                (16, 16, 3)))
  imgs = torch.from_numpy(np.random.default_rng(1).uniform(
      0, 1, (2, 16, 16, 3)).astype(np.float32))
  with kernel_spies() as spy:
    c, v = tscoord.apply(params, small_scoord(tscoord, impl), imgs)
  assert all(m.call_count == 0 for m in spy.values())
  cx, vx = tscoord.apply(params, small_scoord(tscoord), imgs)
  assert c.shape == (2, 16, 16, 3)
  assert torch.equal(c, cx) and torch.equal(v, vx)


@pytest.mark.parametrize("norm", ["none", "ws"])
def test_scoordnet_fused_needs_group_norm(norm):
  cfg = dataclasses.replace(small_scoord(tscoord, "pallas_fused"), norm=norm)
  with pytest.raises(ValueError, match="pallas_fused"):
    tscoord.init(torch.Generator().manual_seed(0), cfg, (16, 16, 3), "cpu")


def test_scoordnet_full_width_kernel_calls():
  # the default config at 640x480: 12 chain calls (layers 4..14 and the
  # head block); under pallas_3x3, layers 4-6 (the 512-wide layers miss
  # the byte bound)
  fused = tkfnet.kernel_shapes(tkfnet.KFNetConfig(
      scoordnet=tscoord.SCoordNetConfig(conv_impl="pallas_fused")))
  assert fused["conv3x3_gn_chain"] == (
      [(60, 80, 128, 256), (60, 80, 256, 256), (60, 80, 256, 512)]
      + [(60, 80, 512, 512)] * 9)
  assert fused["conv3x3_same"] == []
  same = tkfnet.kernel_shapes(tkfnet.KFNetConfig(
      scoordnet=tscoord.SCoordNetConfig(conv_impl="pallas_3x3")))
  assert same["conv3x3_same"] == [(60, 80, 128, 256), (60, 80, 256, 256),
                                  (60, 80, 256, 512)]
  assert same["conv3x3_gn_chain"] == []


# --------------------------------------------------------------- OFlowNet


def small_oflow(module, conv_impl="pallas_3x3"):
  # 48x80 frames -> a 6x10 map; the decoder's 128/256-wide convs take the
  # kernel at 6x10, 3x5 (odd) and 2x3
  return module.OFlowNetConfig(
      encoder_channels=(8, 16, 128, 128), encoder_strides=(2, 2, 2, 1),
      search_radius=2, stem_s2d=1, compute_dtype="bfloat16",
      conv_impl=conv_impl)


@pytest.fixture(scope="module")
def oflow_params():
  return jax.tree_util.tree_map(
      np.asarray, joflow.init(jax.random.key(1), small_oflow(joflow),
                              (48, 80, 3)))


def test_oflownet_kernel_shapes():
  cfg = tkfnet.KFNetConfig(oflownet=small_oflow(toflow))
  first = tkfnet.kernel_shapes(cfg, (48, 80, 3), first=True)
  later = tkfnet.kernel_shapes(cfg, (48, 80, 3))
  assert first["conv3x3_same"] == [(6, 10, 128, 128)]  # the encoder
  assert later["conv3x3_same"] == [(6, 10, 128, 128),  # then the decoder
                                   (6, 10, 128, 128), (3, 5, 128, 128),
                                   (2, 3, 256, 256), (3, 5, 256, 128),
                                   (6, 10, 256, 128)]
  full = tkfnet.KFNetConfig(
      oflownet=toflow.OFlowNetConfig(conv_impl="pallas_3x3"))
  assert len(tkfnet.kernel_shapes(full, first=True)["conv3x3_same"]) == 1
  assert tkfnet.kernel_shapes(full)["conv3x3_same"] == [
      (60, 80, 128, 128), (60, 80, 128, 128), (30, 40, 128, 128),
      (15, 20, 256, 256), (30, 40, 256, 128), (60, 80, 256, 128)]


def test_oflownet_encode_matches_jax(oflow_params):
  img = np.random.default_rng(3).uniform(0, 1, (48, 80, 3)).astype(
      np.float32)
  with pallas_interpret():
    want = joflow.encode(oflow_params, small_oflow(joflow), jnp.asarray(img))
  with kernel_spies() as spy:
    got = toflow.encode(convert.params_from_jax(oflow_params),
                        small_oflow(toflow), torch.from_numpy(img))
  assert spy["conv3x3_same"].call_count == 1
  # bf16 features: one rounding step
  np.testing.assert_allclose(f32(got), f32(want), rtol=BF16_STEP,
                             atol=BF16_STEP)


def test_oflownet_decode_matches_jax(oflow_params):
  cv = np.random.default_rng(4).normal(size=(6, 10, 25)).astype(np.float32)
  with pallas_interpret():
    fj, wj = joflow.decode(oflow_params, small_oflow(joflow), jnp.asarray(cv))
  tcfg = small_oflow(toflow)
  with kernel_spies() as spy:
    ft, wt = toflow.decode(convert.params_from_jax(oflow_params), tcfg,
                           torch.from_numpy(cv))
  assert spy["conv3x3_same"].call_count == 5
  # measured: flow 1.1e-6, W rel 1.0e-6 (my CPU run)
  np.testing.assert_allclose(f32(ft), f32(fj), rtol=0, atol=5e-6)
  np.testing.assert_allclose(f32(wt), f32(wj), rtol=5e-6, atol=1e-7)
  # the same decoder batched takes the xla path, exactly
  fx, wx = toflow.decode(convert.params_from_jax(oflow_params),
                         small_oflow(toflow, "xla"), torch.from_numpy(cv)[None])
  fb, wb = toflow.decode(convert.params_from_jax(oflow_params), tcfg,
                         torch.from_numpy(cv)[None])
  assert torch.equal(fb, fx) and torch.equal(wb, wx)


# ------------------------------------------------------------ whole slice


def slice_config(mods, dtype="float32"):
  scoord, oflow, kf = mods
  return kf.KFNetConfig(
      scoordnet=scoord.SCoordNetConfig(
          channels=(8, 16, 128, 128), strides=(2, 2, 2, 1),
          head_channels=128, stem_s2d=1, compute_dtype=dtype,
          conv_impl="pallas_fused"),
      oflownet=oflow.OFlowNetConfig(
          encoder_channels=(8, 16, 128, 128), encoder_strides=(2, 2, 2, 1),
          search_radius=2, stem_s2d=1, compute_dtype=dtype,
          conv_impl="pallas_3x3"))


def test_slice_two_filter_steps_match_jax():
  jcfg = slice_config((jscoord, joflow, jkfnet))
  tcfg = slice_config((tscoord, toflow, tkfnet))
  jparams = jkfnet.init(jax.random.key(0), jcfg, (48, 64, 3))
  tparams = to_port(jparams)
  imgs = np.random.default_rng(0).uniform(0, 1, (3, 48, 64, 3)).astype(
      np.float32)
  with pallas_interpret():
    x, P, feat = jkfnet.first_step(jparams, jcfg, jnp.asarray(imgs[0]))
    for img in imgs[1:]:
      x, P, feat, aux_j = jkfnet.filter_step(jparams, jcfg, x, P, feat,
                                             jnp.asarray(img))
  with kernel_spies() as spy:
    xt, Pt, ft = tkfnet.first_step(tparams, tcfg, torch.from_numpy(imgs[0]))
    for img in imgs[1:]:
      xt, Pt, ft, aux_t = tkfnet.filter_step(tparams, tcfg, xt, Pt, ft,
                                             torch.from_numpy(img))
  first = tkfnet.kernel_shapes(tcfg, (48, 64, 3), first=True)
  later = tkfnet.kernel_shapes(tcfg, (48, 64, 3))
  for name, mock_fn in spy.items():
    assert mock_fn.call_count == len(first[name]) + 2 * len(later[name])
  assert spy["conv3x3_gn_chain"].call_count == 6   # 2 a frame
  assert spy["conv3x3_same"].call_count == 13      # 1, then 6 a frame
  np.testing.assert_allclose(f32(aux_t["z"]), f32(aux_j["z"]), rtol=0,
                             atol=1.5e-2)
  np.testing.assert_allclose(f32(aux_t["V"]), f32(aux_j["V"]), rtol=1.5e-2)
  np.testing.assert_allclose(f32(aux_t["flow"]), f32(aux_j["flow"]), rtol=0,
                             atol=3.5e-2)
  np.testing.assert_allclose(f32(aux_t["W"]), f32(aux_j["W"]), rtol=2e-2)
  np.testing.assert_allclose(f32(xt), f32(x), rtol=0, atol=1.5e-2)
  np.testing.assert_allclose(f32(Pt), f32(P), rtol=1.5e-2)
  assert np.array_equal(aux_t["consistent"].numpy(),
                        np.asarray(aux_j["consistent"]))


# ------------------------------------------------ no backward, launch plan


def _small_conv(cin=128, cout=128, h=4, w=5, seed=0):
  gen = torch.Generator().manual_seed(seed)
  x = torch.randn((h, w, cin), generator=gen).to(torch.bfloat16)
  wt = torch.randn((cout, cin, 3, 3), generator=gen) * 0.05
  return x, wt, torch.ones(cin), torch.zeros(cin)


@pytest.mark.parametrize("which", ["x", "w", "scale"])
def test_conv_wrappers_refuse_grad(which):
  # the Pallas kernels have no VJP; the wrappers refuse what autograd would
  # record, on any device, so the CPU's plain version behaves as the kernel
  x, wt, scale, shift = _small_conv()
  t = {"x": x, "w": wt, "scale": scale}[which]
  t.requires_grad_(True)
  if which != "scale":
    with pytest.raises(RuntimeError, match="no backward"):
      tc3.conv3x3_same(x, wt)
  with pytest.raises(RuntimeError, match="no backward"):
    tc3.conv3x3_gn_chain(x, scale, shift, wt)
  with torch.no_grad():  # serving: the same tensors under no_grad run
    y = tc3.conv3x3_same(x, wt)
    y2, s1, _ = tc3.conv3x3_gn_chain(x, scale, shift, wt)
  assert y.shape == y2.shape == (4, 5, 128) and s1.shape == (128,)
  t.requires_grad_(False)  # plain tensors run with grad mode on
  torch.testing.assert_close(tc3.conv3x3_same(x, wt), y, rtol=0, atol=0)
  torch.testing.assert_close(tc3.conv3x3_gn_chain(x, scale, shift, wt)[0],
                             y2, rtol=0, atol=0)


@pytest.mark.parametrize("h,w,cin,cout,chain,want", [
    # the conv-kernel configuration's shapes at 640x480 (kernel_shapes)
    (60, 80, 128, 256, True, (2, 1, 40)),
    (60, 80, 256, 256, True, (2, 1, 40)),
    (60, 80, 256, 512, True, (1, 1, 80)),
    (60, 80, 512, 512, True, (1, 1, 80)),
    (60, 80, 128, 128, False, (1, 1, 80)),
    (60, 80, 256, 128, False, (1, 1, 80)),
    (30, 40, 128, 128, False, (1, 1, 20)),
    (30, 40, 256, 128, False, (1, 4, 20)),
    (15, 20, 256, 256, False, (1, 4, 6)),
    (17, 23, 256, 128, False, (1, 4, 9)),
    (17, 23, 256, 128, True, (1, 1, 9)),
])
def test_plan_at_main_path_shapes(h, w, cin, cout, chain, want):
  p = tc3.plan(h, w, cin, cout, chain=chain)
  assert tuple(p) == want
  chunks = cin // tc3.CIN_STEP
  n_tiles = cout // tc3.COUT_TILE
  one_wg = tc3.plan(h, w, cin, cout, chain=chain, wgs=1, splits=1)
  two_wg = tc3.plan(h, w, cin, cout, chain=chain, wgs=2, splits=1)
  # two warpgroups only where one gives more than a wave and two do not
  assert (p.wgs == 2) == (one_wg.tiles * n_tiles > tc3.FILL_BLOCKS
                          >= two_wg.tiles * n_tiles)
  # single-chunk splits where there are four or more chunks and the split
  # units still fit one pass of the card; else none
  split = (not chain and chunks >= 4
           and p.tiles * n_tiles * chunks <= tc3.FILL_BLOCKS)
  assert p.splits == (chunks if split else 1)


def test_conv_tiles_main_path_shapes():
  # the tool and the card tests time and check the shapes kernel_shapes
  # gives for one filter step of the conv-kernel configuration
  from kfnet_tpu_torch.tools import conv_tiles
  same, chain = conv_tiles.main_path_shapes()
  assert same == [(60, 80, 128, 128), (30, 40, 128, 128), (15, 20, 256, 256),
                  (30, 40, 256, 128), (60, 80, 256, 128)]
  assert chain == [(60, 80, 128, 256), (60, 80, 256, 256), (60, 80, 256, 512),
                   (60, 80, 512, 512)]
  for shape in same:
    plans = conv_tiles.candidates(*shape, chain=False)
    assert tc3.plan(*shape) in plans
    assert {p.wgs for p in plans} == {1, 2}
    assert {p.splits for p in plans} == {
        s for s in range(1, shape[2] // 64 + 1) if (shape[2] // 64) % s == 0}
  for shape in chain:
    assert [p.splits for p in conv_tiles.candidates(*shape, chain=True)] == [
        1, 1]
  # the bound: 2·h·w·9·cin·cout operations at 989 TFLOP/s, or the bytes
  ms, by = conv_tiles.bound_ms(60, 80, 512, 512, chain=True)
  assert by == "operations"
  assert ms == pytest.approx(2 * 4800 * 9 * 512 * 512 / 989e12 * 1e3)
  ms, by = conv_tiles.bound_ms(15, 20, 256, 256)
  assert by == "bytes"
  assert ms == pytest.approx((300 * 256 * 2 * 2 + 9 * 256 * 256 * 2)
                             / 3.35e12 * 1e3)


def test_plan_overrides_and_refusals():
  assert tc3.plan(60, 80, 512, 512, chain=True, wgs=2) == (2, 1, 40)
  assert tc3.plan(15, 20, 256, 256, wgs=2, splits=2) == (2, 2, 3)
  assert tc3.plan(60, 80, 128, 128, splits=2).splits == 2
  with pytest.raises(ValueError, match="divide"):
    tc3.plan(60, 80, 256, 128, splits=3)
  with pytest.raises(ValueError, match="chain"):
    tc3.plan(60, 80, 256, 128, chain=True, splits=2)
  with pytest.raises(ValueError, match="warpgroups"):
    tc3.plan(60, 80, 256, 128, wgs=3)
  # the fill rules follow the card's SM count where the caller gives it
  assert tc3.plan(60, 80, 128, 256, chain=True).wgs == 2
  assert tc3.plan(60, 80, 128, 256, chain=True, sms=200).wgs == 1
  assert tc3.plan(15, 20, 256, 256).splits == 4
  assert tc3.plan(15, 20, 256, 256, sms=40).splits == 1
  # 8 x 8-pixel tiles per warpgroup, counted over the map's rectangle
  for h, w in ((1, 1), (8, 8), (9, 17), (60, 80)):
    for wgs in (1, 2):
      p = tc3.plan(h, w, 128, 128, chain=True, wgs=wgs)
      assert p.tiles == -(-h // (tc3.WG_ROWS * wgs)) * -(-w // tc3.TILE_W)


# ------------------------------------------------- prepared weight layout


def test_prepared_weights_layout_and_reuse():
  _, wt, _, _ = _small_conv(cin=64, cout=128)
  wk = tc3.prepared_weights(wt)
  assert wk.dtype == torch.bfloat16 and wk.shape == (128, 9 * 64)
  assert wk.is_contiguous()
  # K = (3*dy + dx)*cin + c
  want = wt.to(torch.bfloat16).permute(0, 2, 3, 1).reshape(128, 9 * 64)
  assert torch.equal(wk, want)
  assert tc3.prepared_weights(wt) is wk  # one copy per weight tensor


@pytest.mark.parametrize("update", ["copy_", "mul_", "setitem", "no_grad"])
def test_prepared_weights_follow_in_place_updates(update):
  _, wt, _, _ = _small_conv(cin=64, cout=128, seed=1)
  old = tc3.prepared_weights(wt)
  if update == "copy_":
    wt.copy_(torch.randn(wt.shape))
  elif update == "mul_":
    wt.mul_(-2.0)
  elif update == "setitem":
    wt[3, 5, 1, 2] = 7.0
  else:
    with torch.no_grad():
      wt.add_(1.0)
  new = tc3.prepared_weights(wt)
  assert new is not old
  want = wt.to(torch.bfloat16).permute(0, 2, 3, 1).reshape(128, 9 * 64)
  assert torch.equal(new, want)


def test_prepared_weights_die_with_their_tensor():
  import gc
  _, wt, _, _ = _small_conv(cin=64, cout=128, seed=2)
  tc3.prepared_weights(wt)
  key = id(wt)
  assert key in tc3._prepared
  del wt
  gc.collect()
  assert key not in tc3._prepared
  # a new tensor never meets another's copy, even at a reused id
  for seed in range(3):
    _, w2, _, _ = _small_conv(cin=64, cout=128, seed=seed)
    want = w2.to(torch.bfloat16).permute(0, 2, 3, 1).reshape(128, 9 * 64)
    assert torch.equal(tc3.prepared_weights(w2), want)
    del w2


def test_weights_updated_in_place_reach_layer_and_model_outputs():
  # the layer and the relocaliser read the weights they hold now: an
  # in-place update, or new params, changes what comes out
  from kfnet_tpu_torch.eval.online import OnlineRelocalizer
  layer = tL.conv(128, 3, 1, impl="pallas_3x3")
  params, _ = layer.init(torch.Generator().manual_seed(0), (6, 7, 128),
                         "cpu")
  x = torch.randn((1, 128, 6, 7)).contiguous(
      memory_format=torch.channels_last)
  y0 = layer.apply(params, x)
  with torch.no_grad():
    params["w"].mul_(0.5)
  y1 = layer.apply(params, x)
  assert not torch.equal(y0, y1)
  torch.testing.assert_close(
      y1, tL.conv(128, 3, 1, impl="pallas_3x3").apply(
          {k: v.clone() for k, v in params.items()}, x), rtol=0, atol=0)
  assert torch.equal(tc3.prepared_weights(params["w"]),
                     params["w"].to(torch.bfloat16).permute(0, 2, 3, 1)
                     .reshape(128, 9 * 128))

  cfg = tkfnet.KFNetConfig(
      scoordnet=tscoord.SCoordNetConfig(
          channels=(8, 16, 128, 128), strides=(2, 2, 2, 1),
          head_channels=128, stem_s2d=1, conv_impl="pallas_fused"),
      oflownet=toflow.OFlowNetConfig(
          encoder_channels=(8, 16, 128, 128), encoder_strides=(2, 2, 2, 1),
          search_radius=2, stem_s2d=1, conv_impl="pallas_3x3"))
  img = (48, 64, 3)
  frames = np.random.default_rng(0).integers(0, 256, (2,) + img,
                                             dtype=np.uint8)
  K = np.asarray([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)

  def run(p):
    reloc = OnlineRelocalizer(p, cfg, K, solve_pose=False, device="cpu")
    for f in frames:
      reloc.process(f)
    return [t.clone() for t in reloc.state[:2]]

  params = tkfnet.init(0, cfg, img, device="cpu")
  before = run(params)
  # the head block's conv: the last conv3x3_gn_chain call of the trunk
  trunk_w = params["scoordnet"][len(cfg.scoordnet.channels)][0]["w"]
  with torch.no_grad():
    trunk_w.mul_(1.5)
  after = run(params)
  assert not torch.equal(before[0], after[0])
  fresh = run(tL.tree_map(lambda t: t.clone(), params))  # new params
  for a, b in zip(after, fresh):
    assert torch.equal(a, b)
