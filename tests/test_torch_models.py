"""The port's models against the JAX package on the tiny configs of
tests/tiny_configs.py (float32), with JAX-initialised weights converted by
convert.params_from_jax.

Tolerances: the tiny-config goldens at rtol 5e-4 / atol 5e-5, those of
tests/test_goldens.py; single modules at rtol 1e-4 / atol 2e-5 (float32
convolutions summed in another order).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfnet_tpu.kernels import cost_volume as jcv
from kfnet_tpu.models import kfnet as jkfnet
from kfnet_tpu.models import oflownet as joflow
from kfnet_tpu.models import scoordnet as jscoord
from kfnet_tpu_torch import convert
from kfnet_tpu_torch.kernels import cost_volume as tcv
from kfnet_tpu_torch.models import kfnet as tkfnet
from kfnet_tpu_torch.models import oflownet as toflow
from kfnet_tpu_torch.models import scoordnet as tscoord
from tests import tiny_configs as tc

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "goldens")
GOLDENS = {"group": "kfnet_tiny_forward.npz",
           "none": "kfnet_tiny_forward_nonorm.npz"}
TOL = dict(rtol=1e-4, atol=2e-5)


def port_config(jcfg, use_fused_kernel=True):
  """The port's config with the same fields as a JAX KFNetConfig."""
  return tkfnet.KFNetConfig(
      scoordnet=tscoord.SCoordNetConfig(
          **dataclasses.asdict(jcfg.scoordnet)),
      oflownet=toflow.OFlowNetConfig(**dataclasses.asdict(jcfg.oflownet)),
      chi2_threshold=jcfg.chi2_threshold, invalid_cov=jcfg.invalid_cov,
      use_fused_kernel=use_fused_kernel, w_scale=jcfg.w_scale,
      adaptive_alpha_max=jcfg.adaptive_alpha_max)


def jax_cfg(norm="group", **kw):
  cfg = tc.tiny_kfnet(**kw)
  return dataclasses.replace(
      cfg,
      scoordnet=dataclasses.replace(cfg.scoordnet, norm=norm),
      oflownet=dataclasses.replace(cfg.oflownet, norm=norm))


def both_params(jcfg, seed):
  jparams = jkfnet.init(jax.random.key(seed), jcfg, tc.IMG)
  return jparams, convert.params_from_jax(
      jax.tree_util.tree_map(np.asarray, jparams))


def t(a):
  return torch.from_numpy(np.array(a))


def close(got, want, **tol):
  np.testing.assert_allclose(got.detach().numpy(), np.asarray(want),
                             **(tol or TOL))


def run_port(tparams, tcfg, imgs):
  """Frame 0 measurement-only, then filter steps: the sequence
  kfnet_tpu.filter.sequence.run_filter computes."""
  x, P, feat = tkfnet.first_step(tparams, tcfg, imgs[0])
  xs, Ps = [x], [P]
  for img in imgs[1:]:
    x, P, feat, _ = tkfnet.filter_step(tparams, tcfg, x, P, feat, img)
    xs.append(x)
    Ps.append(P)
  return torch.stack(xs), torch.stack(Ps)


@pytest.mark.parametrize("use_fused_kernel", [True, False])
@pytest.mark.parametrize("norm", sorted(GOLDENS))
def test_reproduces_goldens(norm, use_fused_kernel):
  jcfg = jax_cfg(norm)
  _, tparams = both_params(jcfg, 42)
  tcfg = port_config(jcfg, use_fused_kernel)
  imgs = t(tc.random_images(3, seed=42))
  xs, Ps = run_port(tparams, tcfg, imgs)
  z, V = tkfnet.measure(tparams, tcfg, imgs[0])
  with np.load(os.path.join(GOLDEN_DIR, GOLDENS[norm])) as want:
    for k, got in (("xs", xs), ("Ps", Ps), ("z", z), ("V", V)):
      np.testing.assert_allclose(got.numpy(), want[k], rtol=5e-4, atol=5e-5,
                                 err_msg=f"golden {k} (norm={norm})")


@pytest.mark.parametrize("norm", ["group", "none", "ws"])
def test_scoordnet_apply(norm):
  jcfg = dataclasses.replace(tc.tiny_scoordnet(), norm=norm,
                             coord_offset=(0.5, -1.0, 2.0), coord_scale=1.5)
  tcfg = tscoord.SCoordNetConfig(**dataclasses.asdict(jcfg))
  jp = jscoord.init(jax.random.key(1), jcfg, tc.IMG)
  tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
  img = tc.random_images(2, seed=1)
  jz, jV = jscoord.apply(jp, jcfg, img)
  tz, tV = tscoord.apply(tp, tcfg, t(img))
  assert tz.shape == (2, 6, 8, 3) and tV.shape == (2, 6, 8, 1)
  close(tz, jz)
  close(tV, jV)


def test_scoordnet_uint8_ingest():
  jcfg = tc.tiny_scoordnet()
  tcfg = tscoord.SCoordNetConfig(**dataclasses.asdict(jcfg))
  jp = jscoord.init(jax.random.key(2), jcfg, tc.IMG)
  tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
  img = np.random.default_rng(2).integers(0, 256, tc.IMG).astype(np.uint8)
  jz, jV = jscoord.apply(jp, jcfg, jnp.asarray(img))
  tz, tV = tscoord.apply(tp, tcfg, torch.from_numpy(img))
  close(tz, jz)
  close(tV, jV)


def test_adjusted_strides_match():
  for strides, f in [((1, 2, 1, 2, 1, 2), 2), ((2, 1, 2, 1, 2, 1), 2),
                     ((2, 2, 2), 4), ((1, 2, 2, 2), 8), ((2, 2), 1)]:
    assert (tscoord._adjusted_strides(strides, f)
            == jscoord._adjusted_strides(strides, f))


def test_oflownet_encode_cost_volume_decode():
  jcfg = tc.tiny_oflownet()
  tcfg = toflow.OFlowNetConfig(**dataclasses.asdict(jcfg))
  jp = joflow.init(jax.random.key(3), jcfg, tc.IMG)
  tp = convert.params_from_jax(jax.tree_util.tree_map(np.asarray, jp))
  imgs = tc.random_images(2, seed=3)
  jf = [joflow.encode(jp, jcfg, imgs[i]) for i in range(2)]
  tf = [toflow.encode(tp, tcfg, t(imgs[i])) for i in range(2)]
  for g, w in zip(tf, jf):
    close(g, w)
  jv = jcv.cost_volume(jf[0], jf[1], jcfg.search_radius)
  tv = tcv.cost_volume(tf[0], tf[1], tcfg.search_radius)
  assert tv.shape == (6, 8, 25)
  close(tv, jv)
  jflow, jW = joflow.decode(jp, jcfg, jv)
  tflow, tW = toflow.decode(tp, tcfg, tv)
  close(tflow, jflow)
  close(tW, jW)
  close(toflow.apply(tp, tcfg, t(imgs[0]), t(imgs[1]))[0],
        joflow.apply(jp, jcfg, imgs[0], imgs[1])[0])


@pytest.mark.parametrize("r", [1, 3])
def test_cost_volume_channel_order_and_border(r):
  rng = np.random.default_rng(r)
  prev = rng.normal(size=(2, 5, 7, 4)).astype(np.float32)
  cur = rng.normal(size=(2, 5, 7, 4)).astype(np.float32)
  want = jcv.cost_volume(jnp.asarray(prev), jnp.asarray(cur), r)
  got = tcv.cost_volume(t(prev), t(cur), r)
  close(got, want, rtol=1e-5, atol=1e-6)
  # channel (dy+r)(2r+1)+(dx+r) correlates cur at p with prev at p+(dx,dy)
  dy, dx = 1, -1
  k = (dy + r) * (2 * r + 1) + (dx + r)
  np.testing.assert_allclose(
      got[0, 2, 3, k].item(), float(np.dot(cur[0, 2, 3], prev[0, 3, 2])) / 4,
      rtol=1e-5)
  assert got[0, 0, 0, 0].item() == 0.0  # outside the frame


def test_cost_volume_bf16_operands_multiply_in_f32():
  rng = np.random.default_rng(0)
  a = torch.from_numpy(rng.normal(size=(4, 5, 8)).astype(np.float32))
  b = torch.from_numpy(rng.normal(size=(4, 5, 8)).astype(np.float32))
  got = tcv.cost_volume(a.bfloat16(), b.bfloat16(), 1)
  want = tcv.cost_volume(a.bfloat16().float(), b.bfloat16().float(), 1)
  assert got.dtype == torch.float32
  assert torch.equal(got, want)


@pytest.mark.parametrize("use_fused_kernel", [True, False])
def test_first_and_filter_steps_match_jax(use_fused_kernel):
  jcfg = jax_cfg()
  jparams, tparams = both_params(jcfg, 11)
  tcfg = port_config(jcfg, use_fused_kernel)
  imgs = tc.random_images(3, seed=11)
  jx, jP, jfeat = jkfnet.first_step(jparams, jcfg, imgs[0])
  tx, tP, tfeat = tkfnet.first_step(tparams, tcfg, t(imgs[0]))
  close(tx, jx)
  close(tP, jP)
  close(tfeat, jfeat)
  for i in (1, 2):
    jx, jP, jfeat, jaux = jkfnet.filter_step(jparams, jcfg, jx, jP, jfeat,
                                             imgs[i])
    tx, tP, tfeat, taux = tkfnet.filter_step(tparams, tcfg, tx, tP, tfeat,
                                             t(imgs[i]))
    close(tx, jx, rtol=5e-4, atol=5e-5)
    close(tP, jP, rtol=5e-4, atol=5e-5)
    close(tfeat, jfeat)
    for k in ("flow", "W", "z", "V"):
      close(taux[k], jaux[k])
    np.testing.assert_array_equal(taux["consistent"].numpy(),
                                  np.asarray(jaux["consistent"]))
    assert ("x_prior" in taux) == (not use_fused_kernel)
    if not use_fused_kernel:  # carries the previous step's error too
      close(taux["x_prior"], jaux["x_prior"], rtol=5e-4, atol=5e-5)
      close(taux["P_prior"], jaux["P_prior"], rtol=5e-4, atol=5e-5)


def test_adaptive_inflation_matches_jax():
  jcfg = jax_cfg(adaptive_alpha_max=4.0)
  jparams, tparams = both_params(jcfg, 12)
  tcfg = port_config(jcfg)  # the adaptive path takes the composition
  imgs = tc.random_images(2, seed=12)
  jx, jP, jf = jkfnet.first_step(jparams, jcfg, imgs[0])
  # a prior that disagrees with the measurement, so alpha > 1
  jx = jx + 0.5
  tx, tP, tf = t(jx), t(jP), t(jf)
  jout = jkfnet.filter_step(jparams, jcfg, jx, jP, jf, imgs[1])
  tout = tkfnet.filter_step(tparams, tcfg, tx, tP, tf, t(imgs[1]))
  close(tout[0], jout[0], rtol=5e-4, atol=5e-5)
  close(tout[1], jout[1], rtol=5e-4, atol=5e-5)
  close(tout[3]["P_prior"], jout[3]["P_prior"], rtol=5e-4, atol=5e-5)


def test_config_defaults_mirror_jax():
  j, p = jkfnet.KFNetConfig(), tkfnet.KFNetConfig()
  assert dataclasses.asdict(p.scoordnet) == dataclasses.asdict(j.scoordnet)
  assert dataclasses.asdict(p.oflownet) == dataclasses.asdict(j.oflownet)
  for f in ("chi2_threshold", "invalid_cov", "w_scale",
            "adaptive_alpha_max"):
    assert getattr(p, f) == getattr(j, f)
  assert p.use_fused_kernel and not j.use_pallas
  with pytest.raises(ValueError):
    tkfnet.KFNetConfig(adaptive_alpha_max=0.5)


def test_init_needs_a_device_without_cuda(monkeypatch):
  monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
  with pytest.raises(RuntimeError):
    tkfnet.init(0, port_config(jax_cfg()), tc.IMG)
  params = tkfnet.init(0, port_config(jax_cfg()), tc.IMG, device="cpu")
  assert params["scoordnet"][0][0]["w"].device.type == "cpu"
