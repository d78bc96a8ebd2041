"""Width-sharded filtering (kfnet_tpu_torch/parallel/spatial.py) on an
8-entry CPU mesh, the cases of tests/test_spatial_sharding.py: the cost
volume with its halo exchange, the whole filter with W sharded 8 ways
(2 columns a shard at 1/8 resolution, so the warp's and the U-Net's halos
span several shards and the U-Net's coarsest maps leave shards empty),
against the port's unsharded functions and against the JAX package's.

Tolerances: the cost volume rtol = atol = 1e-6 (tests/test_spatial_sharding.py);
the filter against the unsharded port x atol 2e-5, P rtol 3e-5 / atol
1e-6 (the same file), against the JAX package's spatial filter at the
goldens' rtol 5e-4 / atol 5e-5; a use_fused_kernel config against the
composition atol 5e-4 with a median under 2e-5 (the JAX test's); the
layers against their unsharded forms rtol = atol = 1e-6 (float32 sums in
another order); the warp bit-equal (the same arithmetic on the same
values).
"""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kfnet_tpu.kernels.cost_volume import cost_volume as jcost_volume
from kfnet_tpu.models import kfnet as jkfnet
from kfnet_tpu.models import oflownet as joflow
from kfnet_tpu.models import scoordnet as jscoord
from kfnet_tpu.parallel import mesh as jmesh
from kfnet_tpu.parallel import spatial as jspatial
from kfnet_tpu_torch import convert
from kfnet_tpu_torch.core import warp as twarp
from kfnet_tpu_torch.kernels import conv3x3 as c3
from kfnet_tpu_torch.filter import sequence as tseq
from kfnet_tpu_torch.models import kfnet as tkfnet
from kfnet_tpu_torch.models import oflownet as toflow
from kfnet_tpu_torch.models import scoordnet as tscoord
from kfnet_tpu_torch.nn import layers as L
from kfnet_tpu_torch.parallel import mesh as tmesh
from kfnet_tpu_torch.parallel import spatial as tspatial
from tests import tiny_configs as tc
from tests.test_torch_conv3x3 import pallas_interpret
from tests.test_torch_models import port_config

GOLDEN = dict(rtol=5e-4, atol=5e-5)
TIGHT = dict(rtol=1e-6, atol=1e-6)
WIDE = (48, 128, 3)  # 1/8-res width 16: 2 columns a shard over 8


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def mesh():
  return tmesh.Mesh(["cpu"] * 8)


def images(n, seed):
  return np.asarray(tc.random_images(n, seed=seed, shape=WIDE))


@pytest.fixture(scope="module")
def setup():
  jcfg = tc.tiny_kfnet()
  jparams = jkfnet.init(jax.random.key(0), jcfg, WIDE)
  params = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          jparams))
  return jcfg, jparams, port_config(jcfg, use_fused_kernel=False), params


@pytest.mark.parametrize("radius", [0, 1, 2, 4])
def test_cost_volume_halo_exchange_matches_unsharded(mesh, radius):
  """W sharded 8 ways, 4 columns a shard: every correlation whose window
  crosses a shard boundary sees its neighbour's columns."""
  rng = np.random.default_rng(0)
  h, w, c = 12, 32, 16
  fp = rng.normal(size=(h, w, c)).astype(np.float32)
  fc = rng.normal(size=(h, w, c)).astype(np.float32)
  out = tspatial.cost_volume_spatial(torch.from_numpy(fp),
                                     torch.from_numpy(fc), radius, mesh)
  assert len(out.shards) == 8
  assert all(s.shape == (h, 4, (2 * radius + 1) ** 2) for s in out.shards)
  np.testing.assert_allclose(out.full().numpy(),
                             np.asarray(jcost_volume(fp, fc, radius)),
                             **TIGHT)


def test_cost_volume_spatial_refuses_a_radius_past_one_neighbour(mesh):
  x = torch.zeros(8, 32, 8)
  with pytest.raises(ValueError, match="radius <= W/n_shards"):
    tspatial.cost_volume_spatial(x, x, 5, mesh)
  with pytest.raises(ValueError, match="axis"):
    tspatial.cost_volume_spatial(x, x, 1, mesh, axis_name="model")


def test_halo_exchange_spans_neighbours_and_zero_fills(mesh):
  x = tmesh.split(mesh, torch.arange(16.0).reshape(1, 16, 1), axis=-2)
  ext = tspatial._halo_exchange_w(x, 3)
  assert ext.shards[0][0, :, 0].tolist() == [0, 0, 0, 0, 1, 2, 3, 4]
  assert ext.shards[4][0, :, 0].tolist() == [5, 6, 7, 8, 9, 10, 11, 12]
  assert ext.shards[7][0, :, 0].tolist() == [11, 12, 13, 14, 15, 0, 0, 0]
  with pytest.raises(ValueError, match="empty halo"):
    tspatial._halo_exchange_w(x, 0)


def test_full_filter_spatially_sharded_matches_single_device_and_jax(
    mesh, setup):
  """The whole filter (convs, GroupNorm, cost volume, U-Net, warp, Kalman)
  with W sharded 8 ways against the unsharded port and against the JAX
  package's GSPMD filter on its 8-device mesh."""
  jcfg, jparams, cfg, params = setup
  imgs = images(4, 5)
  xs_ref, Ps_ref, _ = tseq.run_filter(params, cfg, imgs, device="cpu")
  xs, Ps = tspatial.run_filter_spatial(params, cfg, imgs, mesh)
  assert len(xs.shards) == 8
  assert all(s.shape == (4, 6, 2, 3) for s in xs.shards)
  np.testing.assert_allclose(xs.full().numpy(), xs_ref.numpy(), atol=2e-5)
  np.testing.assert_allclose(Ps.full().numpy(), Ps_ref.numpy(), rtol=3e-5,
                             atol=1e-6)
  jxs, jPs = jspatial.run_filter_spatial(jparams, jcfg, imgs,
                                         jmesh.make_mesh(8))
  np.testing.assert_allclose(xs.full().numpy(), np.asarray(jxs), **GOLDEN)
  np.testing.assert_allclose(Ps.full().numpy(), np.asarray(jPs), **GOLDEN)


def test_run_filter_spatial_places_params_once(mesh, setup):
  """Repeat calls reuse the placed params (the counterpart of
  ``_spatial_jit``'s cache): the second call is a hit and copies
  nothing."""
  _, _, cfg, params = setup
  imgs = images(3, 9)
  cache = tspatial._spatial_params
  a = tspatial.run_filter_spatial(params, cfg, imgs, mesh)
  hits, copies = cache.hits, cache.copies
  b = tspatial.run_filter_spatial(params, cfg, imgs, mesh)
  assert cache.hits == hits + 1 and cache.copies == copies
  assert torch.equal(a[0].full(), b[0].full())


def test_spatial_filter_fused_kernel_config_runs_the_composition(mesh,
                                                                 setup):
  """use_fused_kernel under W-sharding runs the composition (the kernel
  reads whole maps) and still matches the unsharded composition."""
  _, _, cfg, params = setup
  imgs = images(3, 9)
  ref, _, _ = tseq.run_filter(params, cfg, imgs, device="cpu")
  fused = dataclasses.replace(cfg, use_fused_kernel=True)
  xs, _ = tspatial.run_filter_spatial(params, fused, imgs, mesh)
  diff = np.abs(xs.full().numpy() - ref.numpy())
  assert diff.max() <= 5e-4 and float(np.median(diff)) < 2e-5


def test_adaptive_inflation_reduces_across_shards(mesh, setup):
  """adaptive_alpha_max > 1: the update of W-sharded maps takes the
  map-wide mean of the inflation over every shard's warp-valid pixels (one
  α for the map, here well above 1), equal to the unsharded update."""
  _, _, cfg, _ = setup
  cfg = dataclasses.replace(cfg, adaptive_alpha_max=8.0)
  rng = np.random.default_rng(4)
  h, w = 6, 16

  def t(*shape, lo=None, hi=None):
    a = (rng.uniform(lo, hi, shape) if lo is not None
         else rng.normal(size=shape))
    return torch.from_numpy(a.astype(np.float32))

  x, P = t(h, w, 3), t(h, w, 1, lo=0.01, hi=0.05)
  flow, W = t(h, w, 2, lo=-2.5, hi=2.5), t(h, w, 1, lo=0.01, hi=0.05)
  z, V = x + t(h, w, 3), t(h, w, 1, lo=0.01, hi=0.05)
  want = tkfnet._composed_update(cfg, x, P, flow, W, z, V)
  shard = lambda a: tmesh.split(mesh, a, axis=-2)
  xs, Ps = tspatial._update(cfg, shard(x), shard(P),
                            *(shard(a).shards for a in (flow, W, z, V)))
  np.testing.assert_allclose(torch.cat(xs, 1).numpy(), want[0].numpy(),
                             **TIGHT)
  np.testing.assert_allclose(torch.cat(Ps, 1).numpy(), want[1].numpy(),
                             **TIGHT)
  plain = tkfnet._composed_update(dataclasses.replace(
      cfg, adaptive_alpha_max=0.0), x, P, flow, W, z, V)
  alpha = want[3][1] / plain[3][1]
  assert float(alpha.min()) > 2.0  # the inflation took effect


def test_groupnorm_across_shards_equals_unsharded(mesh):
  gn = L.group_norm()
  rng = np.random.default_rng(2)
  x = torch.from_numpy(rng.normal(1.0, 2.0, (1, 64, 6, 16)).astype(
      np.float32))
  params = {"scale": torch.from_numpy(rng.uniform(0.5, 2, 64).astype(
      np.float32)), "bias": torch.from_numpy(rng.normal(size=64).astype(
          np.float32))}
  out = gn.apply(params, tmesh.split(mesh, x, axis=-1))
  np.testing.assert_allclose(out.full().numpy(), gn.apply(params, x).numpy(),
                             **TIGHT)
  # a shard's own moments are not the map's
  alone = gn.apply(params, x[..., :2])
  assert not torch.allclose(alone, out.shards[0], atol=1e-3)


@pytest.mark.parametrize("width,kind", [(16, "conv3_s1"), (16, "conv3_s2"),
                                        (8, "conv3_s2"), (8, "convT"),
                                        (4, "convT"), (16, "conv1")])
def test_sharded_convs_equal_unsharded(mesh, width, kind):
  """Each conv on W-sharded input: stride 2 on 1-column shards (half the
  shards empty after it), the transposed conv on shards that are empty."""
  layer = {"conv3_s1": L.conv(8, 3, 1, compute_dtype="float32"),
           "conv3_s2": L.conv(8, 3, 2, compute_dtype="float32"),
           "conv1": L.conv(8, 1, 1, compute_dtype="float32"),
           "convT": L.conv_transpose(8, 4, 2, compute_dtype="float32")}[kind]
  gen = torch.Generator().manual_seed(0)
  params, _ = layer.init(gen, (6, width, 5), "cpu")
  params = L.tree_map(lambda p: p + 0.1 * torch.randn(
      p.shape, generator=gen), params)
  x = torch.randn((1, 5, 6, width), generator=gen)
  xs = tmesh.Sharded([x[..., b0:b1] for b0, b1 in zip(
      tmesh.even_bounds(width, 8)[:-1], tmesh.even_bounds(width, 8)[1:])],
      -1, mesh.devices)
  out = layer.apply(params, xs)
  want = layer.apply(params, x)
  assert out.bounds == tmesh.even_bounds(want.shape[-1], 8)
  np.testing.assert_allclose(out.full().numpy(), want.numpy(), **TIGHT)


def test_warp_validity_at_an_inner_shard_edge(mesh):
  """A sample that leaves its shard but not the map is valid and equal to
  the unsharded warp's; one that leaves the map is not (validity against
  the map's width, not the block's)."""
  rng = np.random.default_rng(3)
  h, w, r = 4, 16, 2
  x = torch.from_numpy(rng.normal(size=(h, w, 3)).astype(np.float32))
  P = torch.from_numpy(rng.uniform(0.5, 2, (h, w, 1)).astype(np.float32))
  flow = torch.from_numpy(rng.uniform(-r, r, (h, w, 2)).astype(np.float32))
  flow[:, 2] = torch.tensor([-2.0, 0.0])   # column 2 reads column 0,
  flow[:, 15] = torch.tensor([0.75, 0.0])  # across shard 1's edge; 15 past
                                           # the map: invalid
  W = torch.ones(h, w, 1)
  want = twarp.warp_state_cov(x, P, flow, W)
  halo = r + 1
  for i, (b0, b1) in enumerate([(0, 2), (2, 4), (14, 16)]):
    joint = tmesh.split(mesh, torch.cat([x, P], -1), axis=-2)
    blk = joint.take(b0 // 2, b0 - halo, b1 + halo)
    got = twarp.warp_state_cov(blk[..., :3], blk[..., 3:], flow[:, b0:b1],
                               W[:, b0:b1], first=b0, col0=b0 - halo,
                               width=w)
    for g, ref in zip(got, want):
      assert torch.equal(g, ref[:, b0:b1])
  assert bool(want[2][:, 2].all()) and not bool(want[2][:, 15].any())


def conv_kernel_nets(module_sc, module_of):
  """SCoordNet "pallas_fused", OFlowNet "pallas_3x3", widths of 128 so
  that the kernels take convs (1/8-res maps of 6x16: 2 columns a shard)."""
  sc = module_sc.SCoordNetConfig(
      channels=(8, 8, 16, 16, 128, 128), strides=(1, 2, 1, 2, 1, 2),
      head_channels=128, compute_dtype="float32", conv_impl="pallas_fused")
  of = module_of.OFlowNetConfig(
      encoder_channels=(8, 8, 16), encoder_strides=(2, 2, 2),
      search_radius=2, unet_channels=(8, 128, 128), compute_dtype="float32",
      conv_impl="pallas_3x3")
  return sc, of


@pytest.fixture(scope="module")
def conv_setup():
  sc, of = conv_kernel_nets(jscoord, joflow)
  jcfg = jkfnet.KFNetConfig(scoordnet=sc, oflownet=of, use_pallas=False)
  jparams = jkfnet.init(jax.random.key(0), jcfg, WIDE)
  params = convert.params_from_jax(jax.tree_util.tree_map(np.asarray,
                                                          jparams))
  return jcfg, jparams, port_config(jcfg, use_fused_kernel=False), params


def test_conv_kernel_config_keeps_the_kernels_arithmetic(mesh, conv_setup,
                                                        monkeypatch):
  """conv_impl "pallas_fused" / "pallas_3x3": as the JAX package's mesh
  keeps its Pallas kernels, the W-sharded filter runs the kernels (the
  chain on the gathered map, conv3x3_same on each halo'd block) and stays
  at the kernel path's values (bf16 operands), far nearer to them than to
  PyTorch's convs. The float32 convs between them sum in another order,
  so a bf16 rounding flips now and then: the median is held, and the
  largest difference within 1e-2."""
  _, _, cfg, params = conv_setup
  sc, of = cfg.scoordnet, cfg.oflownet
  imgs = images(3, 5)
  kernels, _, _ = tseq.run_filter(params, cfg, imgs, device="cpu")
  xla = dataclasses.replace(
      cfg, scoordnet=dataclasses.replace(sc, conv_impl="xla"),
      oflownet=dataclasses.replace(of, conv_impl="xla"))
  convs, _, _ = tseq.run_filter(params, xla, imgs, device="cpu")
  calls = {"conv3x3_same": [], "conv3x3_gn_chain": []}
  for name in calls:
    def spy(x, *a, real=getattr(c3, name), name=name, **kw):
      calls[name].append(tuple(x.shape))
      return real(x, *a, **kw)
    monkeypatch.setattr(c3, name, spy)
  xs, _ = tspatial.run_filter_spatial(params, cfg, imgs, mesh)
  # the chain on the whole 6x16 map; conv3x3_same (the U-Net's 3x8 and
  # 2x4 maps) on a shard's one column and a halo column on each side
  assert calls["conv3x3_gn_chain"] and all(
      s[:2] == (6, 16) for s in calls["conv3x3_gn_chain"])
  assert calls["conv3x3_same"] and all(
      s[1] == 3 for s in calls["conv3x3_same"])
  d_kernels = (xs.full() - kernels).abs()
  d_convs = (xs.full() - convs).abs()
  assert float(d_kernels.median()) < 2e-5 and float(d_kernels.max()) < 1e-2
  assert float(d_convs.median()) > 100 * float(d_kernels.median())


def test_conv_kernel_config_matches_jax_spatial(mesh, conv_setup):
  """The conv-kernel config W-sharded 8 ways against the JAX package's
  run_filter_spatial on its 8-device mesh (Pallas kernels in interpret
  mode). JAX's own sharded filter differs from its unsharded one by bf16
  flips (max 6.7e-3, median 3.8e-4 on these inputs, my CPU run): the
  port is held within that, max 1e-2 and median 1e-4."""
  jcfg, jparams, cfg, params = conv_setup
  imgs = images(3, 5)
  xs, Ps = tspatial.run_filter_spatial(params, cfg, imgs, mesh)
  with pallas_interpret():
    jxs, jPs = jspatial.run_filter_spatial(jparams, jcfg, imgs,
                                           jmesh.make_mesh(8))
  for got, want in ((xs, jxs), (Ps, jPs)):
    d = np.abs(got.full().numpy() - np.asarray(want))
    assert d.max() < 1e-2 and float(np.median(d)) < 1e-4


def test_sharded_layers_take_each_entrys_placed_params(mesh, setup,
                                                       monkeypatch):
  """Every sharded layer of run_filter_spatial takes its shard's weights
  from the params placed once per device (``Replicated`` leaves), never a
  copy of another device's; a weight on another device than its shard
  raises instead of being copied for the call."""
  _, _, cfg, params = setup
  seen, real = [], L.entry_params

  def spy(tree, i, device):
    seen.append(all(isinstance(t, tmesh.Replicated)
                    for t in L.tree_leaves(tree)))
    return real(tree, i, device)

  monkeypatch.setattr(L, "entry_params", spy)
  tspatial.run_filter_spatial(params, cfg, images(2, 9), mesh)
  assert seen and all(seen)
  placed = tspatial._spatial_params.get(params, "cpu")
  rep = tmesh.replica_tree([placed] * 8, mesh.devices)
  assert all(c is p for r, p in zip(L.tree_leaves(rep),
                                    L.tree_leaves(placed))
             for c in r.copies)
  layer = L.conv(8, 3, 1, compute_dtype="float32")
  w, _ = layer.init(torch.Generator().manual_seed(0), (6, 16, 5), "cpu")
  x = tmesh.split(mesh, torch.zeros(1, 5, 6, 16), axis=-1)
  with pytest.raises(ValueError, match="place the params"):
    layer.apply(L.tree_map(lambda t: t.to("meta"), w), x)


def test_spatial_refuses_a_width_the_mesh_cannot_split(mesh, setup):
  _, _, cfg, params = setup
  with pytest.raises(ValueError, match="divisible by 8 x the mesh size"):
    tspatial.run_filter_spatial(params, cfg, np.zeros((2, 48, 120, 3),
                                                      np.float32), mesh)
