"""The benchmark's frozen pieces against the program at this commit, on the
CPU at the tiny size: the reference layer by layer, the weights' tree,
the renderer and the FLOP count."""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.families import kfnet as family
from perfbench.reference import kfnet_ref as ref
from perfbench.tests import tiny
from perfbench.traffic import generator, render

CPU = torch.device("cpu")


def _frames(seed, n=2, shape=(48, 64, 3)):
  gen = torch.Generator().manual_seed(seed)
  return torch.randint(0, 256, (n,) + shape, generator=gen,
                       dtype=torch.uint8)


def close(a, b, tol=1e-4):
  err = float(torch.max(torch.abs(a - b)))
  scale = float(torch.max(torch.abs(b))) + 1e-12
  assert err <= tol * scale, (err, scale)


@pytest.fixture(params=["gn-stream1", "nonorm-fleet4"])
def net(request):
  cfg = tiny.config(request.param)
  return cfg, family.kfnet_config(cfg), family.make_weights(cfg, 7, CPU)


def test_weights_tree_is_the_programs(net):
  from kfnet_tpu_torch.models import kfnet
  from kfnet_tpu_torch.nn import layers as L
  cfg, kcfg, params = net
  theirs = kfnet.init(0, kcfg, tuple(cfg["frame"]), device="cpu")
  shapes = lambda t: [tuple(x.shape) for x in L.tree_leaves(t)]
  assert shapes(params) == shapes(theirs)
  assert (L.tree_map(lambda x: None, params)
          == L.tree_map(lambda x: None, theirs))
  assert family.count(cfg) == L.param_count(theirs)


def test_scoordnet_and_encoder(net):
  from kfnet_tpu_torch.models import oflownet, scoordnet
  cfg, kcfg, params = net
  f = _frames(1)[0]
  close(ref.scoordnet_raw(params["scoordnet"], cfg["scoordnet"], f),
        scoordnet.apply_raw(params["scoordnet"], kcfg.scoordnet, f))
  close(ref.encode(params["oflownet"], cfg["oflownet"], f),
        oflownet.encode(params["oflownet"], kcfg.oflownet, f))


def test_cost_volume_and_decoder(net):
  from kfnet_tpu_torch.kernels.cost_volume import cost_volume
  from kfnet_tpu_torch.models import oflownet
  cfg, kcfg, params = net
  gen = torch.Generator().manual_seed(2)
  a, b = torch.randn((2, 6, 8, 16), generator=gen)
  cv = ref.cost_volume(a, b, 2)
  close(cv, cost_volume(a, b, 2))
  close(ref.decode_raw(params["oflownet"], cfg["oflownet"], cv),
        oflownet.decode_raw(params["oflownet"], kcfg.oflownet, cv))


def test_filter_step(net):
  from kfnet_tpu_torch.models import kfnet
  cfg, kcfg, params = net
  f = _frames(3)
  image = kfnet.preprocess_images(kcfg, f)
  x, P, feat = kfnet.first_step(params, kcfg, image[0])
  z, V = ref.measure(params, cfg, f[0])
  close(z, x)
  close(V, P)
  x1, P1, _, aux = kfnet.filter_step(params, kcfg, x, P, feat, image[1])
  s = ref.filter_step(params, cfg, x, P, f[0], f[1])
  for k, v in (("x", x1), ("P", P1), ("z", aux["z"]), ("V", aux["V"]),
               ("flow", aux["flow"]), ("W", aux["W"])):
    close(s[k], v)
  assert torch.equal(s["consistent"], aux["consistent"])


@pytest.mark.parametrize("batch", [1, 4])
def test_pose_solve_with_the_same_draws(batch):
  from kfnet_tpu_torch.pose import ransac
  cfg = tiny.config("gn-stream1")
  rc = dict(cfg["ransac"], top_k=40)
  gen = torch.Generator().manual_seed(5)
  # a map of a real camera: scene points seen by a pose, with noise
  h, w = 6, 8
  K = torch.tensor([[60.0, 0, 31.5], [0, 60.0, 23.5], [0, 0, 1]])
  uv = ref.cell_centers(h, w, 8, CPU)
  depth = 2.0 + torch.rand((batch, h * w), generator=gen)
  rays = torch.cat([(uv - K[:2, 2]) / 60.0, torch.ones(h * w, 1)], -1)
  X = rays * depth[..., None] + 0.3
  X[:, :5] += 3.0 * torch.randn((batch, 5, 3), generator=gen)  # outliers
  x = X.reshape(batch, h, w, 3)
  P = torch.rand((batch, h, w, 1), generator=gen) + 0.1
  shape = (batch, rc["num_hypotheses"], rc["top_k"])
  q = torch.empty(shape if batch > 1 else shape[1:]).exponential_(
      generator=torch.Generator().manual_seed(9))
  mine = ref.solve(x, P, K, q.reshape(shape), rc, 8)
  theirs = ransac.solve_pnp_from_maps(
      x if batch > 1 else x[0], P if batch > 1 else P[0],
      torch.ones_like(P if batch > 1 else P[0], dtype=torch.bool), K,
      torch.Generator().manual_seed(9), stride=8,
      config=ransac.RansacConfig(**rc))
  close(mine[0], theirs["T_wc"].reshape(batch, 4, 4), 1e-3)
  assert torch.equal(mine[1], theirs["num_inliers"].reshape(batch))


def test_draws_repeat_the_programs_generator():
  from perfbench import check
  gen = torch.Generator().manual_seed(11)
  seq = [torch.empty((3, 4)).exponential_(generator=gen) for _ in range(5)]
  got = check.draws(11, (3, 4), 5, CPU, {1, 4})
  assert torch.equal(got[1], seq[1]) and torch.equal(got[4], seq[4])


def test_renderer_is_the_programs():
  from kfnet_tpu_torch.data import synthetic
  n = 5
  mine = render.orbit(n, 123)
  theirs = synthetic.orbit_trajectory(n, seed=123, duration=(n - 1) / 48)
  np.testing.assert_allclose(mine, theirs, atol=1e-5)
  scene = render.make_scene(0)
  K = torch.tensor([[58.5, 0, 31.5], [0, 58.5, 23.5], [0, 0, 1.0]])
  T = torch.as_tensor(mine)
  rgb, _ = synthetic.render(synthetic.make_scene(0), T, K, 48, 64)
  close(render.render(scene, T, K, 48, 64), rgb, 1e-5)


def test_pool_layout_and_resets():
  m = tiny.mix("nonorm-fleet4")
  pool = generator.frames(m, 21, (48, 64, 3), CPU)
  assert pool.shape == (16, 4, 48, 64, 3) and pool.dtype == torch.uint8
  # camera 1's frame j sits at tick (j - stagger) mod n
  again = generator.frames(m, 21, (48, 64, 3), CPU)
  assert torch.equal(pool, again)
  assert torch.equal(pool[(0 - m["stagger"]) % 16, 1], pool[12, 1])
  r = generator.resets(m, 16)
  assert r.sum() == 4 and r[0, 0] and r[12, 1] and r[8, 2] and r[4, 3]
  other = generator.frames(m, 22, (48, 64, 3), CPU)
  assert not torch.equal(pool, other)


def test_flop_count_is_the_programs():
  from kfnet_tpu_torch.eval import flops as theirs
  from kfnet_tpu_torch.models import kfnet
  from perfbench import run
  bench = run.load_benchmark(tiny.ROOT)
  cfg = run.load_config(bench, "kfnet-gn-640x480")
  mine = family.frame_flops(cfg, (480, 640))
  assert mine == pytest.approx(
      theirs.filter_step_flops(kfnet.KFNetConfig(), 480, 640), rel=1e-12)
  assert mine == pytest.approx(241.7e9, rel=1e-3)
  first = family.frame_flops(cfg, (480, 640), first=True)
  assert first < mine
