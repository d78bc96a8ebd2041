"""ESAC in the port (models/esac.py, the multi-map solve of pose/ransac.py,
eval/online.EsacRelocalizer) against the benchmark's plain reference
(perfbench/reference/esac_ref.py) on the CPU, at a small size: 3 experts
at an eighth of the published widths, 48x64 frames, float32, seeded
random weights.

Tolerances and why:
  * gating probabilities, rtol 1e-4 / atol 1e-6; expert maps of the
    grouped pass, rtol 1e-4 / atol 1e-4 of values up to ~30: the same
    float32 convolutions summed in another order (the port's 1x1 convs
    and first conv as matrix products, the reference's all as convs), a
    few ulps a layer over 17 layers;
  * the grouped pass over several pairs against each pair alone, rtol
    1e-5 / atol 1e-5: batched products against one-pair ones, the same
    products;
  * the pose from the same draws on the same maps: T_wc within 1e-4 and
    the inlier counts equal (a point within 1e-4 px of the threshold
    flips; none is at these sizes);
  * everything else (one map a frame against today's solve, a NaN map no
    hypothesis reads, the drawn experts against all M) bit for bit: the
    same operations on the same values.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from kfnet_tpu_torch.eval.online import (EsacRelocalizer, PASS_PAIRS,
                                         pair_passes)
from kfnet_tpu_torch.models import esac
from kfnet_tpu_torch.pose import ransac
from kfnet_tpu_torch.utils import tracing
from perfbench.reference import esac_ref

CFG = esac.EsacConfig(num_experts=3, stem_channels=(4, 8, 16, 32),
                      res_channels=64, head_channels=64,
                      gating_channels=(1, 2, 4, 8),
                      compute_dtype="float32")
RCFG = ransac.RansacConfig(solver="p3p", num_hypotheses=32)
REF_CFG = {"image_mean": 0.4, "image_std": 0.25, "num_experts": 3,
           "ransac": {"num_hypotheses": 32, "inlier_threshold_px": 10.0,
                      "refine_iters": 10, "refine_threshold_px": 10.0}}
K = np.asarray([[58.5, 0, 31.5], [0, 58.5, 23.5], [0, 0, 1]], np.float32)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def params():
  p = esac.init(3, CFG, device="cpu")
  # biases and centres away from 0, so that a misplaced one shows
  gen = torch.Generator().manual_seed(4)
  for tree in (p["gating"], p["experts"]):
    for leaf in tree.values():
      if isinstance(leaf, dict):
        leaf["b"] = 0.1 * torch.randn(leaf["b"].shape, generator=gen)
  p["experts"]["centre"] = 2.0 * torch.randn((3, 3), generator=gen)
  p["gating"]["fc"]["w"] *= 20.0  # a peaked gating, as a trained one
  return p


def frames(seed, n=2):
  return torch.from_numpy(np.random.default_rng(seed).integers(
      0, 256, (n, 48, 64, 3), dtype=np.uint8))


def test_gating_and_each_expert_match_the_reference(params):
  f = frames(0)
  image = esac.preprocess(CFG, f)
  np.testing.assert_allclose(esac.gate(params, CFG, image).numpy(),
                             esac_ref.gate(params, REF_CFG, f).numpy(),
                             rtol=1e-4, atol=1e-6)
  served = esac.served_experts(params, CFG)
  every = torch.arange(2 * 3)  # each expert on each frame
  got = esac.experts_at(served, CFG, image, every // 3, every % 3)
  assert got.shape == (6, 6, 8, 3)
  for m in range(3):
    np.testing.assert_allclose(got[m::3].numpy(),
                               esac_ref.expert(params, REF_CFG, m, f).numpy(),
                               rtol=1e-4, atol=1e-4)


def test_the_published_widths_and_work():
  full = esac.EsacConfig()
  layers = esac.expert_layers(full)
  assert sum(cin * cout * k * k for _, cin, cout, k, _ in layers) == \
      6_876_960
  assert sum(cout for _, _, cout, _, _ in layers) == 5_859  # the biases
  assert esac.map_shape((480, 640)) == (60, 80)
  assert esac.map_shape((48, 64)) == (6, 8)


def test_the_grouped_pass_equals_the_experts_one_by_one(params):
  image = esac.preprocess(CFG, frames(1))
  served = esac.served_experts(params, CFG)
  slot, expert = torch.tensor([0, 1, 1, 0]), torch.tensor([2, 0, 2, 2])
  got = esac.experts_at(served, CFG, image, slot, expert)
  for p in range(4):
    want = esac.experts_at(served, CFG, image, slot[p:p + 1],
                           expert[p:p + 1])[0]
    np.testing.assert_allclose(got[p].numpy(), want.numpy(), rtol=1e-5,
                               atol=1e-5)


def test_the_draw_of_experts_and_its_counts():
  probs = torch.tensor([[0.5, 0.3, 0.2], [0.0, 0.0, 1.0]])
  u = torch.tensor([[0.0, 0.49, 0.5, 0.79, 0.8, 0.9999999],
                    [0.0, 0.3, 0.5, 0.7, 0.9, 0.99]])
  e = esac.draw_experts(probs, u)
  assert e.tolist() == [[0, 0, 1, 1, 2, 2], [2] * 6]
  assert torch.equal(e, esac_ref.draw_experts(probs, u))
  assert esac.expert_counts(e, 3).tolist() == [[2, 2, 2], [0, 0, 6]]


def _maps_and_draws(seed, T=2, E=4):
  gen = torch.Generator().manual_seed(seed)
  maps = torch.randn((E, 6, 8, 3), generator=gen) + torch.tensor(
      [0.0, 0.0, 4.0])
  map_of = torch.randint(0, E, (T, 32), generator=gen)
  return maps, map_of


def test_the_multi_map_pose_matches_the_reference_from_the_same_draws():
  maps, map_of = _maps_and_draws(5)
  Kt = torch.from_numpy(K)
  out = ransac.solve_pnp_from_maps(
      maps, None, torch.ones(maps.shape[:-1], dtype=torch.bool), Kt,
      torch.Generator().manual_seed(9), 8, RCFG, map_of=map_of)
  q = torch.empty((2, 32, 48)).exponential_(
      generator=torch.Generator().manual_seed(9))
  T, n_in = esac_ref.solve(maps, map_of, Kt, q, REF_CFG["ransac"], 8)
  np.testing.assert_allclose(out["T_wc"].numpy(), T.numpy(), atol=1e-4)
  assert torch.equal(out["num_inliers"], n_in)


def test_a_hypothesis_reads_only_its_own_map():
  maps, map_of = _maps_and_draws(6)
  map_of[map_of == 3] = 2  # no hypothesis draws map 3
  valid = torch.ones(maps.shape[:-1], dtype=torch.bool)
  Kt = torch.from_numpy(K)
  solve = lambda m: ransac.solve_pnp_from_maps(
      m, None, valid, Kt, torch.Generator().manual_seed(2), 8, RCFG,
      map_of=map_of)
  want = solve(maps)
  poisoned = maps.clone()
  poisoned[3] = float("nan")
  got = solve(poisoned)
  assert torch.isfinite(got["T_wc"]).all()
  for k in want:
    assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("solver", ["dlt", "p3p"])
def test_one_map_a_frame_is_the_one_map_solve_bit_for_bit(solver):
  gen = torch.Generator().manual_seed(7)
  T = 3
  x = torch.randn((T, 6, 8, 3), generator=gen) + torch.tensor([0.0, 0, 4])
  P = torch.rand((T, 6, 8, 1), generator=gen) + 0.1
  valid = torch.rand((T, 6, 8), generator=gen) > 0.1
  cfg = ransac.RansacConfig(solver=solver, num_hypotheses=32, top_k=40)
  Kt = torch.from_numpy(K)
  want = ransac.solve_pnp_from_maps(x, P, valid, Kt,
                                    torch.Generator().manual_seed(3), 8, cfg)
  map_of = torch.arange(T)[:, None].expand(T, 32).contiguous()
  got = ransac.solve_pnp_from_maps(x, P, valid, Kt,
                                   torch.Generator().manual_seed(3), 8, cfg,
                                   map_of=map_of)
  for k in want:
    assert torch.equal(got[k], want[k]), k


def test_the_drawn_experts_give_the_pose_of_all_experts(params):
  B = 2
  rl = EsacRelocalizer(params, CFG, K, batch_size=B, ransac_config=RCFG,
                       seed=4, device="cpu")
  f = frames(8, B)
  packed = rl.tick(f)
  probs, map_of, pairs = rl.last
  # every (slot, expert) pair run, then the same solve from the same state
  image = esac.preprocess(CFG, f)
  every = torch.arange(B * 3)
  full = esac.experts_at(esac.served_experts(params, CFG), CFG, image,
                         every // 3, every % 3)
  assert len(pairs) < B * 3
  assert torch.equal(full[pairs], rl.maps[pairs])
  gen = torch.Generator().manual_seed(4)
  torch.rand((B, 32), generator=gen)  # the tick's uniforms
  out = ransac.solve_pnp_from_maps(
      full.reshape(B * 3, 6, 8, 3), None,
      torch.ones((B * 3, 6, 8), dtype=torch.bool), torch.from_numpy(K), gen,
      8, RCFG, map_of=map_of)
  assert torch.equal(out["T_wc"].reshape(B, 16), packed[:, :16])
  assert torch.equal(out["num_inliers"], packed[:, 16])


def test_the_surface_records_its_spans_and_counters(params):
  rl = EsacRelocalizer(params, CFG, K, batch_size=2, ransac_config=RCFG,
                       seed=1, device="cpu")
  tracing.enable()
  try:
    got = [rl.process(frames(10 + t).numpy()) for t in range(3)]
  finally:
    tracing.disable()
  snap = tracing.snapshot()
  names = {s.name for s in snap["spans"]}
  assert {"online.tick", "online.wait", "esac.gate", "esac.route",
          "esac.experts", "pose.solve"} <= names
  c = snap["counters"]
  assert c["host.syncs"] == 6  # the read-back and the answer, a tick
  assert c["esac.expert_runs"] == sum(info["pairs"] for _, info in got)
  assert 3 <= c["esac.experts_drawn"] <= 9
  for poses, info in got:
    assert poses.shape == (2, 4, 4) and np.isfinite(poses).all()
    assert info["num_inliers"].shape == (2,)


def test_the_expert_passes():
  assert PASS_PAIRS == 16
  assert pair_passes(1) == [1]
  assert pair_passes(16) == [16]
  assert pair_passes(38) == [16, 16, 6]
  assert sum(pair_passes(76)) == 76


def test_more_pairs_than_a_pass_run_in_several(params, monkeypatch):
  """With passes of 1 pair, a tick's pairs run in several passes and the
  pose is the one pass's."""
  from kfnet_tpu_torch.eval import online
  f = frames(12, 2)

  def tick(size):
    monkeypatch.setattr(online, "PASS_PAIRS", size)
    rl = EsacRelocalizer(params, CFG, K, batch_size=2, ransac_config=RCFG,
                         seed=6, device="cpu")
    out = rl.tick(f)
    return out, rl.maps[rl.last[2]], len(rl.last[2])

  one, maps_one, pairs = tick(16)
  several, maps_several, _ = tick(1)
  assert pairs > 1 and len(online.pair_passes(pairs)) == pairs
  np.testing.assert_allclose(maps_several.numpy(), maps_one.numpy(),
                             rtol=1e-5, atol=1e-5)
  np.testing.assert_allclose(several.numpy(), one.numpy(), rtol=1e-4,
                             atol=1e-4)
