"""The pose solve's CUDA kernels (kernels/ransac.py) on the card (marker
``cuda``); they skip where there is no CUDA device. This file imports only
torch, numpy and kfnet_tpu_torch, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider \
        tests/test_torch_ransac_cuda.py

Each stage's kernel is held against its plain PyTorch version
(``*_reference``) at the served shapes: the DLT at T = 1 and T = 4 over
k = 2048 points a frame (OnlineRelocalizer, FleetRelocalizer), and P3P
with ``map_of`` over a stack of 4 x 19 maps of 4800 cells (EsacRelocalizer),
256 draws a frame, on seeded scenes of known poses whose winner is clear
(25-45% outliers, exact inliers). Tolerances, and why:

  * hypothesize and score: the candidates and their scores equal the plain
    version's bit for bit (a NaN for a NaN, where a degenerate draw's
    Cholesky meets a pivot that is not positive). The kernels round as the
    card's plain version does (csrc/ransac.cu); a float32 minimal solver
    turns any other rounding into another pose on a poorly conditioned
    draw, and RANSAC's pick among near-ties follows it. That rounding is
    the libraries' the kernels were probed under (chip_smoke.py's
    RANSAC_PROBED): under another cuBLAS or cuSOLVER
    ``test_each_stage_kernel_matches_its_plain_version`` may fail with no
    kernel change.
  * pick_and_refine: from the same candidates and scores, T_wc within 1e-3
    (the LM's normal equations summed in another order: a converged
    float32 solve), num_inliers within 2, inlier_ratio within 2 / k and the
    mean inlier error within 1e-2 px.
  * The whole solve through ``GraphedSolve`` (draws, three kernels) against
    the eager plain solve with a generator of the same seed: T_wc within
    1e-3 and inliers within 2 (the same draws: the kernels draw nothing),
    the generators in one state after it.

The kernels give the same bits twice (fixed-order sums, no atomics): two
replays of one capture, and an eager call against a replay. Their
launches count once a call eagerly and once a replay under capture, and
``pose.kernel_solves`` counts every solve. The wrappers refuse CPU tensors,
other dtypes, wrong shapes and non-contiguous input.
"""

import numpy as np
import pytest
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch.core import geometry as geo
from kfnet_tpu_torch.kernels import launches
from kfnet_tpu_torch.kernels import ransac as kr
from kfnet_tpu_torch.pose import ransac
from kfnet_tpu_torch.utils import tracing

pytestmark = pytest.mark.cuda

K_NP = np.array([[585.0, 0.0, 319.5], [0.0, 585.0, 239.5], [0.0, 0.0, 1.0]])
H, W, STRIDE = 60, 80, 8  # a 640x480 frame's map
EXPERTS = 19
TOP_K = 2048

# (name, solver, frames); "esac4": P3P over EXPERTS maps a frame
SHAPES = [("stream1", "dlt", 1), ("fleet4", "dlt", 4), ("esac4", "p3p", 4)]


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device and nvcc")
  kfnet_tpu_torch.set_fp32_precision()  # the plain versions' f32 products
  return torch.device("cuda")


def rotation(w):
  th = np.linalg.norm(w)
  k = w / th
  Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
  return np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx


def pose_maps(rng, n, outliers):
  """n maps of one known pose each: the world coordinates of every cell's
  pixel at depths in [1, 5) m, ``outliers`` of them moved about 2 m, and
  variances in [0.5, 2). Returns (coords (n, H, W, 3), var (n, H, W, 1),
  T_wc (n, 4, 4)) as numpy."""
  off = (STRIDE - 1) // 2
  v, u = np.meshgrid(np.arange(H) * STRIDE + off, np.arange(W) * STRIDE + off,
                     indexing="ij")
  coords, poses = [], []
  for _ in range(n):
    R = rotation(rng.normal(size=3) * 0.3)
    t = rng.normal(size=3) * 0.5
    d = rng.uniform(1.0, 5.0, (H, W))
    pc = np.stack([(u - K_NP[0, 2]) / K_NP[0, 0] * d,
                   (v - K_NP[1, 2]) / K_NP[1, 1] * d, d], -1)
    X = pc @ R.T + t
    out = rng.uniform(size=(H, W)) < outliers
    X[out] += rng.normal(size=(int(out.sum()), 3)) * 2.0
    T = np.eye(4)
    T[:3, :3], T[:3, 3] = R, t
    coords.append(X)
    poses.append(T)
  return (np.stack(coords), rng.uniform(0.5, 2.0, (n, H, W, 1)),
          np.stack(poses))


def served_case(name, dev, seed=0):
  """The pools, draws and config of one served shape: (uv, X, w, K, idx,
  map_of, config)."""
  _, solver, T = next(s for s in SHAPES if s[0] == name)
  rng = np.random.default_rng(seed)
  f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=dev)
  K = f32(K_NP)
  gen = torch.Generator(device=dev).manual_seed(seed)
  grid = geo.cell_center_grid(H, W, STRIDE, device=dev).reshape(-1, 2)
  if solver == "dlt":
    cfg = ransac.RansacConfig(top_k=TOP_K)
    coords, var, _ = pose_maps(rng, T, 0.25)
    valid = torch.ones((T, H * W), dtype=torch.bool, device=dev)
    uv, X, w = ransac.select_confident(grid, f32(coords).reshape(T, -1, 3),
                                       f32(var).reshape(T, -1), valid, TOP_K)
    idx = ransac.sample_hypotheses(w, cfg.num_hypotheses, cfg.draw_size, gen)
    return uv, X, w, K, idx, None, cfg
  cfg = ransac.RansacConfig(solver="p3p")
  # frame b's experts see its pose, most of their cells wrong
  coords = np.concatenate([
      pose_maps(np.random.default_rng([seed, b]), 1, 0.45)[0].repeat(
          EXPERTS, 0) + rng.normal(size=(EXPERTS, H, W, 3)) * (
              rng.uniform(size=(EXPERTS, H, W, 1)) < 0.3)
      for b in range(T)])
  X = f32(coords).reshape(T * EXPERTS, -1, 3)
  w = torch.ones(X.shape[:2], device=dev)
  experts = torch.as_tensor(rng.integers(0, EXPERTS, (T, cfg.num_hypotheses)),
                            device=dev)
  map_of = experts + EXPERTS * torch.arange(T, device=dev)[:, None]
  idx = ransac.sample_hypotheses(w, cfg.num_hypotheses, cfg.draw_size, gen,
                                 map_of)
  return grid, X, w, K, idx, map_of, cfg


def plain_stages(uv, X, w, K, idx, map_of, cfg):
  """The plain versions on the card: (candidates (T, M c, 12), scores
  (T, M c), the solve's outputs)."""
  uvh, Xh, wh = kr.per_hypothesis(uv, X, w, map_of)
  Rs, ts = kr.hypothesize_reference(uvh, Xh, K, idx, cfg.solver)
  inl = kr.score_reference(uvh, Xh, wh, K, Rs, ts, cfg.inlier_threshold_px)
  out = kr.refine_reference(uv, X, w, K, Rs, ts, inl, cfg.refine_iters,
                            cfg.refine_threshold_px, map_of)
  return kr.candidates(Rs, ts), torch.sum(inl, dim=-1), out


def outputs_close(got, want, k):
  np.testing.assert_allclose(got["T_wc"].cpu().numpy(),
                             want["T_wc"].cpu().numpy(), atol=1e-3)
  for name, tol in (("num_inliers", 2.0), ("inlier_ratio", 2.0 / k),
                    ("mean_inlier_error_px", 1e-2)):
    np.testing.assert_allclose(got[name].cpu().numpy(),
                               want[name].cpu().numpy(), atol=tol, rtol=0,
                               err_msg=name)


@pytest.mark.parametrize("name", [s[0] for s in SHAPES])
def test_each_stage_kernel_matches_its_plain_version(cuda, name):
  uv, X, w, K, idx, map_of, cfg = served_case(name, cuda)
  c = kr.CANDIDATES[cfg.solver]
  cands, scores, want = plain_stages(uv, X, w, K, idx, map_of, cfg)

  got_c = kr.hypothesize(uv, X, K, idx, cfg.solver, map_of)
  torch.testing.assert_close(got_c, cands, rtol=0, atol=0, equal_nan=True)
  got_s = kr.score(uv, X, w, K, cands, c, cfg.inlier_threshold_px, map_of)
  assert torch.equal(got_s, scores)

  got = kr.pick_and_refine(uv, X, w, K, cands, scores, c,
                           cfg.inlier_threshold_px, cfg.refine_iters,
                           cfg.refine_threshold_px, map_of)
  outputs_close(got, want, X.shape[1])
  # a clear winner: the truth's inliers, not a tie of a few
  assert (want["num_inliers"] > 0.3 * X.shape[1]).all()


def test_graphed_solve_matches_the_eager_plain_solve(cuda):
  T, seed = 4, 3
  rng = np.random.default_rng(seed)
  coords, var, T_wc = pose_maps(rng, T, 0.3)
  f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)
  maps = (f32(coords), f32(var),
          torch.ones((T, H, W, 1), dtype=torch.bool, device=cuda))
  K = f32(K_NP)
  cfg = ransac.RansacConfig()
  solver = ransac.GraphedSolve()
  gen = torch.Generator(device=cuda).manual_seed(seed)
  ref = torch.Generator(device=cuda).manual_seed(seed)
  grid = geo.cell_center_grid(H, W, STRIDE, device=cuda).reshape(-1, 2)
  wrappers = (kr.hypothesize, kr.score, kr.pick_and_refine)
  before = [f.launches for f in wrappers]
  tracing.enable()
  try:
    for i in range(3):  # a capture (its warm-up solves), then two replays
      got = ransac.solve_pnp_from_maps(*maps, K, gen, config=cfg,
                                       graphed=solver)
      got = {n: v.clone() for n, v in got.items()}
      uv, X, w = ransac.select_confident(
          grid, maps[0].reshape(T, -1, 3), maps[1].reshape(T, -1),
          maps[2].reshape(T, -1), cfg.top_k)
      idx = ransac.sample_hypotheses(w, cfg.num_hypotheses, cfg.draw_size,
                                     ref)
      _, _, want = plain_stages(uv, X, w, K, idx, None, cfg)
      outputs_close(got, want, cfg.top_k)
      assert (geo.translation_error(got["T_wc"], f32(T_wc)) < 0.01).all()
  finally:
    tracing.disable()
  torch.cuda.synchronize()
  counters = tracing.snapshot()["counters"]
  assert counters["pose.captures"] == 1 and counters["pose.replays"] == 2
  assert counters["pose.kernel_solves"] == 3
  # the warm-up's launches, then one each a replay; none while capturing
  assert [f.launches - b for f, b in zip(wrappers, before)] == [3, 3, 3]
  assert torch.equal(gen.get_state(), ref.get_state())


@pytest.mark.parametrize("name", ["stream1", "esac4"])
def test_replays_give_the_same_bits(cuda, name):
  uv, X, w, K, idx, map_of, cfg = served_case(name, cuda, seed=4)
  c = kr.CANDIDATES[cfg.solver]

  def solve():
    cands = kr.hypothesize(uv, X, K, idx, cfg.solver, map_of)
    scores = kr.score(uv, X, w, K, cands, c, cfg.inlier_threshold_px, map_of)
    return kr.pick_and_refine(uv, X, w, K, cands, scores, c,
                              cfg.inlier_threshold_px, cfg.refine_iters,
                              cfg.refine_threshold_px, map_of)

  eager = solve()
  side = torch.cuda.Stream()
  side.wait_stream(torch.cuda.current_stream())
  with torch.cuda.stream(side):
    solve()
  torch.cuda.current_stream().wait_stream(side)
  graph = torch.cuda.CUDAGraph()
  before = kr.pick_and_refine.launches
  with launches.recorded() as record, torch.cuda.graph(graph):
    out = solve()
  assert kr.pick_and_refine.launches == before  # captured, not run
  replays = []
  for _ in range(2):
    graph.replay()
    launches.replayed(record)
    replays.append({n: v.clone() for n, v in out.items()})
  torch.cuda.synchronize()
  assert kr.pick_and_refine.launches == before + 2
  assert record == {kr.hypothesize: 1, kr.score: 1, kr.pick_and_refine: 1}
  for n in eager:
    assert torch.equal(replays[0][n], replays[1][n]), n
    assert torch.equal(replays[0][n], eager[n]), n


def test_kernels_reject_bad_inputs(cuda):
  uv, X, w, K, idx, _, cfg = served_case("fleet4", cuda)
  cands = kr.hypothesize(uv, X, K, idx, "dlt")
  scores = kr.score(uv, X, w, K, cands, 1, 10.0)
  with pytest.raises(ValueError, match="cuda"):
    kr.hypothesize(uv.cpu(), X.cpu(), K.cpu(), idx.cpu(), "dlt")
  with pytest.raises(ValueError, match="is on"):
    kr.score(uv, X, w, K.cpu(), cands, 1, 10.0)
  with pytest.raises(TypeError):
    kr.hypothesize(uv, X.double(), K, idx, "dlt")
  with pytest.raises(TypeError):
    kr.hypothesize(uv, X, K, idx.int(), "dlt")
  with pytest.raises(ValueError, match="shape"):
    kr.score(uv, X, w[:, :-1], K, cands, 1, 10.0)
  with pytest.raises(ValueError, match="contiguous"):
    kr.hypothesize(uv.transpose(0, 1).contiguous().transpose(0, 1), X, K,
                   idx, "dlt")
  with pytest.raises(ValueError, match="draw of 3"):
    kr.hypothesize(uv, X, K, idx[..., :3], "dlt")
  with pytest.raises(ValueError, match="solver"):
    kr.hypothesize(uv, X, K, idx, "epnp")
  with pytest.raises(ValueError, match="per_draw"):
    kr.score(uv, X, w, K, cands, 2, 10.0)
  with pytest.raises(ValueError, match="pools"):
    kr.hypothesize(uv[:1], X[:1], K, idx, "dlt")
  with pytest.raises(ValueError, match="scores"):
    kr.pick_and_refine(uv, X, w, K, cands, scores[:, :-1], 1, 10.0, 10, 10.0)
  assert kr.CANDIDATES == {"dlt": 1, "p3p": 4}
