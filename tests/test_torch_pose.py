"""The port's pose solver against the JAX package: DLT, reprojection errors,
LM refinement and the RANSAC solve fed the same hypothesis index set
(reproduced here from kfnet_tpu/pose/ransac.py), plus recovery of a known
pose by the port's own sampling.

Variances are untied so both top-k preselections keep the same order.
Tolerances: rotations and translations to 1e-3 (the DLT's inverse
iteration and 3x3 inverses round differently in the two packages), pixel
errors to 1e-3 px relative 1e-4, inlier counts equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfnet_tpu.core import geometry as jgeo
from kfnet_tpu.pose import pnp as jpnp
from kfnet_tpu.pose import ransac as jransac
from kfnet_tpu_torch.core import geometry as tgeo
from kfnet_tpu_torch.pose import pnp as tpnp
from kfnet_tpu_torch.pose import ransac as transac


def synth_scene(rng, n=200, noise_px=0.0, outlier_frac=0.0):
  """Random camera viewing a random point cloud: (uv, X, T_wc, K), numpy."""
  w = rng.normal(size=3) * 0.3
  R_wc = np.asarray(jgeo.axis_angle_to_matrix(jnp.asarray(w, jnp.float32)))
  t_wc = rng.normal(size=3).astype(np.float32)
  T_wc = np.asarray(jgeo.make_pose(jnp.asarray(R_wc), jnp.asarray(t_wc)))
  K = np.asarray(jgeo.make_intrinsics(*jgeo.SEVEN_SCENES_K))
  pc = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1.0, 1.0, n),
                 rng.uniform(1.0, 5.0, n)], -1).astype(np.float32)
  X = (pc @ R_wc.T + t_wc).astype(np.float32)
  uv, _ = jgeo.project(jnp.asarray(X), jnp.asarray(K), jnp.asarray(T_wc))
  uv = np.array(uv) + rng.normal(size=(n, 2)).astype(np.float32) * noise_px
  n_out = int(n * outlier_frac)
  if n_out:
    idx = rng.choice(n, n_out, replace=False)
    X[idx] += rng.normal(size=(n_out, 3)).astype(np.float32) * 2.0
  return uv.astype(np.float32), X, T_wc, K


def t(a):
  return torch.from_numpy(np.array(a, dtype=np.float32))


def w2c(T_wc):
  T_cw = np.linalg.inv(T_wc)
  return T_cw[:3, :3].astype(np.float32), T_cw[:3, 3].astype(np.float32)


@pytest.mark.parametrize("n,noise", [(24, 0.0), (6, 0.0), (100, 1.0)])
def test_dlt_matches_jax(n, noise):
  uv, X, T_wc, K = synth_scene(np.random.default_rng(n), n=n,
                               noise_px=noise)
  jR, jt = jpnp.dlt_pnp(jnp.asarray(uv), jnp.asarray(X), jnp.asarray(K))
  tR, tt = tpnp.dlt_pnp(t(uv), t(X), t(K))
  np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-3)
  np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-3)
  if noise == 0.0:
    Rg, tg = w2c(T_wc)
    np.testing.assert_allclose(tR.numpy(), Rg, atol=2e-3)
    np.testing.assert_allclose(tt.numpy(), tg, atol=5e-3)


def test_dlt_batched_equals_one_by_one():
  uv, X, _, K = synth_scene(np.random.default_rng(3), n=60, noise_px=0.5)
  idx = torch.from_numpy(
      np.random.default_rng(3).permutation(60)[:48].reshape(8, 6))
  Rb, tb = tpnp.dlt_pnp(t(uv)[idx], t(X)[idx], t(K))
  for i in range(8):
    R1, t1 = tpnp.dlt_pnp(t(uv)[idx[i]], t(X)[idx[i]], t(K))
    np.testing.assert_allclose(Rb[i].numpy(), R1.numpy(), atol=1e-5)
    np.testing.assert_allclose(tb[i].numpy(), t1.numpy(), atol=1e-5)


def test_reprojection_errors_match_jax():
  uv, X, T_wc, K = synth_scene(np.random.default_rng(4), n=50, noise_px=2.0)
  R, tt = w2c(T_wc)
  X[:3, 2] -= 40.0  # some points behind the camera get max_err
  je = jpnp.reprojection_errors(*(jnp.asarray(a) for a in (uv, X, K, R, tt)))
  te = tpnp.reprojection_errors(t(uv), t(X), t(K), t(R), t(tt))
  np.testing.assert_allclose(te.numpy(), np.asarray(je), rtol=1e-4,
                             atol=1e-3)


def test_refine_lm_matches_jax():
  uv, X, T_wc, K = synth_scene(np.random.default_rng(2), n=100, noise_px=2.0)
  R0, t0 = w2c(T_wc)
  dR = np.asarray(jgeo.axis_angle_to_matrix(
      jnp.asarray([0.05, -0.04, 0.03], jnp.float32)))
  R_bad, t_bad = dR @ R0, t0 + np.float32([0.05, -0.05, 0.08])
  w = np.ones(100, np.float32)
  jR, jt = jpnp.refine_pnp_lm(*(jnp.asarray(a) for a in
                                (uv, X, K, R_bad, t_bad, w)), iters=15)
  tR, tt = tpnp.refine_pnp_lm(t(uv), t(X), t(K), t(R_bad), t(t_bad), t(w),
                              iters=15)
  np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-3)
  np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-3)
  e_bad = tpnp.reprojection_errors(t(uv), t(X), t(K), t(R_bad),
                                   t(t_bad)).mean()
  e_fit = tpnp.reprojection_errors(t(uv), t(X), t(K), tR, tt).mean()
  assert e_fit < 0.5 * e_bad


def _jax_indices(w, k, num_hypotheses, rng_key):
  """kfnet_tpu/pose/ransac.py's hypothesis sampling, step for step."""
  logits = jnp.where(w > 0, 0.0, -jnp.inf)
  logits = jnp.where(jnp.any(w > 0), logits, jnp.zeros_like(logits))
  sample = lambda key: jax.random.choice(
      key, k, shape=(6,), replace=False, p=jax.nn.softmax(logits))
  return jax.vmap(sample)(jax.random.split(rng_key, num_hypotheses))


@pytest.mark.parametrize("seed", [5, 6])
def test_solve_with_indices_matches_jax(seed):
  rng = np.random.default_rng(seed)
  n = 400
  uv, X, T_wc, K = synth_scene(rng, n=n, noise_px=1.0, outlier_frac=0.3)
  var = rng.uniform(0.5, 2.0, n).astype(np.float32)  # untied
  valid = np.ones(n, bool)
  valid[:10] = False
  cfg = transac.RansacConfig(num_hypotheses=64, top_k=256)
  jcfg = jransac.RansacConfig(num_hypotheses=64, top_k=256)
  key = jax.random.key(seed)
  want = jransac.solve_pnp_ransac(*(jnp.asarray(a) for a in
                                    (uv, X, var, valid, K)), key, jcfg)
  juv, jX, jw = jransac.select_confident(*(jnp.asarray(a) for a in
                                           (uv, X, var, valid)), 256)
  idx = np.array(_jax_indices(jw, 256, 64, key))
  tuv, tX, tw = transac.select_confident(t(uv), t(X), t(var),
                                         torch.from_numpy(valid), 256)
  np.testing.assert_array_equal(tuv.numpy(), np.asarray(juv))
  np.testing.assert_array_equal(tw.numpy(), np.asarray(jw))
  got = transac.solve_with_indices(tuv, tX, tw, t(K),
                                   torch.from_numpy(idx).long(), cfg)
  np.testing.assert_allclose(got["T_wc"].numpy(), np.asarray(want["T_wc"]),
                             atol=1e-3)
  assert got["num_inliers"].item() == float(want["num_inliers"])
  np.testing.assert_allclose(got["inlier_ratio"].item(),
                             float(want["inlier_ratio"]), rtol=1e-6)
  np.testing.assert_allclose(got["mean_inlier_error_px"].item(),
                             float(want["mean_inlier_error_px"]), rtol=1e-3)


def test_ransac_recovers_known_pose():
  rng = np.random.default_rng(7)
  uv, X, T_wc, K = synth_scene(rng, n=500, noise_px=1.0, outlier_frac=0.3)
  gen = torch.Generator().manual_seed(0)
  out = transac.solve_pnp_ransac(
      t(uv), t(X), t(rng.uniform(0.5, 2.0, 500)),
      torch.ones(500, dtype=torch.bool), t(K), gen,
      transac.RansacConfig(num_hypotheses=128, top_k=500))
  assert tgeo.translation_error(out["T_wc"], t(T_wc)).item() < 0.05
  assert tgeo.rotation_error_deg(out["T_wc"], t(T_wc)).item() < 1.0
  assert out["inlier_ratio"].item() > 0.6


def test_sampling_draws_distinct_valid_slots():
  gen = torch.Generator().manual_seed(1)
  w = torch.zeros(40)
  w[::2] = 1.0
  idx = transac.sample_hypotheses(w, 200, 6, gen)
  assert idx.shape == (200, 6)
  for row in idx.tolist():
    assert len(set(row)) == 6 and all(i % 2 == 0 for i in row)
  # every valid slot is reachable
  assert set(idx.flatten().tolist()) == set(range(0, 40, 2))


def test_from_maps_uses_cell_centres():
  np.testing.assert_array_equal(
      tgeo.cell_center_grid(3, 4, 8).numpy(),
      np.asarray(jgeo.cell_center_grid(3, 4, 8)))


def test_geometry_matches_jax():
  rng = np.random.default_rng(8)
  w = rng.normal(size=(5, 3)).astype(np.float32)
  w[0] = 0.0
  np.testing.assert_allclose(
      tgeo.axis_angle_to_matrix(t(w)).numpy(),
      np.asarray(jgeo.axis_angle_to_matrix(jnp.asarray(w))), atol=1e-6)
  M = (np.asarray(jgeo.axis_angle_to_matrix(jnp.asarray(w)))
       + rng.normal(size=(5, 3, 3)).astype(np.float32) * 0.05)
  M[1, :, 2] *= -1  # det < 0: flipped into SO(3)
  R = tgeo.orthonormalize_rotation(t(M))
  np.testing.assert_allclose(
      R.numpy(), np.asarray(jgeo.orthonormalize_rotation(jnp.asarray(M))),
      atol=1e-5)
  np.testing.assert_allclose(torch.linalg.det(R).numpy(), 1.0, atol=1e-5)
  T = np.asarray(jgeo.make_pose(jnp.asarray(R.numpy()),
                                jnp.asarray(w)))
  np.testing.assert_allclose(
      tgeo.invert_pose(t(T)).numpy(),
      np.asarray(jax.vmap(jgeo.invert_pose)(jnp.asarray(T))), atol=1e-6)
  np.testing.assert_allclose(
      tgeo.hat(t(w)).numpy(), np.asarray(jgeo.hat(jnp.asarray(w))))


# The batched solve: a leading frame dim T through select_confident,
# sample_hypotheses, solve_with_indices and refine_pnp_lm, held against the
# JAX package's solve under jax.vmap over frames (per-frame keys, their
# index sets reproduced here) and against T single calls of the port on the
# same indices. Tolerances as above against JAX; against the single calls
# rtol 1e-4 / atol 1e-5 on T_wc (batched and single products may sum in
# another order), inlier counts equal.

def _frames(T, n=400, seed=20):
  rng = np.random.default_rng(seed)
  scenes = [synth_scene(rng, n=n, noise_px=1.0, outlier_frac=0.3)
            for _ in range(T)]
  uv, X, T_wc, K = (np.stack(a) for a in zip(*scenes))
  var = rng.uniform(0.5, 2.0, (T, n)).astype(np.float32)
  valid = np.ones((T, n), bool)
  valid[:, :10] = False
  valid[1, 10:30] = False  # the frames differ in their valid sets
  return uv, X, var, valid, T_wc, K[0]


def test_batched_solve_with_indices_matches_jax_vmap_and_single_calls():
  T, n, k, M = 3, 400, 256, 64
  uv, X, var, valid, T_wc, K = _frames(T, n)
  jcfg = jransac.RansacConfig(num_hypotheses=M, top_k=k)
  cfg = transac.RansacConfig(num_hypotheses=M, top_k=k)
  keys = jax.random.split(jax.random.key(4), T)
  want = jax.vmap(lambda u, x, v, m, key: jransac.solve_pnp_ransac(
      u, x, v, m, jnp.asarray(K), key, jcfg))(
          *(jnp.asarray(a) for a in (uv, X, var, valid)), keys)
  jsel = jax.vmap(lambda u, x, v, m: jransac.select_confident(u, x, v, m, k))(
      *(jnp.asarray(a) for a in (uv, X, var, valid)))
  idx = np.stack([np.array(_jax_indices(jsel[2][f], k, M, keys[f]))
                  for f in range(T)])
  tuv, tX, tw = transac.select_confident(t(uv), t(X), t(var),
                                         torch.from_numpy(valid), k)
  for g, w in zip((tuv, tX, tw), jsel):
    np.testing.assert_array_equal(g.numpy(), np.asarray(w))
  tidx = torch.from_numpy(idx).long()
  got = transac.solve_with_indices(tuv, tX, tw, t(K), tidx, cfg)
  assert got["T_wc"].shape == (T, 4, 4)
  np.testing.assert_allclose(got["T_wc"].numpy(), np.asarray(want["T_wc"]),
                             atol=1e-3)
  np.testing.assert_array_equal(got["num_inliers"].numpy(),
                                np.asarray(want["num_inliers"]))
  np.testing.assert_allclose(got["inlier_ratio"].numpy(),
                             np.asarray(want["inlier_ratio"]), rtol=1e-6)
  for f in range(T):
    one = transac.solve_with_indices(tuv[f], tX[f], tw[f], t(K), tidx[f],
                                     cfg)
    np.testing.assert_allclose(got["T_wc"][f].numpy(), one["T_wc"].numpy(),
                               rtol=1e-4, atol=1e-5)
    assert got["num_inliers"][f].item() == one["num_inliers"].item()
    np.testing.assert_allclose(got["mean_inlier_error_px"][f].item(),
                               one["mean_inlier_error_px"].item(),
                               rtol=1e-4)
    assert tgeo.translation_error(got["T_wc"][f], t(T_wc[f])).item() < 0.05


def test_batched_pieces_equal_single_frames():
  T, n = 3, 120
  uv, X, var, valid, _, K = _frames(T, n, seed=21)
  sel = transac.select_confident(t(uv), t(X), t(var),
                                 torch.from_numpy(valid), 64)
  for f in range(T):
    one = transac.select_confident(t(uv[f]), t(X[f]), t(var[f]),
                                   torch.from_numpy(valid[f]), 64)
    for g, w in zip(sel, one):
      assert torch.equal(g[f], w)
  # shared pixels (one grid for all frames) broadcast over the frames
  shared = transac.select_confident(t(uv[0]), t(X), t(var),
                                    torch.from_numpy(valid), 64)
  assert shared[0].shape == (T, 64, 2)
  w = sel[2].clone()
  w[2] = 0.0  # a frame with no valid slot samples over all of them
  idx = transac.sample_hypotheses(w, 50, 6, torch.Generator().manual_seed(0))
  assert idx.shape == (T, 50, 6)
  for f in range(T):
    for row in idx[f].tolist():
      assert len(set(row)) == 6 and all(w[f, i] > 0 or f == 2 for i in row)
  # the LM polish, T frames at once against one by one
  R0 = torch.stack([tgeo.axis_angle_to_matrix(t([0.05 * f, -0.04, 0.03]))
                    for f in range(T)])
  t0 = t(np.random.default_rng(1).normal(size=(T, 3)))
  R, tt = tpnp.refine_pnp_lm(sel[0], sel[1], t(K), R0, t0, sel[2], iters=5)
  for f in range(T):
    R1, t1 = tpnp.refine_pnp_lm(sel[0][f], sel[1][f], t(K), R0[f], t0[f],
                                sel[2][f], iters=5)
    np.testing.assert_allclose(R[f].numpy(), R1.numpy(), rtol=1e-4,
                               atol=1e-5)
    np.testing.assert_allclose(tt[f].numpy(), t1.numpy(), rtol=1e-4,
                               atol=1e-5)


def test_from_maps_batched_recovers_known_poses():
  """(T, h, w) maps of known scenes through one batched solve: each frame's
  pose back; a 3-dim map stack is refused."""
  rng = np.random.default_rng(9)
  T, h, w, stride = 4, 30, 40, 8
  K = np.asarray(jgeo.make_intrinsics(*jgeo.SEVEN_SCENES_K))
  grid = np.asarray(jgeo.cell_center_grid(h, w, stride)).reshape(-1, 2)
  coords, poses = [], []
  for _ in range(T):
    R_wc = np.asarray(jgeo.axis_angle_to_matrix(
        jnp.asarray(rng.normal(size=3) * 0.2, jnp.float32)))
    t_wc = rng.normal(size=3).astype(np.float32)
    depth = rng.uniform(1.0, 4.0, h * w)
    rays = np.concatenate([grid, np.ones((h * w, 1))], 1) @ np.linalg.inv(K).T
    pc = rays * depth[:, None]
    X = pc @ R_wc.T + t_wc
    out = rng.choice(h * w, h * w // 4, replace=False)
    X[out] += rng.normal(size=(len(out), 3)) * 2.0
    coords.append(X.reshape(h, w, 3).astype(np.float32))
    T_wc = np.eye(4)
    T_wc[:3, :3], T_wc[:3, 3] = R_wc, t_wc
    poses.append(T_wc)
  var = t(rng.uniform(0.5, 2.0, (T, h, w, 1)))
  ones = torch.ones(var.shape, dtype=torch.bool)
  got = transac.solve_pnp_from_maps_batched(
      t(np.stack(coords)), var, ones, t(K), torch.Generator().manual_seed(0),
      stride=stride, config=transac.RansacConfig(num_hypotheses=128))
  assert got["T_wc"].shape == (T, 4, 4)
  for f in range(T):
    assert tgeo.translation_error(got["T_wc"][f], t(poses[f])).item() < 0.02
    assert tgeo.rotation_error_deg(got["T_wc"][f], t(poses[f])).item() < 0.5
  with pytest.raises(ValueError):
    transac.solve_pnp_from_maps_batched(t(coords[0]), var[0], ones[0], t(K))
