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
