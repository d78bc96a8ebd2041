"""The port's P3P solver (kfnet_tpu_torch/pose/p3p.py) and RANSAC's
``solver="p3p"`` against the JAX package's, float32 on the CPU.

Tolerances: Durand–Kerner roots within 1e-4 (complex64, 40 iterations on
both sides); on triangles from known poses that are well conditioned (the
JAX package's own candidate within 1e-4 of the truth: float32 P3P loses up
to 1e-3 on the others, in both packages) the candidate nearest the truth
within 1e-4 of JAX's and within 1e-3 of the truth;
``solve_with_indices`` fed JAX's index sets within the DLT parity test's
atol 1e-3 on T_wc (tests/test_torch_pose.py), with the OpenCV oracle of
tests/test_pnp.py:116 beside it.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfnet_tpu.core import geometry as jgeo
from kfnet_tpu.pose import p3p as jp3p
from kfnet_tpu.pose import ransac as jransac
from kfnet_tpu_torch.core import geometry as tgeo
from kfnet_tpu_torch.pose import p3p as tp3p
from kfnet_tpu_torch.pose import ransac as transac
from tests.test_pnp import synth_scene


def t(a):
  return torch.from_numpy(np.array(a, np.float32))


def _match(got, want):
  """Largest distance from a root of ``want`` to its nearest in ``got``."""
  return max(float(np.min(np.abs(got - w))) for w in want)


def test_quartic_roots_match_jax():
  rng = np.random.default_rng(0)
  coeffs = [np.poly([1.0, 2.0, 3.0, 4.0])]                  # real roots
  coeffs.append(np.poly([0.5, -1.5, 0.3 + 0.8j, 0.3 - 0.8j]).real)
  coeffs += [rng.normal(size=5) for _ in range(6)]
  coeffs = np.stack(coeffs).astype(np.float32)
  got = tp3p.durand_kerner_quartic(t(coeffs)).numpy()
  assert got.dtype == np.complex64 and got.shape == (len(coeffs), 4)
  for c, g in zip(coeffs, got):
    want = np.asarray(jp3p.durand_kerner_quartic(jnp.asarray(c)))
    assert _match(g, want) < 1e-4, (c, g, want)
  np.testing.assert_allclose(np.sort(got[0].real), [1, 2, 3, 4], atol=1e-4)


def _minimal_sets(n, seed=1):
  """n well-conditioned triangles seen from known poses: (uv (n, 3, 2), X
  (n, 3, 3), T_cw (n, 4, 4)), float32."""
  rng = np.random.default_rng(seed)
  K = np.asarray(jgeo.make_intrinsics(*jgeo.SEVEN_SCENES_K))
  uvs, Xs, Ts = [], [], []
  while len(uvs) < n:
    w = rng.normal(size=3) * 0.4
    R_wc = np.asarray(jgeo.axis_angle_to_matrix(jnp.asarray(w, jnp.float32)))
    t_wc = rng.normal(size=3).astype(np.float32)
    T_wc = np.asarray(jgeo.make_pose(jnp.asarray(R_wc), jnp.asarray(t_wc)))
    pc = np.stack([rng.uniform(-1, 1, 3), rng.uniform(-0.8, 0.8, 3),
                   rng.uniform(1.5, 4, 3)], -1).astype(np.float32)
    # well conditioned: sides of at least 0.5 m, far from collinear
    a, b = pc[1] - pc[0], pc[2] - pc[0]
    if (min(np.linalg.norm(pc[i] - pc[j]) for i, j in ((0, 1), (0, 2), (1, 2)))
        < 0.5 or np.linalg.norm(np.cross(a, b)) < 0.3):
      continue
    X = pc @ R_wc.T + t_wc
    uv, _ = jgeo.project(jnp.asarray(X), jnp.asarray(K), jnp.asarray(T_wc))
    uvs.append(np.asarray(uv))
    Xs.append(X.astype(np.float32))
    Ts.append(np.asarray(jgeo.invert_pose(jnp.asarray(T_wc))))
  return np.stack(uvs), np.stack(Xs), np.stack(Ts), K


def _nearest(Rs, ts, T_cw):
  err = [np.abs(Rs[i] - T_cw[:3, :3]).max() + np.abs(ts[i] - T_cw[:3, 3]).max()
         for i in range(4)]
  i = int(np.argmin(err))
  return i, err[i]


def test_p3p_matches_jax_on_known_poses():
  uv, X, T_cw, K = _minimal_sets(20)
  Rs, ts = tp3p.p3p_grunert(t(uv), t(X), t(K))   # one batched call
  assert Rs.shape == (20, 4, 3, 3) and ts.shape == (20, 4, 3)
  Rs, ts = Rs.numpy(), ts.numpy()
  assert np.isfinite(Rs).all() and np.isfinite(ts).all()
  held = 0
  for n in range(20):
    jR, jt = jp3p.p3p_grunert(jnp.asarray(uv[n]), jnp.asarray(X[n]),
                              jnp.asarray(K))
    jR, jt = np.asarray(jR), np.asarray(jt)
    ji, jerr = _nearest(jR, jt, T_cw[n])
    if jerr > 1e-4:  # not well conditioned in float32
      continue
    i, err = _nearest(Rs[n], ts[n], T_cw[n])
    assert err < 1e-3, (n, err)
    np.testing.assert_allclose(Rs[n, i], jR[ji], atol=1e-4)
    np.testing.assert_allclose(ts[n, i], jt[ji], atol=1e-4)
    held += 1
  assert held >= 10, held


def _jax_indices(w, k, num_hypotheses, size, rng_key):
  """kfnet_tpu/pose/ransac.py's hypothesis sampling, step for step."""
  logits = jnp.where(w > 0, 0.0, -jnp.inf)
  logits = jnp.where(jnp.any(w > 0), logits, jnp.zeros_like(logits))
  sample = lambda key: jax.random.choice(
      key, k, shape=(size,), replace=False, p=jax.nn.softmax(logits))
  return jax.vmap(sample)(jax.random.split(rng_key, num_hypotheses))


@pytest.mark.parametrize("seed", [5, 6])
def test_p3p_solve_with_indices_matches_jax(seed):
  rng = np.random.default_rng(seed)
  n = 400
  uv, X, T_wc, K = synth_scene(rng, n=n, noise_px=1.0, outlier_frac=0.5)
  var = rng.uniform(0.5, 2.0, n).astype(np.float32)
  valid = np.ones(n, bool)
  cfg = transac.RansacConfig(num_hypotheses=64, top_k=256, solver="p3p")
  jcfg = jransac.RansacConfig(num_hypotheses=64, top_k=256, solver="p3p")
  assert cfg.draw_size == 3
  key = jax.random.key(seed)
  want = jransac.solve_pnp_ransac(*(jnp.asarray(a) for a in
                                    (uv, X, var, valid, K)), key, jcfg)
  _, _, jw = jransac.select_confident(*(jnp.asarray(a) for a in
                                        (uv, X, var, valid)), 256)
  idx = np.array(_jax_indices(jw, 256, 64, 3, key))
  tuv, tX, tw = transac.select_confident(t(uv), t(X), t(var),
                                         torch.from_numpy(valid), 256)
  got = transac.solve_with_indices(tuv, tX, tw, t(K),
                                   torch.from_numpy(idx).long(), cfg)
  np.testing.assert_allclose(got["T_wc"].numpy(), np.asarray(want["T_wc"]),
                             atol=1e-3)
  assert got["num_inliers"].item() == float(want["num_inliers"])
  # and two frames at once, as the served fleet solves them
  both = transac.solve_with_indices(
      *(torch.stack([a, a]) for a in (tuv, tX, tw)), t(K),
      torch.from_numpy(np.stack([idx, idx])).long(), cfg)
  np.testing.assert_allclose(both["T_wc"][1].numpy(), got["T_wc"].numpy(),
                             atol=1e-5)


def test_p3p_ransac_low_inlier_ratio_and_opencv_oracle():
  cv2 = pytest.importorskip("cv2")
  rng = np.random.default_rng(5)
  uv, X, T_wc, K = synth_scene(rng, n=400, noise_px=1.0, outlier_frac=0.6)
  cfg = transac.RansacConfig(num_hypotheses=128, top_k=400, solver="p3p")
  gen = torch.Generator().manual_seed(0)
  out = transac.solve_pnp_ransac(t(uv), t(X), torch.ones(400),
                                 torch.ones(400, dtype=torch.bool), t(K),
                                 gen, cfg)
  T_gt = t(T_wc)
  assert tgeo.translation_error(out["T_wc"], T_gt).item() < 0.05
  assert tgeo.rotation_error_deg(out["T_wc"], T_gt).item() < 1.0
  ok, rvec, tvec, _ = cv2.solvePnPRansac(
      np.asarray(X, np.float64), np.asarray(uv, np.float64),
      np.asarray(K, np.float64), None, reprojectionError=10.0,
      iterationsCount=256, flags=cv2.SOLVEPNP_EPNP)
  assert ok
  T_cv = tgeo.invert_pose(tgeo.make_pose(t(cv2.Rodrigues(rvec)[0]),
                                         t(tvec[:, 0])))
  assert tgeo.translation_error(T_cv, T_gt).item() < 0.05
  assert tgeo.translation_error(out["T_wc"], T_cv).item() < 0.08


def test_unknown_solver_raises():
  with pytest.raises(ValueError, match="solver"):
    transac.RansacConfig(solver="epnp")
  assert transac.RansacConfig().draw_size == 6
