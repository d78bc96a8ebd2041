"""The port's camera geometry (kfnet_tpu_torch/core/geometry.py) against
the JAX package's on the same inputs, float32 on the CPU.

Tolerance: rtol 1e-5 / atol 1e-5 (float32 products summed in another
order); grids, intrinsics and validity masks exactly.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfnet_tpu.core import geometry as jgeo
from kfnet_tpu_torch.core import geometry as tgeo

TOL = dict(rtol=1e-5, atol=1e-5)


def t(a):
  return torch.from_numpy(np.array(a, np.float32))


def _pose(rng, angle=0.6):
  w = rng.normal(size=3) * angle
  R = np.asarray(jgeo.axis_angle_to_matrix(jnp.asarray(w, jnp.float32)))
  return np.asarray(jgeo.make_pose(jnp.asarray(R),
                                   jnp.asarray(rng.normal(size=3),
                                               jnp.float32)))


def test_intrinsics_and_grids_equal():
  np.testing.assert_array_equal(
      tgeo.make_intrinsics(*tgeo.SEVEN_SCENES_K).numpy(),
      np.asarray(jgeo.make_intrinsics(*jgeo.SEVEN_SCENES_K)))
  assert tgeo.SEVEN_SCENES_K == jgeo.SEVEN_SCENES_K
  np.testing.assert_array_equal(tgeo.pixel_grid(5, 7).numpy(),
                                np.asarray(jgeo.pixel_grid(5, 7)))


@pytest.mark.parametrize("with_pixels", [False, True])
def test_backproject_matches_jax(with_pixels):
  rng = np.random.default_rng(0)
  depth = rng.uniform(0.5, 5.0, (6, 8)).astype(np.float32)
  K = np.asarray(jgeo.make_intrinsics(60.0, 58.0, 3.5, 2.5))
  pixels = (np.asarray(jgeo.cell_center_grid(6, 8, 8)) if with_pixels
            else None)
  want = jgeo.backproject(jnp.asarray(depth), jnp.asarray(K),
                          None if pixels is None else jnp.asarray(pixels))
  got = tgeo.backproject(t(depth), t(K),
                         None if pixels is None else t(pixels))
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_transform_and_project_match_jax():
  rng = np.random.default_rng(1)
  T = _pose(rng)
  K = np.asarray(jgeo.make_intrinsics(*jgeo.SEVEN_SCENES_K))
  X = rng.normal(size=(4, 5, 3)).astype(np.float32) + [0, 0, 4]
  np.testing.assert_allclose(
      tgeo.transform_points(t(T), t(X)).numpy(),
      np.asarray(jgeo.transform_points(jnp.asarray(T), jnp.asarray(X))),
      **TOL)
  uv, z = tgeo.project(t(X), t(K), t(T))
  juv, jz = jgeo.project(jnp.asarray(X), jnp.asarray(K), jnp.asarray(T))
  np.testing.assert_allclose(z.numpy(), np.asarray(jz), **TOL)
  # pixels are hundreds: the float32 division's relative error
  np.testing.assert_allclose(uv.numpy(), np.asarray(juv), rtol=1e-5,
                             atol=1e-3)


@pytest.mark.parametrize("stride", [1, 8])
def test_depth_to_world_coords_matches_jax(stride):
  rng = np.random.default_rng(2)
  depth = rng.uniform(0.5, 5.0, (48, 64)).astype(np.float32)
  depth[rng.uniform(size=depth.shape) < 0.2] = 0.0    # invalid
  depth[3, 3] = np.nan
  depth[11, 19] = 2e3                                 # beyond max_depth
  K = np.asarray(jgeo.make_intrinsics(60.0, 60.0, 31.5, 23.5))
  T = _pose(rng)
  coords, valid = tgeo.depth_to_world_coords(t(depth), t(K), t(T), stride)
  jc, jv = jgeo.depth_to_world_coords(jnp.asarray(depth), jnp.asarray(K),
                                      jnp.asarray(T), stride)
  np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
  assert not valid.all() and valid.any()
  np.testing.assert_allclose(coords.numpy(), np.asarray(jc), **TOL)


def test_matrix_to_axis_angle_matches_jax():
  rng = np.random.default_rng(3)
  axes = rng.normal(size=(6, 3))
  axes /= np.linalg.norm(axes, axis=1, keepdims=True)
  # generic, tiny, zero and near-π angles (the three regimes)
  angles = np.array([0.7, 2.0, 1e-5, 0.0, np.pi - 1e-4, np.pi - 2e-3])
  w = (axes * angles[:, None]).astype(np.float32)
  R = np.asarray(jgeo.axis_angle_to_matrix(jnp.asarray(w)))
  got = tgeo.matrix_to_axis_angle(t(R)).numpy()
  want = np.asarray(jgeo.matrix_to_axis_angle(jnp.asarray(R)))
  np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)
  # and the round trip away from π (there float32 loses the axis in both)
  back = tgeo.axis_angle_to_matrix(torch.from_numpy(got[:4])).numpy()
  np.testing.assert_allclose(back, R[:4], atol=1e-5)


def test_orthonormalize_rotation_svd_matches_jax():
  rng = np.random.default_rng(4)
  M = rng.normal(size=(5, 3, 3)).astype(np.float32)
  M[0] = np.diag([1.0, 1.0, -1.0]).astype(np.float32)  # a reflection
  got = tgeo.orthonormalize_rotation_svd(t(M)).numpy()
  want = np.asarray(jgeo.orthonormalize_rotation_svd(jnp.asarray(M)))
  np.testing.assert_allclose(got, want, atol=1e-5)
  np.testing.assert_allclose(np.linalg.det(got), 1.0, atol=1e-5)
  # the solver's polar form agrees where det > 0
  pos = np.linalg.det(M) > 0
  np.testing.assert_allclose(tgeo.orthonormalize_rotation(t(M)).numpy()[pos],
                             got[pos], atol=1e-4)
