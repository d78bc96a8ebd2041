"""The port's pose smoother (kfnet_tpu_torch/pose/smoothing.py, host numpy
float64) against the JAX package's on the cases of
tests/test_pose_smoothing.py: both are the same float64 arithmetic, so
every output is held equal exactly."""

import numpy as np
import pytest

from kfnet_tpu.pose import smoothing as jsm
from kfnet_tpu_torch.pose import smoothing as tsm


def _traj(n=120, scale=1.0, step=0.02):
  T = np.zeros((n, 4, 4))
  for t in range(n):
    ang = 0.01 * t
    c, s = np.cos(ang), np.sin(ang)
    T[t] = np.eye(4)
    T[t][:3, :3] = [[c, -s, 0], [s, c, 0], [0, 0, 1]]
    T[t][:3, 3] = scale * np.asarray(
        [step * t, 0.3 * np.sin(0.05 * t), 0.1 * np.cos(0.03 * t)])
  return T


def _noisy(T, seed=0, t_sigma=0.02, r_sigma_deg=0.5, scale=1.0):
  rng = np.random.default_rng(seed)
  out = T.copy()
  for t in range(len(T)):
    out[t][:3, 3] += scale * t_sigma * rng.standard_normal(3)
    w = np.radians(r_sigma_deg) * rng.standard_normal(3)
    out[t][:3, :3] = out[t][:3, :3] @ jsm._exp_so3(w)
  return out


def _teleport():
  T = _noisy(_traj(60), seed=1)
  T[30:, :3, 3] += [5.0, 0.0, 0.0]
  return T


def _outlier():
  T = _noisy(_traj(60), seed=2)
  T[25, :3, 3] += [1.5, -0.8, 0.3]
  return T


def _flip():
  T = _noisy(_traj(40), seed=3)
  T[20:, :3, :3] = T[20:, :3, :3] @ np.diag([-1.0, -1.0, 1.0])  # 180°
  return T


CASES = {
    "noisy": (lambda: _noisy(_traj()), {}, None),
    "beta_zero": (lambda: _noisy(_traj()), {"beta": 0.0}, None),
    "teleport": (_teleport, {}, None),
    "reset_mask": (lambda: _noisy(_traj(50), seed=4), {},
                   np.arange(50) % 17 == 5),
    "scale_20": (lambda: _noisy(_traj(scale=20.0), scale=20.0), {}, None),
    "outlier": (_outlier, {"beta": 0.6}, None),
    "rotation_flip": (_flip, {"rot_gate_deg": 10.0}, None),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_smooth_trajectory_equals_jax(case):
  make, kw, reset = CASES[case]
  T = make()
  got = tsm.smooth_trajectory(T, tsm.SmootherConfig(**kw), reset=reset)
  want = jsm.smooth_trajectory(T, jsm.SmootherConfig(**kw), reset=reset)
  np.testing.assert_array_equal(got, want)
  # streaming equals offline in the port too
  sm = tsm.PoseSmoother(tsm.SmootherConfig(**kw))
  stream = []
  for i in range(len(T)):
    if reset is not None and reset[i]:
      sm.reset()
    stream.append(sm.update(T[i]))
  np.testing.assert_array_equal(np.stack(stream), got)
  R = got[:, :3, :3]
  np.testing.assert_allclose(R @ np.swapaxes(R, 1, 2),
                             np.broadcast_to(np.eye(3), R.shape), atol=1e-9)


def test_log_exp_so3_equal_jax():
  rng = np.random.default_rng(5)
  ws = [rng.normal(size=3) * s for s in (1e-14, 1e-3, 0.5, 2.0)]
  ws.append(np.array([0.0, 0.0, np.pi]))
  for w in ws:
    R = tsm._exp_so3(w)
    np.testing.assert_array_equal(R, jsm._exp_so3(w))
    np.testing.assert_array_equal(tsm._log_so3(R), jsm._log_so3(R))
  assert tsm.SmootherConfig() == tsm.SmootherConfig(
      **{f: getattr(jsm.SmootherConfig(), f)
         for f in jsm.SmootherConfig.__dataclass_fields__})
