"""Gated constant-velocity SE(3) pose smoothing, a serving option after
the pose solve (the port's own copy of ``kfnet_tpu/pose/smoothing.py``,
which imports no JAX; the port imports nothing of the JAX package).

Coordinate-space filtering leaves the per-frame iid scatter of the PnP
solutions in pose space, where a constant-velocity SE(3) predictor blended
geodesically toward the prediction averages it out.
  - Host numpy float64 on purpose: the input is the solver's (4, 4) pose a
    frame, a few bytes, and float32 trigonometry near the identity
    quantizes (the pose metrics are float64 host math for the same
    reason).
  - The relock gate is scale-aware: it compares the prediction's gap to
    the measurement against an EMA of the measured frame-to-frame motion,
    with an absolute floor for near-static streams. A tripped gate emits
    the measurement and drops the velocity, as the filter's χ² test trusts
    the measurement on inconsistency.
  - Off by default everywhere (``OnlineRelocalizer(smoother=...)``,
    ``FleetRelocalizer(smoother=...)``): the reference solves each frame
    with no pose-space coupling.
"""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class SmootherConfig:
  """Knobs for the gated constant-velocity smoother.

  beta: weight on the constant-velocity prediction (0 = pass-through,
    1 = ignore measurements — never use 1). The calibration study
    (docs/CALIBRATION.md §6) selects 0.4.
  gate_factor: relock when the prediction-vs-measurement translation gap
    exceeds ``gate_factor × (EMA of measured frame-to-frame motion)``.
  min_gate_m: absolute gate floor in meters, so near-static streams
    (motion EMA → 0) still tolerate solver scatter without relocking
    every frame.
  rot_gate_deg: relock when the prediction-vs-measurement geodesic
    rotation gap exceeds this (degrees).
  motion_ema: EMA rate for the motion-scale tracker (per frame).
  """
  beta: float = 0.4
  gate_factor: float = 3.0
  min_gate_m: float = 0.05
  rot_gate_deg: float = 30.0
  motion_ema: float = 0.2


def _log_so3(R: np.ndarray) -> np.ndarray:
  """SO(3) log map → rotation vector, f64, exact near identity
  (arcsin-of-norm branch; arccos branch only past 90°)."""
  w = 0.5 * np.asarray(
      [R[2, 1] - R[1, 2], R[0, 2] - R[2, 0], R[1, 0] - R[0, 1]])
  s = np.linalg.norm(w)           # = sin(theta)
  c = (np.trace(R) - 1.0) / 2.0   # = cos(theta)
  if s < 1e-12:
    if c > 0.0:
      return np.zeros(3)
    # theta ≈ pi: axis from the dominant column of R + I
    A = R + np.eye(3)
    axis = A[:, int(np.argmax(np.diag(A)))]
    axis = axis / np.linalg.norm(axis)
    return np.pi * axis
  theta = np.arcsin(min(s, 1.0)) if c >= 0.0 else np.pi - np.arcsin(min(s, 1.0))
  return (theta / s) * w


def _exp_so3(w: np.ndarray) -> np.ndarray:
  theta = np.linalg.norm(w)
  if theta < 1e-12:
    return np.eye(3)
  k = w / theta
  K = np.asarray([[0.0, -k[2], k[1]], [k[2], 0.0, -k[0]],
                  [-k[1], k[0], 0.0]])
  return np.eye(3) + np.sin(theta) * K + (1.0 - np.cos(theta)) * (K @ K)


def _inv_se3(T: np.ndarray) -> np.ndarray:
  out = np.eye(4)
  out[:3, :3] = T[:3, :3].T
  out[:3, 3] = -T[:3, :3].T @ T[:3, 3]
  return out


class PoseSmoother:
  """Streaming form: one ``update`` per frame, O(1) state.

  Matches ``smooth_trajectory`` exactly (the offline form is this class
  run over the stack). ``reset()`` drops all history — wire it to the
  same signal that resets the filter state (e.g. a relocalization-stream
  restart in eval/online.py).
  """

  def __init__(self, config: SmootherConfig = SmootherConfig()):
    self.config = config
    self.reset()

  def reset(self):
    self._prev = None        # last emitted (smoothed) pose
    self._prev2 = None       # the one before (for the velocity estimate)
    self._prev_meas = None   # last MEASURED pose (motion-scale tracker)
    self._motion = None      # EMA of measured frame-to-frame translation

  def update(self, T_meas: np.ndarray) -> np.ndarray:
    """Consume one measured camera-to-world pose, emit the smoothed one."""
    cfg = self.config
    T = np.asarray(T_meas, np.float64)
    # The gate is computed from the PRE-update motion EMA, and the EMA
    # ingests each measured step CLIPPED to that gate: a single gross
    # PnP outlier can inflate the EMA by at most one gate_factor-bounded
    # contribution (instead of poisoning it outright, which would widen
    # the gate enough to blend the NEXT good frames toward the outlier),
    # while sustained genuine speed changes still re-seed the EMA within
    # a few frames of geometric growth. The first observed step seeds
    # the EMA unclipped (there is no scale to gate against yet).
    gate = max(cfg.gate_factor * (self._motion or 0.0), cfg.min_gate_m)
    if self._prev_meas is not None:
      step = float(np.linalg.norm(T[:3, 3] - self._prev_meas[:3, 3]))
      self._motion = (step if self._motion is None else
                      (1.0 - cfg.motion_ema) * self._motion
                      + cfg.motion_ema * min(step, gate))
    self._prev_meas = T

    if self._prev is None:
      out = T
    else:
      if self._prev2 is not None:
        pred = self._prev @ (_inv_se3(self._prev2) @ self._prev)
      else:
        pred = self._prev
      gap_t = float(np.linalg.norm(pred[:3, 3] - T[:3, 3]))
      dR = T[:3, :3].T @ pred[:3, :3]
      gap_r = np.degrees(np.linalg.norm(_log_so3(dR)))
      if gap_t > gate or gap_r > cfg.rot_gate_deg:
        # relock: emit the measurement, drop the (untrustworthy) velocity
        self._prev2, self._prev = None, T
        return T
      b = cfg.beta
      out = np.eye(4)
      out[:3, 3] = (1.0 - b) * T[:3, 3] + b * pred[:3, 3]
      out[:3, :3] = T[:3, :3] @ _exp_so3(b * _log_so3(dR))
    self._prev2, self._prev = self._prev, out
    return out


def smooth_trajectory(T_wc: np.ndarray,
                      config: SmootherConfig = SmootherConfig(),
                      reset: np.ndarray | None = None) -> np.ndarray:
  """Offline form: smooth a (T, 4, 4) camera-to-world trajectory.

  reset: optional (T,) bool mask; True drops all history before
  consuming that frame (stream restarts / scene cuts).
  """
  sm = PoseSmoother(config)
  out = []
  for t in range(len(T_wc)):
    if reset is not None and bool(reset[t]):
      sm.reset()
    out.append(sm.update(T_wc[t]))
  return np.stack(out)
