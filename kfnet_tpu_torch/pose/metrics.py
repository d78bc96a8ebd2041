"""Pose-evaluation metrics: per-scene median translation (m) / rotation
(deg), matching the reference's DSAC++-protocol eval (a copy of
``kfnet_tpu/pose/metrics.py``, host numpy in float64)."""

from __future__ import annotations

import numpy as np


def pose_errors(T_est, T_gt):
  """Per-frame (translation m, rotation deg) errors. Accepts (T, 4, 4).

  Computed host-side in float64 with the arcsin/Frobenius geodesic form
  (that of the JAX package's ``geometry.rotation_error_deg``): all
  reported pose metrics must resolve well below 0.001°, since
  filter-vs-measurement comparisons live in the 0–0.5° regime where the
  f32 arccos form quantizes at ~0.03°.
  """
  T_est = np.asarray(T_est, np.float64)
  T_gt = np.asarray(T_gt, np.float64)
  t = np.linalg.norm(T_est[..., :3, 3] - T_gt[..., :3, 3], axis=-1)
  diff = T_est[..., :3, :3] - T_gt[..., :3, :3]
  fro = np.sqrt(np.sum(diff * diff, axis=(-1, -2)))
  sin_half = np.clip(fro / (2.0 * np.sqrt(2.0)), 0.0, 1.0)
  theta_small = 2.0 * np.arcsin(sin_half)
  R = T_est[..., :3, :3] @ np.swapaxes(T_gt[..., :3, :3], -1, -2)
  trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
  cos_t = np.clip((trace - 1.0) / 2.0, -1.0, 1.0)
  r = np.degrees(np.where(cos_t > 0.0, theta_small, np.arccos(cos_t)))
  return t, r


def median_errors(T_est, T_gt):
  """(median translation m, median rotation deg) over a sequence."""
  t, r = pose_errors(T_est, T_gt)
  return float(np.median(t)), float(np.median(r))


def accuracy_at(T_est, T_gt, t_thresh_m: float = 0.05,
                r_thresh_deg: float = 5.0) -> float:
  """Fraction of frames within (5cm, 5deg) — the standard 7-Scenes
  accuracy figure reported alongside medians."""
  t, r = pose_errors(T_est, T_gt)
  return float(np.mean((t <= t_thresh_m) & (r <= r_thresh_deg)))


def report(scene: str, T_est, T_gt) -> dict:
  """Structured JSON-able per-scene report."""
  med_t, med_r = median_errors(T_est, T_gt)
  return {
      "scene": scene,
      "frames": int(np.asarray(T_est).shape[0]),
      "median_translation_m": med_t,
      "median_rotation_deg": med_r,
      "accuracy_5cm_5deg": accuracy_at(T_est, T_gt),
  }
