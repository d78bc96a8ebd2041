"""The toy family's plain reference: KFNet's reference measurement
(``kfnet_ref.measure``) and pose solve (``kfnet_ref.solve``), float32
with TF32 off."""

from __future__ import annotations

from perfbench.reference import kfnet_ref

REFERENCE = kfnet_ref.REFERENCE


def measure(params, cfg: dict, frames, prec=REFERENCE):
  """(z, V) of (..., H, W, 3) uint8 frames."""
  return kfnet_ref.measure(params, cfg, frames, prec)


def solve(z, V, K, draws, cfg: dict, prec=REFERENCE):
  """(T_wc (T, 4, 4), inliers (T,)) of (T, h, w, 3) maps."""
  return kfnet_ref.solve(z, V, K, draws, cfg["ransac"], cfg["pose_stride"],
                         prec)
