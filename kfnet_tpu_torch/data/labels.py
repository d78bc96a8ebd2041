"""Scene-coordinate labels (port of ``kfnet_tpu/data/labels.py``): depth and
pose -> 1/8-resolution coordinate maps and validity masks, the per-scene
normalisation statistics, and ``save`` / ``load`` of label files."""

from __future__ import annotations

import os
from typing import Iterable

import numpy as np
import torch

from kfnet_tpu_torch.core import geometry as geo


def generate(depth: torch.Tensor, K: torch.Tensor, T_wc: torch.Tensor,
             stride: int = 8, min_depth: float = 0.05,
             max_depth: float = 20.0):
  """(H, W) depth + pose -> ((h, w, 3) coordinates, (h, w) valid), on the
  inputs' device."""
  return geo.depth_to_world_coords(depth, K, T_wc, stride=stride,
                                   min_depth=min_depth, max_depth=max_depth)


def scene_statistics(coords_list: Iterable[np.ndarray],
                     valid_list: Iterable[np.ndarray]):
  """Mean (3,) float32 and one std of the valid scene coordinates (float64
  sums on the host): SCoordNet's ``coord_offset`` / ``coord_scale``."""
  total = np.zeros(3, np.float64)
  total_sq = np.zeros(3, np.float64)
  count = 0
  for coords, valid in zip(coords_list, valid_list):
    c = np.asarray(coords).reshape(-1, 3)
    c = c[np.asarray(valid).reshape(-1).astype(bool)]
    total += c.sum(0)
    total_sq += (c ** 2).sum(0)
    count += c.shape[0]
  if count == 0:
    # a degenerate coord_scale would be baked into the net's config
    raise ValueError(
        "scene_statistics: no valid label pixels in any sampled frame — "
        "check depth_scale / min_depth / max_depth against the dataset")
  mean = total / count
  var = total_sq / count - mean ** 2
  std = float(np.sqrt(np.maximum(var, 1e-12).mean()))
  return mean.astype(np.float32), std


def save(path: str, coords, valid):
  os.makedirs(os.path.dirname(path), exist_ok=True)
  np.savez_compressed(path, coords=np.asarray(coords, np.float32),
                      valid=np.asarray(valid, bool))


def load(path: str):
  with np.load(path) as f:
    return f["coords"], f["valid"]
