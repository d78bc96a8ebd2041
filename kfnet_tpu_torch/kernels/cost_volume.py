"""Cost volume for OFlowNet (port of ``kfnet_tpu/kernels/cost_volume.py``,
which is plain XLA, not a Pallas kernel; plain PyTorch here).

``cv[..., k]`` for k = (dy+r)·(2r+1) + (dx+r) is the correlation between
feat_cur at p and feat_prev at p + (dx, dy), divided by C, and zero where
the shifted window leaves the previous frame.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def cost_volume(feat_prev: torch.Tensor, feat_cur: torch.Tensor,
                radius: int = 4) -> torch.Tensor:
  """(..., H, W, C) features -> (..., H, W, (2r+1)²) float32 correlations.

  The operands are cast to float32 before the product (a bf16·bf16
  product is exact in f32). One pass per row offset dy: the padded
  previous rows are unfolded into their 2r+1 column shifts (a view), so
  the volume takes 2r+1 products instead of (2r+1)²."""
  h, w, c = feat_prev.shape[-3:]
  r = radius
  prev_p = F.pad(feat_prev.to(torch.float32), (0, 0, r, r, r, r))
  cur32 = feat_cur.to(torch.float32)
  scale = 1.0 / float(c)
  slabs = []
  for dy in range(-r, r + 1):
    rows = prev_p[..., dy + r:dy + r + h, :, :]         # (..., h, w+2r, C)
    win = rows.unfold(-2, 2 * r + 1, 1)                 # (..., h, w, C, 2r+1)
    slabs.append(torch.sum(cur32[..., None] * win, dim=-2) * scale)
  return torch.cat(slabs, dim=-1)
