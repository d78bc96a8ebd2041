"""The two heads' output steps: raw float32 head -> (mean, variance).

One function per head, used by the nets (``models/oflownet.output_step``,
``models/scoordnet.output_step``) and by the fused filter kernel's plain
version (``kernels/fused_filter.fused_filter_step_reference``); the kernel
computes the same in its registers. The nets pass their own log-variance
clamps.
"""

from __future__ import annotations

import functools

import torch


def flow_output(raw: torch.Tensor, radius: int, log_var_clip):
  """OFlowNet's head: raw (..., 3) -> (flow ``r·tanh(raw[..., :2])``
  (..., 2), process variance ``exp(clamp(raw[..., 2:3], *log_var_clip))``
  (..., 1))."""
  flow = float(radius) * torch.tanh(raw[..., :2])
  log_var = torch.clamp(raw[..., 2:3], *log_var_clip)
  return flow, torch.exp(log_var)


@functools.lru_cache(maxsize=16)
def _offset_tensor(offset: tuple, device: torch.device) -> torch.Tensor:
  # cached: a host->device copy of a fresh tensor would sync every frame
  return torch.tensor(offset, dtype=torch.float32, device=device)


def coord_output(raw: torch.Tensor, coord_scale: float, coord_offset,
                 log_var_clip):
  """SCoordNet's head: raw (..., 4) -> (coords ``raw[..., :3] ·
  coord_scale + coord_offset`` (..., 3), variance ``exp(clamp(raw[...,
  3:4], *log_var_clip)) · coord_scale²`` (..., 1))."""
  log_var = torch.clamp(raw[..., 3:4], *log_var_clip)
  offset = _offset_tensor(tuple(float(o) for o in coord_offset), raw.device)
  coords = raw[..., :3] * coord_scale + offset
  variance = torch.exp(log_var) * (coord_scale ** 2)
  return coords, variance
