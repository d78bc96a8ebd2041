"""FLOP accounting for the filter pipeline (port of
``kfnet_tpu/eval/flops.py``): the bench reports a computed MFU, not just
frames per second.

The analytic count is the JAX package's, conv and cost-volume FLOPs of one
filter step (elementwise and GroupNorm work is bound by memory and adds
nothing to the total). Its cross-check is ``counted_flops``, PyTorch's
own count of the products an eager call runs (the counterpart of XLA's
cost analysis). The peak is the card's dense bf16 tensor-core rate, looked
up by its name; there is no default.
"""

from __future__ import annotations

import torch

from kfnet_tpu_torch.models.scoordnet import _adjusted_strides

# Dense bf16 tensor-core peak by CUDA device name (NVIDIA's data sheets,
# without sparsity), most specific name first.
_PEAK_BF16 = (
    ("H100 NVL", 835e12),
    ("H100 PCIe", 756e12),
    ("H100 80GB HBM3", 989.4e12),  # the SXM part
    ("H100 SXM", 989.4e12),
)


def peak_for(name: str) -> float | None:
  """The dense bf16 peak (FLOP/s) of a card by its name; None when the
  name is unknown."""
  for key, peak in _PEAK_BF16:
    if key in name:
      return peak
  return None


def peak_flops(device) -> float | None:
  """The dense bf16 peak (FLOP/s) of ``device``: None for a device that is
  not a card of the table (the CPU, an unknown GPU), so that no MFU is
  computed against a peak that is not the card's."""
  device = torch.device(device)
  if device.type != "cuda":
    return None
  return peak_for(torch.cuda.get_device_name(device))


def counted_flops(fn, *args) -> float:
  """FLOPs of the matrix products and convolutions that one eager call
  ``fn(*args)`` runs, by ``torch.utils.flop_counter.FlopCounterMode``.
  It counts ATen operators only: a hand-written kernel (the conv kernels,
  the fused update) runs outside its sight, so count a config whose
  convolutions are PyTorch's (``conv_impl="xla"``)."""
  from torch.utils.flop_counter import FlopCounterMode
  counter = FlopCounterMode(display=False)
  with counter:
    fn(*args)
  return float(counter.get_total_flops())


def _conv_flops(h, w, cin, cout, k, stride):
  ho, wo = -(-h // stride), -(-w // stride)
  return 2.0 * ho * wo * k * k * cin * cout, ho, wo


def scoordnet_flops(cfg, h, w) -> float:
  """Analytic conv FLOPs of one SCoordNet forward at (h, w) input."""
  f = cfg.stem_s2d
  if f > 1:
    h, w, cin = h // f, w // f, 3 * f * f
  else:
    cin = 3
  total = 0.0
  for c, s in zip(cfg.channels, _adjusted_strides(cfg.strides, cfg.stem_s2d)):
    fl, h, w = _conv_flops(h, w, cin, c, 3, s)
    total += fl
    cin = c
  fl, h, w = _conv_flops(h, w, cin, cfg.head_channels, 3, 1)
  total += fl
  fl, _, _ = _conv_flops(h, w, cfg.head_channels, 4, 1, 1)
  return total + fl


def oflownet_flops(cfg, h, w) -> float:
  """Analytic conv+cost-volume FLOPs of ONE OFlowNet step as used by the
  filter (one encoder pass per frame + cost volume + decoder)."""
  f = cfg.stem_s2d
  if f > 1:
    h, w, cin = h // f, w // f, 3 * f * f
  else:
    cin = 3
  total = 0.0
  for c, s in zip(cfg.encoder_channels,
                  _adjusted_strides(cfg.encoder_strides, cfg.stem_s2d)):
    fl, h, w = _conv_flops(h, w, cin, c, 3, s)
    total += fl
    cin = c
  # cost volume: (2r+1)^2 correlations of C-dim features per pixel
  total += 2.0 * h * w * cfg.cv_channels * cin
  # U-Net decoder
  c0, c1, c2 = cfg.unet_channels
  seq = [
      (cfg.cv_channels, c0, 3, 1), (c0, c0, 3, 1),   # enc0
      (c0, c1, 3, 2), (c1, c1, 3, 1),                # down1
      (c1, c2, 3, 2), (c2, c2, 3, 1),                # down2
  ]
  hh, ww = h, w
  shapes = {}
  for i, (ci, co, k, s) in enumerate(seq):
    fl, hh, ww = _conv_flops(hh, ww, ci, co, k, s)
    total += fl
    if i == 1:
      shapes["e0"] = (h, w)
    if i == 3:
      shapes["d1"] = (hh, ww)
  h1, w1 = shapes["d1"]
  # up1 (4x4 transpose conv ≈ conv at output res), fuse1, up0, fuse0, head
  total += 2.0 * h1 * w1 * 16 * c2 * c1 / 4  # transpose conv c2->c1
  fl, _, _ = _conv_flops(h1, w1, c1 + c1, c1, 3, 1)
  total += fl
  total += 2.0 * h * w * 16 * c1 * c0 / 4
  fl, _, _ = _conv_flops(h, w, c0 + c0, c0, 3, 1)
  total += fl
  fl, _, _ = _conv_flops(h, w, c0, 3, 3, 1)
  return total + fl


def filter_step_flops(cfg, h=480, w=640) -> float:
  """Analytic FLOPs of one recursive-filter step (measurement + process +
  update; the Kalman/warp math is O(h/8·w/8) and negligible)."""
  return (scoordnet_flops(cfg.scoordnet, h, w)
          + oflownet_flops(cfg.oflownet, h, w))
