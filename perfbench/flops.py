"""The benchmark's own yardstick of work: operations and bytes computed
from the configuration's shapes, and the card's published peaks.

The conv and cost-volume count is the analytic one of the program's
``eval/flops.py`` at the time this benchmark was written (one filter step
at 640x480: 241.7 GFLOP in the paper's widths), frozen here so that a
later change to the program cannot move it. The fused update's count is
what its inputs and outputs need, each byte read or written once.
"""

from __future__ import annotations

from perfbench import weights

# NVIDIA H100 SXM5 data sheet, dense (no sparsity), at its 700 W limit.
PEAKS = {
    "H100 SXM": {"bf16": 989e12, "fp32": 67e12, "hbm_bytes": 3.35e12},
}
# the names torch.cuda.get_device_name gives the SXM part
NAMES = {"NVIDIA H100 80GB HBM3": "H100 SXM", "NVIDIA H100 SXM": "H100 SXM"}


def peaks_for(device_name: str):
  """The data sheet's peaks of a card by its CUDA name; None when the card
  is not in the table (no share of a peak is then reported)."""
  key = NAMES.get(device_name)
  return PEAKS.get(key) if key else None


def _conv_work(h, w, cin, cout, k, s, transposed, low):
  """(FLOPs, bytes) of one conv: 2·k²·cin·cout a product per output (per
  input for a transposed conv); bytes of the input, weights and output
  once, 2 a value for the low-precision convs, 4 for the float32 heads."""
  if transposed:
    flops = 2.0 * h * w * k * k * cin * cout
    ho, wo = 2 * h, 2 * w
  else:
    ho, wo = -(-h // s), -(-w // s)
    flops = 2.0 * ho * wo * k * k * cin * cout
  size = 2 if low else 4
  return flops, size * (h * w * cin + k * k * cin * cout + ho * wo * cout)


def conv_flops(cfg, frame_shape, first: bool = False) -> float:
  return sum(_conv_work(*c)[0]
             for c in weights.conv_shapes(cfg, frame_shape, first))


def map_shape(cfg, frame_shape):
  """(h, w) of the filtered maps: the frame over SCoordNet's total stride
  (the stem's factor times the strided convs)."""
  s = cfg["scoordnet"]["stem_s2d"]
  for st in weights.adjusted_strides(cfg["scoordnet"]["strides"],
                                     cfg["scoordnet"]["stem_s2d"]):
    s *= st
  return frame_shape[0] // s, frame_shape[1] // s


def cost_volume_flops(cfg, frame_shape) -> float:
  """(2r+1)² correlations of C-dim features a map pixel."""
  of = cfg["oflownet"]
  h, w = map_shape(cfg, frame_shape)
  return (2.0 * h * w * (2 * of["search_radius"] + 1) ** 2
          * of["encoder_channels"][-1])


def frame_flops(cfg, frame_shape, first: bool = False) -> float:
  """Analytic FLOPs of a frame's nets: a filter step (both nets, the cost
  volume), or with ``first`` a first frame (SCoordNet and the encoder)."""
  total = conv_flops(cfg, frame_shape, first)
  return total if first else total + cost_volume_flops(cfg, frame_shape)


def conv_bound_s(cfg, frame_shape, peaks, first: bool = False) -> float:
  """The least time a frame's convs could take on the card: for each conv
  the larger of its FLOPs at the tensor-core peak (the float32 heads at
  the float32 peak) and its bytes at the memory bandwidth, summed."""
  total = 0.0
  for c in weights.conv_shapes(cfg, frame_shape, first):
    flops, nbytes = _conv_work(*c)
    peak = peaks["bf16"] if c[-1] else peaks["fp32"]
    total += max(flops / peak, nbytes / peaks["hbm_bytes"])
  return total


# the fused update per map pixel: reads the two raw heads (3 + 4 floats)
# and the previous posterior (3 + 1), writes the posterior (3 + 1), flow
# (2), W, z (3), V (float32 each) and the consistency mask (1 byte)
FUSED_BYTES_PER_PIXEL = 4 * (3 + 4 + 3 + 1) + 4 * (3 + 1 + 2 + 1 + 3 + 1) + 1
# float32 operations a pixel: the heads' tanh (2), exp (2), scales (6);
# bilinear weights and the 4-tap blend of 4 channels (40); the
# innovation, its norm and the test (10); gain and update (12)
FUSED_OPS_PER_PIXEL = 72


def fused_bound_s(cfg, frame_shape, peaks, maps: int = 1) -> float:
  """The least time of one fused-update launch over ``maps`` maps."""
  h, w = map_shape(cfg, frame_shape)
  n = maps * h * w
  return max(n * FUSED_BYTES_PER_PIXEL / peaks["hbm_bytes"],
             n * FUSED_OPS_PER_PIXEL / peaks["fp32"])
