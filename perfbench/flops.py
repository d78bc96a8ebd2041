"""The benchmark's own yardstick of work that every family shares: the
card's published peaks, and the operations, bytes and least time of a
convolution computed from its shapes. A family counts its own frame's
work from these (``families/<family>.py``).
"""

from __future__ import annotations

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


def conv_work(h, w, cin, cout, k, s, transposed, low):
  """(FLOPs, bytes) of one conv: 2·k²·cin·cout a product per output (per
  input for a transposed conv); bytes of the input, weights and output
  once, 2 a value for the low-precision convs, 4 for the float32 ones."""
  if transposed:
    flops = 2.0 * h * w * k * k * cin * cout
    ho, wo = 2 * h, 2 * w
  else:
    ho, wo = -(-h // s), -(-w // s)
    flops = 2.0 * ho * wo * k * k * cin * cout
  size = 2 if low else 4
  return flops, size * (h * w * cin + k * k * cin * cout + ho * wo * cout)


def convs_bound_s(shapes, peaks) -> float:
  """The least time the convs of ``shapes`` ((h_in, w_in, cin, cout, k,
  stride, transposed, low) each) could take on the card: for each conv
  the larger of its FLOPs at the tensor-core peak (the float32 ones at
  the float32 peak) and its bytes at the memory bandwidth, summed."""
  total = 0.0
  for c in shapes:
    flops, nbytes = conv_work(*c)
    peak = peaks["bf16"] if c[-1] else peaks["fp32"]
    total += max(flops / peak, nbytes / peaks["hbm_bytes"])
  return total
