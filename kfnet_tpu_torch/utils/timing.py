"""Device synchronisation for benchmarking (port of
``kfnet_tpu/utils/timing.py``).

PyTorch returns from a CUDA call before the device has run it, so a host
clock read after it measures the enqueue. A stream runs in order, so
copying ONE scalar derived from the last outputs to the host waits for
everything enqueued before it: that copy is the sync. All benchmark and
eval timing of the port goes through ``sync``.
"""

from __future__ import annotations

import torch

from kfnet_tpu_torch.nn import layers as L
from kfnet_tpu_torch.utils import tracing


def sync(tree) -> float:
  """Wait for everything enqueued up to (and including) the tensors in
  ``tree`` (dicts, lists and tuples of them); returns the sum of their
  absolute values as a float (the checksum also keeps the work needed)."""
  leaves = [t for t in L.tree_leaves(tree) if isinstance(t, torch.Tensor)]
  total = sum(torch.sum(torch.abs(t.to(torch.float32))) for t in leaves)
  tracing.count("host.syncs")
  return float(total)  # scalar device->host copy == the sync
