"""Structured metric logging (port of ``kfnet_tpu/utils/logging.py``):
console + JSONL + optional TensorBoard (``tensorboardX``, imported only
when a directory is given, and skipped when it is not installed)."""

from __future__ import annotations

import json
import os
import sys
import time


class MetricLogger:
  def __init__(self, jsonl_path: str | None = None,
               tensorboard_dir: str | None = None,
               stream=None):
    self._stream = stream or sys.stderr
    self._jsonl = None
    if jsonl_path:
      os.makedirs(os.path.dirname(jsonl_path) or ".", exist_ok=True)
      self._jsonl = open(jsonl_path, "a")
    self._tb = None
    if tensorboard_dir:
      try:
        from tensorboardX import SummaryWriter
        self._tb = SummaryWriter(tensorboard_dir)
      except ImportError:
        self.log_text("tensorboardX unavailable; TB logging disabled")

  @staticmethod
  def _scalars(metrics: dict) -> dict:
    """Coerce to python floats, accepting numpy scalars and 0-d tensors (a
    CUDA one is read back here); text and non-scalar payloads (arrays,
    None) are not metrics and are left out."""
    out = {}
    for k, v in metrics.items():
      if isinstance(v, (str, bytes)):
        continue  # text payloads are not metrics even if float()-able
      try:
        out[k] = float(v)
      except (TypeError, ValueError, RuntimeError):
        pass
    return out

  def log_metrics(self, step: int, metrics: dict):
    scalars = self._scalars(metrics)
    parts = " ".join(f"{k}={v:.5g}" for k, v in sorted(scalars.items()))
    self._stream.write(f"[step {step}] {parts}\n")
    self._stream.flush()
    if self._jsonl:
      rec = {"step": step, "time": time.time(), **scalars}
      self._jsonl.write(json.dumps(rec) + "\n")
      self._jsonl.flush()
    if self._tb:
      for k, v in scalars.items():
        self._tb.add_scalar(k, v, step)

  def log_text(self, msg: str):
    self._stream.write(msg + "\n")
    self._stream.flush()

  def close(self):
    if self._jsonl:
      self._jsonl.close()
    if self._tb:
      self._tb.close()
