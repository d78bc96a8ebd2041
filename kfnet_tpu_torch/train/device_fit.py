"""On-device training for small datasets (port of
``kfnet_tpu/train/device_fit.py``; the demo's trainer): the whole dataset
lives on the device, and each step gathers its minibatch rows there, so a
step moves no data from the host. The minibatch indices are drawn a chunk
of steps at a time from ``np.random.default_rng(seed)``, exactly as the
JAX package draws them, so the two train on the same rows step for step;
one upload of a chunk's indices and one log line a chunk.
"""

from __future__ import annotations

import numpy as np
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch.train import trainer


def draw_indices(rng: np.random.Generator, k: int, n: int, batch: int,
                 window: int = 0) -> np.ndarray:
  """A chunk's rows: (k, batch) indices in [0, n), or with ``window`` > 0
  (k, batch, window) runs of consecutive frames, in the JAX package's
  order of draws."""
  if window > 0:
    starts = rng.integers(0, n - window + 1, size=(k, batch, 1))
    return starts + np.arange(window)
  return rng.integers(0, n, size=(k, batch))


def gather(data: dict, idx: torch.Tensor) -> dict:
  """Rows ``idx`` ((batch,) or (batch, window)) of every array of ``data``
  (leading axis: rows or time), gathered on their device; a window's
  frames are gathered as they are, no window is built beforehand."""
  flat = idx.reshape(-1)
  return {k: v.index_select(0, flat).reshape(idx.shape + v.shape[1:])
          for k, v in data.items()}


def fit_on_device(loss_fn, params, data: dict, steps: int, lr: float,
                  batch: int = 8, chunk: int = 250, seed: int = 0,
                  tag: str = "", log=print, window: int = 0, device=None):
  """Train ``steps`` optimizer steps on ``data`` moved to ``device``
  (``cuda`` unless given), from a copy of ``params``.

  window: when > 0, ``data`` holds one time-contiguous sequence per key
  (leading axis = time) and each minibatch row is a WINDOW of ``window``
  consecutive frames (batch leading dims (batch, window, ...)), the input
  of ``objectives.kfnet_window_objective``.

  Returns (final TrainState, last-step metrics dict)."""
  device = kfnet_tpu_torch.resolve_device(device)
  opt = trainer.make_optimizer(trainer.OptimizerConfig(learning_rate=lr))
  state = trainer.create_state(trainer.clone_params(params, device), opt)
  data = trainer.to_device(data, device)
  n = next(iter(data.values())).shape[0]
  if window > n:
    raise ValueError(f"window {window} exceeds sequence length {n}")
  one_step = trainer.make_train_step(loss_fn, opt)

  rng = np.random.default_rng(seed)
  done = 0
  m = {}
  while done < steps:
    k = min(chunk, steps - done)  # k rows exactly: never more steps
    idxs = torch.as_tensor(draw_indices(rng, k, n, batch, window),
                           device=device)
    for idx in idxs:
      state, m = one_step(state, gather(data, idx))
    done += k
    if log:
      log(f"{tag} step {done}: " + " ".join(
          f"{key}={float(val):.4f}" for key, val in sorted(m.items())
          if key in ("coord_err_m", "warp_err_m", "loss", "supervised_frac")))
  return state, m
