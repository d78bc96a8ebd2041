"""Host-side input pipeline (port of ``kfnet_tpu/data/pipeline.py``):
decode -> augment -> label -> batch -> prefetch.

A background thread keeps up to N batches ready ahead of the training
step; ``batched_native`` makes each batch in one call of the port's C++
loader (``native_io.load_batch``). With ``to_device`` a batch is pinned
in that thread and goes to the device (``cuda`` unless given) from pinned
host memory, asynchronously.

Augmentation follows the reference's per-scene training recipe: a random
crop (aligned to the 8 px output stride so that labels stay exact) and
mild photometric jitter on the image only, with the JAX package's draws
from ``np.random.Generator``, so that one seed gives the same batches.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
from typing import Callable, Iterator, Sequence

import numpy as np


@dataclasses.dataclass(frozen=True)
class AugmentConfig:
  crop: tuple[int, int] | None = None  # (H, W), multiple of 8
  brightness: float = 0.15
  contrast: float = 0.15
  enabled: bool = True


def _photometric(rng: np.random.Generator, img: np.ndarray,
                 cfg: AugmentConfig) -> np.ndarray:
  b = rng.uniform(-cfg.brightness, cfg.brightness)
  c = rng.uniform(1.0 - cfg.contrast, 1.0 + cfg.contrast)
  return np.clip((img - 0.5) * c + 0.5 + b, 0.0, 1.0)


def _crop_indices(rng: np.random.Generator, h: int, w: int,
                  crop: tuple[int, int], stride: int = 8):
  ch, cw = crop
  # align crop origin to the output stride so strided labels stay exact.
  y = rng.integers(0, (h - ch) // stride + 1) * stride
  x = rng.integers(0, (w - cw) // stride + 1) * stride
  return int(y), int(x)


def augment_example(rng: np.random.Generator, example: dict,
                    cfg: AugmentConfig, stride: int = 8) -> dict:
  """Crop image/depth AND any pre-generated strided label maps together
  (crop origin is stride-aligned, so the strided maps crop exactly by
  (y//stride, x//stride) with no principal-point shift needed — the label
  at strided cell (i, j) of the crop is the label of full-image cell
  (y//stride + i, x//stride + j)); photometric jitter on the image(s) only."""
  if not cfg.enabled:
    return example
  out = dict(example)
  img_keys = [k for k in ("image", "image_prev") if k in out]
  if cfg.crop is not None:
    h, w = out[img_keys[0]].shape[:2]
    y, x = _crop_indices(rng, h, w, cfg.crop, stride)
    ch, cw = cfg.crop
    for k in img_keys:
      out[k] = out[k][y:y + ch, x:x + cw]
    for k in ("depth", "depth_prev"):
      if k in out:
        out[k] = out[k][y:y + ch, x:x + cw]
    ys, xs, chs, cws = y // stride, x // stride, ch // stride, cw // stride
    for k in ("coords", "coords_prev", "valid", "valid_prev"):
      if k in out:
        out[k] = out[k][ys:ys + chs, xs:xs + cws]
    out["crop_offset"] = np.asarray([x, y], np.float32)
  for k in img_keys:
    out[k] = _photometric(rng, out[k], cfg)
  return out


def pin_batch(batch: dict, device) -> dict:
  """A numpy batch as host tensors, page-locked when bound for the card so
  that its copy up can be asynchronous. The batch streams call it in their
  prefetch thread, off the training loop's path."""
  from kfnet_tpu_torch.filter.sequence import host_frames
  return {k: host_frames(v, device) for k, v in batch.items()}


def batch_to_device(batch: dict, device=None) -> dict:
  """A batch's arrays as tensors on ``device`` (``cuda`` unless given);
  bound for the card they go up from pinned memory, asynchronously (a
  batch from :func:`pin_batch` is not pinned again)."""
  import kfnet_tpu_torch
  from kfnet_tpu_torch.filter.sequence import frames_to_device
  device = kfnet_tpu_torch.resolve_device(device)
  return {k: frames_to_device(v, device) for k, v in batch.items()}


def _stream(produce, prefetch_depth, to_device, device):
  """Iterate ``produce()`` through a :class:`Prefetcher`; with
  ``to_device`` each batch is pinned in the prefetch thread and only
  its non-blocking copy is enqueued here."""
  if to_device:
    import kfnet_tpu_torch
    device = kfnet_tpu_torch.resolve_device(device)
    items = (pin_batch(b, device) for b in produce())
  else:
    items = produce()
  pf = Prefetcher(items, depth=prefetch_depth)
  try:
    for batch in pf:
      if to_device:
        batch = batch_to_device(batch, device)
      yield batch
  finally:
    pf.close()  # deterministic even when the consumer stops early


class Prefetcher:
  """Runs ``producer`` in a daemon thread, keeping up to ``depth`` items
  queued; iteration yields until the producer is exhausted, and raises
  the producer's error in the consumer.

  ``close()`` retires the thread when the consumer stops early (the
  normal case: ``trainer.fit`` leaves an endless stream at max_steps);
  without it the producer would block on a full queue for the life of
  the process, holding ``depth`` batches. The iterator closes itself on
  exhaustion and when it is abandoned (its ``finally`` runs when the
  consuming generator is closed)."""

  _DONE = object()

  def __init__(self, producer: Iterator, depth: int = 3):
    self._q: queue.Queue = queue.Queue(maxsize=depth)
    self._err: BaseException | None = None
    self._stop = threading.Event()

    def put(item) -> bool:
      """Bounded put that gives up when close() is called."""
      while not self._stop.is_set():
        try:
          self._q.put(item, timeout=0.2)
          return True
        except queue.Full:
          continue
      return False

    def run():
      try:
        for item in producer:
          if not put(item):
            return
      except BaseException as e:  # raised again in the consumer
        self._err = e
      finally:
        put(self._DONE)

    self._thread = threading.Thread(target=run, daemon=True)
    self._thread.start()

  def close(self):
    """Unblock and join the producer thread; drop queued batches."""
    self._stop.set()
    try:
      while True:
        self._q.get_nowait()
    except queue.Empty:
      pass
    self._thread.join(timeout=5.0)

  def __iter__(self):
    try:
      while True:
        item = self._q.get()
        if item is self._DONE:
          if self._err is not None:
            raise self._err
          return
        yield item
    finally:
      self.close()


def batched(load_fns: Sequence[Callable[[], dict]],
            batch_size: int,
            seed: int = 0,
            augment: AugmentConfig | None = None,
            epochs: int | None = None,
            drop_remainder: bool = True,
            prefetch_depth: int = 3,
            to_device: bool = True,
            device=None) -> Iterator[dict]:
  """Shuffled, batched, prefetched stream of stacked numpy batches, or of
  tensors on ``device`` with ``to_device``.

  Args:
    load_fns: one zero-arg loader per example (returns dict of arrays).
    epochs: None = loop forever.
  """
  rng = np.random.default_rng(seed)
  aug = augment or AugmentConfig(enabled=False)

  def produce():
    epoch = 0
    while epochs is None or epoch < epochs:
      order = rng.permutation(len(load_fns))
      for start in range(0, len(order), batch_size):
        idx = order[start:start + batch_size]
        if len(idx) < batch_size and drop_remainder:
          continue
        examples = [augment_example(rng, load_fns[i](), aug)
                    for i in idx]
        batch = {}
        for k in examples[0]:
          v0 = examples[0][k]
          if isinstance(v0, np.ndarray):
            batch[k] = np.stack([e[k] for e in examples])
        yield batch
      epoch += 1

  yield from _stream(produce, prefetch_depth, to_device, device)


def batched_native(color_paths, depth_paths, poses, K, image_size,
                   batch_size: int,
                   stride: int = 8,
                   depth_scale: float = 1e-3,
                   min_depth: float = 0.05,
                   max_depth: float = 20.0,
                   seed: int = 0,
                   augment: AugmentConfig | None = None,
                   epochs: int | None = None,
                   drop_remainder: bool = True,
                   prefetch_depth: int = 3,
                   to_device: bool = True,
                   num_threads: int | None = None,
                   device=None) -> Iterator[dict]:
  """Batch stream of the port's C++ loader: each batch is one GIL-free
  ``kfn_load_batch`` call (file read -> PNG decode -> fused label
  generation over a std::thread pool) in the prefetch thread.
  Augmentation (stride-aligned crop + photometric) applies on the decoded
  batch as in :func:`batched`, with the same draws. There is no fallback:
  where the library cannot be built, the first batch raises with the
  compiler's output.
  """
  from kfnet_tpu_torch.data import native_io

  n = len(color_paths)
  h, w = image_size
  rng = np.random.default_rng(seed)
  aug = augment or AugmentConfig(enabled=False)
  poses = np.asarray(poses, np.float32)

  def produce():
    epoch = 0
    while epochs is None or epoch < epochs:
      order = rng.permutation(n)
      for start in range(0, n, batch_size):
        idx = order[start:start + batch_size]
        if len(idx) < batch_size and drop_remainder:
          continue
        batch = native_io.load_batch(
            [color_paths[i] for i in idx],
            [depth_paths[i] for i in idx],
            poses[idx], K, width=w, height=h, stride=stride,
            depth_scale=depth_scale, min_depth=min_depth,
            max_depth=max_depth, num_threads=num_threads)
        if aug.enabled:
          examples = [augment_example(
              rng, {k: v[j] for k, v in batch.items()}, aug, stride)
              for j in range(len(idx))]
          batch = {k: np.stack([e[k] for e in examples])
                   for k in examples[0]}
        yield batch
      epoch += 1

  yield from _stream(produce, prefetch_depth, to_device, device)
