"""Sequence-level recursive filtering (port of
``kfnet_tpu/filter/sequence.py``).

The JAX package runs a sequence as one ``lax.scan`` whose carry (x, P,
features) never leaves the device. Here a sequence is a loop over frames
with the same carry. On ``cuda`` each filter step is one CUDA graph
(``GraphedStep``), the counterpart of the jitted ``run_filter_jit`` and
``run_filter_first_jit``: frame 0 runs ``first_step`` eagerly, the first
filter-step frame warms up eagerly on a side stream (that frame's result)
and captures the step, and every later frame copies itself into the
graph's frame buffer and replays it. The graph is kept per (config, frame
shape and type, device, ``return_aux``) and replayed by later calls with
the same weights (the JAX package's compile cache); a call with other
weights, or after an in-place weight update, captures again. A capture
synchronises the device once. ``graph=False`` runs every step eagerly; the
CPU always does.

Every function runs on ``device`` when one is given, else on the device of
the params it is given; params and frames are moved there (``placed``).
Nothing moves to the CPU on its own.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch.kernels import launches
from kfnet_tpu_torch.models import kfnet
from kfnet_tpu_torch.nn import layers as L
from kfnet_tpu_torch.parallel import mesh as mesh_lib
from kfnet_tpu_torch.utils import tracing


class GraphedStep:
  """One filter step as one CUDA graph over static buffers: the carry (x,
  P, features) and the frame. A replay reads them and writes the new carry
  back into the carry's buffers, so the next replay finds it there.
  ``outputs(aux)`` picks what else the step gives (the graph's static
  outputs, overwritten by every replay); ``first`` is the warm-up's, the
  capturing frame's result.

  With a (B,) bool ``mask`` (a batch of B streams), the step also takes a
  per-slot reset: a slot whose mask is set starts over at this frame, its
  posterior the frame's measurement (z, V), as ``kfnet.first_step`` gives
  it, and its aux has ``reset`` (the mask). The mask is a static buffer
  that each replay copies into, so a reset never captures again.

  The graph holds the addresses of the weights and of the conv kernels'
  prepared weight layouts, so it is valid while no held weight has been
  updated in place or replaced (``fits``). A capture that fails raises.

  Building one is the span ``filter.capture`` (``utils/tracing.py``) and
  counts one ``filter.captures`` and one ``host.syncs``; a replay is the
  span ``filter.replay``, timed on the device by CUDA events."""

  def __init__(self, params, config, carry, frame, outputs, mask=None):
    self._params, self._config, self._outputs = params, config, outputs
    self._leaves = L.tree_leaves(params)
    self._weights = self._weight_state()
    with tracing.span("filter.capture"):
      self.carry = tuple(t.clone() for t in carry)
      self.frame = frame.clone()
      self.mask = None if mask is None else mask.clone()
      dev = frame.device
      side = torch.cuda.Stream(dev)
      side.wait_stream(torch.cuda.current_stream(dev))
      with torch.cuda.stream(side):  # warm-up: this frame's step, eagerly
        self.first = self._body()
      torch.cuda.current_stream(dev).wait_stream(side)
      self.graph = torch.cuda.CUDAGraph()
      tracing.count("filter.captures")
      tracing.count("host.syncs")  # torch.cuda.graph synchronises first
      # thread_local: the capture refuses unsafe CUDA calls (a sync, a
      # pageable copy) made by this thread, which would break the graph,
      # while calls from other threads of a server (pinning the next
      # frame, say) cannot invalidate it
      with launches.recorded() as self.recorded, torch.cuda.graph(
          self.graph, capture_error_mode="thread_local"):
        self.out = self._body()

  def _weight_state(self):
    return tuple((t._version, t.data_ptr()) for t in self._leaves)

  def _body(self):
    x, P, feat = self.carry
    image = kfnet.preprocess_images(self._config, self.frame)
    x1, P1, feat1, aux = kfnet.filter_step(self._params, self._config, x, P,
                                           feat, image)
    if self.mask is not None:
      x1, P1 = restart_slots(self.mask, x1, P1, aux)
      aux = dict(aux, reset=self.mask)
    for buf, new in zip(self.carry, (x1, P1, feat1)):
      buf.copy_(new)
    return self._outputs(aux)

  def fits(self, params, frame, carry, mask=None) -> bool:
    """Whether a replay computes this frame's step from ``carry`` with
    ``params``: the captured params object, same frame and carry shapes and
    types, a mask where the capture had one, and no held weight updated in
    place or replaced since capture."""
    return (params is self._params and
            (mask is None) == (self.mask is None) and
            (mask is None or mask.shape == self.mask.shape) and
            frame.shape == self.frame.shape and
            frame.dtype == self.frame.dtype and
            all(a.shape == b.shape and a.dtype == b.dtype
                for a, b in zip(carry, self.carry)) and
            self._weight_state() == self._weights)

  def replay(self, frame, carry, mask=None):
    """This frame's step from ``carry`` (and the slots' reset ``mask``):
    copied into the carry's buffers first unless it is already there (it
    is after the graph's own step)."""
    with tracing.span("filter.replay", device=self.frame.device):
      if carry is not self.carry:
        for buf, new in zip(self.carry, carry):
          buf.copy_(new)
      self.frame.copy_(frame, non_blocking=True)
      if mask is not None:
        self.mask.copy_(mask, non_blocking=True)
      self.graph.replay()
      launches.replayed(self.recorded)
      return self.out


def restart_slots(mask, x1, P1, aux):
  """(x1, P1) with each slot of the (B,) bool ``mask`` replaced by its
  measurement (aux's z, V): a stream that starts over at this frame."""
  m = mask[:, None, None, None]
  return torch.where(m, aux["z"], x1), torch.where(m, aux["V"], P1)


# The captured steps of run_filter and its forms, one per key of _graph_key.
_graphs: dict = {}


def _all_aux(aux):
  return aux


def _no_aux(aux):
  return {}


def _graph_key(config, frame, return_aux, entry=None):
  return (config, tuple(frame.shape), frame.dtype, frame.device, return_aux,
          entry)


def _captured_step(params, config, carry, frame, return_aux, entry=None):
  """(step, its outputs for this frame): the kept graph replayed when it
  fits, else a new capture (whose warm-up is this frame's step). ``entry``
  keeps one graph per (mesh, entry): a mesh may name one device twice."""
  key = _graph_key(config, frame, return_aux, entry)
  step = _graphs.get(key)
  if step is not None and step.fits(params, frame, carry):
    return step, step.replay(frame, carry)
  _graphs.pop(key, None)  # free the old graph's memory first
  step = _graphs[key] = GraphedStep(params, config, carry, frame,
                                    _all_aux if return_aux else _no_aux)
  return step, step.first


def _on(t: torch.Tensor, device: torch.device) -> bool:
  if t.device.type != device.type:
    return False
  if device.index is None and device.type == "cuda":
    return t.device.index == torch.cuda.current_device()
  return device.index is None or t.device.index == device.index


def placed(params, device):
  """(params on the device, the device): ``device`` when given, else the
  params'. Params already there are returned as they are, the same object,
  so that a kept graph still fits them; others (``convert``'s CPU output,
  say) are copied there."""
  device = (kfnet_tpu_torch.resolve_device(device) if device is not None
            else L.tree_leaves(params)[0].device)
  if all(_on(p, device) for p in L.tree_leaves(params)):
    return params, device
  return L.tree_map(lambda p: p.to(device), params), device


def _use_graph(device: torch.device, graph: bool | None) -> bool:
  if graph is None:
    return device.type == "cuda"
  if graph and device.type != "cuda":
    raise ValueError(f"graph=True needs a CUDA device, got {device}")
  return graph


def frames_to_device(images, device: torch.device) -> torch.Tensor:
  """A frame stack as a tensor on ``device``; a host stack bound for the
  card is copied from pinned memory, asynchronously."""
  if isinstance(images, np.ndarray):
    images = torch.from_numpy(images if images.flags.writeable
                              else images.copy())
  images = torch.as_tensor(images)
  if device.type == "cuda" and images.device.type == "cpu":
    images = images.pin_memory()
  return images.to(device, non_blocking=True)


def _filter_steps(params, config, frames, carry, return_aux, graph,
                  entry=None):
  """The filter steps over ``frames`` (preprocessed, on the device) from
  ``carry``. Returns (xs, Ps, final carry, stacked aux or None)."""
  n = frames.shape[0]
  x, P = carry[:2]
  xs = x.new_empty((n,) + tuple(x.shape))
  Ps = P.new_empty((n,) + tuple(P.shape))
  auxs = None
  step = None
  for t in range(n):
    if not graph:
      x1, P1, feat1, aux = kfnet.filter_step(params, config, *carry,
                                             frames[t])
      carry = (x1, P1, feat1)
    elif step is None:  # the weights are checked once a call
      step, aux = _captured_step(params, config, carry, frames[t],
                                 return_aux, entry)
      carry = step.carry
    else:
      aux = step.replay(frames[t], carry)
    xs[t].copy_(carry[0])
    Ps[t].copy_(carry[1])
    if return_aux:
      if auxs is None:
        auxs = {k: v.new_empty((n,) + tuple(v.shape)) for k, v in aux.items()}
      for k, v in aux.items():
        auxs[k][t].copy_(v)
  if step is not None:  # the graph's buffers: the next replay overwrites
    carry = tuple(c.clone() for c in carry)
  return xs, Ps, carry, auxs


def run_filter(params, config: kfnet.KFNetConfig, images,
               carry: Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
               | None = None,
               return_aux: bool = False, device=None,
               graph: bool | None = None):
  """Filter a whole (T, H, W, 3) sequence.

  Args:
    images: (T, H, W, 3) frames (uint8 0..255, or float in [0, 1]), a
      tensor or a numpy array; moved to the device.
    carry: optional (x, P, feat) carry to resume from (chunked
      streaming); None starts a new sequence with frame 0 =
      measurement-only.
    graph: replay each filter step as a CUDA graph (the default on
      ``cuda``; False runs it eagerly).

  Returns:
    (xs, Ps): (T, h, w, 3), (T, h, w, 1) per-frame posteriors, the final
    carry, and (with ``return_aux``) the stacked aux dict of frames
    1..T-1 (of every frame when resuming).
  """
  params, device = placed(params, device)
  graph = _use_graph(device, graph)
  return _run_filter(params, config, frames_to_device(images, device), carry,
                     return_aux, graph)


def _run_filter(params, config, frames, carry, return_aux, graph,
                entry=None):
  """run_filter on frames and params already on their device."""
  frames = kfnet.preprocess_images(config, frames)
  lead = None
  if carry is None:
    x0, P0, feat0 = kfnet.first_step(params, config, frames[0])
    carry, frames, lead = (x0, P0, feat0), frames[1:], (x0, P0)
  xs, Ps, carry, auxs = _filter_steps(params, config, frames, carry,
                                      return_aux, graph, entry)
  if lead is not None:
    xs = torch.cat([lead[0][None], xs])
    Ps = torch.cat([lead[1][None], Ps])
  if return_aux:
    return xs, Ps, carry, auxs
  return xs, Ps, carry


def _stack_chunk(chunk, device: torch.device, copy_stream, index=None):
  """One chunk of frames as a (k, H, W, 3) tensor on ``device``. Host frames
  are stacked once on the host; bound for the card, they go through pinned
  memory on ``copy_stream``, and the current stream waits for the copy.
  The span ``sequence.stage`` of chunk ``index``."""
  with tracing.span("sequence.stage", id=index):
    if isinstance(chunk[0], np.ndarray):
      host = torch.from_numpy(np.stack(chunk))
    else:
      host = torch.stack([torch.as_tensor(f) for f in chunk])
    if host.device == device or copy_stream is None:
      return host.to(device)
    host = host.pin_memory()
    with torch.cuda.stream(copy_stream):
      frames = host.to(device, non_blocking=True)
      done = copy_stream.record_event()
    compute = torch.cuda.current_stream(device)
    compute.wait_event(done)
    frames.record_stream(compute)  # allocated on the copy stream
    return frames


def run_filter_chunked_arrays(params, config: kfnet.KFNetConfig,
                              frame_source, chunk_size: int = 32,
                              return_aux: bool = False, device=None,
                              graph: bool | None = None):
  """Stream an arbitrarily long sequence through the filter in chunks
  (O(chunk) device memory), yielding WHOLE device-resident chunks: (xs (k,
  h, w, 3), Ps (k, h, w, 1)).

  Args:
    frame_source: iterable of (H, W, 3) frames: numpy arrays or tensors
      (on the host, or already on the device, where they stay). uint8
      frames stay 1 byte a channel through the host stack and the upload
      and are cast to [0, 1] float32 on the device.
    return_aux: also yield the stacked per-step aux dict as a third
      element. Frame 0 is measurement-only and has no filter step, so in
      the FIRST yielded chunk the aux rows align with ``xs[1:]``; in every
      later chunk they align with ``xs`` 1:1.

  The first chunk holds one extra frame (frame 0, measurement-only), the
  others ``chunk_size``; a ragged tail runs its own frames. (The JAX
  streamer pads the tail to the chunk's shape, for its one compile, and
  trims the outputs; a per-frame graph has no chunk shape, so nothing is
  padded and the outputs are the same.)

  The generator is pipelined one chunk deep: chunk k is stacked on the
  host, uploaded and its steps enqueued BEFORE chunk k-1 is yielded. On
  ``cuda`` the upload is a copy from pinned memory on a copy stream, and
  the compute stream waits on an event for it, so chunk k's upload
  overlaps chunk k-1's compute. What does not overlap: the host's stack
  and pin of chunk k run before the yield, on the host; and a consumer's
  read of chunk k-1 (``.cpu()``, a sync) on the compute stream is queued
  behind chunk k's steps, so it returns only after chunk k's compute as
  well (XLA's transfer of one buffer waits for that buffer alone; a CUDA
  stream is in order). Outputs and their order are those of the
  unpipelined form; one extra chunk of inputs and outputs is resident.

  An exception in chunk k's stack, upload or dispatch (a bad frame shape,
  out of memory) does not destroy chunk k-1's results: they are yielded
  first, then the exception propagates on the consumer's next ``next()``.
  """
  params, device = placed(params, device)
  graph = _use_graph(device, graph)
  copy_stream = torch.cuda.Stream(device) if device.type == "cuda" else None

  def flush(chunk, carry, index):
    frames = _stack_chunk(chunk, device, copy_stream, index)
    out = run_filter(params, config, frames, carry=carry,
                     return_aux=return_aux, device=device, graph=graph)
    if return_aux:
      xs, Ps, carry, auxs = out
      return (xs, Ps, auxs), carry
    xs, Ps, carry = out
    return (xs, Ps), carry

  buf = []
  carry = None
  first = True
  chunks = 0  # chunks flushed
  pending = None  # the previous chunk's outputs, not yet yielded
  for frame in frame_source:
    buf.append(frame)
    if len(buf) == (chunk_size + 1 if first else chunk_size):
      try:
        out, carry = flush(buf, carry, chunks)  # stack, upload, enqueue k
      except BaseException:
        if pending is not None:
          done, pending = pending, None
          yield done  # keep chunk k-1 for the consumer's record
        raise
      first = False
      buf = []
      chunks += 1
      if pending is not None:
        yield pending  # the consumer reads k-1 while k computes
      pending = out
  if buf:
    try:
      out, carry = flush(buf, carry, chunks)
    except BaseException:
      if pending is not None:
        done, pending = pending, None
        yield done
      raise
    if pending is not None:
      yield pending
    pending = out
  if pending is not None:
    yield pending


def run_filter_chunked(params, config: kfnet.KFNetConfig, frame_source,
                       chunk_size: int = 32, device=None,
                       graph: bool | None = None):
  """Per-frame wrapper over :func:`run_filter_chunked_arrays`.

  Yields:
    (x, P) posterior per frame, in order (views of the chunk's outputs).
  """
  for xs, Ps in run_filter_chunked_arrays(params, config, frame_source,
                                          chunk_size=chunk_size,
                                          device=device, graph=graph):
    for i in range(xs.shape[0]):
      yield xs[i], Ps[i]


def run_filter_batched(params, config: kfnet.KFNetConfig, images,
                       device=None, graph: bool | None = None):
  """Serving mode: B independent sequences filtered in lockstep.

  Args:
    images: (T, B, H, W, 3), time-major, so each step takes a contiguous
      (B, H, W, 3) slab; on the kernel path one fused launch updates the B
      maps of a step.

  Returns:
    xs (T, B, h, w, 3), Ps (T, B, h, w, 1).
  """
  xs, Ps, _ = run_filter(params, config, images, device=device, graph=graph)
  return xs, Ps


class Placements:
  """A params tree placed once per device: ``get(params, device)`` copies
  ``params`` to ``device`` on its first call there (``placed``: none where
  they are there already) and returns that placement while the source's
  tensors are unchanged (no in-place update, none replaced). The
  counterpart of the JAX package's cached ``device_put`` of the params
  under a mesh; like its ``lru_cache``, it keeps what it placed for the
  life of the process. ``copies`` counts the copies made, ``hits`` the
  calls that found their placement kept."""

  def __init__(self):
    self._kept: dict = {}
    self.copies = 0
    self.hits = 0

  def get(self, params, device):
    device = torch.device(device)
    leaves = L.tree_leaves(params)
    state = tuple((t._version, t.data_ptr()) for t in leaves)
    key = (id(params), device)
    kept = self._kept.get(key)
    if kept is not None and kept[0] is params and kept[1] == state:
      self.hits += 1
      return kept[2]
    out, _ = placed(params, device)
    if out is not params:
      self.copies += 1
    self._kept[key] = (params, state, out)
    return out


# The fleet's params, placed once per device across calls.
_fleet_params = Placements()


def run_filter_fleet(params, config: kfnet.KFNetConfig, images, mesh,
                     axis_name: str = "data"):
  """Multi-GPU serving: B independent sequences split over the mesh's
  entries (the JAX package's ``run_filter_fleet``).

  Streams never interact, so the split needs no collective: entry i
  filters its contiguous group of B / n streams with
  :func:`run_filter_batched` on its device, its filter step its own graph
  (one per (config, frame shape, entry), kept across calls). The params
  are placed once per device and kept (``_fleet_params``): a repeat call
  with the same params neither copies them nor captures again. One thread
  enqueues every entry's steps, entry after entry.

  Args:
    images: (T, B, H, W, 3) time-major frames; the mesh size must divide B.
    mesh: a ``parallel.mesh.Mesh``.

  Returns:
    xs (T, B, h, w, 3), Ps (T, B, h, w, 1), each a ``Sharded`` along B.
  """
  mesh.check_axis(axis_name)
  n, B = mesh.size, images.shape[1]
  if B % n:
    raise ValueError(f"batch {B} must be divisible by mesh size {n}")
  shards = mesh_lib.split(mesh, images, axis=1)
  xs, Ps = [], []
  for i, (dev, frames) in enumerate(zip(mesh.devices, shards.shards)):
    p = _fleet_params.get(params, dev)
    x, P, _ = _run_filter(p, config, frames, None, False,
                          _use_graph(dev, None), entry=(mesh, i))
    xs.append(x)
    Ps.append(P)
  return (mesh_lib.Sharded(xs, 1, mesh.devices),
          mesh_lib.Sharded(Ps, 1, mesh.devices))


def run_filter_python_loop(params, config: kfnet.KFNetConfig, images,
                           device=None):
  """Reference-shaped eager loop (one step per frame on the raw frame, like
  the TF1 eval driver): the reference of the equivalence tests."""
  params, device = placed(params, device)
  images = frames_to_device(images, device)
  x, P, feat = kfnet.first_step(params, config, images[0])
  xs, Ps = [x], [P]
  for t in range(1, images.shape[0]):
    x, P, feat, _ = kfnet.filter_step(params, config, x, P, feat, images[t])
    xs.append(x)
    Ps.append(P)
  return torch.stack(xs), torch.stack(Ps)
