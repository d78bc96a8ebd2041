"""The port's one CUDA graph capture and replay, a ``Graph``: the filter
step (``filter/sequence.GraphedStep``), the served pose solve
(``pose/ransac.GraphedSolve``) and ESAC's parts (``eval/online.py``)."""

from __future__ import annotations

import torch

from kfnet_tpu_torch.kernels import launches
from kfnet_tpu_torch.utils import tracing


def use_graph(device: torch.device, graph: bool | None) -> bool:
  if graph is None:
    return device.type == "cuda"
  if graph and device.type != "cuda":
    raise ValueError(f"graph=True needs a CUDA device, got {device}")
  return graph


class Graph:
  """``fn(*inputs)`` as one CUDA graph over static clones of ``inputs`` (a
  None stays None). Building it runs ``fn`` on a side stream (the warm-up,
  whose result is ``first``), then captures it with ``generator``
  registered (each replay draws its next block) in memory ``pool``, and
  counts one ``host.syncs``. ``replay`` copies each input into its buffer
  unless it is that buffer, replays, counts the captured kernel launches
  (``kernels/launches.py``) and returns ``out``, the graph's outputs."""

  def __init__(self, fn, inputs, generator=None, pool=None):
    self.inputs = tuple(None if t is None else t.clone() for t in inputs)
    dev = next(t for t in self.inputs if t is not None).device
    side = torch.cuda.Stream(dev)
    side.wait_stream(torch.cuda.current_stream(dev))
    with torch.cuda.stream(side):
      self.first = fn(*self.inputs)
    torch.cuda.current_stream(dev).wait_stream(side)
    self.graph = torch.cuda.CUDAGraph()
    if generator is not None:  # the default one is registered anyway
      self.graph.register_generator_state(generator)
    tracing.count("host.syncs")  # torch.cuda.graph synchronises first
    # thread_local: only this thread's unsafe calls (a sync, a pageable
    # copy) break the capture, not a server's other threads
    with launches.recorded() as self.record, torch.cuda.graph(
        self.graph, pool=pool, capture_error_mode="thread_local"):
      self.out = fn(*self.inputs)

  def replay(self, *inputs):
    for buf, new in zip(self.inputs, inputs):
      if buf is not None and new is not buf:
        buf.copy_(new, non_blocking=True)
    self.graph.replay()
    launches.replayed(self.record)
    return self.out


def kept(held: dict, slot, fits, build):
  """(graph, whether built now): ``held[slot]`` where ``fits(graph)``, else
  ``build()`` kept there, the old graph dropped first to free its memory."""
  if slot in held and fits(held[slot]):
    return held[slot], False
  held.pop(slot, None)
  held[slot] = build()
  return held[slot], True
