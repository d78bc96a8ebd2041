"""Kernel launch counts that hold under CUDA graph capture and replay.

Each kernel wrapper has a ``launches`` attribute: the launches of its
kernel that ran. A wrapper calls ``count(wrapper)`` where it launches. Out
of a capture that adds one. While a CUDA graph is being captured on the
current stream the launch does not run; it is recorded in the innermost
``recorded()`` block instead, and ``replayed(record)`` adds the recorded
launches once for each replay of that graph.

    with launches.recorded() as record, torch.cuda.graph(g):
      ...                       # wrappers called: recorded, not counted
    g.replay()
    launches.replayed(record)   # each wrapper's count grows by its calls
"""

from __future__ import annotations

import contextlib

import torch

_records: list = []  # the open recorded() blocks, innermost last


def count(wrapper) -> None:
  """One launch of ``wrapper``'s kernel: run now, or recorded in a graph."""
  if torch.cuda.is_current_stream_capturing():
    if _records:
      _records[-1][wrapper] = _records[-1].get(wrapper, 0) + 1
  else:
    wrapper.launches += 1


@contextlib.contextmanager
def recorded():
  """Collect {wrapper: launches} of the calls captured inside the block."""
  record: dict = {}
  _records.append(record)
  try:
    yield record
  finally:
    _records.pop()  # blocks close innermost first


def replayed(record: dict) -> None:
  """Count one replay of a graph whose launches ``recorded()`` collected."""
  for wrapper, n in record.items():
    wrapper.launches += n
