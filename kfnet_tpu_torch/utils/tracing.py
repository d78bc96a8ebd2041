"""The port's own spans and counters at its layer boundaries.

    from kfnet_tpu_torch.utils import tracing

    tracing.enable()                  # or run under any torch.profiler
    ...                               # serve, filter, solve
    tracing.disable()
    got = tracing.snapshot()          # {"spans": [Span, ...], "counters": {}}

The tracer is on while a ``torch.profiler`` records (the flag PyTorch's
own ranges read) and between ``enable()`` and ``disable()``. Off, a span
or a count reads that flag, notes that it was off, and does nothing else:
it allocates nothing and enters no range.

A session starts at the first span or count that finds the tracer on
after one found it off (or after ``disable()`` turned it off), and at
``enable()``; starting one drops the last
one's spans and zeroes the counters. ``snapshot()`` returns the last
session. So the spans of a profiled stretch of work are that stretch's
alone, as long as the program ran with the tracer off before it.

A span (``span(name, id)``) records its name, its start and end on
``time.perf_counter_ns()``, the index of the span it opened inside
(``parent``) and a request id, inherited from that span when not given:
the frame or tick number of a served frame, the chunk index of a
sequence. While a profiler records, a span is also a
``torch.profiler.record_function`` range of the same name, so the
profiler's trace carries it on the device trace's clock. Spans opened
while the current stream captures a CUDA graph are not recorded (the
capture's own span holds that time). Past ``MAX_SPANS`` spans a session
records no more and counts each one lost in ``tracing.dropped``.

Counters (``count(name, n)``): ``host.syncs``, the points where the
program waits for the device; ``filter.captures``, the filter step's
CUDA graphs built; ``pose.captures`` and ``pose.replays``, the served pose
solve's CUDA graphs built and replayed; ``pose.kernel_solves``, the solves
that ran the pose kernels (``kernels/ransac.py``), eager or replayed;
ESAC's ``esac.expert_runs`` (the (slot, expert) pairs a tick ran),
``esac.experts_drawn`` (the distinct experts of a tick), ``esac.captures``
and ``esac.replays`` (its gating, draw and expert-pass graphs);
``tracing.dropped``.
"""

from __future__ import annotations

import contextlib
import threading
import time
from typing import NamedTuple

import torch
from torch.autograd import profiler as _profiler

MAX_SPANS = 200_000


class Span(NamedTuple):
  name: str
  start_ns: int
  end_ns: int | None     # None while the span is open
  parent: int | None     # index of the enclosing span in the session
  id: object             # the request: frame, tick or chunk
  device_ms: float | None  # CUDA events around it, where asked


class _Session:
  """One session's spans (as lists, closed in place), counters, and each
  thread's stack of open spans: (index or None where dropped, id)."""

  def __init__(self):
    self.spans: list = []
    self.counters: dict = {}
    self.stacks: dict = {}
    self.lock = threading.Lock()

  def count(self, name: str, n: int):
    with self.lock:
      self.counters[name] = self.counters.get(name, 0) + n


_enabled = False
_live = False  # whether the last span or count found the tracer on
_session = _Session()


def _current() -> _Session:
  """The session a span or count that found the tracer on belongs to."""
  global _live, _session
  if not _live:
    _session = _Session()
    _live = True
  return _session


def enable():
  """Turn the tracer on without a profiler, starting a new session."""
  global _enabled, _live
  _enabled, _live = True, False
  _current()


def disable():
  """Turn off what ``enable()`` turned on (a profiler keeps it on)."""
  global _enabled, _live
  _enabled = False
  if not _profiler._is_profiler_enabled:
    _live = False


_OFF = contextlib.nullcontext()


class _Span:
  __slots__ = ("name", "id", "device", "session", "rec", "range", "stack")

  def __init__(self, name, id, device):
    self.name, self.id, self.device = name, id, device
    self.session = _current()
    self.rec = self.range = self.stack = None

  def __enter__(self):
    if (torch.cuda.is_initialized()
        and torch.cuda.is_current_stream_capturing()):
      return None
    s = self.session
    stack = self.stack = s.stacks.setdefault(threading.get_ident(), [])
    parent, inherited = stack[-1] if stack else (None, None)
    if self.id is None:
      self.id = inherited
    if len(s.spans) >= MAX_SPANS:
      s.count("tracing.dropped", 1)
      stack.append((None, self.id))  # its children inherit its id
      return None
    if _profiler._is_profiler_enabled:
      self.range = torch.profiler.record_function(self.name)
      self.range.__enter__()
    events = None
    if self.device is not None and torch.device(self.device).type == "cuda":
      events = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
      events[0].record()
    self.rec = [self.name, time.perf_counter_ns(), None, parent, self.id,
                events]
    stack.append((len(s.spans), self.id))
    s.spans.append(self.rec)
    return None

  def __exit__(self, *exc):
    rec = self.rec
    if rec is not None:
      rec[2] = time.perf_counter_ns()
      if rec[5] is not None:
        rec[5][1].record()
    if self.stack is not None:
      self.stack.pop()
    if self.range is not None:
      self.range.__exit__(*exc)
    return False


def span(name: str, id=None, device=None):
  """A context manager: the span ``name`` of request ``id`` (the enclosing
  span's when None). With a CUDA ``device``, also a CUDA event pair on the
  current stream around it, read by ``snapshot()`` as ``device_ms``."""
  global _live
  if _enabled or _profiler._is_profiler_enabled:
    return _Span(name, id, device)
  _live = False
  return _OFF


def count(name: str, n: int = 1):
  """Add ``n`` to the counter ``name`` (only while the tracer is on)."""
  global _live
  if _enabled or _profiler._is_profiler_enabled:
    _current().count(name, n)
  else:
    _live = False


def snapshot() -> dict:
  """The last session: {"spans": [Span in the order opened], "counters":
  {name: n}}. Reading the spans' CUDA events waits for them."""
  s = _session
  spans = []
  for name, t0, t1, parent, rid, events in list(s.spans):
    ms = None
    if events is not None and t1 is not None:
      events[1].synchronize()
      ms = events[0].elapsed_time(events[1])
    spans.append(Span(name, t0, t1, parent, rid, ms))
  with s.lock:
    counters = dict(s.counters)
  return {"spans": spans, "counters": counters}
