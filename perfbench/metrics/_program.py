"""What the readers of the program's own spans and counters share
(``kfnet_tpu_torch/utils/tracing.py``). The profiler of a ``--trace 1``
run turns the program's tracer on, so the program's last session is the
traced part of the window (the set-up's traced eager step is an earlier
one). Its spans are stamped on ``time.perf_counter_ns()``; the device
trace's microseconds are joined to that clock by the traced part's own
start, which the harness stamps on both (``rec.t0`` on the host clock,
the ``perfbench.trace`` range's start ``rec.trace.lo`` in the trace).
A program without the tracer gives no session, and every reader None."""

from __future__ import annotations

import importlib

from perfbench import tracing


def session(ctx):
  """The program's last session ({"spans", "counters"}), read once a run;
  None where the program has no tracer or the session holds nothing."""
  if not hasattr(ctx, "program_session"):
    try:
      mod = importlib.import_module("kfnet_tpu_torch.utils.tracing")
    except ModuleNotFoundError:
      got = None
    else:
      got = mod.snapshot()
      if not got["spans"] and not got["counters"]:
        got = None
    ctx.program_session = got
  return ctx.program_session


def spans(ctx, name):
  """The session's closed spans named ``name``."""
  got = session(ctx)
  if got is None:
    return []
  return [s for s in got["spans"] if s.name == name and s.end_ns is not None]


def outermost(ctx, name):
  """The spans named ``name`` that open inside no other program span (a
  fleet over a mesh runs its entries' ticks inside its own)."""
  return [s for s in spans(ctx, name) if s.parent is None]


def host_ms(s) -> float:
  return (s.end_ns - s.start_ns) / 1e6


def mean_ms(ctx, name, per=None):
  """Host ms of the ``name`` spans over their count, or over the count of
  the ``per`` spans (a stage's ms a solve); None where either is empty."""
  got = spans(ctx, name)
  n = len(spans(ctx, per)) if per is not None else len(got)
  if not got or not n:
    return None
  return sum(host_ms(s) for s in got) / n


def trace_us(ctx, ns) -> float:
  """A program stamp (``perf_counter_ns``) in the device trace's us."""
  return ns / 1e3 - ctx.rec.t0 * 1e6 + ctx.rec.trace.lo


def overlap(gaps, intervals) -> float:
  """us shared by the ``gaps`` ((start, length), sorted) and the merged,
  sorted ``intervals`` ([start, end])."""
  total, j = 0.0, 0
  for start, length in gaps:
    end = start + length
    while j < len(intervals) and intervals[j][1] <= start:
      j += 1
    k = j
    while k < len(intervals) and intervals[k][0] < end:
      total += min(end, intervals[k][1]) - max(start, intervals[k][0])
      k += 1
  return total


def idle_share_under(ctx, name):
  """The device's idle time inside the traced part while the host was in
  a ``name`` span, in % of the part's length (the base of
  ``device.idle_share.*``)."""
  t = ctx.rec.trace
  got = spans(ctx, name)
  if t is None or t.window_s <= 0 or not got:
    return None
  host = tracing.union([(trace_us(ctx, s.start_ns), trace_us(ctx, s.end_ns))
                        for s in got], t.lo, t.hi)
  _, gaps = tracing.busy_and_gaps(t.ops, t.lo, t.hi)
  return 100.0 * overlap(gaps, host) / (t.window_s * 1e6)
