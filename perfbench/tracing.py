"""Spans, CUDA events and the profiler trace of a ``--trace 1`` run.

Spans come from the benchmark's own wrappers around the calls into each
layer of the program (``patch``, from the family's ``PATCHES`` and
``layer_patches``): module and class attributes replaced for the traced
run only, and put back after it. A span records its host times, and
while the profiler runs it is also a ``record_function`` range named
``perfbench.<span>``, so the trace can say which span launched a kernel
and what the host was doing while the device idled.

The trace is read from ``torch.profiler``'s chrome export (CUPTI): device
operations (kernels, copies, fills) with their times and correlation ids,
the runtime calls that launched them, and the ranges.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
import json
import os
import tempfile
import time

import torch

PREFIX = "perfbench."
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


class Spans:
  """Host spans by name: (start, end) on ``time.perf_counter``; CUDA event
  pairs by name where asked."""

  def __init__(self):
    self.times = collections.defaultdict(list)
    self.events = collections.defaultdict(list)
    self.profiling = False

  @contextlib.contextmanager
  def span(self, name: str, cuda_events: bool = False):
    rf = (torch.profiler.record_function(PREFIX + name) if self.profiling
          else contextlib.nullcontext())
    pair = None
    with rf:
      if cuda_events:
        pair = (torch.cuda.Event(enable_timing=True),
                torch.cuda.Event(enable_timing=True))
        pair[0].record()
      t0 = time.perf_counter()
      try:
        yield
      finally:
        t1 = time.perf_counter()
        if pair is not None:
          pair[1].record()
          self.events[name].append((t0, pair))
        self.times[name].append((t0, t1))

  def wrap(self, name: str, fn, cuda_events: bool = False):
    def wrapped(*args, **kwargs):
      with self.span(name, cuda_events):
        return fn(*args, **kwargs)
    wrapped.__wrapped__ = fn
    return wrapped

  def durations(self, name: str, after: float = float("-inf")):
    return [t1 - t0 for t0, t1 in self.times[name] if t0 >= after]

  def event_ms(self, name: str, after: float = float("-inf")):
    """Device ms of each CUDA event pair of ``name`` (synchronises)."""
    pairs = [p for t0, p in self.events[name] if t0 >= after]
    if pairs:
      torch.cuda.synchronize()
    return [a.elapsed_time(b) for a, b in pairs]


class Proxy:
  """A module as one of the program's modules sees it, with some of its
  functions under spans (the module itself is left as it is)."""

  def __init__(self, module, wrapped: dict):
    self._module = module
    self.__dict__.update(wrapped)

  def __getattr__(self, name):
    return getattr(self._module, name)


def patch(spans: Spans, family):
  """Wrap the program's layer entries in spans: the family's ``PATCHES``,
  then its ``layer_patches``; returns the undo."""
  undo = []

  def put(owner, attr, value):
    undo.append((owner, attr, getattr(owner, attr)))
    setattr(owner, attr, value)

  mods = family.modules()
  for key, path, name, events in family.PATCHES:
    owner = mods[key]
    *parents, attr = path.split(".")
    for p in parents:
      owner = getattr(owner, p)
    put(owner, attr, spans.wrap(name, getattr(owner, attr), events))
  for owner, attr, value in family.layer_patches(spans, mods):
    put(owner, attr, value)

  def restore():
    for owner, attr, value in reversed(undo):
      setattr(owner, attr, value)

  return restore


# ---- reading a trace ------------------------------------------------------


def profile():
  acts = [torch.profiler.ProfilerActivity.CPU]
  if torch.cuda.is_available():
    acts.append(torch.profiler.ProfilerActivity.CUDA)
  return torch.profiler.profile(activities=acts)


def read_trace(prof) -> dict:
  """The trace's device operations (name, start us, duration us, launching
  span or None, correlation id, launch us or None), the ranges (name,
  start us, end us) and the trace's own window range, from ``prof``'s
  chrome export."""
  with tempfile.TemporaryDirectory() as d:
    path = os.path.join(d, "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
      events = json.load(f)["traceEvents"]
  ops, launches, ranges = [], {}, []
  for e in events:
    cat = e.get("cat")
    if e.get("ph") != "X":
      continue
    if cat in DEVICE_CATS:
      ops.append((e["name"], float(e["ts"]), float(e["dur"]),
                  (e.get("args") or {}).get("correlation")))
    elif cat in LAUNCH_CATS:
      corr = (e.get("args") or {}).get("correlation")
      if corr is not None:
        launches[corr] = float(e["ts"])
    elif cat == "user_annotation" and e["name"].startswith(PREFIX):
      ranges.append((e["name"][len(PREFIX):], float(e["ts"]),
                     float(e["ts"]) + float(e["dur"])))
  del events
  points = [launches.get(c) for _, _, _, c in ops]
  owners = innermost(ranges, points)
  return {"ops": [(n, ts, dur, owners[i], c, points[i])
                  for i, (n, ts, dur, c) in enumerate(ops)],
          "ranges": ranges}


def innermost(ranges, points):
  """For each time in ``points`` (None allowed), the name of the innermost
  range holding it, or None. Ranges nest (they are one thread's)."""
  order = sorted((p, i) for i, p in enumerate(points) if p is not None)
  rs = sorted(ranges, key=lambda r: (r[1], -r[2]))
  out = [None] * len(points)
  stack, j = [], 0
  for p, i in order:
    while j < len(rs) and rs[j][1] <= p:
      stack.append(rs[j])
      j += 1
    stack = [r for r in stack if r[2] >= p]
    out[i] = stack[-1][0] if stack else None
  return out


def union(intervals, lo: float, hi: float):
  """Merged [start, end] intervals, clipped to [lo, hi]."""
  merged = []
  for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
    if e <= s:
      continue
    if merged and s <= merged[-1][1]:
      merged[-1][1] = max(merged[-1][1], e)
    else:
      merged.append([s, e])
  return merged


def busy_and_gaps(ops, lo: float, hi: float):
  """(busy us, [(gap start us, gap us)]) of the device inside [lo, hi]."""
  merged = union([(o[1], o[1] + o[2]) for o in ops], lo, hi)
  busy = sum(e - s for s, e in merged)
  gaps, at = [], lo
  for s, e in merged:
    if s > at:
      gaps.append((at, s - at))
    at = e
  if hi > at:
    gaps.append((at, hi - at))
  return busy, gaps


def is_kernel(name: str) -> bool:
  return not name.startswith(("Memcpy", "Memset"))


def eager_sequence(trace: dict, layers):
  """[(kernel name, layer or None)] of a trace of one eager step, in
  launch order: the span of ``layers`` that launched it."""
  ks = sorted((o for o in trace["ops"] if is_kernel(o[0])),
              key=lambda o: o[1])
  return [(o[0], o[3] if o[3] in layers else None) for o in ks]


def align(replay, seq, lookahead: int = 4):
  """Layers of one graph replay's kernels (in device order) from the eager
  step's sequence: a replay runs the kernels it captured in the order they
  were launched, so its i-th kernel is matched with the next kernel of the
  same name in ``seq`` (a few ahead at most; kernels the capture adds, the
  frame's copy in and the carry's copies out, match nothing). Returns a
  layer or None per kernel and the count matched."""
  out, j, matched = [], 0, 0
  for name in replay:
    hit = next((k for k in range(j, min(j + lookahead, len(seq)))
                if seq[k][0] == name), None)
    if hit is None:
      out.append(None)
      continue
    out.append(seq[hit][1])
    j = hit + 1
    matched += 1
  return out, matched


class TraceSummary:
  """What the readers take from the trace of the traced part of a
  window: device operations inside it, busy time and gaps, the gaps
  named by the span the host was in, spans counted inside it, and the
  layer of each kernel: the span of ``layers`` that launched it where it
  ran eagerly, its place in the eager step's sequence where a replay
  under ``replay_span`` ran it."""

  def __init__(self, trace: dict, window_s: float, eager_seq,
               layers=(), replay_span=None):
    window = [r for r in trace["ranges"] if r[0] == "trace"]
    if not window:
      raise RuntimeError("the trace holds no 'perfbench.trace' range")
    _, lo, hi = window[0]
    self.lo, self.hi = lo, hi
    self.window_s = window_s
    self.ops = [o for o in trace["ops"] if o[1] < hi and o[1] + o[2] > lo]
    busy, gaps = busy_and_gaps(self.ops, lo, hi)
    self.busy_s = busy / 1e6
    host = [r for r in trace["ranges"] if r[0] != "trace"]
    names = innermost(host, [g[0] for g in gaps])
    self.gaps = sorted(((n or "harness", d / 1e6)
                        for n, (_, d) in zip(names, gaps)),
                       key=lambda g: -g[1])
    self.spans = [r for r in host if lo <= r[1] and r[2] <= hi]
    self.span_counts = collections.Counter(r[0] for r in self.spans)
    self.layer_names = tuple(layers)
    self.layers = [o[3] if o[3] in self.layer_names else None
                   for o in self.ops]
    replays = collections.defaultdict(list)
    for i, o in enumerate(self.ops):
      if replay_span is not None and o[3] == replay_span and is_kernel(o[0]):
        replays[o[4]].append(i)
    self.replay_kernels = self.replay_matched = 0
    for idx in replays.values():
      idx.sort(key=lambda i: self.ops[i][1])
      got, n = align([self.ops[i][0] for i in idx], eager_seq)
      for i, layer in zip(idx, got):
        self.layers[i] = layer
      self.replay_kernels += len(idx)
      self.replay_matched += n

  def layer_seconds(self, layer: str) -> float:
    return sum(o[2] for o, l in zip(self.ops, self.layers)
               if l == layer) / 1e6

  def launched_under(self, span: str):
    return [o for o in self.ops if o[3] == span]

  def launched_in_each(self, span: str):
    """[[ops] of each ``span`` range inside the traced part, in time
    order]: the ops whose launch fell inside that range and inside no
    range nested in it."""
    rs = sorted((r[1], r[2]) for r in self.spans if r[0] == span)
    starts = [s for s, _ in rs]
    out = [[] for _ in rs]
    for o in self.launched_under(span):
      at = o[5]
      if at is None:
        continue
      j = bisect.bisect_right(starts, at) - 1
      if j >= 0 and at <= rs[j][1]:
        out[j].append(o)
    return out

  def top_ops(self, n: int = 10):
    by = collections.Counter()
    for o in self.ops:
      by[o[0][:160]] += o[2] / 1e6
    return [[k, v] for k, v in by.most_common(n)]

  def layer_shares(self) -> dict:
    """Each layer's share of the device time of the traced part's ops,
    "other" for the rest; and the share of replayed kernels that found
    their place in the eager sequence."""
    total = sum(o[2] for o in self.ops) or 1.0
    out = {l: self.layer_seconds(l) * 1e6 / total for l in self.layer_names}
    out["other"] = 1.0 - sum(out.values())
    out["replay_kernels_matched"] = (self.replay_matched
                                     / max(self.replay_kernels, 1))
    return out
