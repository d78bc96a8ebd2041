"""The three ways a mix drives the program, each set up, warmed up and
then run for a fixed window: one camera or B cameras in lockstep through
the family's ``Server``, and recorded sequences through its
``sequences`` runner (``families/<family>.py``).

Every loop is closed: a client hands in its next frame when the previous
answer is on the host. A loop keeps what the check needs: each frame's
answer, and on the device what the family keeps of the frames the check
may compare (``Server.keep``, a chunk's outputs), taken after the frame
was answered (outside the latency).
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import time

import numpy as np
import torch

from perfbench import tracing
from perfbench.traffic import generator


@dataclasses.dataclass
class Record:
  mode: str
  t0: float = 0.0          # the window's start (perf_counter)
  t1: float = 0.0          # its end
  paused_s: float = 0.0    # reading the trace, inside a traced window
  trace_end: float = float("-inf")  # where the traced part ended
  frames: int = 0          # frames answered in the window
  first_frames: int = 0    # of them, first frames (measurement only)
  attempted: int = 0
  latencies: list = dataclasses.field(default_factory=list)
  # (time answered, frames, first frames) of each tick or chunk
  units: list = dataclasses.field(default_factory=list)
  # serving: per tick (row, reset (B,), T_wc (B, 4, 4), inliers (B,),
  # solve index) on the host; on the device what the family keeps of a
  # tick (``Server.keep``, a tuple of (B, ...) tensors) for the ticks
  # where a track restarts (``firsts``) or the pose is not finite
  # (``odd``), and that of tick i - 1 and i joined for the ticks a seeded
  # reservoir kept (``kept``, the compared steps and poses)
  ticks: list = dataclasses.field(default_factory=list)
  firsts: dict = dataclasses.field(default_factory=dict)
  odd: dict = dataclasses.field(default_factory=dict)
  kept: dict = dataclasses.field(default_factory=dict)
  # offline: (pass, t) -> a chunk's outputs of frame t - 1 and frame t
  # joined; t = 0: those of frame 0
  samples: dict = dataclasses.field(default_factory=dict)
  solves: int = 0          # ticks since the family's server was made
  trace: object = None

  @property
  def window_s(self) -> float:
    return self.t1 - self.t0 - self.paused_s


class Reservoir:
  """A uniform sample of at most ``size`` of the items offered, drawn from
  ``seed`` (Algorithm R), so that a run keeps a bounded number of maps
  however long its window."""

  def __init__(self, size: int, seed: int):
    self.size, self.rng = size, np.random.default_rng(seed)
    self.keys, self.values, self.seen = [], [], 0

  def offer(self, key, value):
    if len(self.keys) < self.size:
      self.keys.append(key)
      self.values.append(value)
    else:
      j = int(self.rng.integers(0, self.seen + 1))
      if j < self.size:
        self.keys[j], self.values[j] = key, value
    self.seen += 1

  def items(self) -> dict:
    return dict(zip(self.keys, self.values))


class Window:
  """A window of ``seconds`` of the host clock. In a traced run its first
  ``trace_s`` run under the profiler; the trace is read when that part
  ends, and the time that takes is left out of the window."""

  def __init__(self, seconds: float, rec: Record, trace=None):
    self.seconds, self.rec, self.trace = seconds, rec, trace
    self.prof = None

  def start(self):
    if self.trace is not None:
      self.prof = tracing.profile()
      self.prof.start()
      self.trace.spans.profiling = True
      self.range = torch.profiler.record_function(tracing.PREFIX + "trace")
      self.range.__enter__()
    self.rec.t0 = self.t_trace = time.perf_counter()

  @property
  def tracing(self) -> bool:
    return self.prof is not None

  def done(self, drain=None) -> bool:
    """Whether the window's time is up. Where work may still be in flight,
    ``drain`` waits for all of it, and the traced part ends after that
    wait, so that it holds the device work launched in it."""
    now = time.perf_counter()
    if self.prof is not None and now - self.t_trace >= self.trace.trace_s:
      if drain is not None:
        drain()
        now = time.perf_counter()
      self._read_trace(now)
      now = time.perf_counter()
    return now - self.rec.t0 - self.rec.paused_s >= self.seconds

  def _read_trace(self, now):
    self.range.__exit__(None, None, None)
    window_s = now - self.t_trace
    self.trace.spans.profiling = False
    self.prof.stop()
    self.rec.trace = tracing.TraceSummary(
        tracing.read_trace(self.prof), window_s, self.trace.eager_seq,
        self.trace.layers, self.trace.replay_span)
    self.prof = None
    self.rec.trace_end = time.perf_counter()
    self.rec.paused_s += self.rec.trace_end - now

  def end(self):
    if self.prof is not None:  # a window shorter than its traced part
      self._read_trace(time.perf_counter())
    self.rec.t1 = time.perf_counter()


def _span(trace, name):
  return (trace.spans.span(name) if trace is not None
          else contextlib.nullcontext())


def serve(family, prog, params, cfg, mix, pool, seed, seconds, device,
          trace=None) -> Record:
  """One camera (``mode`` "stream") or B in lockstep ("fleet")."""
  server = family.Server(prog, params, cfg, mix, pool, seed, device)
  n_pool, B = pool.shape[0], pool.shape[1]
  fleet = mix["mode"] == "fleet"
  solves = 0

  def step(row, reset):
    """Hand in one tick's frames; (T_wc (B, 4, 4), inliers (B,))."""
    nonlocal solves
    out = server.tick(row, reset)
    solves += 1
    return out

  # warm-up: the first tick (eager), the capture, replays, and for one
  # camera its reset path; the window goes on from there
  warm = mix["warmup"]
  none = np.zeros(B, bool)
  for row in range(warm):
    step(row, none)
  if not fleet:
    for row in range(3):
      step(row, np.ones(1, bool) if row == 0 else none)
  # the window opens on the first tick after the warm-up where a track
  # restarts, so that every window holds a first frame
  tick = warm
  while not generator.resets(mix, 1, tick)[0].any():
    tick += 1
  if device.type == "cuda":
    torch.cuda.synchronize(device)
  rec = Record(mix["mode"])
  keep = Reservoir(max(mix["checks"]["step"], mix["checks"]["pose"]),
                   generator.camera_seed(seed, 1 << 22))
  prev = None
  win = Window(seconds, rec, trace)
  win.start()
  while True:
    row = tick % n_pool
    reset = generator.resets(mix, 1, tick)[0]
    rec.attempted += B
    with _span(trace, "process"):
      t0 = time.perf_counter()
      poses, inl = step(row, reset)
      lat = time.perf_counter() - t0
    with _span(trace, "clone"):
      cur = server.keep()
    i = len(rec.ticks)
    poses = np.asarray(poses, np.float32)
    rec.latencies.extend([lat] * B)
    rec.frames += B
    rec.first_frames += int(reset.sum())
    rec.units.append((t0 + lat, B, int(reset.sum())))
    rec.ticks.append((row, reset, poses, np.asarray(inl, np.float32),
                      solves - 1))
    if reset.any():
      rec.firsts[i] = cur
    if not np.isfinite(poses).all():
      rec.odd[i] = cur
    if prev is not None:
      keep.offer(i, prev + cur)
    prev = cur
    tick += 1
    if win.done():
      break
  win.end()
  rec.kept = keep.items()
  rec.solves = solves
  return rec


def offline_picks(mix, seed):
  """The frames of an offline sequence whose outputs the check may
  compare (kept with those of the frame before)."""
  rng = np.random.default_rng(generator.camera_seed(seed, 1 << 20))
  return sorted(rng.choice(np.arange(1, mix["pool_frames"]),
                           mix["checks"]["step"], replace=False).tolist())


class Ahead:
  """Chunks launched and not yet waited for, each behind an event recorded
  after it on the compute stream; a chunk is counted when its event has
  passed. Off the card the work is done when launched."""

  def __init__(self, rec: Record, device):
    self.rec, self.cuda = rec, device.type == "cuda"
    self.pending = collections.deque()

  def launched(self, frames: int, firsts: int):
    event = torch.cuda.Event() if self.cuda else None
    if event is not None:
      event.record()
    self.pending.append((event, frames, firsts))
    self.rec.attempted += frames

  def wait(self, keep: int = 0):
    """Wait until at most ``keep`` chunks are in flight."""
    while len(self.pending) > keep:
      event, frames, firsts = self.pending.popleft()
      if event is not None:
        event.synchronize()
      self.rec.units.append((time.perf_counter(), frames, firsts))
      self.rec.frames += frames
      self.rec.first_frames += firsts


def offline(family, prog, params, cfg, mix, pool, seed, seconds, device,
            trace=None) -> Record:
  """Recorded sequences of ``pool_frames`` frames, each run from its
  frame 0 by the family's ``sequences`` runner, in chunks of
  ``chunk_size`` from uint8 host frames.

  The host launches ahead of the device: it waits only for the chunk
  ``ahead_chunks`` behind the newest (``ahead_chunks_traced`` in the
  traced part, whose end waits for all), so that a stall of the host
  shorter than the work in flight leaves the device busy. (The CUDA launch
  queue may hold the host back sooner: on an H100 a window's last wait
  is about a tenth of a second, one chunk or so.) A chunk
  counts once an event recorded after it has passed. When the window's
  time is up nothing more is launched; the clock is read after the wait
  for all that was, and every frame launched counts. The runner
  launches chunk k + 1 before it yields chunk k, so a window that closes
  inside a sequence holds that chunk too.
  """
  sequence = family.sequences(prog, params, mix, device)
  n = pool.shape[0]
  chunk = mix["chunk_size"]
  picks = offline_picks(mix, seed)

  def frames(count):
    return (pool[i, 0] for i in range(count))

  def run(count):
    return sequence(frames(count))

  for out in run(mix["warmup"]):  # first chunk, a full one, a tail
    float(out[0][-1].flatten()[0])
  rec = Record(mix["mode"])
  ahead = Ahead(rec, device)
  win = Window(seconds, rec, trace)
  win.start()
  pass_no, over = 0, False
  while not over:
    at, prev = 0, None
    for out in run(n):
      k = out[0].shape[0]
      with _span(trace, "clone"):
        if at == 0:
          rec.samples[(pass_no, 0)] = tuple(a[0].clone() for a in out)
        for t in picks:
          if at <= t < at + k:
            i = t - at
            before = tuple(a[i - 1] for a in out) if i > 0 else prev
            rec.samples[(pass_no, t)] = (tuple(a.clone() for a in before)
                                         + tuple(a[i].clone() for a in out))
      prev = tuple(a[-1] for a in out)
      first = int(at == 0)
      at += k
      if at < n:  # the chunk launched before this one was yielded
        nxt = min(chunk, n - at)
      with _span(trace, "sync"):
        ahead.launched(k, first)
        ahead.wait(mix["ahead_chunks_traced"] if win.tracing
                   else mix["ahead_chunks"])
      if win.done(drain=lambda: ahead.wait(0)):
        over = True
        break
    pass_no += 1
  if at < n:
    ahead.launched(nxt, 0)
  with _span(trace, "sync"):
    ahead.wait(0)
  win.end()
  return rec
