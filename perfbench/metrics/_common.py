"""What several per-layer readers share. A reader is ``read(ctx)`` in
``metrics/<metric name>.py``; it returns the metric's value, or None when
its run holds nothing for it to read (the metric is then left out)."""

from __future__ import annotations


def post_trace_units(ctx):
  """(frames, first frames, seconds) answered after the traced part of
  the window, where no profiler slows the host."""
  units = [u for u in ctx.rec.units if u[0] > ctx.rec.trace_end]
  if not units:
    return None
  return (sum(u[1] for u in units), sum(u[2] for u in units),
          ctx.rec.t1 - ctx.rec.trace_end)


def post_trace_rate(ctx):
  """Frames answered a second after the traced part of the window."""
  got = post_trace_units(ctx)
  if got is None:
    return None
  frames, _, seconds = got
  return frames / seconds


def mfu(ctx):
  """The whole step's share of the card's dense bf16 peak, in %: the
  family's analytic FLOPs (``frame_flops``) of the frames answered after
  the traced part over its length."""
  got = post_trace_units(ctx)
  if got is None or ctx.peaks is None:
    return None
  frames, firsts, seconds = got
  frame_flops = ctx.family.frame_flops
  work = (firsts * frame_flops(ctx.cfg, ctx.frame_shape, first=True)
          + (frames - firsts) * frame_flops(ctx.cfg, ctx.frame_shape))
  return 100.0 * work / seconds / ctx.peaks["bf16"]


def idle_share(ctx):
  t = ctx.rec.trace
  if t is None or t.window_s <= 0:
    return None
  return 100.0 * (1.0 - t.busy_s / t.window_s)


def host_ms(ctx, span):
  d = ctx.spans.durations(span, after=ctx.rec.trace_end)
  return 1e3 * sum(d) / len(d) if d else None


def replay_ms(ctx):
  ms = ctx.spans.event_ms("filter.replay", after=ctx.rec.trace_end)
  return sum(ms) / len(ms) if ms else None


def traced_frames(ctx):
  """(filter-step frames, first frames) launched in the traced part."""
  t = ctx.rec.trace
  return (t.span_counts["filter.replay"] * ctx.batch,
          t.span_counts["filter.first"] * ctx.batch)
