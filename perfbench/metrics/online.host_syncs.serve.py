"""The program's ``host.syncs`` counter (every point where it waits for
the device) over its outermost ``online.tick`` spans, in the traced part:
host syncs a tick."""

from perfbench.metrics._program import outermost, session


def read(ctx):
  got = session(ctx)
  ticks = outermost(ctx, "online.tick")
  if got is None or not ticks:
    return None
  return got["counters"].get("host.syncs", 0) / len(ticks)
