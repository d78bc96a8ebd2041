"""The share of the traced part's pose solves that replayed the serving
surface's CUDA graph, in %: the program's ``pose.replays`` counter over its
``pose.solve`` spans. None where the program counts neither a pose graph's
capture nor a replay (a program whose solve is never graphed)."""

from perfbench.metrics._program import session, spans


def read(ctx):
  got = session(ctx)
  solves = spans(ctx, "pose.solve")
  if got is None or not solves:
    return None
  counters = got["counters"]
  if "pose.replays" not in counters and "pose.captures" not in counters:
    return None
  return 100.0 * counters.get("pose.replays", 0) / len(solves)
