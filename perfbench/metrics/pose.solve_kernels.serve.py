"""Kernels a pose solve launches: the traced part's kernels whose launch
fell inside a solve's span, over the solves in it."""


def read(ctx):
  t = ctx.rec.trace
  solves = t.span_counts["pose.solve"] if t is not None else 0
  if not solves:
    return None
  n = sum(1 for o in t.launched_under("pose.solve")
          if not o[0].startswith(("Memcpy", "Memset")))
  return n / solves if n else None
