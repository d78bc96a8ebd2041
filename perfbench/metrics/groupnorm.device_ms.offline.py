"""Device ms a frame of the kernels that only GroupNorm launches (named in
one eager frame), over the traced part's frames."""

from perfbench.metrics._common import traced_frames


def read(ctx):
  t = ctx.rec.trace
  if t is None:
    return None
  seconds = t.layer_seconds("groupnorm")
  steps, firsts = traced_frames(ctx)
  if not seconds or not steps + firsts:
    return None
  return 1e3 * seconds / (steps + firsts)
