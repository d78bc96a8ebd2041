"""The convolutions' share of their roofline, in %: the least time the
traced part's frames' convs could take (each conv the larger of FLOPs at
peak and bytes at bandwidth, the KFNet family's ``conv_bound_s``) over the
device time of the kernels that only the convs launch (named in one eager
frame)."""

from perfbench.metrics._common import traced_frames


def read(ctx):
  t = ctx.rec.trace
  if t is None or ctx.peaks is None:
    return None
  seconds = t.layer_seconds("conv")
  steps, firsts = traced_frames(ctx)
  if not seconds or not steps + firsts:
    return None
  conv_bound_s = ctx.family.conv_bound_s
  bound = (steps * conv_bound_s(ctx.cfg, ctx.frame_shape, ctx.peaks)
           + firsts * conv_bound_s(ctx.cfg, ctx.frame_shape, ctx.peaks,
                                   first=True))
  return 100.0 * bound / seconds
