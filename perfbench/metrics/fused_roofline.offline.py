"""The fused warp + Kalman update kernel's share of its roofline, in %:
the larger of its bytes at bandwidth and its operations at the float32
peak (the KFNet family's ``fused_bound_s``) over its device time, per
launch."""


def read(ctx):
  t = ctx.rec.trace
  if t is None or ctx.peaks is None:
    return None
  seconds = t.layer_seconds("fused")
  launches = t.span_counts["filter.replay"]
  if not seconds or not launches:
    return None
  bound = ctx.family.fused_bound_s(ctx.cfg, ctx.frame_shape, ctx.peaks,
                                   maps=ctx.batch)
  return 100.0 * bound * launches / seconds
