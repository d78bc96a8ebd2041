"""ESAC's whole tick's share of the card's dense bf16 peak, in %: the
analytic work of the ticks answered after the traced part (the gating on
every frame, ``gating_flops``, and each pair run, ``expert_flops``; nothing
for the solve, as ``mfu.serve`` counts) over that stretch's length."""

from perfbench.metrics._esac import post_trace_ticks


def read(ctx):
  got = post_trace_ticks(ctx)
  if got is None or ctx.peaks is None:
    return None
  ticks, pairs, seconds = got
  fam = ctx.family
  work = (ticks * ctx.batch * fam.gating_flops(ctx.cfg, ctx.frame_shape)
          + pairs * fam.expert_flops(ctx.cfg, ctx.frame_shape))
  return 100.0 * work / seconds / ctx.peaks["bf16"]
