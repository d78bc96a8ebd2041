"""The grouped expert pass's share of its roofline, in %: the analytic
work of the pairs the traced part's ticks drew (the program's
``esac.expert_runs`` counter times the family's ``expert_flops``, 70.97
GFLOP a pair at 480x640) at the card's dense bf16 peak, over the device
time of the kernels launched inside the harness's ``esac.experts`` spans
there (the passes' graph replays, which run exactly the drawn pairs).
Whatever implements the pass, the same work is counted."""

from perfbench import tracing
from perfbench.metrics._program import session


def read(ctx):
  t = ctx.rec.trace
  got = session(ctx)
  if t is None or got is None or ctx.peaks is None:
    return None
  pairs = got["counters"].get("esac.expert_runs", 0)
  busy_us = sum(o[2] for o in t.launched_under("esac.experts")
                if tracing.is_kernel(o[0]))
  if not pairs or not busy_us:
    return None
  work = pairs * ctx.family.expert_flops(ctx.cfg, ctx.frame_shape)
  return 100.0 * work / ctx.peaks["bf16"] / (busy_us / 1e6)
