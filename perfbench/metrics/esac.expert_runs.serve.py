"""(slot, expert) pairs ESAC's grouped pass ran a tick: the program's
``esac.expert_runs`` counter over its outermost ``online.tick`` spans, in
the traced part. None where the program counts no expert runs."""

from perfbench.metrics._program import outermost, session


def read(ctx):
  got = session(ctx)
  ticks = outermost(ctx, "online.tick")
  if got is None or not ticks or "esac.expert_runs" not in got["counters"]:
    return None
  return got["counters"]["esac.expert_runs"] / len(ticks)
