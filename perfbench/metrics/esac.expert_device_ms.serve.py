"""Device ms of ESAC's grouped expert pass (every (slot, expert) pair a
tick drew, one graph of its bucket): CUDA events around each call
(``EsacRelocalizer._run_pairs``, span ``esac.experts``), mean over the
ticks after the traced part."""

from perfbench.metrics._esac import event_mean_ms


def read(ctx):
  return event_mean_ms(ctx, "esac.experts")
