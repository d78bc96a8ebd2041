"""Device ms of ESAC's gating (the graph of the luma, the gating net and
its softmax): CUDA events around each call of the surface's gating
(``EsacRelocalizer._gated``, span ``esac.gate``), mean over the ticks after
the traced part."""

from perfbench.metrics._esac import event_mean_ms


def read(ctx):
  return event_mean_ms(ctx, "esac.gate")
