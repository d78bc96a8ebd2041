"""Device ms of ESAC's multi-map pose solve (one graph replay): CUDA
events around each ``pose.solve`` call (``ransac.solve_pnp_from_maps``),
mean over the ticks after the traced part. Events, not the trace's extent
of the replay's kernels, which CUPTI stretches."""

from perfbench.metrics._esac import event_mean_ms


def read(ctx):
  return event_mean_ms(ctx, "pose.solve")
