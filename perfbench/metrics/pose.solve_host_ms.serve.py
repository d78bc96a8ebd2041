"""Host ms of ``ransac.solve_pnp_from_maps`` (the solve's enqueue; it
reads nothing back), mean per solve after the traced part."""

from perfbench.metrics._common import host_ms


def read(ctx):
  return host_ms(ctx, "pose.solve")
