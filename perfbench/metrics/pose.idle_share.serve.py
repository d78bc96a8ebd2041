"""The device's idle share of the traced part while the host is in the
program's ``pose.solve`` span, in % of the part's length (the base of
``device.idle_share.*``): the idle time the solve's host dispatch leaves."""

from perfbench.metrics._program import idle_share_under


def read(ctx):
  return idle_share_under(ctx, "pose.solve")
