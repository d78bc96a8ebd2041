"""The device's idle share of the traced part while the host stages a
chunk (the program's ``sequence.stage`` span), in % of the part's length
(the base of ``device.idle_share.*``): the gaps the program's staging,
not the harness, leaves."""

from perfbench.metrics._program import idle_share_under


def read(ctx):
  return idle_share_under(ctx, "sequence.stage")
