"""Host ms of a tick's one wait for the device (the program's
``online.wait`` span: ``OnlineRelocalizer.process``'s copy to the host,
``FleetRelocalizer._finalize``'s event wait), mean a wait over the traced
part. Read inside the traced part, where CUPTI slows each launch: compare
it across PRs, never with the host metrics read after the traced part."""

from perfbench.metrics._program import mean_ms


def read(ctx):
  return mean_ms(ctx, "online.wait")
