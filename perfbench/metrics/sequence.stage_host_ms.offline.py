"""Host ms of staging a chunk of a recorded sequence (the program's
``sequence.stage`` span, ``filter/sequence._stack_chunk``: the host stack,
the pin and the upload's enqueue), mean a chunk over the traced part,
where CUPTI slows each launch."""

from perfbench.metrics._program import mean_ms


def read(ctx):
  return mean_ms(ctx, "sequence.stage")
