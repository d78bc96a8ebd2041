"""Host ms of ``tick()`` (the enqueue of a tick's whole work: its filter
step and pose solve), mean per call after the traced part."""

from perfbench.metrics._common import host_ms


def read(ctx):
  return host_ms(ctx, "online.tick")
