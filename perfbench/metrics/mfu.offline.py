"""The whole step's share of the card's dense bf16 peak, in %."""

from perfbench.metrics._common import mfu as read  # noqa: F401
