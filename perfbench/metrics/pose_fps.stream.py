"""Frames whose pose reached the host, a second, after the traced part of
the window: one camera's rate, held end to end only in the fleet, where
it is steadier; here it moves with the stream's tail."""

from perfbench.metrics._common import post_trace_rate as read  # noqa: F401
