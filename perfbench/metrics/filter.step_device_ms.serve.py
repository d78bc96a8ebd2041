"""Device ms of the filter step: CUDA events around each replay of its
graph (``sequence.GraphedStep.replay``), mean over the replays after the
traced part (a replay serves every slot of a tick)."""

from perfbench.metrics._common import replay_ms as read  # noqa: F401
