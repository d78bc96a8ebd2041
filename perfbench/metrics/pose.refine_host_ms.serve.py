"""Host ms of the pose solve's ``pose.refine`` stage (the program's own
span, ``pose/ransac.py``), over the solves (``pose.solve`` spans) of
the traced part. Read inside the traced part, where CUPTI slows each
launch: compare it with the other stages and across PRs, never with
``pose.solve_host_ms.serve``, which is read after the traced part."""

from perfbench.metrics._program import mean_ms


def read(ctx):
  return mean_ms(ctx, "pose.refine", per="pose.solve")
