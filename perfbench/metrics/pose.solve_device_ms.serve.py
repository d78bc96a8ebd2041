"""Device ms of a pose solve: for each ``pose.solve`` span of the traced
part, from the first start to the last end of the kernels launched inside
it (on the serving surfaces one graph replay; copies and fills left out,
as ``pose.solve_kernels.serve`` leaves them out), mean over the solves
that launched any."""

from perfbench import tracing


def read(ctx):
  t = ctx.rec.trace
  if t is None:
    return None
  ms = []
  for ops in t.launched_in_each("pose.solve"):
    ks = [o for o in ops if tracing.is_kernel(o[0])]
    if ks:
      ms.append((max(o[1] + o[2] for o in ks) - min(o[1] for o in ks)) / 1e3)
  return sum(ms) / len(ms) if ms else None
