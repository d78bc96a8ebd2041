"""What the readers of ESAC's per-layer metrics share: CUDA-event device
times of the harness's spans after the traced part, and the analytic work
of the family's ``expert_flops`` / ``gating_flops``."""

from __future__ import annotations


def event_mean_ms(ctx, span):
  """Mean device ms of the ``span`` CUDA event pairs opened after the
  traced part; None where there are none."""
  ms = ctx.spans.event_ms(span, after=ctx.rec.trace_end)
  return sum(ms) / len(ms) if ms else None


def post_trace_ticks(ctx):
  """(ticks, pairs run) answered after the traced part, as the family's
  ``layer_patches`` logged them with the run's spans (``spans.pairs``), and
  that stretch's seconds; None where none was logged."""
  log = [n for t, n in getattr(ctx.spans, "pairs", ())
         if t > ctx.rec.trace_end]
  if not log:
    return None
  return len(log), sum(log), ctx.rec.t1 - ctx.rec.trace_end
