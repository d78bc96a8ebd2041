"""The readers of the program's own spans and counters
(``metrics/_program.py`` and the five metrics on it): each on a synthetic
trace summary and a synthetic session of the program's tracer, the join
of the two clocks and the overlap of idle gaps with spans included; None
where the program has no tracer or its session holds nothing; and a tiny
traced run on the CPU of a serving cell and an offline cell, in which
each of the cell's new metrics reads a value. Beside them the reader of
the pose solve's device time (``pose.solve_device_ms.serve``) on a
synthetic trace: one extent of kernels a solve span."""

from __future__ import annotations

import collections
import types

import pytest
import torch

from perfbench import loops, run, tracing
from perfbench.metrics import _program
from perfbench.tests import tiny

BENCH = run.load_benchmark(tiny.ROOT)
NEW = {"serve": ["pose.idle_share.serve", "online.wait_host_ms.serve",
                 "online.host_syncs.serve"],
       "offline": ["sequence.stage_host_ms.offline",
                   "sequence.stage_idle_share.offline"]}
# the program's tracing.Span, field for field
Span = collections.namedtuple(
    "Span", "name start_ns end_ns parent id device_ms")

T0 = 100.0       # the traced part's start on the host clock (s)
LO = 5000.0      # ... and in the trace (us)


def ns(ms):
  """The host stamp ``ms`` ms into the traced part, in ns."""
  return round((T0 + ms / 1e3) * 1e9)


def ctx_of(ops, spans, counters, window_ms=100.0):
  trace = {"ops": ops, "ranges": [("trace", LO, LO + window_ms * 1e3)]}
  rec = loops.Record("stream", t0=T0, t1=T0 + 1.0, trace_end=T0 + 0.2)
  rec.trace = tracing.TraceSummary(trace, window_ms / 1e3, [])
  return types.SimpleNamespace(
      rec=rec, spans=tracing.Spans(), batch=1,
      program_session={"spans": spans, "counters": counters})


def op(start_ms, length_ms):
  return ("k", LO + start_ms * 1e3, length_ms * 1e3, None, 1)


def serving_ctx():
  """Two ticks of 40 ms, each a solve of four stages and a wait; the
  device busy 0-2, 30-50 and 90-100 ms of a 100 ms part."""
  spans = []
  for tick, at in ((0, 0.0), (1, 50.0)):
    i = len(spans)
    spans += [Span("online.tick", ns(at), ns(at + 40), None, tick, None),
              Span("pose.solve", ns(at + 5), ns(at + 35), i, tick, None)]
    for k, name in enumerate(("draw", "hypothesize", "score", "refine")):
      spans.append(Span(f"pose.{name}", ns(at + 5 + 7 * k),
                        ns(at + 5 + 7 * k + k + 1), i + 1, tick, None))
    spans.append(Span("online.wait", ns(at + 40), ns(at + 42), None, tick,
                      None))
  # a mesh entry's tick inside the first: not a tick of its own
  spans.append(Span("online.tick", ns(1), ns(2), 0, 0, None))
  ops = [op(0, 2), op(30, 20), op(90, 10)]
  return ctx_of(ops, spans, {"host.syncs": 2})


def test_the_clock_join_and_the_overlap():
  ctx = serving_ctx()
  assert _program.trace_us(ctx, ns(1.5)) == pytest.approx(LO + 1500.0)
  gaps = [(0.0, 10.0), (20.0, 5.0), (40.0, 20.0)]
  assert _program.overlap(gaps, [[5.0, 22.0], [45.0, 50.0], [55.0, 70.0]]
                          ) == pytest.approx(5 + 2 + 5 + 5)
  assert _program.overlap(gaps, []) == 0.0


def test_the_serving_readers_on_a_synthetic_session():
  ctx = serving_ctx()
  read = lambda name: run.load_reader(name)(ctx)
  # solves at 5-35 and 55-85 ms; the device idles 2-30, 50-90 ms: idle
  # under a solve 5-30 and 55-85 ms, 55 ms of the part's 100
  assert read("pose.idle_share.serve") == pytest.approx(55.0)
  assert read("online.wait_host_ms.serve") == pytest.approx(2.0)
  assert read("online.host_syncs.serve") == pytest.approx(1.0)


def test_the_offline_readers_on_a_synthetic_session():
  spans = [Span("sequence.stage", ns(10 * c), ns(10 * c + 4), None, c, None)
           for c in range(3)]
  spans.append(Span("sequence.stage", ns(90), None, None, 3, None))  # open
  ops = [op(0, 1), op(3, 10), op(20, 80)]
  ctx = ctx_of(ops, spans, {})
  assert run.load_reader("sequence.stage_host_ms.offline")(ctx) == \
      pytest.approx(4.0)
  # stages at 0-4, 10-14, 20-24 ms; the device idles 1-3 and 13-20 ms
  assert run.load_reader("sequence.stage_idle_share.offline")(ctx) == \
      pytest.approx(3.0)


def test_no_session_or_no_span_reads_none(monkeypatch):
  empty = ctx_of([op(0, 1)], [], {})
  other = ctx_of([op(0, 1)], [Span("conv", ns(0), ns(1), None, None, None)],
                 {"filter.captures": 1})
  for ctx in (empty, other):
    for name in NEW["serve"] + NEW["offline"]:
      assert run.load_reader(name)(ctx) is None, name

  def no_tracer(name):
    raise ModuleNotFoundError(name)

  monkeypatch.setattr(_program.importlib, "import_module", no_tracer)
  ctx = serving_ctx()
  del ctx.program_session
  for name in NEW["serve"] + NEW["offline"]:
    assert run.load_reader(name)(ctx) is None, name


def test_the_metrics_are_declared_for_their_cells():
  per_layer = {m["name"]: m for m in BENCH["per_layer"]}
  for kind, cells in (("serve", ["gn-stream1", "nonorm-fleet4"]),
                      ("offline", ["gn-offline1000", "nonorm-offline1000"])):
    for name in NEW[kind]:
      assert per_layer[name]["workloads"] == cells
      assert per_layer[name]["better"] == "lower"
  m = per_layer[SOLVE_MS]
  assert (m["unit"], m["better"], m["source"], m["layer"], m["moves"],
          m["workloads"]) == ("ms", "lower", "device_trace", "pose",
                              "pose_ms_p95", ["gn-stream1", "nonorm-fleet4"])
  for stage in ("draw", "hypothesize", "score", "refine"):
    assert f"pose.{stage}_host_ms.serve" not in per_layer


SOLVE_MS = "pose.solve_device_ms.serve"


def solve_trace_ctx():
  """A 100 ms part with three solve spans, launched under each: 5-10 ms a
  graph launch whose kernels run 6-9.5 ms (a copy in before them, 5.5-6
  ms, left out); 40-45 ms eager launches whose kernels run 41-47 ms; 80-85
  ms a span that launches only a fill. Kernels launched outside a solve
  (a step at 20 ms) and a solve cut by the part's end (95-105 ms) count
  for none."""
  spans = [("pose.solve", LO + 5e3, LO + 10e3),
           ("pose.solve", LO + 40e3, LO + 45e3),
           ("pose.solve", LO + 80e3, LO + 85e3),
           ("pose.solve", LO + 95e3, LO + 105e3)]

  def k(name, start_ms, length_ms, owner, launch_ms, corr):
    return (name, LO + start_ms * 1e3, length_ms * 1e3, owner, corr,
            LO + launch_ms * 1e3)

  ops = [k("Memcpy DtoD", 5.5, 0.5, "pose.solve", 5.2, 1),
         k("dlt", 6.0, 1.0, "pose.solve", 6.0, 2),
         k("score", 7.5, 2.0, "pose.solve", 6.0, 2),
         k("step", 20.0, 5.0, "filter.replay", 20.0, 3),
         k("topk", 41.0, 1.0, "pose.solve", 40.5, 4),
         k("lm", 45.0, 2.0, "pose.solve", 44.0, 5),
         k("Memset", 81.0, 0.1, "pose.solve", 80.5, 6),
         k("late", 96.0, 1.0, "pose.solve", 96.0, 7)]
  trace = {"ops": ops, "ranges": [("trace", LO, LO + 100e3)] + spans}
  rec = loops.Record("stream", t0=T0, t1=T0 + 1.0, trace_end=T0 + 0.2)
  rec.trace = tracing.TraceSummary(trace, 0.1, [])
  return types.SimpleNamespace(rec=rec)


def test_the_solve_device_time_on_a_synthetic_trace():
  ctx = solve_trace_ctx()
  groups = ctx.rec.trace.launched_in_each("pose.solve")
  assert [[o[0] for o in g] for g in groups] == [
      ["Memcpy DtoD", "dlt", "score"], ["topk", "lm"], ["Memset"]]
  # (9.5 - 6) and (47 - 41) ms; the span with only a fill counts for none
  assert run.load_reader(SOLVE_MS)(ctx) == pytest.approx((3.5 + 6.0) / 2)


def test_the_solve_device_time_reads_none_without_solve_kernels():
  ctx = solve_trace_ctx()
  ctx.rec.trace.ops = [o for o in ctx.rec.trace.ops
                       if o[0].startswith(("Memcpy", "Memset"))]
  assert run.load_reader(SOLVE_MS)(ctx) is None
  assert run.load_reader(SOLVE_MS)(ctx_of([op(0, 1)], [], {})) is None
  ctx.rec.trace = None
  assert run.load_reader(SOLVE_MS)(ctx) is None


@pytest.mark.parametrize("cell,kind", [("gn-stream1", "serve"),
                                       ("nonorm-fleet4", "serve"),
                                       ("gn-offline1000", "offline")])
def test_a_tiny_traced_run_reads_each_new_metric(cell, kind):
  res, _ = run.run_cell(tiny.cell(cell), tiny.config(cell), tiny.mix(cell),
                        2 ** 31 + 17, 1.2, True, torch.device("cpu"),
                        tiny.limits(cell), bench=BENCH)
  for name in NEW[kind]:
    assert res["metrics"][name]["value"] is not None, name
  if kind == "serve":
    assert res["metrics"]["online.host_syncs.serve"]["value"] == 1.0
