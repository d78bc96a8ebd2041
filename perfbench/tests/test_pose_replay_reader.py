"""The reader of ``pose.replay_share.serve`` (the program's ``pose.replays``
counter over its ``pose.solve`` spans) on synthetic sessions of the
program's tracer, built as ``test_program_span_readers.py`` builds them:
100 when every solve of the traced part replayed, the share when a capture
falls inside it, None with no session, no solve, or no pose graph counted;
and a tiny traced run on the CPU, whose solves are eager, leaves it out."""

from __future__ import annotations

import pytest
import torch

from perfbench import run
from perfbench.metrics import _program
from perfbench.tests import tiny
from perfbench.tests.test_program_span_readers import Span, ctx_of, ns, op

BENCH = run.load_benchmark(tiny.ROOT)
NAME = "pose.replay_share.serve"


def solves_ctx(n, counters):
  """n ticks of 20 ms, each a solve; the device busy through the part."""
  spans = []
  for tick in range(n):
    i = len(spans)
    spans += [Span("online.tick", ns(20 * tick), ns(20 * tick + 15), None,
                   tick, None),
              Span("pose.solve", ns(20 * tick + 2), ns(20 * tick + 3), i,
                   tick, None)]
  return ctx_of([op(0, 100)], spans, counters)


def read(ctx):
  return run.load_reader(NAME)(ctx)


def test_every_solve_replayed_reads_100():
  assert read(solves_ctx(4, {"pose.replays": 4, "host.syncs": 4})) == 100.0


def test_a_capture_inside_the_part_reads_the_share():
  ctx = solves_ctx(4, {"pose.captures": 1, "pose.replays": 3,
                       "host.syncs": 5})
  assert read(ctx) == pytest.approx(75.0)
  assert read(solves_ctx(2, {"pose.captures": 1})) == 0.0


def test_no_session_no_solve_or_no_pose_graph_reads_none(monkeypatch):
  assert read(solves_ctx(0, {"pose.replays": 0})) is None
  # an eager program: solves, but no pose graph captured or replayed
  assert read(solves_ctx(3, {"host.syncs": 3})) is None

  def no_tracer(name):
    raise ModuleNotFoundError(name)

  monkeypatch.setattr(_program.importlib, "import_module", no_tracer)
  ctx = solves_ctx(3, {"pose.replays": 3})
  del ctx.program_session
  assert read(ctx) is None


def test_the_metric_is_declared_for_the_serving_cells():
  m = {m["name"]: m for m in BENCH["per_layer"]}[NAME]
  assert m["workloads"] == ["gn-stream1", "nonorm-fleet4"]
  assert (m["better"], m["unit"], m["layer"], m["moves"]) == (
      "higher", "%", "pose", "pose_ms_p95")


def test_a_tiny_traced_run_on_the_cpu_leaves_it_out():
  cell = "gn-stream1"
  res, _ = run.run_cell(tiny.cell(cell), tiny.config(cell), tiny.mix(cell),
                        2 ** 31 + 19, 1.2, True, torch.device("cpu"),
                        tiny.limits(cell), bench=BENCH)
  assert NAME not in res["metrics"]
  assert res["metrics"]["pose.solve_host_ms.serve"]["value"] is not None
