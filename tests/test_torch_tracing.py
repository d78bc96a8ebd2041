"""The port's own tracer (``kfnet_tpu_torch/utils/tracing.py``) and the
spans and counters at its layer boundaries, on the CPU at the tiny
float32 config: off it records nothing and enters no range; under a
``torch.profiler`` its spans carry their parents and request ids, a new
session drops the last, and the profiler's chrome trace holds each span as
a range of the same name on one clock with the span's own stamps (the
durations within 50 us, one offset for all); the pose solve's four stages
nest in order inside it; a served tick counts one ``host.syncs`` a
finalized tick. With torch's CUDA graph calls faked, every user of
``utils/graphs.py`` (the filter step of both surfaces and of run_filter,
the pose solve, ESAC's parts) is rehearsed on the CPU: when it captures,
what a replay copies in, which generator and pool a capture takes, and
kernel launches counted once a replay. The tests marked ``cuda`` count
one ``filter.captures`` per captured step and hold ``host.syncs`` against
torch's own detection of host syncs on both serving surfaces. This file
imports only torch, numpy and kfnet_tpu_torch:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_tracing.py
"""

import collections
import contextlib
import gc
import json
import unittest.mock as mock
import warnings
import weakref

import numpy as np
import pytest
import torch

from kfnet_tpu_torch.eval.online import (EsacRelocalizer, FleetRelocalizer,
                                         OnlineRelocalizer, pair_passes)
from kfnet_tpu_torch.filter import sequence
from kfnet_tpu_torch.kernels import launches
from kfnet_tpu_torch.models import esac, kfnet, oflownet, scoordnet
from kfnet_tpu_torch.nn import layers as L
from kfnet_tpu_torch.pose import ransac
from kfnet_tpu_torch.utils import graphs, timing, tracing

CFG = kfnet.KFNetConfig(
    scoordnet=scoordnet.SCoordNetConfig(
        channels=(8, 8, 16, 16, 16, 16), strides=(1, 2, 1, 2, 1, 2),
        head_channels=16, compute_dtype="float32"),
    oflownet=oflownet.OFlowNetConfig(
        encoder_channels=(8, 8, 16), encoder_strides=(2, 2, 2),
        search_radius=2, unet_channels=(8, 8, 16), compute_dtype="float32"))
K = np.asarray([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)
RCFG = ransac.RansacConfig(num_hypotheses=16, top_k=32)
STAGES = ["pose.draw", "pose.hypothesize", "pose.score", "pose.refine"]


@pytest.fixture(scope="module")
def params():
  return kfnet.init(0, CFG, (48, 64, 3), device="cpu")


def frames(n, seed=0):
  return np.random.default_rng(seed).integers(0, 256, (n, 48, 64, 3),
                                              dtype=np.uint8)


@pytest.fixture
def traced():
  """The tracer on from a new session; off again after the test."""
  tracing.enable()
  yield
  tracing.disable()


def names(got):
  return collections.Counter(s.name for s in got["spans"])


def profile_cpu():
  return torch.profiler.profile(
      activities=[torch.profiler.ProfilerActivity.CPU])


def test_off_records_nothing_and_enters_no_range():
  tracing.enable()
  with tracing.span("kept", id=1):
    tracing.count("kept")
  tracing.disable()
  with mock.patch.object(torch.profiler, "record_function") as rf:
    assert tracing.span("a") is tracing.span("b")  # no object made
    with tracing.span("a", id=2):
      tracing.count("host.syncs")
    timing.sync(torch.ones(3))
  rf.assert_not_called()
  got = tracing.snapshot()
  assert [(s.name, s.id) for s in got["spans"]] == [("kept", 1)]
  assert got["counters"] == {"kept": 1}


def test_spans_under_the_profiler_nest_inherit_ids_and_start_sessions():
  with profile_cpu():
    with tracing.span("outer", id=7):
      with tracing.span("mid"):
        with tracing.span("inner", id=9):
          tracing.count("c", 2)
        with tracing.span("leaf"):
          pass
    with tracing.span("other"):
      tracing.count("c")
  got = tracing.snapshot()
  spans = {s.name: (s, i) for i, s in enumerate(got["spans"])}
  assert [s.name for s in got["spans"]] == ["outer", "mid", "inner", "leaf",
                                            "other"]
  assert spans["outer"][0].parent is None and spans["other"][0].parent is None
  assert spans["mid"][0].parent == spans["outer"][1]
  assert spans["inner"][0].parent == spans["leaf"][0].parent == spans[
      "mid"][1]
  assert [spans[n][0].id for n in ("outer", "mid", "inner", "leaf",
                                   "other")] == [7, 7, 9, 7, None]
  for s in got["spans"]:
    assert s.start_ns <= s.end_ns and s.device_ms is None
  assert got["counters"] == {"c": 3}
  with tracing.span("between"):  # found off: the next profiler starts anew
    pass
  with profile_cpu():
    with tracing.span("second"):
      tracing.count("d")
  got = tracing.snapshot()
  assert [s.name for s in got["spans"]] == ["second"]
  assert got["counters"] == {"d": 1}


def test_the_chrome_trace_holds_each_span_on_the_spans_clock(tmp_path):
  """Each span is a range of its name whose duration is the span's within
  50 us, at one offset from the span's stamps for every span. The spans
  are short and busy: on a virtual machine a range whose thread slept
  ends 0.1-0.2 ms late. Scheduling noise on a loaded host can stretch one
  range: three attempts."""
  for attempt in range(3):
    with profile_cpu() as prof:
      with torch.profiler.record_function("warm-up"):
        torch.ones(4).sum()
      for i in range(5):
        with tracing.span(f"s{attempt}.{i}", id=i):
          for _ in range(i + 1):
            torch.ones(64, 64).sum()
    # a profiler started right after another, with no call into the
    # program between them, continues its session: keep this attempt's
    got = {s.name: s for s in tracing.snapshot()["spans"]
           if s.name.startswith(f"s{attempt}.")}
    assert len(got) == 5
    path = tmp_path / f"trace{attempt}.json"
    prof.export_chrome_trace(str(path))
    ranges = {e["name"]: e for e in json.loads(path.read_text())[
        "traceEvents"] if e.get("cat") == "user_annotation"}
    assert set(got) <= set(ranges)
    dur = [abs(ranges[n]["dur"] - (s.end_ns - s.start_ns) / 1e3)
           for n, s in got.items()]
    off = [ranges[n]["ts"] - s.start_ns / 1e3 for n, s in got.items()]
    if max(dur) < 50 and max(off) - min(off) < 50:
      return
  pytest.fail(f"durations differ by {dur} us, offsets by "
              f"{max(off) - min(off)} us")


def random_maps(seed):
  gen = torch.Generator().manual_seed(seed)
  coords = torch.randn((6, 8, 3), generator=gen)
  variance = torch.rand((6, 8, 1), generator=gen) + 0.1
  return coords, variance, torch.ones_like(variance, dtype=torch.bool)


@pytest.mark.parametrize("solver", ["dlt", "p3p"])
def test_the_pose_stages_nest_in_order_inside_the_solve(traced, solver):
  coords, variance, valid = random_maps(3)
  cfg = ransac.RansacConfig(num_hypotheses=8, top_k=32, solver=solver)
  with tracing.span("tick", id=5):
    ransac.solve_pnp_from_maps(coords, variance, valid, torch.as_tensor(K),
                               torch.Generator().manual_seed(0), config=cfg)
  spans = tracing.snapshot()["spans"]
  assert [s.name for s in spans] == ["tick", "pose.solve"] + STAGES
  solve = spans[1]
  assert solve.parent == 0 and all(s.parent == 1 for s in spans[2:])
  assert all(s.id == 5 for s in spans)
  at = solve.start_ns
  for s in spans[2:]:
    assert at <= s.start_ns <= s.end_ns
    at = s.end_ns
  assert at <= solve.end_ns


@pytest.mark.parametrize("surface,depth", [("stream", 0), ("fleet", 0),
                                           ("fleet", 2)])
def test_a_tick_counts_one_host_sync_a_finalized_tick(params, traced,
                                                      surface, depth):
  fs = frames(5)
  if surface == "stream":
    reloc = OnlineRelocalizer(params, CFG, K, ransac_config=RCFG,
                              device="cpu")
    for f in fs:
      reloc.process(f)
    finalized = [5]
  else:
    reloc = FleetRelocalizer(params, CFG, K, batch_size=2,
                             ransac_config=RCFG, pipeline_depth=depth,
                             device="cpu")
    for f in fs:
      reloc.process(np.stack([f, f[::-1]]), reset=[False, True])
    finalized = [5 - depth]
    assert tracing.snapshot()["counters"]["host.syncs"] == finalized[0]
    reloc.flush()
    finalized.append(5)
  got = tracing.snapshot()
  assert got["counters"] == {"host.syncs": finalized[-1]}
  n = names(got)
  assert n["online.tick"] == n["pose.solve"] == 5
  assert n["online.wait"] == 5 and n["filter.first"] == 1
  ticks = [s.id for s in got["spans"] if s.name == "online.tick"]
  waits = [s.id for s in got["spans"] if s.name == "online.wait"]
  assert ticks == waits == list(range(5))
  for s in got["spans"]:
    if s.name == "pose.solve":
      assert got["spans"][s.parent].name == "online.tick"


def test_chunks_stage_under_their_index_and_sync_counts(params, traced):
  out = list(sequence.run_filter_chunked_arrays(
      params, CFG, iter(frames(11)), chunk_size=4, device="cpu"))
  assert [xs.shape[0] for xs, _ in out] == [5, 4, 2]
  got = tracing.snapshot()
  stages = [s for s in got["spans"] if s.name == "sequence.stage"]
  assert [s.id for s in stages] == [0, 1, 2]
  assert all(s.parent is None for s in stages)
  assert names(got)["filter.first"] == 1 and "host.syncs" not in got[
      "counters"]
  timing.sync(out[-1])
  assert tracing.snapshot()["counters"] == {"host.syncs": 1}


def test_past_the_cap_spans_are_counted_as_dropped(traced, monkeypatch):
  monkeypatch.setattr(tracing, "MAX_SPANS", 2)
  with tracing.span("a", id=1):
    with tracing.span("b"):
      with tracing.span("c"):
        with tracing.span("d"):
          pass
  got = tracing.snapshot()
  assert [(s.name, s.id) for s in got["spans"]] == [("a", 1), ("b", 1)]
  assert got["counters"] == {"tracing.dropped": 2}


def test_no_span_is_recorded_inside_a_graph_capture(traced):
  with mock.patch.object(torch.cuda, "is_initialized", return_value=True), \
      mock.patch.object(torch.cuda, "is_current_stream_capturing",
                        return_value=True):
    with tracing.span("captured"):
      tracing.count("filter.captures")
  got = tracing.snapshot()
  assert got["spans"] == [] and got["counters"] == {"filter.captures": 1}


@pytest.mark.parametrize("surface", ["stream", "fleet"])
def test_the_cpu_serves_the_eager_solve_with_its_stages(params, traced,
                                                        surface):
  """A surface on the CPU builds no graphed solve: each of its solves is
  the eager one, its four stages inside it, and nothing counts a pose
  capture or replay."""
  if surface == "stream":
    reloc = OnlineRelocalizer(params, CFG, K, ransac_config=RCFG,
                              device="cpu")
    serve = reloc.process
  else:
    reloc = FleetRelocalizer(params, CFG, K, batch_size=2,
                             ransac_config=RCFG, device="cpu")
    serve = lambda f: reloc.process(np.stack([f, f[::-1]]))
  assert reloc._solver is None
  for f in frames(3):
    serve(f)
  got = tracing.snapshot()
  assert "pose.captures" not in got["counters"]
  assert "pose.replays" not in got["counters"]
  solves = [i for i, s in enumerate(got["spans"]) if s.name == "pose.solve"]
  assert len(solves) == 3
  for i in solves:
    assert [s.name for s in got["spans"] if s.parent == i] == STAGES


class _FakeGraph:
  """``torch.cuda.CUDAGraph`` on the CPU: records the generators
  registered to it and the memory pool it was captured in, and counts its
  replays (which recompute nothing). Every one made is in ``made``."""

  made: list = []

  def __init__(self):
    self.generators, self.replays, self.pool = [], 0, None
    _FakeGraph.made.append(self)

  def register_generator_state(self, gen):
    self.generators.append(gen)

  def replay(self):
    self.replays += 1


@contextlib.contextmanager
def _fake_capture(graph, pool=None, capture_error_mode="global"):
  """``torch.cuda.graph`` on the CPU: the body runs eagerly, as the capture
  records it, seen as capturing by the tracer and the launch counters,
  with the registered generators' states put back after it (a capture
  draws nothing)."""
  assert capture_error_mode == "thread_local"
  graph.pool = pool
  states = [g.get_state() for g in graph.generators]
  with mock.patch.object(torch.cuda, "is_initialized", return_value=True), \
      mock.patch.object(torch.cuda, "is_current_stream_capturing",
                        return_value=True):
    yield
  for g, st in zip(graph.generators, states):
    g.set_state(st)


@pytest.fixture
def fake_cuda_graphs():
  """The CUDA calls of ``utils/graphs.py`` replaced so that every graph
  user (the filter step, the pose solve, ESAC's parts) runs graphed on the
  CPU, where ``graph`` is not False: the control flow of a capture and its
  replays, not their values (a fake capture runs its body once more, a
  fake replay computes nothing). Yields the fake graphs made, in order."""
  stream = mock.Mock()
  _FakeGraph.made = []
  with mock.patch.object(torch.cuda, "Stream", return_value=stream), \
      mock.patch.object(torch.cuda, "current_stream", return_value=stream), \
      mock.patch.object(torch.cuda, "stream",
                        side_effect=lambda s: contextlib.nullcontext()), \
      mock.patch.object(torch.cuda, "CUDAGraph", _FakeGraph), \
      mock.patch.object(torch.cuda, "graph", _fake_capture), \
      mock.patch.object(torch.cuda, "graph_pool_handle", object), \
      mock.patch.object(torch.cuda, "is_current_stream_capturing",
                        return_value=False), \
      mock.patch.object(graphs, "use_graph",
                        lambda device, graph: graph is not False), \
      mock.patch.dict(sequence._graphs, clear=True):
    yield _FakeGraph.made


class _Wrapper:
  """A kernel wrapper as ``kernels/launches.py`` counts it."""
  launches = 0


def test_the_mechanism_clones_copies_in_and_keeps_one_graph_a_slot(
    fake_cuda_graphs):
  """``graphs.Graph``: a None input stays None, the warm-up runs on the
  clones and is the building call's result; a replay copies each new
  input into its buffer (none that is its buffer already), counts the
  capture's launches and returns the capture's outputs. ``graphs.kept``
  replays a graph that fits and drops an old one before building anew."""
  wrapper = _Wrapper()
  seen = []

  def fn(a, none, b):
    seen.append((a, none, b))
    launches.count(wrapper)
    return a + b

  a, b = torch.ones(3), torch.arange(3.0)
  g = graphs.Graph(fn, (a, None, b))
  assert g.inputs[1] is None and g.inputs[0] is not a
  assert all(x is y for x, y in zip(seen[0], g.inputs))
  assert torch.equal(g.first, a + b) and g.first is not g.out
  assert wrapper.launches == 1 and g.record == {wrapper: 1}
  buf = g.inputs[0]
  assert g.replay(buf, None, torch.full((3,), 5.0)) is g.out
  assert g.inputs[0] is buf and torch.equal(g.inputs[2], torch.full((3,), 5.))
  assert wrapper.launches == 2 and g.graph.replays == 1
  held, builds = {}, []

  def build():
    builds.append(dict(held))  # what the slot holds while building
    return graphs.Graph(fn, (a, None, b))

  first, built = graphs.kept(held, "s", lambda _: True, build)
  assert built and held == {"s": first}
  assert graphs.kept(held, "s", lambda _: True, build) == (first, False)
  second, built = graphs.kept(held, "s", lambda _: False, build)
  assert built and second is not first and builds == [{}, {}]


def _updated(params):
  """A copy of ``params`` whose weights a test may update in place."""
  return L.tree_map(lambda t: t.clone(), params)


def test_a_graphed_relocaliser_captures_its_step_once_and_replays(
    params, traced, fake_cuda_graphs):
  """Rehearsed on the CPU: the first filter-step frame warms up (that
  frame's result, the eager surface's) and captures the step; later
  frames copy themselves into the graph's frame buffer and replay, the
  carry staying in the graph's buffers; after a reset the next frame
  copies the new carry in and replays; an in-place weight update, or a
  new frame shape, captures again."""
  p = _updated(params)
  graphed = OnlineRelocalizer(p, CFG, K, solve_pose=False, device="cpu")
  eager = OnlineRelocalizer(p, CFG, K, solve_pose=False, device="cpu",
                            graph=False)
  fs = frames(6)
  assert graphed._graphs.get("step") is None
  got = [graphed.tick(f) for f in fs[:2]]
  want = [eager.tick(f) for f in fs[:2]]
  assert torch.equal(got[1], want[1])  # the warm-up is this frame's step
  assert tracing.snapshot()["counters"] == {"filter.captures": 1,
                                            "host.syncs": 1}
  step = graphed._graphs.get("step")
  assert graphed.state is step.carry
  for f in fs[2:4]:
    graphed.tick(f)
    assert torch.equal(step.frame, torch.from_numpy(f))
  assert graphed._graphs.get("step") is step and step.graph.replays == 2
  graphed.reset()
  eager.reset()
  graphed.tick(fs[4])
  eager.tick(fs[4])
  new = eager.state
  graphed.tick(fs[5])
  assert graphed._graphs.get("step") is step and step.graph.replays == 3
  assert all(torch.equal(b, c) for b, c in zip(step.carry, new))
  with torch.no_grad():
    L.tree_leaves(p)[0].add_(0.0)  # a new version of the same values
  graphed.tick(fs[0])
  assert graphed._graphs.get("step") is not step
  graphed.reset()
  wide = np.concatenate([fs[:2], fs[:2]], axis=2)  # (2, 48, 128, 3)
  graphed.tick(wide[0])
  graphed.tick(wide[1])
  assert tuple(graphed._graphs.get("step").frame.shape) == (48, 128, 3)
  assert tracing.snapshot()["counters"]["filter.captures"] == 3


def test_a_graphed_fleet_copies_each_ticks_reset_mask_in(params, traced,
                                                         fake_cuda_graphs):
  """Rehearsed on the CPU: the fleet's step captures once, with the reset
  mask a static buffer that every later tick copies its mask into (zeros
  where the tick resets no slot); the capturing tick's result is the
  eager fleet's."""
  graphed = FleetRelocalizer(params, CFG, K, batch_size=2, solve_pose=False,
                             device="cpu")
  eager = FleetRelocalizer(params, CFG, K, batch_size=2, solve_pose=False,
                           device="cpu", graph=False)
  ticks = [np.stack([f, f[::-1]]) for f in frames(5)]
  resets = [None, [True, False], [False, True], None, [True, True]]
  for t, (tick, reset) in enumerate(zip(ticks, resets)):
    got = graphed.tick(tick, reset=reset)
    if t < 2:
      assert torch.equal(got, eager.tick(tick, reset=reset))
    if t:
      want = [False, False] if reset is None else reset
      assert graphed._graphs.get("step").mask.tolist() == want
  assert graphed._graphs.get("step").graph.replays == 3
  assert tracing.snapshot()["counters"] == {"filter.captures": 1,
                                            "host.syncs": 1}


def test_run_filter_keeps_one_graph_a_key(params, traced, fake_cuda_graphs):
  """Rehearsed on the CPU: a graphed run_filter captures its step on frame
  1 (the warm-up: the eager run's step) and replays it on the rest; a
  second call replays the kept graph; another return_aux and a new frame
  shape are new keys; an in-place weight update captures again in its
  key."""
  p = _updated(params)
  fs = frames(4)
  run = lambda images, **kw: sequence.run_filter(p, CFG, images,
                                                 device="cpu",
                                                 return_aux=True, **kw)[3]
  got, want = run(fs), run(fs, graph=False)
  assert all(torch.equal(got[k][0], want[k][0]) for k in want)
  (step,) = sequence._graphs.values()
  assert step.graph.replays == 2
  run(fs)
  assert list(sequence._graphs.values()) == [step]
  assert step.graph.replays == 5
  assert tracing.snapshot()["counters"]["filter.captures"] == 1
  sequence.run_filter(p, CFG, fs, device="cpu")
  run(np.concatenate([fs, fs], axis=2))
  assert len(sequence._graphs) == 3
  with torch.no_grad():
    L.tree_leaves(p)[0].add_(0.0)
  run(fs)
  assert len(sequence._graphs) == 3 and step not in sequence._graphs.values()
  assert tracing.snapshot()["counters"]["filter.captures"] == 4


ECFG = esac.EsacConfig(num_experts=3, stem_channels=(4, 8, 16, 32),
                       res_channels=64, head_channels=64,
                       gating_channels=(1, 2, 4, 8), compute_dtype="float32")
ERCFG = ransac.RansacConfig(solver="p3p", num_hypotheses=32)


@pytest.fixture(scope="module")
def esac_params():
  return esac.init(3, ECFG, device="cpu")


def test_esac_captures_every_part_on_the_first_tick(esac_params, traced,
                                                    fake_cuda_graphs):
  """Rehearsed on the CPU: ESAC's first tick captures the gating, the draw
  (the only one of them with the generator registered), the expert pass of
  every size (in one pool) and the solve, and is the eager surface's tick
  bit for bit; each later tick replays the gating, the draw and one pass
  graph a pass."""
  B = 2
  graphed, eager = (EsacRelocalizer(esac_params, ECFG, K, batch_size=B,
                                    ransac_config=ERCFG, seed=5,
                                    device="cpu", graph=graph)
                    for graph in (None, False))
  ticks = np.random.default_rng(3).integers(0, 256, (3, B, 48, 64, 3),
                                            dtype=np.uint8)
  assert torch.equal(graphed.tick(ticks[0]), eager.tick(ticks[0]))
  assert torch.equal(graphed._gen.get_state(), eager._gen.get_state())
  sizes = B * ECFG.num_experts  # below PASS_PAIRS: one graph a size
  assert tracing.snapshot()["counters"] == {
      "esac.captures": 2 + sizes, "pose.captures": 1,
      "host.syncs": 2 + sizes + 1 + 2,  # and each surface's read-back
      "esac.expert_runs": mock.ANY,
      "esac.experts_drawn": mock.ANY}
  made = fake_cuda_graphs
  gen = [graphed._gen]
  assert [g.generators for g in made] == [[], gen] + [[]] * sizes + [gen]
  pool = made[2].pool
  assert pool is not None
  assert [g.pool for g in made] == [None, None] + [pool] * sizes + [None]
  passes = 0
  for tick in ticks[1:]:
    graphed.tick(tick)
    passes += len(pair_passes(graphed.last[2].numel()))
  assert tracing.snapshot()["counters"]["esac.replays"] == 2 * 2 + passes
  assert [g.replays for g in made[:2]] == [2, 2]
  assert sum(g.replays for g in made[2:-1]) == passes
  assert len(made) == 2 + sizes + 1  # nothing captured after the first


@pytest.mark.parametrize("surface", ["stream", "fleet", "esac"])
def test_a_dropped_surface_frees_its_graphs_at_once(params, esac_params,
                                                     fake_cuda_graphs,
                                                     surface):
  """A graphed surface is in no reference cycle: dropping it frees it and
  its graphs at once. Left to a garbage collection, they could be freed
  inside another surface's capture, which a CUDA capture refuses."""
  if surface == "esac":
    reloc = EsacRelocalizer(esac_params, ECFG, K, ransac_config=ERCFG,
                            device="cpu")
    ticks = [f[None] for f in frames(3)]
  elif surface == "fleet":
    reloc = FleetRelocalizer(params, CFG, K, batch_size=2,
                             ransac_config=RCFG, device="cpu")
    ticks = [np.stack([f, f]) for f in frames(3)]
  else:
    reloc = OnlineRelocalizer(params, CFG, K, ransac_config=RCFG,
                              device="cpu")
    ticks = frames(3)
  for t in ticks:
    reloc.tick(t)
  assert len(fake_cuda_graphs) > 1  # the solve and more were captured
  gone = [weakref.ref(reloc)] + [weakref.ref(g) for g in fake_cuda_graphs]
  fake_cuda_graphs.clear()
  gc.disable()
  try:
    del reloc
    assert [r() for r in gone] == [None] * len(gone)
  finally:
    gc.enable()


def _launching(fn, wrapper):
  """``fn`` that also launches ``wrapper``'s kernel once a call."""
  def call(*args, **kwargs):
    launches.count(wrapper)
    return fn(*args, **kwargs)
  return call


@pytest.mark.parametrize("user", ["filter_step", "pose_solve", "esac_gate"])
def test_a_launch_inside_any_capture_counts_once_a_replay(
    params, esac_params, fake_cuda_graphs, monkeypatch, user):
  """A kernel wrapper called inside each graph user's body counts once a
  served frame, graphed as eagerly: the warm-up's launch runs, the
  capture's is recorded and not counted, and each replay adds it once."""
  wrapper = _Wrapper()
  if user == "esac_gate":
    monkeypatch.setattr(esac, "gate", _launching(esac.gate, wrapper))
    reloc = EsacRelocalizer(esac_params, ECFG, K, batch_size=1,
                            ransac_config=ERCFG, device="cpu")
    served = [f[None] for f in frames(4)]
  else:
    owner, name = ((kfnet, "filter_step") if user == "filter_step"
                   else (ransac, "_solve_maps"))
    monkeypatch.setattr(owner, name,
                        _launching(getattr(owner, name), wrapper))
    reloc = OnlineRelocalizer(params, CFG, K, ransac_config=RCFG,
                              solve_pose=user == "pose_solve", device="cpu")
    served = frames(4)
  for f in served:
    reloc.tick(f)
  # the filter step runs from the second frame on, the rest every frame
  assert wrapper.launches == len(served) - (user == "filter_step")


def test_a_graphed_solve_captures_once_a_key_and_replays(traced,
                                                         fake_cuda_graphs):
  """Rehearsed on the CPU: the first call of a key solves eagerly (this
  call's result, one block of draws) and captures with the generator
  registered; later calls copy the maps into the graph's buffers and
  replay, returning its output buffers; a new map shape, config or
  generator captures again."""
  Kt = torch.as_tensor(K)
  gen = torch.Generator().manual_seed(4)
  ref_gen = torch.Generator().manual_seed(4)
  holder = ransac.GraphedSolve()
  maps = random_maps(5)
  got = ransac.solve_pnp_from_maps(*maps, Kt, gen, config=RCFG,
                                   graphed=holder)
  assert tracing.snapshot()["counters"] == {"pose.captures": 1,
                                            "host.syncs": 1}
  spans = tracing.snapshot()["spans"]
  # the warm-up's stages; none recorded inside the capture
  assert [s.name for s in spans] == ["pose.solve", "pose.capture"] + STAGES
  assert holder.graph.generators == [gen]
  tracing.disable()
  want = ransac.solve_pnp_from_maps(*maps, Kt, ref_gen, config=RCFG)
  assert all(torch.equal(got[k], want[k]) for k in want)
  assert torch.equal(gen.get_state(), ref_gen.get_state())
  tracing.enable()
  captured = holder.graph
  for seed in (6, 7):
    new = random_maps(seed)
    out = ransac.solve_pnp_from_maps(*new, Kt, gen, config=RCFG,
                                     graphed=holder)
    assert out is holder.out and holder.graph is captured
    assert all(torch.equal(b, m) for b, m in zip(holder.inputs, new + (Kt,)))
  assert captured.replays == 2
  got = tracing.snapshot()
  assert got["counters"] == {"pose.replays": 2}
  assert [s.name for s in got["spans"]] == ["pose.solve"] * 2  # no stages
  wider = tuple(torch.cat([m, m], dim=1) for m in random_maps(8))
  other = ransac.RansacConfig(num_hypotheses=8, top_k=32)
  for args, cfg in (((*wider, Kt, gen), RCFG), ((*maps, Kt, gen), other),
                    ((*maps, Kt, torch.Generator().manual_seed(4)), other)):
    ransac.solve_pnp_from_maps(*args, config=cfg, graphed=holder)
    assert holder.graph is not captured
    captured = holder.graph
  assert tracing.snapshot()["counters"]["pose.captures"] == 3


# ---- on the card ------------------------------------------------------------


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")
  return torch.device("cuda")


@pytest.mark.cuda
def test_one_filter_capture_per_graphed_step(cuda, params, traced):
  reloc = OnlineRelocalizer(params, CFG, K, ransac_config=RCFG, device=cuda)
  for f in frames(4):
    reloc.process(f)
  got = tracing.snapshot()
  # the pose solve captured on the first frame and replayed after it; the
  # kernels solve the warm-up and each replay
  assert got["counters"] == {"filter.captures": 1, "pose.captures": 1,
                             "pose.replays": 3, "pose.kernel_solves": 1 + 3,
                             "host.syncs": 4 + 2}
  replays = [s for s in got["spans"] if s.name == "filter.replay"]
  assert len(replays) == 2 and all(s.device_ms > 0 for s in replays)
  capture = [s for s in got["spans"] if s.name == "filter.capture"]
  assert len(capture) == 1
  assert got["spans"][capture[0].parent].name == "online.tick"
  capture = [s for s in got["spans"] if s.name == "pose.capture"]
  assert len(capture) == 1
  assert got["spans"][capture[0].parent].name == "pose.solve"
  sequence.run_filter(params, CFG, frames(3, seed=1), device=cuda)
  assert tracing.snapshot()["counters"]["filter.captures"] == 2


@pytest.mark.cuda
@pytest.mark.parametrize("surface", ["stream", "fleet"])
def test_host_syncs_match_torchs_own_sync_detection(cuda, params, surface):
  """20 served ticks after the capture: every sync torch detects is one the
  program counts. The sync debug mode warns on copies and stream or device
  syncs but not on an event's wait (``cudaEventSynchronize``, the fleet's
  ``_finalize``), which torch's GPU trace reports instead; the two together
  must equal ``host.syncs``."""
  from torch.cuda import _gpu_trace
  if surface == "stream":
    reloc = OnlineRelocalizer(params, CFG, K, ransac_config=RCFG,
                              device=cuda)
    serve = lambda f: reloc.process(f)
  else:
    reloc = FleetRelocalizer(params, CFG, K, batch_size=4,
                             ransac_config=RCFG, device=cuda)
    serve = lambda f: reloc.process(np.stack([f] * 4),
                                    reset=[False, False, False, False])
  fs = frames(23)
  for f in fs[:3]:  # the eager first tick, the capture, a replay
    serve(f)
  torch.cuda.synchronize()
  event_waits = []
  torch._C._activate_gpu_trace()
  callbacks = _gpu_trace.EventSynchronizationCallbacks.callback_list
  callbacks.append(event_waits.append)
  # the mode is set before the warnings are recorded: setting it may warn
  torch.cuda.set_sync_debug_mode("warn")
  tracing.enable()
  try:
    with warnings.catch_warnings(record=True) as caught:
      warnings.simplefilter("always")
      for f in fs[3:]:
        serve(f)
  finally:
    tracing.disable()
    torch.cuda.set_sync_debug_mode("default")
    callbacks.remove(event_waits.append)
  warned = sum("synchronizing" in str(w.message) for w in caught)
  syncs = tracing.snapshot()["counters"]["host.syncs"]
  assert syncs == 20
  assert warned + len(event_waits) == syncs, (warned, len(event_waits))
