"""The harness on the CPU: discovery by name, the metric arithmetic on
synthetic spans and traces, the import check, and whole runs at the tiny
size: a sound run is correct; the control and each fault the cells can
have are not. Tests that need the card are marked ``cuda``."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import types

import numpy as np
import pytest
import torch

from perfbench import check, loops, run, tracing
from perfbench.families import kfnet as family
from perfbench.tests import tiny
from perfbench.traffic import generator

CPU = torch.device("cpu")
BENCH = run.load_benchmark(tiny.ROOT)
CELLS = [w["name"] for w in BENCH["workloads"]]


# ---- discovery ------------------------------------------------------------


def test_every_name_has_its_file():
  for c in BENCH["configs"]:
    cfg = run.load_config(BENCH, c["name"])
    assert cfg["name"] == c["name"] and c["reduced"] == []
    assert run.load_family(cfg) is family
    assert family.count(cfg) > 26e6  # the paper's widths
  for w in BENCH["workloads"]:
    assert generator.load(w["traffic"])["mode"] in ("stream", "fleet",
                                                    "offline")
    assert set(check.load_limits(w["name"])) <= set(family.NUMBERS)
  for m in BENCH["per_layer"]:
    assert callable(run.load_reader(m["name"]))
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    for cell in m.get("workloads", []):
      assert cell in CELLS


def test_every_cell_reports_setup_another_metric_and_a_layer():
  for cell in CELLS:
    e2e = [m["name"] for m in run.metrics_of(BENCH, cell, "end_to_end")]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert run.metrics_of(BENCH, cell, "per_layer")


def test_unknown_names_raise():
  with pytest.raises(FileNotFoundError):
    generator.load("no-such-mix")
  with pytest.raises(FileNotFoundError):
    run.load_reader("no.such.metric")
  with pytest.raises(LookupError, match="names no family"):
    run.family_file({"name": "x"})
  with pytest.raises(LookupError, match="has no module"):
    run.family_file({"name": "x", "family": "no_such_family"})


@pytest.mark.parametrize("family", [None, "no_such_family"])
def test_a_config_without_a_family_module_stops_the_run(monkeypatch, capsys,
                                                        family):
  real = run.load_config

  def config(bench, name):
    cfg = real(bench, name)
    del cfg["family"]
    if family is not None:
      cfg["family"] = family
    return cfg

  monkeypatch.setattr(run, "load_config", config)
  rc = run.main(["--workload", "gn-stream1", "--seed", "1", "--seconds",
                 "1", "--trace", "0"])
  out = capsys.readouterr()
  assert rc == 2 and out.out == ""
  assert "family" in out.err


def test_judge_takes_the_familys_order_and_refuses_unknown_names():
  limits = {"pose_mismatch": {"limit": 0.05}, "meas_z_rel": {"limit": 0.08}}
  numbers = {"meas_z_rel": 0.01, "pose_mismatch": 0.0, "other": 0.0}
  ok, shown = check.judge(numbers, limits, family.NUMBERS)
  assert ok and list(shown) == ["meas_z_rel", "pose_mismatch"]
  # a number the family computes but does not define as compared
  ok, shown = check.judge(numbers, dict(limits, other={"limit": 1.0}),
                          family.NUMBERS)
  assert not ok and list(shown)[-1] == "other"
  assert shown["other"] == {"value": None, "limit": 1.0}


# ---- arithmetic ------------------------------------------------------------


def test_percentile_and_rate():
  lat = [0.01 * i for i in range(1, 101)]
  assert run.percentile(lat, 95) == pytest.approx(0.9505)
  assert run.percentile(lat, 50) == pytest.approx(0.505)
  rec = loops.Record("stream", t0=10.0, t1=22.0, paused_s=2.0, frames=500)
  assert rec.frames / rec.window_s == 50.0


def test_union_busy_and_gaps():
  ops = [("a", 0.0, 10.0, None, 1), ("b", 5.0, 10.0, None, 2),
         ("c", 30.0, 5.0, None, 3), ("d", 90.0, 20.0, None, 4)]
  busy, gaps = tracing.busy_and_gaps(ops, 0.0, 100.0)
  assert busy == 15.0 + 5.0 + 10.0
  assert gaps == [(15.0, 15.0), (35.0, 55.0)]


def test_innermost_span():
  ranges = [("tick", 0.0, 100.0), ("solve", 50.0, 90.0), ("x", 60.0, 70.0)]
  got = tracing.innermost(ranges, [10.0, 55.0, 65.0, 95.0, 200.0, None])
  assert got == ["tick", "solve", "x", "tick", None, None]


def test_replayed_kernels_take_the_layer_of_their_place():
  eager = {"ops": [("cast", 0, 1, "groupnorm", 1), ("gemm", 1, 1, "conv", 2),
                   ("sum", 3, 1, "groupnorm", 3), ("cast", 4, 1, None, 4),
                   ("Memcpy DtoD", 5, 1, None, 5), ("step", 6, 1, "fused", 6)]}
  seq = tracing.eager_sequence(eager, family.LAYERS)
  assert seq == [("cast", "groupnorm"), ("gemm", "conv"), ("sum", "groupnorm"),
                 ("cast", None), ("step", "fused")]
  # the replay adds a frame copy in front and a carry copy behind; the same
  # name takes the layer of its place
  got, n = tracing.align(["s2d", "cast", "gemm", "sum", "cast", "step",
                          "copy"], seq)
  assert got == [None, "groupnorm", "conv", "groupnorm", None, "fused", None]
  assert n == 5


def _ctx(trace_ops, ranges, eager_seq, cfg, mix, batch=1):
  trace = {"ops": trace_ops,
           "ranges": [("trace", 0.0, 1e6)] + ranges}
  summary = tracing.TraceSummary(trace, 1.0, eager_seq, family.LAYERS,
                                 family.REPLAY_SPAN)
  rec = loops.Record("offline", t0=0.0, t1=12.0, trace_end=2.0)
  rec.units = [(1.0, 10, 1), (3.0, 100, 0), (12.0, 100, 0)]
  rec.trace = summary
  spans = tracing.Spans()
  return types.SimpleNamespace(
      rec=rec, spans=spans, family=family, cfg=cfg, mix=mix,
      frame_shape=(480, 640, 3),
      batch=batch,
      peaks={"bf16": 989e12, "fp32": 67e12, "hbm_bytes": 3.35e12})


def test_readers_on_a_synthetic_trace():
  cfg = run.load_config(BENCH, "kfnet-gn-640x480")
  mix = generator.load("offline1000")
  ops = [("gemm", 0.0, 400.0, "filter.replay", 7),
         ("gnk", 400.0, 100.0, "filter.replay", 7),
         ("fused_filter_kernel", 500.0, 2.5, "filter.replay", 7),
         ("tiny", 600.0, 1.0, "pose.solve", 8),
         ("Memcpy HtoD", 700.0, 1.0, "pose.solve", 9)]
  ranges = [("filter.replay", 0.0, 10.0), ("pose.solve", 590.0, 800.0)]
  seq = [("gemm", "conv"), ("gnk", "groupnorm"),
         ("fused_filter_kernel", "fused")]
  ctx = _ctx(ops, ranges, seq, cfg, mix)
  assert ctx.rec.trace.layer_shares()["replay_kernels_matched"] == 1.0
  peaks = ctx.peaks
  conv = run.load_reader("conv_roofline.offline")(ctx)
  assert conv == pytest.approx(
      100 * family.conv_bound_s(cfg, (480, 640), peaks) / 400e-6)
  assert run.load_reader("groupnorm.device_ms.offline")(ctx) == 0.1
  fused = run.load_reader("fused_roofline.offline")(ctx)
  assert fused == pytest.approx(
      100 * 4800 * family.FUSED_BYTES_PER_PIXEL / 3.35e12 / 2.5e-6)
  assert run.load_reader("pose.solve_kernels.serve")(ctx) == 1.0
  idle = run.load_reader("device.idle_share.offline")(ctx)
  assert idle == pytest.approx(100 * (1 - 504e-6))
  mfu = run.load_reader("mfu.offline")(ctx)
  assert mfu == pytest.approx(
      100 * 200 * family.frame_flops(cfg, (480, 640)) / 10.0 / 989e12)
  for name in ("online.tick_host_ms.serve", "pose.solve_host_ms.serve"):
    assert run.load_reader(name)(ctx) is None  # no spans: left out


def test_host_span_reader():
  ctx = _ctx([], [], [], run.load_config(BENCH, "kfnet-gn-640x480"),
             generator.load("stream1"))
  ctx.spans.times["pose.solve"] = [(1.0, 1.5), (3.0, 3.02), (4.0, 4.04)]
  assert run.load_reader("pose.solve_host_ms.serve")(ctx) == pytest.approx(
      30.0)


# ---- the import check -----------------------------------------------------


def test_banned_names_are_compared_whole(monkeypatch):
  monkeypatch.setitem(sys.modules, "kfnet_tpu_torch_x", types.ModuleType("x"))
  assert "kfnet_tpu" not in run.banned_modules()
  monkeypatch.setitem(sys.modules, "kfnet_tpu.models", types.ModuleType("y"))
  assert run.banned_modules() == ["kfnet_tpu"]


def test_a_run_loads_neither_jax_nor_the_jax_package():
  code = (
      "import sys, torch; sys.path.insert(0, %r)\n"
      "from perfbench import run\nfrom perfbench.tests import tiny\n"
      "c = 'gn-stream1'\n"
      "res, _ = run.run_cell(tiny.cell(c), tiny.config(c), tiny.mix(c), 5,"
      " 0.5, False, torch.device('cpu'), tiny.limits(c))\n"
      "print(res['correct'], run.banned_modules())\n" % tiny.ROOT)
  env = dict(os.environ)
  env.pop("PYTHONPATH", None)
  out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                       text=True, timeout=300, env=env, cwd=tiny.ROOT)
  assert out.returncode == 0, out.stderr[-2000:]
  assert out.stdout.strip().splitlines()[-1] == "True []"


def test_run_refuses_without_a_card():
  if torch.cuda.is_available():
    pytest.skip("a card is present")
  out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "gn-stream1", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], capture_output=True, text=True,
                       timeout=120, cwd=tiny.ROOT)
  assert out.returncode != 0 and out.stdout == ""


# ---- whole runs at the tiny size ------------------------------------------


def _run(cell, seed=2 ** 31 + 3, seconds=3.0):
  res, _ = run.run_cell(tiny.cell(cell), tiny.config(cell), tiny.mix(cell),
                        seed, seconds, False, CPU, tiny.limits(cell))
  return res


@pytest.mark.parametrize("cell", CELLS)
def test_a_sound_run_is_correct(cell):
  res = _run(cell)
  assert res["correct"], res["checks"]
  assert res["attempted"] > 0 and res["failed"] == 0


@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell):
  cfg, mix = tiny.config(cell), tiny.mix(cell)
  seed = 17
  params = family.make_weights(cfg, seed, CPU)
  pool = generator.frames(mix, seed, tuple(cfg["frame"]), CPU)
  rec = family.control(cfg, mix, params, pool, seed, CPU, 40,
                      mix["pool_frames"])
  numbers = family.compare(cfg, mix, params, pool, rec, seed, CPU)
  correct, shown = check.judge(numbers, tiny.limits(cell), family.NUMBERS)
  assert not correct, shown


def _unchanged_state(monkeypatch):
  """Fault: a filter step that returns its state unchanged."""
  from kfnet_tpu_torch.models import kfnet
  real = kfnet.filter_step

  def stale(params, config, x, P, feat, image):
    _, _, f1, aux = real(params, config, x, P, feat, image)
    return x.clone(), P.clone(), f1, aux

  monkeypatch.setattr(kfnet, "filter_step", stale)


def _half_batch(monkeypatch):
  """Fault: half the slots of a batch left out of the step."""
  from kfnet_tpu_torch.models import kfnet
  real = kfnet.filter_step

  def half(params, config, x, P, feat, image):
    x1, P1, f1, aux = real(params, config, x, P, feat, image)
    if x.dim() == 4:
      h = x.shape[0] // 2
      x1, P1 = torch.cat([x1[:h], x[h:]]), torch.cat([P1[:h], P[h:]])
    return x1, P1, f1, aux

  monkeypatch.setattr(kfnet, "filter_step", half)


def _altered_pose(monkeypatch):
  """Fault: a served pose altered where the solve produces it."""
  from kfnet_tpu_torch.pose import ransac
  real = ransac.solve_pnp_from_maps

  def moved(*args, **kwargs):
    out = dict(real(*args, **kwargs))
    out["T_wc"] = out["T_wc"].clone()
    out["T_wc"][..., 0, 3] += 0.25
    return out

  monkeypatch.setattr(ransac, "solve_pnp_from_maps", moved)


def _altered_posterior(monkeypatch):
  """Fault: a posterior altered where the step produces it (its
  coordinates' channels in reverse order)."""
  from kfnet_tpu_torch.models import kfnet
  real = kfnet.filter_step

  def moved(*args, **kwargs):
    x1, P1, f1, aux = real(*args, **kwargs)
    return x1.flip(-1), P1, f1, aux

  monkeypatch.setattr(kfnet, "filter_step", moved)


FAULTS = {
    "gn-stream1": [_unchanged_state, _altered_pose, _altered_posterior],
    "nonorm-fleet4": [_unchanged_state, _half_batch, _altered_pose,
                      _altered_posterior],
    "gn-offline1000": [_unchanged_state, _altered_posterior],
    "nonorm-offline1000": [_unchanged_state, _altered_posterior],
}


@pytest.mark.parametrize("cell,fault", [(c, f) for c in CELLS
                                        for f in FAULTS[c]],
                         ids=lambda v: getattr(v, "__name__", v))
def test_a_fault_is_not_correct(monkeypatch, cell, fault):
  fault(monkeypatch)
  res = _run(cell)
  assert not res["correct"], res["checks"]


# ---- on the card ----------------------------------------------------------


@pytest.fixture
def card():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device")


@pytest.mark.cuda
def test_a_cell_on_the_card(card):
  out = subprocess.run([sys.executable, "perfbench/run.py", "--workload",
                        "gn-offline1000", "--seed", str(2 ** 31 + 11),
                        "--seconds", "3", "--trace", "0"],
                       capture_output=True, text=True, timeout=600,
                       cwd=tiny.ROOT)
  assert out.returncode == 0, out.stderr[-3000:]
  res = json.loads(out.stdout.strip().splitlines()[-1])
  assert res["correct"] and res["metrics"]["filtered_fps"]["value"] > 0
  assert list(res)[-1] == "checks"
