"""The ESAC family (``families/esac.py``, ``esac_check.py``) on the CPU at
a tiny size: 5 experts at an eighth of the widths, 48x64 frames, float32.
Golden: the weights from a fixed seed (the gating's fitted layer included)
and the rendered pool by hash, the parameter count and the analytic work
(a tiny expert and gating, and the published 70.97 / 1.32 GFLOP at
480x640), and ``compare``, ``failures`` and ``judge`` on the record of one
fixed run, whose window closes after a fixed number of ticks. Beside them
each new reader on a synthetic context, and a tiny traced run in which
the readers that a CPU can feed read a value."""

from __future__ import annotations

import hashlib
import math
import types
import unittest.mock as mock

import pytest
import torch

from perfbench import check, loops, run, tracing
from perfbench.families import esac as family
from perfbench.tests import tiny
from perfbench.traffic import generator

CPU = torch.device("cpu")
WEIGHT_SEED = 2 ** 31 + 101
RUN_SEED = 2 ** 31 + 202
CELL = "esac-fleet4"
BENCH = run.load_benchmark(tiny.ROOT)
NEW = ["esac.gate_device_ms.serve", "esac.expert_device_ms.serve",
       "esac.expert_runs.serve", "esac.expert_roofline.serve",
       "esac.solve_device_ms.serve", "esac.mfu.serve"]
TICKS = 16  # the window closes on this call of ``Window.done``

WEIGHTS = "1a506c98a604bba68eeb876238f22d26012f36d4173090c49e02d86cb58163bc"
POOL = "fe6666410dc094caba62b1794e9ed6907dbcfad8c1eb4c9ff0b80fea4b0d5bf1"
COUNTS = (543665, 130877253)
NUMBERS = {"gate_rel": 1.298758661505417e-06, "route_mismatch": 0.0,
           "route_replay_mismatch": 0.0, "map_rel": 8.946228717832128e-07,
           "pairs_per_tick": 9.6, "pose_mismatch": 0.0,
           "pose_mismatch_ref_maps": 0.016666666666666666,
           "top_share_median": 0.8125, "experts_per_frame": 2.484375,
           "top_experts": 4}


def config() -> dict:
  cfg = run.load_config(BENCH, tiny.cell(CELL)["config"])
  cfg["frame"] = [48, 64, 3]
  cfg["num_experts"] = 5
  cfg["expert"].update(stem_channels=[4, 8, 16, 32], res_channels=64,
                       head_channels=64)
  cfg["gating"]["channels"] = [2, 2, 4, 8]
  cfg["gating"]["calibration"].update(frames=20, experts_per_frame=2.0,
                                      intrinsics=[58.5, 58.5, 31.5, 23.5])
  cfg["compute_dtype"] = "float32"
  cfg["ransac"]["num_hypotheses"] = 32
  return cfg


def mix() -> dict:
  m = generator.load(tiny.cell(CELL)["traffic"])
  m["intrinsics"] = [58.5, 58.5, 31.5, 23.5]
  m.update(pool_frames=16, stagger=4)
  return m


def limits() -> dict:
  return tiny.limits(CELL)


def digest(tensors) -> str:
  h = hashlib.sha256()
  for t in tensors:
    t = t.detach().contiguous().cpu()
    h.update(str((tuple(t.shape), str(t.dtype))).encode())
    h.update(t.numpy().tobytes())
  return h.hexdigest()


def leaves(tree):
  if isinstance(tree, dict):
    return [x for k in sorted(tree) for x in leaves(tree[k])]
  return [tree]


def test_weights_work_and_pool():
  cfg = config()
  full = run.load_config(BENCH, tiny.cell(CELL)["config"])
  assert digest(leaves(family.make_weights(cfg, WEIGHT_SEED, CPU))) == \
      WEIGHTS
  assert (family.count(cfg), family.count(full)) == COUNTS
  assert family.expert_flops(full, (480, 640)) == pytest.approx(70.97e9,
                                                                rel=1e-3)
  assert family.gating_flops(full, (480, 640)) == pytest.approx(1.32e9,
                                                                rel=1e-2)
  expert_params = sum(cin * cout * k * k for _, cin, cout, k, _ in
                      family.expert_layers(full))
  assert expert_params == full["work"]["expert_params"]
  assert family.expert_flops(full, (480, 640)) / 1e9 == pytest.approx(
      full["work"]["expert_gflop_480x640"], abs=0.005)
  pool = generator.frames(mix(), RUN_SEED, tuple(cfg["frame"]), CPU)
  assert digest([pool]) == POOL


def test_the_gating_is_fitted_to_its_calibration_frames():
  """The calibration frames draw ``experts_per_frame`` distinct experts
  on average through the fitted layer, and their top experts are spread
  over the experts (each expert owns the views nearest its prototype)."""
  cfg = config()
  params = family.make_weights(cfg, WEIGHT_SEED, CPU)
  frames = family.calibration_frames(cfg, WEIGHT_SEED, CPU)
  assert frames.shape == (20, 48, 64, 3)
  from perfbench.reference import esac_ref
  probs = esac_ref.gate(params, cfg, frames)
  drawn = family.experts_drawn(torch.log(probs),
                               cfg["ransac"]["num_hypotheses"])
  assert drawn == pytest.approx(
      cfg["gating"]["calibration"]["experts_per_frame"], rel=1e-3)
  assert len(set(probs.argmax(1).tolist())) >= 3
  # two experts, two draws: 2 - p1² - p2² distinct, 1.4 at p1 = (1 +
  # sqrt(0.2)) / 2, whose logit gap is log(p1 / (1 - p1))
  p1 = (1 + 0.2 ** 0.5) / 2
  assert family.temperature(torch.tensor([[0.0, -1.0]]), 2, 1.4) == \
      pytest.approx(math.log(p1 / (1 - p1)), rel=1e-5)


def test_the_check_of_a_fixed_run(monkeypatch):
  real_done = loops.Window.done
  calls = [0]

  def done(self, drain=None):
    real_done(self, drain)
    calls[0] += 1
    return calls[0] >= TICKS

  monkeypatch.setattr(loops.Window, "done", done)
  seen = {}
  real_compare = family.compare

  def compare(cfg, mix, params, pool, rec, seed, device):
    seen["rec"] = rec
    return real_compare(cfg, mix, params, pool, rec, seed, device)

  monkeypatch.setattr(family, "compare", compare)
  res, _ = run.run_cell(tiny.cell(CELL), config(), mix(), RUN_SEED, 1.0,
                        False, CPU, limits())
  rec = seen["rec"]
  assert (rec.frames, rec.attempted, len(rec.ticks), rec.solves) == (
      4 * TICKS, 4 * TICKS, TICKS, TICKS + mix()["warmup"])
  assert sorted(rec.kept) == list(range(1, TICKS))
  assert res["numbers"] == NUMBERS
  assert res["numbers"]["route_replay_mismatch"] == 0.0
  assert family.failures(config(), mix(), rec, RUN_SEED, CPU) == (0, 0)
  assert res["failed"] == 0 and res["correct"]
  assert list(res["checks"]) == ["gate_rel", "route_mismatch", "map_rel",
                                 "pose_mismatch"]
  assert check.judge(res["numbers"], limits(), family.NUMBERS) == (
      True, res["checks"])


def test_a_wrong_expert_map_reads_not_correct(monkeypatch):
  """A fault the check must see: the map of every second pair taken from
  the next expert."""
  real_keep = family.Server.keep

  def keep(self):
    probs, map_of, pairs, maps = real_keep(self)
    wrong = maps.clone()
    wrong[::2] = self.reloc.maps.index_select(0, pairs)[::2].roll(1, 0)
    return probs, map_of, pairs, wrong if len(pairs) > 1 else maps + 1.0

  monkeypatch.setattr(family.Server, "keep", keep)
  res, _ = run.run_cell(tiny.cell(CELL), config(), mix(), RUN_SEED, 0.5,
                        False, CPU, limits())
  assert not res["correct"]
  assert res["numbers"]["map_rel"] > limits()["map_rel"]["limit"]


# ---- the readers ------------------------------------------------------------

T0 = 100.0       # the traced part's start on the host clock (s)
LO = 5000.0      # ... and in the trace (us)


class FakePair:
  def __init__(self, ms):
    self.ms = ms

  def elapsed_time(self, other):
    return self.ms


def reader_ctx():
  """A traced part of 100 ms from T0 + 0 to T0 + 0.1 and a window to T0 +
  1: spans after it with CUDA events (gate 0.2 ms and 0.4 ms, experts 3
  and 5 ms, the solve 7 ms) and one inside it (ignored); in the trace,
  two expert passes of kernels 1 + 2 ms and 3 ms (a copy beside them left
  out); the program counted 12 pairs over 2 ticks; the family's patch
  logged 3 ticks after the part, 5, 7 and 6 pairs."""
  spans = tracing.Spans()
  for name, ms in (("esac.gate", (9.0, 0.2, 0.4)),
                   ("esac.experts", (9.0, 3.0, 5.0)),
                   ("pose.solve", (9.0, 7.0))):
    for k, m in enumerate(ms):
      spans.events[name].append((T0 + (0.05 if k == 0 else 0.2 + k),
                                 (FakePair(m), None)))
  ranges = [("trace", LO, LO + 100e3), ("esac.experts", LO + 10e3,
                                        LO + 12e3),
            ("esac.experts", LO + 60e3, LO + 62e3)]

  def k(name, start, length, owner, launch):
    return (name, LO + start * 1e3, length * 1e3, owner, 1,
            LO + launch * 1e3)

  ops = [k("conv", 12.0, 1.0, "esac.experts", 11.0),
         k("conv", 13.0, 2.0, "esac.experts", 11.0),
         k("Memcpy HtoD", 11.5, 0.5, "esac.experts", 11.0),
         k("conv", 62.0, 3.0, "esac.experts", 61.0),
         k("gate", 30.0, 1.0, "esac.gate", 30.0)]
  rec = loops.Record("fleet", t0=T0, t1=T0 + 1.1, trace_end=T0 + 0.1)
  rec.trace = tracing.TraceSummary({"ops": ops, "ranges": ranges}, 0.1, [])
  Sp = types.SimpleNamespace
  session = {"spans": [Sp(name="online.tick", start_ns=0, end_ns=1,
                          parent=None) for _ in range(2)],
             "counters": {"esac.expert_runs": 12}}
  spans.pairs = [(T0 + 0.05, 99), (T0 + 0.5, 5), (T0 + 0.6, 7),
                 (T0 + 0.7, 6)]
  fam = types.SimpleNamespace(
      expert_flops=lambda cfg, fs: 70e9, gating_flops=lambda cfg, fs: 1e9)
  return types.SimpleNamespace(
      rec=rec, spans=spans, family=fam, cfg={}, frame_shape=(480, 640, 3),
      batch=4, peaks={"bf16": 1e15}, program_session=session)


def test_the_readers_on_a_synthetic_context():
  ctx = reader_ctx()
  read = lambda name: run.load_reader(name)(ctx)
  with mock.patch.object(torch.cuda, "synchronize", lambda *a: None):
    assert read("esac.gate_device_ms.serve") == pytest.approx(0.3)
    assert read("esac.expert_device_ms.serve") == pytest.approx(4.0)
    assert read("esac.solve_device_ms.serve") == pytest.approx(7.0)
  assert read("esac.expert_runs.serve") == pytest.approx(6.0)
  # 12 pairs of 70 GFLOP at 1e15 FLOP/s over 6 ms of kernels
  assert read("esac.expert_roofline.serve") == pytest.approx(
      100.0 * 12 * 70e9 / 1e15 / 6e-3)
  # 3 ticks of 4 frames' gating and 18 pairs over the 1.0 s after the part
  assert read("esac.mfu.serve") == pytest.approx(
      100.0 * (3 * 4 * 1e9 + 18 * 70e9) / 1.0 / 1e15)


def test_the_readers_read_none_without_their_inputs():
  ctx = reader_ctx()
  ctx.spans = tracing.Spans()
  ctx.program_session = {"spans": [], "counters": {}}
  ctx.family = types.SimpleNamespace()
  ctx.rec.trace = None
  ctx.peaks = None
  for name in NEW:
    assert run.load_reader(name)(ctx) is None, name


def test_the_metrics_are_declared_for_the_cell():
  per_layer = {m["name"]: m for m in BENCH["per_layer"]}
  for name in NEW:
    assert per_layer[name]["workloads"] == [CELL]
    assert per_layer[name]["moves"] == "pose_fps"
  ends = {m["name"]: m for m in BENCH["end_to_end"]}
  for name in ("pose_fps", "pose_ms_p95"):
    assert ends[name]["workloads"][-1] == CELL


class Event:
  """A CUDA event on the CPU: each pair reads 1.5 ms."""

  def __init__(self, **kwargs):
    pass

  def record(self):
    pass

  def elapsed_time(self, other):
    return 1.5


def test_a_tiny_traced_run_reads_the_cpu_readers():
  with mock.patch.object(torch.cuda, "Event", Event), \
      mock.patch.object(torch.cuda, "synchronize", lambda *a: None):
    res, _ = run.run_cell(tiny.cell(CELL), config(), mix(), 2 ** 31 + 17,
                          1.2, True, CPU, limits(), bench=BENCH)
  got = res["metrics"]
  for name in ("esac.gate_device_ms.serve", "esac.expert_device_ms.serve",
               "esac.solve_device_ms.serve"):
    assert got[name]["value"] == 1.5, name
  assert got["esac.expert_runs.serve"]["value"] >= 4.0
  # no card: no peaks, no kernels
  assert "esac.expert_roofline.serve" not in got
  assert "esac.mfu.serve" not in got
  assert res["correct"]
