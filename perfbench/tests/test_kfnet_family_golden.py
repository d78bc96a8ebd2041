"""The KFNet family reads as the harness read before the family contract
existed: values taken from the harness of that time, on the CPU at the
tiny size (``tiny.py``) for each of the four cells, and at the full
640x480 configurations. The weights from a fixed seed and the rendered
pool by hash, every weight leaf included; the parameter count, a frame's
analytic work (a first frame and a later one) and the conv and fused
update bounds at the H100's peaks; and ``compare``, ``failures`` and
``judge`` on the record of one fixed run, whose window closes after a
fixed number of ticks or chunks. All are compared exactly."""

from __future__ import annotations

import hashlib

import pytest
import torch

from perfbench import check, flops, loops, run
from perfbench.families import kfnet as family
from perfbench.tests import tiny
from perfbench.traffic import generator

CPU = torch.device("cpu")
PEAKS = flops.PEAKS["H100 SXM"]
WEIGHT_SEED = 2 ** 31 + 101
RUN_SEED = 2 ** 31 + 202
# the window closes on this call of ``Window.done`` (a tick or a chunk)
CALLS = {"stream": 24, "fleet": 16, "offline": 12}

# the tiny and the full configurations of each config file: weight hash,
# parameter count and full-size count
WEIGHTS = {
    "kfnet-gn-640x480": (
        "79dc9ea11fe774db31c1b6e74c5e2b4a66371437d6a8bfc6f93e6d991d56965f",
        27479, 26670087),
    "kfnet-nonorm-640x480": (
        "b1953515a645d834ddf428204c3741f88f663a6763c96ef56feca0729864784a",
        27383, 26664071),
}
# frame_flops (first, later) and conv_bound_s (first, later), the same for
# both configurations (the trunk's norm does no counted work)
TINY_WORK = ([3379200.0, 3900928.0],
             [3.9622686567164185e-08, 5.112835820895523e-08])
FULL_WORK = ([233545728000.0, 241711104000.0],
             [0.00024582747902388973, 0.0002552463265424144])
# fused_bound_s (tiny, full) by the maps a launch (B)
FUSED = {1: (1.275223880597015e-09, 1.275223880597015e-07),
         4: (5.10089552238806e-09, 5.10089552238806e-07)}
OFFLINE_POOL = \
    "cc67ab88a569e3f6969dba6fbfa1b42f0639ac32c24d25f6c81ad74db85cd1a6"
OFFLINE_SAMPLES = [(0, 0), (0, 1), (0, 24), (0, 28), (0, 49), (0, 59),
                   (0, 74), (1, 0), (1, 1)]

RUNS = {
    "gn-stream1": {
        "pool": "a8dd775ff9c949ef26e6c1b636f8d024"
                "bcaa069f8e38a0a23c295e315aba7f55",
        "record": {"frames": 24, "first_frames": 2, "attempted": 24,
                   "solves": 31, "ticks": 24, "kept": list(range(1, 24)),
                   "firsts": [0, 16], "odd": [], "samples": []},
        "numbers": {"meas_z_rel": 1.933595285663614e-06,
                    "meas_logV_rms": 1.5295720459107542e-06,
                    "step_x_rel": 5.255198630038649e-06,
                    "step_logP_rms": 5.478779257828137e-06,
                    "step_x_med": 3.9029923755151685e-06,
                    "step_logP_med": 2.9169023036956787e-06,
                    "step_x_top1_share": 0.237117737531662,
                    "step_logP_top1_share": 0.3628119230270386,
                    "pose_mismatch": 0.0},
        "checks": ["meas_z_rel", "meas_logV_rms", "step_x_rel",
                   "step_logP_rms", "pose_mismatch"],
    },
    "gn-offline1000": {
        "pool": OFFLINE_POOL,
        "record": {"frames": 105, "first_frames": 2, "attempted": 105,
                   "solves": 0, "ticks": 0, "kept": [], "firsts": [],
                   "odd": [], "samples": OFFLINE_SAMPLES},
        "numbers": {"meas_z_rel": 1.933595285663614e-06,
                    "meas_logV_rms": 1.5295720459107542e-06,
                    "step_x_rel": 3.715371121870703e-06,
                    "step_logP_rms": 4.2231617953802925e-06,
                    "step_x_med": 2.7121682251163293e-06,
                    "step_logP_med": 2.5033950805664062e-06,
                    "step_x_top1_share": 0.16573511064052582,
                    "step_logP_top1_share": 0.20243576169013977},
        "checks": ["meas_z_rel", "meas_logV_rms", "step_x_rel",
                   "step_logP_rms"],
    },
    "nonorm-fleet4": {
        "pool": "fe6666410dc094caba62b1794e9ed690"
                "7dbcfad8c1eb4c9ff0b80fea4b0d5bf1",
        "record": {"frames": 64, "first_frames": 4, "attempted": 64,
                   "solves": 20, "ticks": 16, "kept": list(range(1, 16)),
                   "firsts": [0, 4, 8, 12], "odd": [], "samples": []},
        "numbers": {"meas_z_rel": 0.0, "meas_logV_rms": 0.0,
                    "step_x_rel": 2.1355797343858285e-06,
                    "step_logP_rms": 1.0067857374451705e-06,
                    "step_x_med": 3.06983167774888e-07,
                    "step_logP_med": 2.682209014892578e-07,
                    "step_x_top1_share": 0.509003221988678,
                    "step_logP_top1_share": 0.473025918006897,
                    "pose_mismatch": 0.0},
        "checks": ["meas_logV_rms", "step_x_med", "step_logP_med",
                   "pose_mismatch"],
    },
    "nonorm-offline1000": {
        "pool": OFFLINE_POOL,
        "record": {"frames": 105, "first_frames": 2, "attempted": 105,
                   "solves": 0, "ticks": 0, "kept": [], "firsts": [],
                   "odd": [], "samples": OFFLINE_SAMPLES},
        "numbers": {"meas_z_rel": 0.0, "meas_logV_rms": 0.0,
                    "step_x_rel": 1.0087725286211935e-06,
                    "step_logP_rms": 6.530289056172478e-07,
                    "step_x_med": 2.7256092494098993e-07,
                    "step_logP_med": 2.3096799850463867e-07,
                    "step_x_top1_share": 0.41256558895111084,
                    "step_logP_top1_share": 0.367256760597229},
        "checks": ["meas_logV_rms", "step_x_med", "step_logP_med"],
    },
}
CELLS = list(RUNS)
BENCH = run.load_benchmark(tiny.ROOT)


def digest(tensors) -> str:
  """sha256 of each tensor's shape, type and bytes, in order."""
  h = hashlib.sha256()
  for t in tensors:
    t = t.detach().contiguous().cpu()
    h.update(str((tuple(t.shape), str(t.dtype))).encode())
    h.update(t.numpy().tobytes())
  return h.hexdigest()


def leaves(tree):
  """Every leaf, a dict's in the order of its sorted keys."""
  if isinstance(tree, dict):
    return [x for k in sorted(tree) for x in leaves(tree[k])]
  if isinstance(tree, list):
    return [x for v in tree for x in leaves(v)]
  return [tree]


@pytest.mark.parametrize("cell", CELLS)
def test_weights_work_and_pool(cell):
  cfg, mix = tiny.config(cell), tiny.mix(cell)
  name = tiny.cell(cell)["config"]
  full = run.load_config(BENCH, name)
  weights, count, full_count = WEIGHTS[name]
  fs = tuple(cfg["frame"])
  assert digest(leaves(family.make_weights(cfg, WEIGHT_SEED, CPU))) == \
      weights
  assert (family.count(cfg), family.count(full)) == (count, full_count)
  for c, shape, (work, bound) in ((cfg, fs, TINY_WORK),
                                  (full, (480, 640), FULL_WORK)):
    assert [family.frame_flops(c, shape, first=True),
            family.frame_flops(c, shape)] == work
    assert [family.conv_bound_s(c, shape, PEAKS, first=True),
            family.conv_bound_s(c, shape, PEAKS)] == bound
  assert (family.fused_bound_s(cfg, fs, PEAKS, maps=mix["cameras"]),
          family.fused_bound_s(full, (480, 640), PEAKS,
                               maps=mix["cameras"])) == FUSED[mix["cameras"]]
  assert family.frame_flops(full, (480, 640)) == pytest.approx(241.7e9,
                                                               rel=1e-3)
  pool = generator.frames(mix, RUN_SEED, fs, CPU)
  assert digest([pool]) == RUNS[cell]["pool"]


@pytest.mark.parametrize("cell", CELLS)
def test_the_check_of_a_fixed_run(monkeypatch, cell):
  mix = tiny.mix(cell)
  real_done = loops.Window.done
  calls = [0]

  def done(self, drain=None):
    real_done(self, drain)
    calls[0] += 1
    return calls[0] >= CALLS[mix["mode"]]

  monkeypatch.setattr(loops.Window, "done", done)
  seen = {}
  real_compare = family.compare

  def compare(cfg, mix, params, pool, rec, seed, device):
    seen["rec"] = rec
    return real_compare(cfg, mix, params, pool, rec, seed, device)

  monkeypatch.setattr(family, "compare", compare)
  limits = tiny.limits(cell)
  res, _ = run.run_cell(tiny.cell(cell), tiny.config(cell), mix, RUN_SEED,
                        1.0, False, CPU, limits)
  rec, want = seen["rec"], RUNS[cell]
  assert {"frames": rec.frames, "first_frames": rec.first_frames,
          "attempted": rec.attempted, "solves": rec.solves,
          "ticks": len(rec.ticks), "kept": sorted(rec.kept),
          "firsts": sorted(rec.firsts), "odd": sorted(rec.odd),
          "samples": sorted(rec.samples)} == want["record"]
  assert res["numbers"] == want["numbers"]
  assert family.failures(tiny.config(cell), mix, rec, RUN_SEED, CPU) == (0,
                                                                       0)
  assert res["failed"] == 0 and res["correct"]
  assert list(res["checks"]) == want["checks"]
  assert res["checks"] == {n: {"value": want["numbers"][n],
                               "limit": limits[n]["limit"]}
                           for n in want["checks"]}
  assert check.judge(res["numbers"], limits, family.NUMBERS) == (
      True, res["checks"])
