"""The port's remaining study tools on the CPU against the JAX package's:
generate_labels (7-Scenes and Cambridge fixtures: the labels and
stats.json), visualize (the PNGs, decoded, pixel for pixel), norm_study
and conv_study (the rows' and report's keys; fps finite), the three
summaries (string for string on the JSON the port's tools write and on
the repository's own docs/ artifacts), profile_filter (a capture on the
CPU, which has no kernels to attribute, and the report of a trace of
kernels), profile_tick (the report's fields), and every device tool's
refusal to run without a card unless --device cpu is given. The port's
tools run the flagship nets, as the JAX tools do: at 48x64 where the
size is a flag, the speed timing on a 48x64 crop in norm_study.

Tolerances: labels within 1e-5 (tests/test_native_io.py:61), valid masks
equal; stats.json's floats within rtol 1e-6, its other fields equal;
everything else exactly. The JAX tools' speed runs (full-width nets at
640x480) are patched out where only their keys are compared. The MFU is
null on the CPU: the port computes none against a peak that is not a
card's (eval/flops.peak_flops).
"""

import functools
import glob
import json
import os
import unittest.mock as mock

import numpy as np
import pytest
import torch
from PIL import Image

from kfnet_tpu.eval import benchmark as jbenchmark
from kfnet_tpu.models import kfnet as jkfnet
from kfnet_tpu.tools import calib_summary as jcalib_summary
from kfnet_tpu.tools import conv_study as jconv_study
from kfnet_tpu.tools import diagnose_summary as jdiagnose_summary
from kfnet_tpu.tools import generate_labels as jgenerate_labels
from kfnet_tpu.tools import norm_study as jnorm_study
from kfnet_tpu.tools import norm_summary as jnorm_summary
from kfnet_tpu.tools import profile_tick as jprofile_tick
from kfnet_tpu.tools import visualize as jvisualize
from kfnet_tpu_torch.data import image_io, labels
from kfnet_tpu_torch.eval import benchmark
from kfnet_tpu_torch.tools import (calib_summary, calibrate, conv_study,
                                   diagnose, diagnose_summary,
                                   generate_labels, norm_study, norm_summary,
                                   prepare_cache, profile_filter,
                                   profile_tick, protocol, visualize)
from tests.test_data import make_fake_7scenes

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DOCS = os.path.join(ROOT, "docs")
MINI = ["--height", "96", "--width", "128", "--train_frames", "6"]
STAGES = dict(H=96, W=128, train_frames=6, sc_steps=1, of_steps=1,
              joint_steps=1)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


# ---- generate_labels -------------------------------------------------------

def _cambridge_fixture(root):
  scene = os.path.join(root, "KingsCollege")
  os.makedirs(os.path.join(scene, "seq1"))
  with open(os.path.join(scene, "dataset_train.txt"), "w") as f:
    f.write("Visual Landmark Dataset\n"
            "ImageFile, Camera Position [X Y Z W P Q R]\n\n"
            "seq1/frame00001.png 0.0 0.0 0.0 1.0 0.0 0.0 0.0\n")
  rng = np.random.default_rng(0)
  image_io.write_png(os.path.join(scene, "seq1", "frame00001.png"),
                     rng.integers(0, 255, (54, 96, 3), dtype=np.uint8))
  image_io.write_png(os.path.join(scene, "seq1", "frame00001.depth.png"),
                     rng.integers(3000, 60000, (54, 96)).astype(np.uint16))


@pytest.mark.parametrize("dataset", ["7scenes", "cambridge"])
def test_generate_labels_equal_jax(tmp_path, dataset):
  root = str(tmp_path / "data")
  if dataset == "7scenes":
    make_fake_7scenes(root)
    scene, seq = "chess", "seq-01"
  else:
    _cambridge_fixture(root)
    scene, seq = "KingsCollege", "seq1"
  outs = {}
  for name, main, extra in (("jax", jgenerate_labels.main, []),
                            ("port", generate_labels.main,
                             ["--device", "cpu"])):
    outs[name] = str(tmp_path / name)
    main(["--input_folder", root, "--output_folder", outs[name],
          "--dataset", dataset, "--scene", scene, "--split", "train",
          *extra])
  stats = {}
  for name, d in outs.items():
    with open(os.path.join(d, "stats.json")) as f:
      stats[name] = json.load(f)
  assert list(stats["port"]) == list(stats["jax"])
  for k, want in stats["jax"].items():
    if k in ("coord_mean", "coord_std"):
      np.testing.assert_allclose(stats["port"][k], want, rtol=1e-6)
    else:
      assert stats["port"][k] == want, k
  files = sorted(glob.glob(os.path.join(outs["jax"], seq, "*.npz")))
  assert files and [os.path.basename(f) for f in sorted(glob.glob(
      os.path.join(outs["port"], seq, "*.npz")))] == [
          os.path.basename(f) for f in files]
  for f in files:
    wc, wv = labels.load(f)
    gc, gv = labels.load(os.path.join(outs["port"], seq,
                                      os.path.basename(f)))
    assert np.array_equal(gv, wv) and gv.any()
    np.testing.assert_allclose(gc[gv], wc[wv], atol=1e-5)


# ---- visualize -------------------------------------------------------------

def test_visualize_pngs_equal_jax(tmp_path):
  rng = np.random.default_rng(0)
  dump, gt_dir = tmp_path / "dump", tmp_path / "gt"
  dump.mkdir()
  gt_dir.mkdir()
  for i in range(2):
    coords = rng.normal(size=(6, 8, 3)).astype(np.float32)
    cov = rng.uniform(0.01, 1.0, (6, 8, 1)).astype(np.float32)
    np.savez(dump / f"frame-{i:06d}.npz", coords=coords, covariance=cov,
             pose=np.eye(4))
    np.savez(gt_dir / f"frame-{i:06d}.npz", coords=coords * 1.01)
  for name, main in (("jax", jvisualize.main), ("port", visualize.main)):
    main(["--dump_dir", str(dump), "--out_dir", str(tmp_path / name),
          "--gt_labels", str(gt_dir)])
  want = sorted(os.listdir(tmp_path / "jax"))
  assert sorted(os.listdir(tmp_path / "port")) == want and len(want) == 6
  for f in want:
    a = np.asarray(Image.open(tmp_path / "port" / f))
    b = np.asarray(Image.open(tmp_path / "jax" / f))
    assert a.shape == b.shape == (6 * 8, 8 * 8, 3), f
    assert np.array_equal(a, b), f


def test_colorize_handles_constant_input():
  img = visualize._colorize(np.zeros((4, 4)))
  assert img.shape == (4, 4, 3) and img.dtype == np.uint8
  assert np.array_equal(img, jvisualize._colorize(np.zeros((4, 4))))


# ---- the study runs: one tiny cache pair, the tools over it ----------------

@pytest.fixture(scope="module")
def study(tmp_path_factory):
  """A group cache (sceneA) and a norm="none" cache with its stage 2, the
  port's calibrate, diagnose and norm_study reports over them."""
  root = tmp_path_factory.mktemp("study")
  gn, nonorm = str(root / "gn"), str(root / "nonorm")
  prepare_cache.main(["--work_dir", gn, "--scenes", "sceneA", "--sc_steps",
                      "1", "--of_steps", "1", "--joint_steps", "1", *MINI,
                      "--device", "cpu"])
  prepare_cache.main(["--work_dir", nonorm, "--scenes", "sceneA",
                      "--scoordnet_norm", "none", "--copy_stage2_from", gn,
                      "--sc_steps", "1", "--of_steps", "1", "--joint_steps",
                      "1", *MINI, "--device", "cpu"])
  reports = {k: str(root / f"{k}.json")
             for k in ("calib", "calib_stress", "diag_gn", "diag_none",
                       "norm")}
  test = ["--test_frames", "6"]
  calibrate.main(["--work_dir", gn, *MINI, *test, "--scenes", "sceneA",
                  "--chi2_grid", "2.37,7.81", "--w_grid", "1,8",
                  "--report", reports["calib"], "--device", "cpu"])
  calibrate.main(["--work_dir", gn, *MINI, *test, "--scenes", "sceneA",
                  "--chi2_grid", "2.37", "--w_grid", "8", "--stress", "0.05",
                  "--smooth_grid", "0,0.4", "--report",
                  reports["calib_stress"], "--device", "cpu"])
  for key, d, norm in (("diag_gn", gn, None), ("diag_none", nonorm, "none")):
    diagnose.main(["--work_dir", d, *MINI, *test, "--scene", "sceneA",
                   "--modes", "measurement_only,filtered_serving",
                   "--report", reports[key], "--device", "cpu"]
                  + (["--scoordnet_norm", norm] if norm else []))
  # the speed cells' timing protocol on the frames' top-left 48x64 (the
  # flagship at 640x480 is too slow for the CPU)
  def bench_fps(cfg, params, images):
    return benchmark.filter_fps(cfg, params, images[:, :48, :64])

  with mock.patch.object(norm_study, "STAGES", STAGES), \
      mock.patch.object(norm_study, "bench_fps", bench_fps):
    out = norm_study.main(["--gn_dir", gn, "--nonorm_dir", nonorm,
                           "--test_frames", "6", "--bench_frames", "3",
                           "--report", reports["norm"], "--device", "cpu"])
  return {"gn": gn, "nonorm": nonorm, "reports": reports, "norm": out}


def test_norm_study_keys_equal_jax(study):
  """JAX's main with its speed runs, loads and evals stubbed: the report's
  keys and the perf rows' keys are the port's."""
  def load(work_dir, scene, test_frames, offset, norm, seed_offset=0):
    cfg = jnorm_study.kfnet_config_for(norm, False)
    return cfg, None, None

  errs = {k: np.ones(6) for k in ("t_meas", "r_meas", "t_filt", "r_filt")}
  report = dict.fromkeys(study["norm"]["group_report"], 0.0)
  with mock.patch.object(jbenchmark, "aot_filter_fps",
                         lambda *a, **k: (10.0, None)), \
      mock.patch.object(jnorm_study, "init_for", lambda cfg: None), \
      mock.patch.object(jnorm_study, "_load", load), \
      mock.patch.object(jnorm_study, "_eval_one",
                        lambda *a, **k: {"errors": errs, "report": report}):
    want = jnorm_study.main(["--test_frames", "6", "--bench_frames", "1"])
  got = study["norm"]
  assert list(got) == list(want)
  assert list(got["perf"]) == list(want["perf"])
  for norm in ("group", "none"):
    assert list(got["perf"][norm]) == list(want["perf"][norm])
    assert np.isfinite(got["perf"][norm]["fps"]) and got["perf"][norm][
        "fps"] > 0
    assert got["perf"][norm]["mfu"] is None  # no peak for the CPU
  assert list(got["paired"]) == list(want["paired"])
  for k in got["paired"]:
    assert list(got["paired"][k]) == list(want["paired"][k])
  assert np.isfinite(got["group_report"]["median_translation_filt_m"])


def test_conv_study_rows_equal_jax():
  argv = ["--frames", "2", "--height", "48", "--width", "64", "--norms",
          "group,none", "--impls", "xla,pallas_3x3,pallas_fused"]
  got = conv_study.main(argv + ["--device", "cpu"])
  with mock.patch.object(jbenchmark, "aot_filter_fps",
                         lambda *a, **k: (10.0, None)), \
      mock.patch.object(jkfnet, "init", lambda *a, **k: None):
    want = jconv_study.main(argv)
  assert list(got) == list(want)
  assert [(r["norm"], r["conv_impl"]) for r in got["rows"]] == [
      (r["norm"], r["conv_impl"]) for r in want["rows"]]
  for g, w in zip(got["rows"], want["rows"]):
    assert list(g) == list(w)
    assert np.isfinite(g["fps"]) and g["fps"] > 0 and g["mfu"] is None
  assert got["backend"] == "cpu"


# ---- the summaries, string for string -------------------------------------

def _both(capsys, jmain, tmain, argv):
  want = jmain(argv)
  want_out = capsys.readouterr().out
  got = tmain(argv)
  got_out = capsys.readouterr().out
  return got, got_out, want, want_out


def test_calib_summary_equals_jax(study, capsys, tmp_path):
  r = study["reports"]
  cases = [
      [r["calib"], r["calib_stress"]],
      [r["calib"], r["calib_stress"], "--markdown", "--point",
       "chi2=2.37,w=8"],
      sorted(glob.glob(os.path.join(DOCS, "CALIBRATION_SWEEP_*.json"))),
      sorted(glob.glob(os.path.join(DOCS, "CALIBRATION_SMOOTH_S*.json")))
      + ["--markdown", "--point", "chi2=2.37,w=16"],
  ]
  for i, argv in enumerate(cases):
    argv = argv + ["--report", str(tmp_path / f"r{i}.json")]
    got, got_out, want, want_out = _both(capsys, jcalib_summary.main,
                                         calib_summary.main, argv)
    assert got_out == want_out, argv
    assert json.dumps(got) == json.dumps(want)


def test_norm_summary_equals_jax(study, capsys):
  ws = sorted(glob.glob(os.path.join(DOCS, "NORM_STUDY_WS*.json")))
  plain = sorted(p for p in glob.glob(os.path.join(DOCS, "NORM_STUDY*.json"))
                 if "_WS" not in p)
  for argv in ([study["reports"]["norm"]],
               [study["reports"]["norm"], "--markdown"], plain,
               ws + ["--markdown"], plain + ws + ["--three_way"]):
    _, got_out, _, want_out = _both(capsys, jnorm_summary.main,
                                    norm_summary.main, argv)
    assert got_out == want_out and got_out, argv
  assert norm_summary.SCENE_SCALE == jnorm_summary.SCENE_SCALE


def test_diagnose_summary_equals_jax(study, capsys):
  r = study["reports"]
  pairs = [f"tiny:{r['diag_gn']}:{r['diag_none']}"]
  docs = [f"outdoor_s1:{DOCS}/DIAGNOSE_outdoor_s1.json:"
          f"{DOCS}/DIAGNOSE_outdoor_nonorm_s1.json",
          f"heldout_s2:{DOCS}/DIAGNOSE_heldout_s2.json:"
          f"{DOCS}/DIAGNOSE_heldout_nonorm_s2.json"]
  for argv in (["--pairs", *pairs], ["--pairs", *pairs, "--markdown",
                                     "--mode", "filtered_serving"],
               ["--pairs", *docs], ["--pairs", *docs, "--markdown"]):
    got, got_out, want, want_out = _both(capsys, jdiagnose_summary.main,
                                         diagnose_summary.main, argv)
    assert got_out == want_out and got == want, argv


# ---- the profilers ---------------------------------------------------------

def test_profile_filter_captures_on_cpu_and_refuses_no_kernels(tmp_path):
  """The capture runs on the CPU (the flagship at 48x64); its trace holds
  the CPU's operators and no kernel, so the summary refuses it."""
  trace = str(tmp_path / "trace")
  about = profile_filter.capture_trace(trace, frames=2, height=48, width=64,
                                       device="cpu")
  assert about == {"device": "cpu", "height": 48, "width": 64, "frames": 2,
                   "use_fused_kernel": True, "runs": profile_filter.RUNS,
                   "wall_ms_per_run": about["wall_ms_per_run"]}
  assert about["wall_ms_per_run"] > 0
  with open(os.path.join(trace, profile_filter.TRACE_FILE)) as f:
    cats = {e.get("cat") for e in json.load(f)["traceEvents"]}
  assert "cpu_op" in cats and "kernel" not in cats
  with pytest.raises(ValueError, match="no kernels"):
    profile_filter.summarize_trace(trace)


def _kernel_trace(path, runs):
  """A chrome trace of ``runs`` runs, each of four kernels with gaps, and a
  CPU operator that the summary must not read."""
  events, t = [], 100.0
  for _ in range(runs):
    for name, dur, gap in (
        ("sm90_xmma_fprop_implicit_gemm_bf16", 20.0, 2.0),
        ("void conv3x3_wgmma<2>(CUtensorMap)", 10.0, 1.0),
        ("fused_filter_kernel", 5.0, 3.0),
        ("elementwise_kernel", 15.0, 4.0)):
      events.append({"ph": "X", "cat": "kernel", "name": name, "ts": t,
                     "dur": dur})
      t += dur + gap
  events.append({"ph": "X", "cat": "cpu_op", "name": "aten::conv2d",
                 "ts": 0.0, "dur": 1e6})
  with open(path, "w") as f:
    json.dump({"traceEvents": events}, f)
  return t - 4.0 - 100.0  # first kernel's start to last kernel's end


def test_profile_filter_report_from_kernels(tmp_path):
  trace = tmp_path / "trace"
  trace.mkdir()
  runs = profile_filter.RUNS
  span = _kernel_trace(str(trace / profile_filter.TRACE_FILE), runs)
  report = str(tmp_path / "pf.json")
  out = profile_filter.main(["--parse_only", "--trace_dir", str(trace),
                             "--report", report, "--top_k", "3"])
  assert out["n_ops"] == 4 and len(out["ops"]) == 3
  assert [o["name"] for o in out["ops"]] == [
      "sm90_xmma_fprop_implicit_gemm_bf16", "elementwise_kernel",
      "void conv3x3_wgmma<2>(CUtensorMap)"]
  assert out["ops"][0]["count_per_run"] == 1.0
  assert out["ops"][0]["share"] == pytest.approx(0.4)
  assert out["self_ms_per_run"] == pytest.approx(0.05)
  assert out["conv_class_share"] == pytest.approx(0.6)
  assert out["conv_class_ms_per_run"] == pytest.approx(0.03)
  assert out["other_ms_per_run"] == pytest.approx(0.02)
  assert out["device_busy_ms_per_run"] == pytest.approx(0.05)
  assert out["idle_fraction"] == pytest.approx(1.0 - 50.0 * runs / span)
  assert out["own_kernels_per_run"]["fused_filter_kernel"] == 1.0
  assert out["own_kernels_per_run"]["conv3x3_wgmma"] == 1.0
  with open(report) as f:
    assert json.load(f) == json.loads(json.dumps(out, default=str))


def test_profile_tick_report_keys_equal_jax():
  # one tick a chain (16 on the card): the CPU runs the flagship's ticks
  measure = functools.partial(profile_tick.measure_fleet, chain_n=1)
  with mock.patch.object(profile_tick, "measure_fleet", measure):
    got = profile_tick.main(["--height", "48", "--width", "64", "--device",
                             "cpu"])
  with mock.patch.object(jprofile_tick, "roundtrip_floor_ms",
                         lambda *a: 1.0), \
      mock.patch.object(jprofile_tick, "measure_fleet",
                        lambda *a, **k: (3.0, 2.0)), \
      mock.patch.object(jkfnet, "init", lambda *a, **k: None):
    want = jprofile_tick.main(["--height", "48", "--width", "64"])
  assert list(got) == list(want)
  for k in ("compute_ms", "roundtrip_floor_ms", "tick_ms",
            "dispatch_residual_ms", "compute_ms_no_pose"):
    assert np.isfinite(got[k]), k
  assert got["batch"] == 4 and got["backend"] == "cpu"


# ---- no card, no --device cpu: every device tool refuses ------------------

NO_CARD = {
    "protocol": (protocol.main, ["--fast"]),
    "prepare_cache": (prepare_cache.main, ["--work_dir", "w"]),
    "calibrate": (calibrate.main, ["--work_dir", "w"]),
    "diagnose": (diagnose.main, ["--work_dir", "w"]),
    "generate_labels": (generate_labels.main, ["--input_folder", "i",
                                               "--output_folder", "o"]),
    "norm_study": (norm_study.main, []),
    "conv_study": (conv_study.main, []),
    "profile_filter": (profile_filter.main, []),
    "profile_tick": (profile_tick.main, []),
}


@pytest.mark.parametrize("tool", sorted(NO_CARD))
def test_raises_without_a_card(tool, tmp_path, monkeypatch):
  monkeypatch.chdir(tmp_path)
  main, argv = NO_CARD[tool]
  with mock.patch.object(torch.cuda, "is_available", lambda: False):
    with pytest.raises(RuntimeError, match="CUDA device"):
      main(argv)
  assert os.listdir(tmp_path) == []  # and nothing was written
