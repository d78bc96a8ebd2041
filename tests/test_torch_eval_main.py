"""The port's evaluation CLI (kfnet_tpu_torch/eval/main.py) on the CPU over
fake on-disk 7-Scenes scenes: the six cases of tests/test_eval_main.py
(batch with report and dump, streaming, uint8 streaming (at the JAX
uint8 test's tolerance: the device ingest's * 1/255 is not the loaders'
n/255 in the last place), the χ² override,
--kfnet_ckpt's serving meta with the explicit flag winning, pose
smoothing), the JAX and port CLIs on the same tree with the same tiny
weights (the dumped coords and covariance within the goldens' rtol 5e-4 /
atol 5e-5), and the committed full-size bf16 flagship read through
--kfnet_ckpt: the config and weights pretrained.load gives, and the
CLI's maps equal to evaluate_sequence's on the same loaded frames.

The tiny weights are the JAX package's init, carried across by convert;
the port's CLI runs the fused update's plain version on the CPU.
"""

import json
import os

import jax
import numpy as np
import pytest
import torch

from kfnet_tpu.eval import main as jeval_main
from kfnet_tpu.models import kfnet as jkfnet
from kfnet_tpu_torch import convert, pretrained
from kfnet_tpu_torch.data import seven_scenes as ts7
from kfnet_tpu_torch.eval import eval_sequence as teval
from kfnet_tpu_torch.eval import main as eval_main
from kfnet_tpu_torch.models import kfnet as tkfnet
from kfnet_tpu_torch.nn import layers as L
from kfnet_tpu_torch.utils import checkpoint as tckpt
from tests import tiny_configs as tc
from tests.test_data import make_fake_7scenes
from tests.test_torch_models import port_config

GOLDEN = dict(rtol=5e-4, atol=5e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
  """Small tensors on one thread (the suite runs in several processes)."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny():
  jcfg = tc.tiny_kfnet()
  jparams = jkfnet.init(jax.random.key(0), jcfg, tc.IMG)
  tparams = convert.params_from_jax(
      jax.tree_util.tree_map(np.asarray, jparams))
  return jcfg, jparams, port_config(jcfg), tparams


@pytest.fixture
def tiny_load(tiny, monkeypatch):
  """The CLI's weights swapped for the tiny net (the flags select dataset
  and scene; the test swaps in the tiny architecture)."""
  _, _, tcfg, tparams = tiny

  def load(exp, image_shape, sc, of, seed=0, device=None):
    return tcfg, tparams

  monkeypatch.setattr(eval_main, "load_pretrained", load)


def common(root, *extra):
  return ["--input_folder", root, "--scene", "chess", "--device", "cpu",
          *extra]


def test_eval_main_cli(tmp_path, tiny_load):
  root = make_fake_7scenes(str(tmp_path / "data"), n=4)
  report_path = str(tmp_path / "report.json")
  dump_dir = str(tmp_path / "dump")
  reports = eval_main.main(common(root, "--report", report_path,
                                  "--dump_dir", dump_dir))
  assert len(reports) == 1
  rep = reports[0]
  assert rep["frames"] == 4
  assert np.isfinite(rep["median_translation_m"])
  assert "median_coord_err_m" in rep  # depth present: accuracy stats
  with open(report_path) as f:
    saved = json.load(f)
  assert saved["scenes"][0]["scene"] == "chess/seq-01"
  d = np.load(os.path.join(dump_dir, "seq-01", "frame-000002.npz"))
  assert d["coords"].shape == (6, 8, 3)
  assert d["covariance"].shape == (6, 8, 1)
  assert d["pose"].shape == (4, 4)
  with open(os.path.join(dump_dir, "meta.json")) as f:
    meta = json.load(f)
  assert meta["stride"] == 8 and meta["dataset"] == "7scenes"
  # a dump directory of another scene's meta is refused before any run
  meta["scene"] = "fire"
  with open(os.path.join(dump_dir, "meta.json"), "w") as f:
    json.dump(meta, f)
  with pytest.raises(ValueError, match="already holds a dump"):
    eval_main.main(common(root, "--dump_dir", dump_dir))


def test_eval_main_cli_streaming(tmp_path, tiny_load):
  """--streaming with a chunk below the sequence's length (the resumed
  carry runs) agrees with the batch eval."""
  root = make_fake_7scenes(str(tmp_path / "data"), n=6)
  rep_s = eval_main.main(common(root, "--streaming", "--chunk_size", "2"))[0]
  rep_b = eval_main.main(common(root))[0]
  assert rep_s["frames"] == 6
  np.testing.assert_allclose(rep_s["median_coord_err_m"],
                             rep_b["median_coord_err_m"], atol=1e-4)


def test_eval_main_cli_streaming_uint8(tmp_path, tiny_load):
  """--uint8_stream: uint8 frames go up and are cast on the device. The
  re-quantization of the loaders' n/255 is lossless, but the device's
  ingest multiplies by 1/255 (the JAX package's arithmetic,
  models/scoordnet.ingest), which differs from n/255 in the last place
  for some n; so the dumped maps equal the float streaming run's within
  tests/test_uint8_ingest.py's tolerance, not bit for bit."""
  root = make_fake_7scenes(str(tmp_path / "data"), n=6)
  frames = [ts7.load_frame(f)["image"]
            for f in ts7.load_split(root, "chess", "test").frames]
  for f in frames:
    q = np.round(f * 255.0)
    np.testing.assert_array_equal(q.astype(np.float32) / 255.0, f)
  base = common(root, "--streaming", "--chunk_size", "2")
  rep_u = eval_main.main(base + ["--uint8_stream", "--dump_dir",
                                 str(tmp_path / "u8")])[0]
  eval_main.main(base + ["--dump_dir", str(tmp_path / "f32")])
  rep_b = eval_main.main(common(root))[0]
  assert rep_u["frames"] == 6
  np.testing.assert_allclose(rep_u["median_coord_err_m"],
                             rep_b["median_coord_err_m"], atol=1e-4)
  for t in range(6):
    a = np.load(tmp_path / "u8" / "seq-01" / f"frame-{t:06d}.npz")
    b = np.load(tmp_path / "f32" / "seq-01" / f"frame-{t:06d}.npz")
    np.testing.assert_allclose(a["coords"], b["coords"], rtol=1e-5,
                               atol=2e-5)
    np.testing.assert_allclose(a["covariance"], b["covariance"], rtol=1e-5,
                               atol=2e-5)
  with pytest.raises(SystemExit):
    eval_main.main(common(root, "--uint8_stream"))  # needs --streaming


def test_eval_main_cli_chi2_override(tmp_path, tiny_load, monkeypatch):
  root = make_fake_7scenes(str(tmp_path / "data"), n=3)
  captured = {}
  orig = eval_main.eval_sequence.evaluate_sequence

  def spy(params, cfg, *a, **kw):
    captured["threshold"] = cfg.chi2_threshold
    return orig(params, cfg, *a, **kw)

  monkeypatch.setattr(eval_main.eval_sequence, "evaluate_sequence", spy)
  eval_main.main(common(root, "--chi2_threshold", "11.34"))
  assert captured["threshold"] == 11.34


def test_eval_main_kfnet_ckpt_serving_meta(tmp_path, monkeypatch):
  """--kfnet_ckpt applies the export meta's serving point
  (serving_w_scale / serving_chi2_threshold) as pretrained.load does;
  explicit flags still win."""
  root = make_fake_7scenes(str(tmp_path / "data"), n=3)
  cfg = tkfnet.KFNetConfig(scoordnet=tc.tiny_scoordnet(),
                           oflownet=tc.tiny_oflownet())
  cfg = port_config(cfg)
  params = tkfnet.init(0, cfg, tc.IMG, "cpu")
  ckpt_dir = str(tmp_path / "kf_export")
  tckpt.export_params(ckpt_dir, params,
                      meta={"serving_w_scale": 2.0,
                            "serving_chi2_threshold": 2.37})
  captured = {}
  orig = eval_main.eval_sequence.evaluate_sequence

  def spy(params, cfg, *a, **kw):
    captured["w"] = cfg.w_scale
    captured["chi2"] = cfg.chi2_threshold
    captured["params"] = params
    return orig(params, cfg, *a, **kw)

  monkeypatch.setattr(eval_main.eval_sequence, "evaluate_sequence", spy)
  base = common(root, "--net_scale", "tiny", "--kfnet_ckpt", ckpt_dir)
  eval_main.main(base)
  assert (captured["w"], captured["chi2"]) == (2.0, 2.37)
  for a, b in zip(L.tree_leaves(captured["params"]), L.tree_leaves(params)):
    assert torch.equal(a, b)
  eval_main.main(base + ["--w_scale", "5"])  # the explicit flag wins
  assert (captured["w"], captured["chi2"]) == (5.0, 2.37)
  with pytest.raises(ValueError, match="replaces"):
    eval_main.main(base + ["--scoordnet_ckpt", ckpt_dir])


def test_eval_main_cli_pose_smoothing(tmp_path, tiny_load):
  """--pose_smooth_beta: the report is recomputed from the smoothed
  trajectory (and labelled), and the dumped poses are the smoothed ones."""
  root = make_fake_7scenes(str(tmp_path / "data"), n=4)
  dump_raw, dump_sm = str(tmp_path / "dump_raw"), str(tmp_path / "dump_sm")
  raw = eval_main.main(common(root, "--dump_dir", dump_raw))
  # tiny-net poses are near random, so the relock gate would trip on every
  # frame: a huge gate makes the smoother engage, to test the CLI's part
  sm = eval_main.main(common(root, "--dump_dir", dump_sm,
                             "--pose_smooth_beta", "0.4",
                             "--pose_smooth_gate_factor", "1e9",
                             "--pose_smooth_rot_gate_deg", "1e9"))
  assert sm[0]["pose_smooth_beta"] == 0.4
  assert "pose_smooth_beta" not in raw[0]
  assert np.isfinite(sm[0]["median_translation_m"])
  assert sm[0]["frames"] == raw[0]["frames"] == 4
  assert "median_coord_err_m" in sm[0]
  p_raw = np.load(os.path.join(dump_raw, "seq-01", "frame-000002.npz"))
  p_sm = np.load(os.path.join(dump_sm, "seq-01", "frame-000002.npz"))
  np.testing.assert_array_equal(p_raw["coords"], p_sm["coords"])
  assert not np.allclose(p_raw["pose"], p_sm["pose"])


def test_eval_main_measurement_only_and_profile(tmp_path, tiny_load):
  root = make_fake_7scenes(str(tmp_path / "data"), n=3)
  prof = tmp_path / "prof"
  rep = eval_main.main(common(root, "--measurement_only", "--chunk_size",
                              "2", "--profile_dir", str(prof)))[0]
  assert rep["frames"] == 3 and np.isfinite(rep["median_translation_m"])
  with open(prof / "trace.json") as f:
    assert json.load(f)["traceEvents"]


def test_eval_main_jax_and_port_clis_agree(tmp_path, tiny, tiny_load,
                                           monkeypatch):
  """The JAX package's CLI and the port's on the same fixture tree with the
  same tiny weights: every dumped frame's coords and covariance within the
  goldens' tolerance, poses_gt equal, the same report keys."""
  jcfg, jparams, _, _ = tiny

  def jload(exp, image_shape, sc, of, seed=0):
    return jcfg, jparams

  monkeypatch.setattr(jeval_main, "load_pretrained", jload)
  root = make_fake_7scenes(str(tmp_path / "data"), n=5)
  jrep = jeval_main.main(["--input_folder", root, "--scene", "chess",
                          "--dump_dir", str(tmp_path / "jax")])
  trep = eval_main.main(common(root, "--dump_dir", str(tmp_path / "port")))
  assert sorted(jrep[0]) == sorted(trep[0])
  with open(tmp_path / "jax" / "meta.json") as f:
    jmeta = json.load(f)
  with open(tmp_path / "port" / "meta.json") as f:
    assert json.load(f) == jmeta
  for t in range(5):
    j = np.load(tmp_path / "jax" / "seq-01" / f"frame-{t:06d}.npz")
    p = np.load(tmp_path / "port" / "seq-01" / f"frame-{t:06d}.npz")
    np.testing.assert_allclose(p["coords"], j["coords"], **GOLDEN)
    np.testing.assert_allclose(p["covariance"], j["covariance"], **GOLDEN)
    np.testing.assert_array_equal(p["pose_gt"], j["pose_gt"])


def test_eval_main_reads_the_committed_flagship(tmp_path, monkeypatch):
  """--kfnet_ckpt of the committed full-size bf16 release (the JAX
  package's orbax export under artifacts/pretrained_full): the meta's
  coordinate normalisation and trunk norm, the config and float32 weights
  pretrained.load(FULL_ASSETS) gives; the CLI's dumped maps equal
  evaluate_sequence's with those weights on the same loaded frames."""
  flagship = os.path.join(pretrained.FULL_ASSETS, "stage3_sceneA")
  root = make_fake_7scenes(str(tmp_path / "data"), n=3)
  seen = {}
  orig = eval_main.eval_sequence.evaluate_sequence

  def spy(params, cfg, *a, **kw):
    seen["cfg"], seen["params"] = cfg, params
    return orig(params, cfg, *a, **kw)

  monkeypatch.setattr(eval_main.eval_sequence, "evaluate_sequence", spy)
  dump = str(tmp_path / "dump")
  eval_main.main(common(root, "--kfnet_ckpt", flagship, "--dump_dir", dump))
  cfg, params = pretrained.load(pretrained.FULL_ASSETS, device="cpu")
  assert seen["cfg"] == cfg
  assert cfg.scoordnet.norm == "group" and cfg.scoordnet.coord_scale != 1.0
  got = L.tree_leaves(seen["params"])
  assert len(got) == len(L.tree_leaves(params))
  for a, b in zip(got, L.tree_leaves(params)):
    assert a.dtype == b.dtype and torch.equal(a, b)
  split = ts7.load_split(root, "chess", "test")
  frames = np.stack([ts7.load_frame(f)["image"] for f in split.frames])
  want = teval.evaluate_sequence(params, cfg, frames, split.intrinsics,
                                 timing_reps=1, device="cpu")
  for t in range(3):
    d = np.load(os.path.join(dump, "seq-01", f"frame-{t:06d}.npz"))
    np.testing.assert_array_equal(d["coords"], want.coords[t])
    np.testing.assert_array_equal(d["covariance"], want.covariance[t])
    np.testing.assert_array_equal(d["pose"], want.poses[t])
