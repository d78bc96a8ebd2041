"""The port's offline pose tool (kfnet_tpu_torch/tools/eval_poses.py) on the
CPU: the four cases of tests/test_eval_poses.py (the re-solve from a dump
of the port's eval CLI, exact recovery of known poses, the solver flags
and the no-ground-truth labelling, pose smoothing), exact recovery by the
JAX package's tool on the same dump as well, the same poses as the eval
CLI's (same seed, solver and device: bit-equal), and load_dump_sequence's
keys= against the JAX package's."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfnet_tpu.core import geometry as jgeo
from kfnet_tpu.tools import eval_poses as jeval_poses
from kfnet_tpu_torch import convert
from kfnet_tpu_torch.eval import main as eval_main
from kfnet_tpu_torch.tools import eval_poses
from tests import tiny_configs as tc
from tests.test_data import make_fake_7scenes
from tests.test_torch_models import port_config


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _make_dump(tmp_path, monkeypatch, n=4):
  from kfnet_tpu.models import kfnet as jkfnet
  jcfg = tc.tiny_kfnet()
  tparams = convert.params_from_jax(jax.tree_util.tree_map(
      np.asarray, jkfnet.init(jax.random.key(0), jcfg, tc.IMG)))
  monkeypatch.setattr(eval_main, "load_pretrained",
                      lambda *a, **k: (port_config(jcfg), tparams))
  root = make_fake_7scenes(str(tmp_path / "data"), n=n)
  dump_dir = str(tmp_path / "dump")
  online = eval_main.main(["--input_folder", root, "--scene", "chess",
                           "--dump_dir", dump_dir, "--device", "cpu"])
  return dump_dir, online


def test_eval_poses_offline_from_dump(tmp_path, monkeypatch):
  dump_dir, online = _make_dump(tmp_path, monkeypatch)
  with open(os.path.join(dump_dir, "meta.json")) as f:
    meta = json.load(f)
  assert meta["stride"] == 8 and np.asarray(meta["intrinsics"]).shape == (3, 3)
  d = np.load(os.path.join(dump_dir, "seq-01", "frame-000001.npz"))
  assert d["pose_gt"].shape == (4, 4)
  report_path = str(tmp_path / "poses.json")
  reports = eval_poses.main(["--dump_dir", dump_dir, "--report", report_path,
                             "--device", "cpu"])
  assert len(reports) == 1
  rep = reports[0]
  assert rep["frames"] == 4
  assert rep["scene"] == "chess/seq-01"
  # the same maps, seed and solver as the eval CLI's batch run: the same
  # poses, so the same medians (the JAX tool only lands in the same band)
  for k in ("median_translation_m", "median_rotation_deg"):
    assert rep[k] == online[0][k]
  with open(report_path) as f:
    assert json.load(f)["scenes"][0]["frames"] == 4


def test_eval_poses_resolves_the_eval_clis_poses(tmp_path, monkeypatch):
  dump_dir, _ = _make_dump(tmp_path, monkeypatch, n=5)
  data = eval_poses.load_dump_sequence(os.path.join(dump_dir, "seq-01"))
  with open(os.path.join(dump_dir, "meta.json")) as f:
    meta = json.load(f)
  from kfnet_tpu_torch.pose import ransac
  poses = eval_poses.solve_sequence(
      data["coords"], data["covariance"], np.asarray(meta["intrinsics"]),
      meta["stride"], ransac.RansacConfig(), seed=0, device="cpu")
  np.testing.assert_array_equal(poses, data["pose"])
  # keys=: the pose-only load, as the JAX package's loader gives it
  got = eval_poses.load_dump_sequence(os.path.join(dump_dir, "seq-01"),
                                      keys=("pose", "pose_gt"))
  want = jeval_poses.load_dump_sequence(os.path.join(dump_dir, "seq-01"),
                                        keys=("pose", "pose_gt"))
  assert sorted(got) == sorted(want) == ["pose", "pose_gt"]
  for k in got:
    np.testing.assert_array_equal(got[k], want[k])


def _synthetic_dump(tmp_path):
  """A dump whose maps are exact backprojections of known poses."""
  h, w, stride = 6, 8, 8
  K = np.asarray(jgeo.make_intrinsics(60.0, 60.0, 31.5, 23.5))
  grid = np.asarray(jgeo.cell_center_grid(h, w, stride)).reshape(-1, 2)
  rng = np.random.default_rng(7)
  dump = tmp_path / "dump"
  (dump / "seq-01").mkdir(parents=True)
  with open(dump / "meta.json", "w") as f:
    json.dump({"intrinsics": K.tolist(), "stride": stride,
               "scene": "synth"}, f)
  for t in range(3):
    R_wc = np.asarray(jgeo.axis_angle_to_matrix(
        jnp.asarray(rng.normal(size=3) * 0.2, jnp.float32)))
    t_wc = rng.normal(size=3).astype(np.float32)
    T_wc = np.asarray(jgeo.make_pose(jnp.asarray(R_wc), jnp.asarray(t_wc)))
    z = rng.uniform(1.0, 5.0, (h * w, 1)).astype(np.float32)
    rays = np.concatenate([(grid - K[:2, 2]) / np.diag(K)[:2],
                           np.ones((h * w, 1), np.float32)], -1)
    X = (rays * z) @ R_wc.T + t_wc
    np.savez(dump / "seq-01" / f"frame-{t:06d}.npz",
             coords=X.reshape(h, w, 3).astype(np.float32),
             covariance=np.full((h, w, 1), 1e-4, np.float32),
             pose=np.eye(4, dtype=np.float32), pose_gt=T_wc)
  return str(dump)


@pytest.mark.parametrize("package", ["port", "jax"])
def test_eval_poses_exact_recovery_from_synthetic_dump(tmp_path, package):
  """Maps that are exact backprojections of known poses are solved back to
  those poses (sub-mm, milli-degree) by either package's tool."""
  dump = _synthetic_dump(tmp_path)
  if package == "port":
    rep = eval_poses.main(["--dump_dir", dump, "--device", "cpu"])[0]
  else:
    rep = jeval_poses.main(["--dump_dir", dump])[0]
  assert rep["median_translation_m"] < 1e-3, rep
  assert rep["median_rotation_deg"] < 0.05, rep
  assert rep["accuracy_5cm_5deg"] == 1.0


def test_eval_poses_solver_flags_and_no_gt(tmp_path, monkeypatch):
  dump_dir, _ = _make_dump(tmp_path, monkeypatch, n=3)
  for f in sorted(os.listdir(os.path.join(dump_dir, "seq-01"))):
    path = os.path.join(dump_dir, "seq-01", f)
    d = dict(np.load(path))
    d.pop("pose_gt")
    np.savez_compressed(path, **d)
  rep = eval_poses.main(["--dump_dir", dump_dir, "--pnp_solver", "p3p",
                         "--num_hypotheses", "64",
                         "--inlier_threshold_px", "6", "--device", "cpu"])[0]
  assert rep["gt_source"] == "dumped_poses_no_gt"
  assert rep["frames"] == 3
  assert np.isfinite(rep["median_translation_m"])
  with pytest.raises(SystemExit, match="no intrinsics"):
    os.remove(os.path.join(dump_dir, "meta.json"))
    eval_poses.main(["--dump_dir", dump_dir, "--device", "cpu"])


def test_eval_poses_pose_smoothing_flag(tmp_path, monkeypatch):
  dump_dir, _ = _make_dump(tmp_path, monkeypatch, n=4)
  raw = eval_poses.main(["--dump_dir", dump_dir, "--device", "cpu"])
  sm = eval_poses.main(["--dump_dir", dump_dir, "--pose_smooth_beta", "0.4",
                        "--device", "cpu"])
  assert "pose_smooth_beta" not in raw[0]
  assert sm[0]["pose_smooth_beta"] == 0.4
  assert sm[0]["frames"] == raw[0]["frames"] == 4
  assert np.isfinite(sm[0]["median_translation_m"])
