"""The port's one-command acceptance runner (kfnet_tpu_torch/tools/
acceptance.py) and the fixture trees it runs on, on the CPU: the cases of
tests/test_acceptance.py in the port.

Held: the port's 7-Scenes fixture read back by the port's loaders (the
JAX test's bounds) and by the JAX package's loaders, equal; the C++ colour
decode against the numpy route bit for bit and depth against PIL; the
stray data/ directory case; the runner end to end at --net_scale tiny on
7-Scenes (every stage export, the report and its baseline, finite
medians), its re-run training nothing (each stage cached through
utils/checkpoint.has_params) and adding the filtered_smoothed block; the
runner on 12-Scenes (JPEG colour, nested scenes) and Cambridge (NVM poses,
test frames without depth); the empty scene list's error. The runner takes
about 5 s a dataset here, so it stays in tier 1 (the JAX package's runner
tests are marked slow for their compile time).
"""

import json
import os

import numpy as np
import pytest
import torch
from PIL import Image

from kfnet_tpu.data import seven_scenes as js7
from kfnet_tpu.tools import acceptance as jacceptance
from kfnet_tpu_torch.data import fixture as fixture_lib
from kfnet_tpu_torch.data import image_io, native_io
from kfnet_tpu_torch.data import seven_scenes as s7
from kfnet_tpu_torch.tools import acceptance
from kfnet_tpu_torch.utils import checkpoint as ckpt_lib

TINY = ["--net_scale", "tiny", "--batch_size", "2", "--sc_steps", "3",
        "--of_steps", "2", "--joint_steps", "2", "--learning_rate", "1e-4",
        "--device", "cpu"]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
  root = str(tmp_path_factory.mktemp("sevenscenes"))
  gt = fixture_lib.write_seven_scenes_fixture(
      root, scenes=("chess",), train_frames=7, test_frames=6, device="cpu")
  return root, gt


def test_fixture_layout_and_loaders(fixture_root):
  """Split files, frame triplets, pose files, the invalid-depth sentinel,
  read back through the loaders the CLIs use; the JAX package's loaders
  read the same values."""
  root, gt = fixture_root
  train = s7.load_split(root, "chess", "train")
  test = s7.load_split(root, "chess", "test")
  assert [f.seq for f in train.frames] == ["seq-01"] * 7
  assert [f.seq for f in test.frames] == ["seq-02"] * 6
  np.testing.assert_allclose(
      train.intrinsics, gt["chess"]["seq-01"]["K"], atol=1e-5)
  fr = s7.load_frame(train.frames[3])
  assert fr["image"].shape == (480, 640, 3)
  np.testing.assert_allclose(
      fr["image"], gt["chess"]["seq-01"]["images"][3], atol=1.0 / 255)
  np.testing.assert_allclose(
      fr["pose"], gt["chess"]["seq-01"]["poses"][3], atol=1e-6)
  assert fr["depth"][0, 0] == 0.0
  valid = gt["chess"]["seq-01"]["depths"][3][2:, 2:]
  np.testing.assert_allclose(fr["depth"][2:, 2:], valid, atol=2e-3)
  jfr = js7.load_frame(js7.load_split(root, "chess", "train").frames[3])
  for k in ("image", "depth", "pose"):
    np.testing.assert_array_equal(fr[k], jfr[k])


def test_fixture_native_loader_parity(fixture_root):
  """The C++ PNG decoder reads the fixture's colour as the numpy route
  does, bit for bit, and its 16-bit depth as PIL does."""
  root, _ = fixture_root
  fr = s7.load_split(root, "chess", "train").frames[0]
  with open(fr.color_path, "rb") as f:
    raw = f.read()
  np.testing.assert_array_equal(image_io.decode_png(raw),
                                image_io.decode_png_plain(raw))
  a = native_io.read_color(fr.color_path)
  np.testing.assert_array_equal(
      a, image_io.decode_png_plain(raw).astype(np.float32) / 255.0)
  pil_raw = np.asarray(Image.open(fr.depth_path), np.uint16)
  np.testing.assert_array_equal(native_io.read_depth_raw(fr.depth_path),
                                pil_raw)


def test_seven_scenes_stray_data_subdir_does_not_shadow(tmp_path):
  root = str(tmp_path)
  fixture_lib.write_seven_scenes_fixture(
      root, scenes=("chess",), train_frames=2, test_frames=2,
      height=96, width=128, device="cpu")
  (tmp_path / "chess" / "seq-01" / "data").mkdir()
  split = s7.load_split(root, "chess", "train")
  assert len(split.frames) == 2
  assert "/data/" not in split.frames[0].color_path


def _run(dataset, root, scene, work, *extra):
  return acceptance.main(["--dataset", dataset, "--root", root,
                          "--scenes", scene, "--work_dir", work, *TINY,
                          *extra])


def _rows_finite(results, scene, frames):
  row = results["scenes"][scene]
  for mode in ("filtered", "measurement_only"):
    assert np.isfinite(row[mode]["median_translation_m"])
    assert np.isfinite(row[mode]["median_rotation_deg"])
    assert row[mode]["sequences"][0]["frames"] == frames


def test_acceptance_runner_end_to_end(tmp_path, monkeypatch):
  """Stages 1 -> 2 -> 3 and the filtered and measurement-only eval over a
  fixture tree, through the CLIs, in one command; then a re-run that
  trains nothing and adds the filtered_smoothed block."""
  root = str(tmp_path / "data")
  fixture_lib.write_seven_scenes_fixture(root, train_frames=7,
                                         test_frames=6, height=48, width=64,
                                         device="cpu")
  work = str(tmp_path / "work")
  report = str(tmp_path / "ACCEPTANCE.json")
  results = _run("7scenes", root, "chess", work, "--report", report)
  _rows_finite(results, "chess", 6)
  assert results["baseline"] == jacceptance.BASELINE_7SCENES
  assert results["baseline"]["kfnet_paper"]["median_translation_m"] == 0.027
  with open(report) as f:
    assert json.load(f)["scenes"]["chess"]["filtered"]["sequences"]
  for stage in ("scoordnet_chess", "oflownet_7scenes", "kfnet_chess"):
    assert ckpt_lib.has_params(os.path.join(work, stage, "export"))

  def trains(*a, **k):
    raise AssertionError("a cached stage was trained again")

  for mod in (acceptance.train_scoordnet, acceptance.train_oflownet,
              acceptance.train_kfnet):
    monkeypatch.setattr(mod, "main", trains)
  results2 = _run("7scenes", root, "chess", work, "--pose_smooth_beta",
                  "0.4")
  assert np.isfinite(
      results2["scenes"]["chess"]["filtered"]["median_translation_m"])
  sm = results2["scenes"]["chess"]["filtered_smoothed"]
  assert np.isfinite(sm["median_translation_m"])
  assert sm["sequences"][0]["pose_smooth_beta"] == 0.4
  assert "filtered_smoothed" in results2["average"]
  # the smoothed block is the dumped filtered trajectory, smoothed
  assert sm["sequences"][0]["frames"] == 6


@pytest.mark.parametrize("dataset,scene", [("12scenes", "apt1/kitchen"),
                                           ("cambridge", "ShopFacade")])
def test_acceptance_runner_other_datasets(dataset, scene, tmp_path):
  """The runner over the 12-Scenes layout (the port's JPEG decoder, nested
  scene directories) and the Cambridge layout (NVM poses, test frames
  without depth: eval only)."""
  root = str(tmp_path / "data")
  if dataset == "12scenes":
    fixture_lib.write_twelve_scenes_fixture(
        root, scenes=(scene,), train_frames=7, test_frames=6, height=48,
        width=64, device="cpu")
  else:
    fixture_lib.write_cambridge_fixture(
        root, scenes=(scene,), train_frames=7, test_frames=6, device="cpu")
  results = _run(dataset, root, scene, str(tmp_path / "work"))
  _rows_finite(results, scene, 6)
  assert results["baseline"] == {}
  if dataset == "cambridge":
    # no depth on the test frames: no coordinate-accuracy stats
    assert "median_coord_err_m" not in (
        results["scenes"][scene]["filtered"]["sequences"][0])


def test_acceptance_empty_scene_list(tmp_path):
  with pytest.raises(SystemExit, match="empty scene list"):
    _run("7scenes", str(tmp_path), ",", str(tmp_path / "work"))
