"""The port's dataset path (kfnet_tpu_torch/data: seven_scenes,
twelve_scenes, cambridge, registry, pipeline, native_io, fixture;
utils/config.py and the dataset presets of configs/) against the JAX
package's on the same files.

Held exactly: splits, colour, depth and poses read from fixtures written
by the JAX package's fixture.py and by tests/test_data.py's
make_fake_7scenes; augment_example and batched for one seed; the presets.
Held within one level of 255: Cambridge colour resized on load (PIL's
antialiased bilinear against the port's). Held at the JAX test's rtol /
atol 1e-5 (tests/test_native_io.py:61): depth_png_to_labels against
labels.generate. The port's fixture against the JAX package's for the
same seed: the files within one quantisation step (1/255, 1 mm) but at
sphere silhouettes, at most 0.1% of the pixels, as the synthetic
renderer's parity (tests/test_torch_synthetic.py).
"""

import dataclasses
import os
import tempfile
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from kfnet_tpu import configs as jconfigs
from kfnet_tpu.core import geometry as jgeo
from kfnet_tpu.data import cambridge as jcb
from kfnet_tpu.data import fixture as jfixture
from kfnet_tpu.data import labels as jlabels
from kfnet_tpu.data import pipeline as jpipe
from kfnet_tpu.data import registry as jregistry
from kfnet_tpu.data import seven_scenes as js7
from kfnet_tpu.data import twelve_scenes as js12
from kfnet_tpu.utils import config as jconfig
from kfnet_tpu_torch import configs as tconfigs
from kfnet_tpu_torch.data import cambridge as tcb
from kfnet_tpu_torch.data import fixture as tfixture
from kfnet_tpu_torch.data import image_io
from kfnet_tpu_torch.data import labels as tlabels
from kfnet_tpu_torch.data import native_io
from kfnet_tpu_torch.data import pipeline as tpipe
from kfnet_tpu_torch.data import registry as tregistry
from kfnet_tpu_torch.data import seven_scenes as ts7
from kfnet_tpu_torch.data import twelve_scenes as ts12
from kfnet_tpu_torch.utils import config as tconfig
from tests.test_data import make_fake_7scenes

SILHOUETTE_SHARE = 1e-3
LABEL_TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def jax_fixture(tmp_path_factory):
  root = str(tmp_path_factory.mktemp("jax_fixture"))
  gt = jfixture.write_seven_scenes_fixture(root, train_frames=4,
                                           test_frames=3, height=48,
                                           width=64, seed=0)
  return root, gt


@pytest.fixture(scope="module")
def fake_scene(tmp_path_factory):
  return make_fake_7scenes(str(tmp_path_factory.mktemp("fake")), n=6)


def _same_split(got, want):
  assert got.scene == want.scene
  assert [dataclasses.astuple(f) for f in got.frames] == [
      dataclasses.astuple(f) for f in want.frames]
  np.testing.assert_array_equal(got.intrinsics, np.asarray(want.intrinsics))
  assert got.intrinsics.dtype == np.float32


def _same_frame(got, want):
  assert sorted(got) == sorted(want)
  for k in want:
    if isinstance(want[k], np.ndarray):
      assert got[k].dtype == want[k].dtype, k
      np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    else:
      assert got[k] == want[k], k


@pytest.mark.parametrize("split", ["train", "test"])
def test_seven_scenes_loader_equals_jax_on_its_fixture(jax_fixture, split):
  root, gt = jax_fixture
  want = js7.load_split(root, "chess", split)
  got = ts7.load_split(root, "chess", split)
  _same_split(got, want)
  for fw, fg in zip(want.frames, got.frames):
    _same_frame(ts7.load_frame(fg), js7.load_frame(fw))
  assert [[f.index for f in s] for s in ts7.iter_sequences(got)] == [
      [f.index for f in s] for s in js7.iter_sequences(want)]


def test_seven_scenes_loader_equals_jax_on_make_fake_7scenes(fake_scene):
  want = js7.load_split(fake_scene, "chess", "train")
  got = ts7.load_split(fake_scene, "chess", "train")
  _same_split(got, want)
  for fw, fg in zip(want.frames, got.frames):
    _same_frame(ts7.load_frame(fg), js7.load_frame(fw))
  assert ts7.load_frame(got.frames[0])["depth"][0, 0] == 0.0  # 65535


def test_missing_sequence_is_loud(tmp_path):
  root = make_fake_7scenes(str(tmp_path), n=2)
  with open(os.path.join(root, "chess", "TestSplit.txt"), "w") as f:
    f.write("sequence7\n")
  with pytest.raises(FileNotFoundError, match="seq-07"):
    ts7.load_split(root, "chess", "test")


def _fake_12scenes(root):
  """tests/test_data.py's 12-Scenes layout: JPEG colour under data/."""
  rng = np.random.default_rng(0)
  sdir = os.path.join(root, "apt1", "kitchen", "seq-01", "data")
  os.makedirs(sdir)
  for name in ("TrainSplit.txt", "TestSplit.txt"):
    with open(os.path.join(root, "apt1", "kitchen", name), "w") as f:
      f.write("sequence1\n")
  for i in range(2):
    Image.fromarray(rng.integers(0, 255, (48, 64, 3)).astype(np.uint8)).save(
        os.path.join(sdir, f"frame-{i:06d}.color.jpg"))
    Image.fromarray(rng.integers(500, 4000, (48, 64)).astype(
        np.uint16)).save(os.path.join(sdir, f"frame-{i:06d}.depth.png"))
    np.savetxt(os.path.join(sdir, f"frame-{i:06d}.pose.txt"), np.eye(4))
  return root


def test_twelve_scenes_split_and_depth_equal_jax_colour_raises(tmp_path):
  root = _fake_12scenes(str(tmp_path))
  want = js12.load_split(root, "apt1/kitchen", "train")
  got = ts12.load_split(root, "apt1/kitchen", "train")
  _same_split(got, want)
  assert got.intrinsics[0, 0] == 572.0
  fr = got.frames[0]
  np.testing.assert_array_equal(ts7.read_depth(fr.depth_path),
                                js7.read_depth(fr.depth_path))
  np.testing.assert_array_equal(ts7.read_pose(fr.pose_path),
                                js7.read_pose(fr.pose_path))
  # colour decodes now (the port's JPEG decoder; it raised before there
  # was one): within two levels of the JAX package's PIL decode
  np.testing.assert_allclose(ts12.load_frame(fr)["image"],
                             js12.load_frame(fr)["image"], atol=2.0 / 255)


@pytest.fixture(scope="module")
def cambridge_scene(tmp_path_factory):
  """A Cambridge layout at 300x500 (not the 272x480 working size, so the
  loaders resize), one frame with a depth file."""
  root = str(tmp_path_factory.mktemp("cambridge"))
  sdir = os.path.join(root, "ShopFacade", "seq1")
  os.makedirs(sdir)
  rng = np.random.default_rng(6)
  smooth = np.add.outer(np.arange(300), np.arange(500))
  lines = ["Visual Landmark Dataset V1",
           "ImageFile, Camera Position [X Y Z W P Q R]", ""]
  for i in range(2):
    rgb = np.clip(np.stack([smooth % 251, smooth * 3 % 256,
                            (smooth // 4) % 256], -1)
                  + rng.integers(-30, 30, (300, 500, 3)), 0, 255)
    Image.fromarray(rgb.astype(np.uint8)).save(
        os.path.join(sdir, f"frame{i + 1:05d}.png"))
    q = rng.normal(size=4)
    lines.append(f"seq1/frame{i + 1:05d}.png " + " ".join(
        f"{v:.9f}" for v in (*rng.normal(size=3), *(q / np.linalg.norm(q)))))
  depth = rng.integers(3000, 60000, (300, 500)).astype(np.uint16)
  depth[:3, :3] = 65535
  Image.fromarray(depth).save(os.path.join(sdir, "frame00001.depth.png"))
  with open(os.path.join(root, "ShopFacade", "dataset_train.txt"), "w") as f:
    f.write("\n".join(lines) + "\n")
  return root


def test_cambridge_loader_resizes_as_jax(cambridge_scene):
  want, wposes = jcb.load_split(cambridge_scene, "ShopFacade", "train")
  got, gposes = tcb.load_split(cambridge_scene, "ShopFacade", "train")
  _same_split(got, want)
  assert sorted(gposes) == sorted(wposes)
  for k in wposes:
    np.testing.assert_array_equal(gposes[k], wposes[k])
  assert got.frames[0].depth_path and not got.frames[1].depth_path
  for fw, fg in zip(want.frames, got.frames):
    w, g = jcb.load_frame(fw, wposes), tcb.load_frame(fg, gposes)
    assert g["image"].shape == w["image"].shape == (272, 480, 3)
    assert g["image"].dtype == np.float32
    assert np.abs(g["image"] - w["image"]).max() <= 1.0 / 255.0 + 1e-7
    assert ("depth" in g) == ("depth" in w)
    if "depth" in w:
      np.testing.assert_array_equal(g["depth"], w["depth"])  # nearest
    np.testing.assert_array_equal(g["pose"], w["pose"])


def test_cambridge_quaternion_matches_jax():
  q = np.random.default_rng(7).normal(size=4)
  np.testing.assert_array_equal(tcb.quat_to_matrix(q), jcb.quat_to_matrix(q))


def test_registry_default_scenes_and_cambridge_intrinsics_guard(tmp_path):
  for name in ("7scenes", "12scenes", "cambridge"):
    assert tregistry.default_scenes(name) == jregistry.default_scenes(name)
    assert tregistry.get(name).name == name
  with pytest.raises(KeyError):
    tregistry.default_scenes("nope")
  adapter = tregistry.get("cambridge")
  with pytest.raises(ValueError, match="must not pass intrinsics"):
    adapter.load_split(str(tmp_path), "KingsCollege", "train",
                       intrinsics=np.eye(3, dtype=np.float32))


def test_registry_cambridge_frames_load_with_their_split(cambridge_scene):
  adapter = tregistry.get("cambridge")
  split = adapter.load_split(cambridge_scene, "ShopFacade", "train")
  with pytest.raises(RuntimeError, match="split context"):
    adapter.load_frame(split.frames[0])
  ex = adapter.load_frame_with_split(split, split.frames[0])
  assert ex["image"].shape == (272, 480, 3) and "depth" in ex


def test_presets_equal_jax():
  for name in ("7scenes", "12scenes", "cambridge"):
    assert dataclasses.asdict(tconfig.PRESETS[name]) == dataclasses.asdict(
        jconfig.PRESETS[name])
  for dataset, scene in (("7scenes", "fire"), ("12scenes", "apt2/bed"),
                         ("cambridge", "GreatCourt")):
    t, j = tconfigs.get(dataset, scene, "/x"), jconfigs.get(dataset, scene,
                                                            "/x")
    for f in ("dataset", "scene", "input_folder", "batch_size",
              "optimizer", "loop", "scoordnet", "oflownet", "seed"):
      assert dataclasses.asdict(t)[f] == dataclasses.asdict(j)[f], f
    assert t.device == "cuda"
    # the port writes under the process's temporary directory, not a fixed
    # /tmp path shared by every checkout
    assert t.model_folder == os.path.join(tempfile.gettempdir(),
                                          "kfnet_tpu_torch_models")
  with pytest.raises(AssertionError):
    tconfigs.get("7scenes", "kitchen")


@pytest.mark.parametrize("net_scale", ["full", "tiny"])
def test_flags_and_from_args_equal_jax(net_scale):
  import argparse
  argv = ["--input_folder", "/d", "--scene", "fire", "--batch_size", "4",
          "--learning_rate", "3e-4", "--max_steps", "10", "--net_scale",
          net_scale, "--steps_per_dispatch", "2", "--dataset", "cambridge"]
  t = tconfig.from_args(tconfig.add_common_flags(
      argparse.ArgumentParser()).parse_args(argv + ["--device", "cpu"]))
  j = jconfig.from_args(jconfig.add_common_flags(
      argparse.ArgumentParser()).parse_args(argv))
  tj, jj = dataclasses.asdict(t), dataclasses.asdict(j)
  assert tj.pop("device") == "cpu"
  assert tj.pop("model_folder") == tconfig.DEFAULT_MODEL_FOLDER
  jj.pop("model_folder")
  assert tj == jj
  named = tconfig.from_args(tconfig.add_common_flags(
      argparse.ArgumentParser()).parse_args(argv + ["--model_folder", "/m"]))
  assert named.model_folder == "/m"


def _example(rng):
  img = rng.uniform(0, 1, (48, 64, 3)).astype(np.float32)
  gy, gx = np.mgrid[0:6, 0:8]
  coords = np.stack([gx, gy, gx + gy], -1).astype(np.float32)
  return {"image": img, "image_prev": img[::-1].copy(),
          "depth": rng.uniform(0.5, 4, (48, 64)).astype(np.float32),
          "coords": coords, "valid": (gx + gy) % 2 == 0,
          "coords_prev": coords + 1, "valid_prev": (gx + gy) % 3 == 0}


@pytest.mark.parametrize("crop", [None, (32, 48)])
def test_augment_example_equals_jax(crop):
  cfg_kw = dict(crop=crop, brightness=0.1, contrast=0.2)
  for seed in range(3):
    ex = _example(np.random.default_rng(10 + seed))
    want = jpipe.augment_example(np.random.default_rng(seed), ex,
                                 jpipe.AugmentConfig(**cfg_kw))
    got = tpipe.augment_example(np.random.default_rng(seed), ex,
                                tpipe.AugmentConfig(**cfg_kw))
    _same_frame(got, want)


def test_batched_equals_jax_for_one_seed(fake_scene):
  split = ts7.load_split(fake_scene, "chess", "train")
  aug = dict(crop=(32, 48), brightness=0.1, contrast=0.1)
  want = list(jpipe.batched(
      [lambda fr=fr: js7.load_frame(fr) for fr in split.frames], 2, seed=5,
      augment=jpipe.AugmentConfig(**aug), epochs=2, to_device=False))
  got = list(tpipe.batched(
      [lambda fr=fr: ts7.load_frame(fr) for fr in split.frames], 2, seed=5,
      augment=tpipe.AugmentConfig(**aug), epochs=2, to_device=False))
  assert len(got) == len(want) == 6
  for g, w in zip(got, want):
    _same_frame(g, w)
  assert (got[0]["crop_offset"] % 8 == 0).all()


def test_batched_to_device_gives_tensors(fake_scene):
  split = ts7.load_split(fake_scene, "chess", "train")
  b = next(tpipe.batched([lambda fr=fr: ts7.load_frame(fr)
                          for fr in split.frames], 2, epochs=1,
                         to_device=True, device="cpu"))
  assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
             for v in b.values())
  assert b["image"].shape == (2, 48, 64, 3)


@pytest.mark.parametrize("route", ["batched", "batched_native"])
def test_batches_are_pinned_in_the_prefetch_thread(route, tmp_path,
                                                   monkeypatch):
  """With ``to_device`` each batch becomes host tensors (pinned when bound
  for the card) in the prefetch thread; the consumer only copies."""
  cpaths, dpaths, poses, K = _write_scene(tmp_path, n=4)
  seen = []
  pin = tpipe.pin_batch

  def recording_pin(batch, device):
    seen.append(threading.current_thread())
    return pin(batch, device)

  monkeypatch.setattr(tpipe, "pin_batch", recording_pin)
  if route == "batched":
    it = tpipe.batched([lambda i=i: {"image": ts7.read_color(cpaths[i])}
                        for i in range(4)], 2, epochs=1, device="cpu")
  else:
    it = tpipe.batched_native(cpaths, dpaths, poses, K, (48, 64), 2,
                              epochs=1, device="cpu")
  batches = list(it)
  assert len(batches) == 2 and len(seen) == 2
  assert all(t is not threading.current_thread() for t in seen)
  assert all(isinstance(v, torch.Tensor) and v.device.type == "cpu"
             for b in batches for v in b.values())


def _pose(rng):
  w = jnp.asarray(rng.normal(size=3).astype(np.float32)) * 0.3
  return np.asarray(jgeo.make_pose(
      jgeo.axis_angle_to_matrix(w),
      jnp.asarray(rng.normal(size=3).astype(np.float32))))


def _write_scene(tmp_path, n=5):
  """tests/test_native_io.py's scene: n random frames at 48x64."""
  rng = np.random.default_rng(1)
  cpaths, dpaths, poses = [], [], []
  for i in range(n):
    cp, dp = str(tmp_path / f"c{i}.png"), str(tmp_path / f"d{i}.png")
    Image.fromarray(rng.integers(0, 256, (48, 64, 3), dtype=np.uint8)).save(
        cp)
    depth = rng.integers(300, 5000, (48, 64)).astype(np.uint16)
    depth[i % 4, :3] = 65535
    depth[(i + 1) % 4, 5] = 0
    Image.fromarray(depth).save(dp)
    cpaths.append(cp)
    dpaths.append(dp)
    poses.append(_pose(rng))
  K = np.asarray([[60., 0, 31.5], [0, 60., 23.5], [0, 0, 1]], np.float32)
  return cpaths, dpaths, np.stack(poses), K


def test_depth_png_to_labels_matches_labels_generate(tmp_path):
  _, dpaths, poses, K = _write_scene(tmp_path, n=2)
  for dp, T in zip(dpaths, poses):
    c_nat, v_nat = native_io.depth_png_to_labels(dp, K, T, stride=8)
    c_ref, v_ref = jlabels.generate(
        jnp.asarray(js7.read_depth(dp)), jnp.asarray(K), jnp.asarray(T),
        stride=8, min_depth=0.05, max_depth=20.0)
    np.testing.assert_array_equal(v_nat, np.asarray(v_ref))
    np.testing.assert_allclose(c_nat, np.asarray(c_ref), **LABEL_TOL)
    c_t, v_t = tlabels.generate(torch.from_numpy(ts7.read_depth(dp)),
                                torch.from_numpy(K), torch.from_numpy(T))
    np.testing.assert_array_equal(v_nat, v_t.numpy())
    np.testing.assert_allclose(c_nat, c_t.numpy(), **LABEL_TOL)


def test_load_batch_equals_per_frame_and_thread_count(tmp_path):
  cpaths, dpaths, poses, K = _write_scene(tmp_path)
  dpaths2 = list(dpaths)
  dpaths2[2] = None  # no depth: zero labels, valid 0
  out4 = native_io.load_batch(cpaths, dpaths2, poses, K, width=64,
                              height=48, num_threads=4)
  out1 = native_io.load_batch(cpaths, dpaths2, poses, K, width=64,
                              height=48, num_threads=1)
  for k in ("image", "coords", "valid"):
    np.testing.assert_array_equal(out4[k], out1[k])
  assert not out4["valid"][2].any()
  for i in (0, 1, 3, 4):
    np.testing.assert_array_equal(out4["image"][i],
                                  js7.read_color(cpaths[i]))
    c, v = native_io.depth_png_to_labels(dpaths[i], K, poses[i])
    np.testing.assert_array_equal(out4["coords"][i], c)
    np.testing.assert_array_equal(out4["valid"][i], v)


def test_load_batch_error_names_frame(tmp_path):
  cpaths, dpaths, poses, K = _write_scene(tmp_path, n=3)
  cpaths[1] = str(tmp_path / "missing.png")
  with pytest.raises(ValueError, match="frame 1.*color"):
    native_io.load_batch(cpaths, dpaths, poses, K, width=64, height=48)


def test_load_batch_error_names_depth_file(tmp_path):
  cpaths, dpaths, poses, K = _write_scene(tmp_path, n=3)
  dpaths[2] = str(tmp_path / "missing-depth.png")
  with pytest.raises(ValueError, match="frame 2.*depth"):
    native_io.load_batch(cpaths, dpaths, poses, K, width=64, height=48)


def test_load_batch_refuses_a_frame_of_another_size(tmp_path):
  cpaths, dpaths, poses, K = _write_scene(tmp_path, n=2)
  with pytest.raises(ValueError, match="frame 0.*color"):
    native_io.load_batch(cpaths, dpaths, poses, K, width=32, height=48)


def test_batched_native_equals_batched(tmp_path):
  """One seed: the same shuffle, so the C++ batches equal the per-frame
  Python ones (labels at the label tolerance), with augmentation too."""
  cpaths, dpaths, poses, K = _write_scene(tmp_path, n=6)

  def load(i):
    c, v = tlabels.generate(torch.from_numpy(ts7.read_depth(dpaths[i])),
                            torch.from_numpy(K), torch.from_numpy(poses[i]))
    return {"image": ts7.read_color(cpaths[i]), "coords": c.numpy(),
            "valid": v.numpy()}

  for aug in (None, tpipe.AugmentConfig(crop=(32, 48))):
    it_py = tpipe.batched([lambda i=i: load(i) for i in range(6)], 2,
                          seed=3, epochs=1, augment=aug, to_device=False)
    it_nat = tpipe.batched_native(cpaths, dpaths, poses, K, (48, 64), 2,
                                  seed=3, epochs=1, augment=aug,
                                  to_device=False)
    n = 0
    for b_py, b_nat in zip(it_py, it_nat):
      assert sorted(b_py) == sorted(b_nat)
      np.testing.assert_array_equal(b_nat["image"], b_py["image"])
      np.testing.assert_allclose(b_nat["coords"], b_py["coords"],
                                 **LABEL_TOL)
      np.testing.assert_array_equal(b_nat["valid"], b_py["valid"])
      n += 1
    assert n == 3


def test_pipeline_propagates_worker_errors():
  def boom():
    raise RuntimeError("decode failed")
  with pytest.raises(RuntimeError, match="decode failed"):
    list(tpipe.batched([boom], batch_size=1, epochs=1, to_device=False))


def test_prefetcher_close_unblocks_producer():
  def forever():
    while True:
      yield np.zeros(8, np.float32)

  pf = tpipe.Prefetcher(forever(), depth=2)
  it = iter(pf)
  next(it)
  pf.close()
  assert not pf._thread.is_alive()


def test_batched_consumer_break_retires_prefetch_thread():
  load_fns = [lambda: {"x": np.zeros(3, np.float32)}] * 6
  before = set(threading.enumerate())
  gen = tpipe.batched(load_fns, 2, epochs=None, to_device=False)
  assert next(gen)["x"].shape == (2, 3)
  gen.close()
  assert set(threading.enumerate()) == before


def _read_back(root, scene, split):
  sp = ts7.load_split(root, scene, split)
  frames = [ts7.load_frame(f) for f in sp.frames]
  return (np.stack([f["image"] for f in frames]),
          np.stack([f["depth"] for f in frames]),
          np.stack([f["pose"] for f in frames]))


def test_port_fixture_equals_jax_fixture(jax_fixture, tmp_path):
  jroot, jgt = jax_fixture
  troot = str(tmp_path)
  tgt = tfixture.write_seven_scenes_fixture(troot, train_frames=4,
                                            test_frames=3, height=48,
                                            width=64, seed=0, device="cpu")
  assert sorted(os.listdir(os.path.join(troot, "chess"))) == sorted(
      os.listdir(os.path.join(jroot, "chess")))
  for split, seq in (("train", "seq-01"), ("test", "seq-02")):
    ti, td, tp = _read_back(troot, "chess", split)
    ji, jd, jp = _read_back(jroot, "chess", split)
    np.testing.assert_allclose(tp, jp, atol=1e-6)
    off = ((np.abs(ti - ji).max(-1) > 1.5 / 255.0)
           | (np.abs(td - jd) > 1.5e-3))
    assert off.mean() <= SILHOUETTE_SHARE, off.mean()
    assert (td[:, :2, :2] == 0).all()  # the invalid stamp
    np.testing.assert_allclose(tgt["chess"][seq]["K"],
                               np.asarray(jgt["chess"][seq]["K"]),
                               rtol=1e-6)


def test_port_cambridge_fixture_reads_back(tmp_path):
  """The port's Cambridge writer at the working size: train frames with
  depth, test frames without, the poses the loader parses are the ones
  rendered, and no resize happens on load."""
  gt = tfixture.write_cambridge_fixture(str(tmp_path), train_frames=2,
                                        test_frames=1, device="cpu")
  for split, n in (("train", 2), ("test", 1)):
    sp, poses = tcb.load_split(str(tmp_path), "KingsCollege", split)
    assert len(sp.frames) == n
    assert all(bool(f.depth_path) == (split == "train") for f in sp.frames)
    want = gt["KingsCollege"][split]
    for t, fr in enumerate(sp.frames):
      ex = tcb.load_frame(fr, poses)
      np.testing.assert_allclose(ex["pose"], want["poses"][t], atol=2e-5)
      assert np.abs(ex["image"] - want["images"][t]).max() <= 0.5 / 255 + 1e-6
      if "depth" in ex:
        # half a millimetre of rounding, and float32's at tens of metres
        np.testing.assert_allclose(ex["depth"], want["depths"][t],
                                   atol=5e-4, rtol=1e-6)
      np.testing.assert_array_equal(
          ex["image"], image_io.read_color(fr.color_path))
