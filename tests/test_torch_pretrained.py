"""The shipped weights in the port: the committed ``.npz`` exports under
kfnet_tpu_torch/assets/pretrained_synthetic against the orbax exports
under artifacts/pretrained_synthetic, the port's loaders against the JAX
package's, and the trained weights relocalizing sceneA.

Tolerances: the exports and the loaded params exactly (the same float32
values); run_filter over the trained weights at the goldens' rtol 5e-4 /
atol 5e-5 (tests/test_goldens.py; both nets are float32 here); the
port's relocalization of sceneA's held-out trajectory within the bounds of
tests/test_pretrained_artifact.py (median < 0.5 m, < 8°).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfnet_tpu import pretrained as jpre
from kfnet_tpu.data import synthetic as jsyn
from kfnet_tpu.filter import sequence as jseq
from kfnet_tpu.utils import checkpoint as jckpt
from kfnet_tpu_torch import convert
from kfnet_tpu_torch import pretrained as tpre
from kfnet_tpu_torch.data import synthetic as tsyn
from kfnet_tpu_torch.eval import eval_sequence as teval
from kfnet_tpu_torch.filter import sequence as tseq
from kfnet_tpu_torch.nn import layers as L
from kfnet_tpu_torch.pose import ransac as transac
from kfnet_tpu_torch.utils import checkpoint as tckpt

ROOT = os.path.join(os.path.dirname(__file__), os.pardir)
ORBAX = os.path.join(ROOT, "artifacts", "pretrained_synthetic")
STAGES = ("stage3_sceneA", "stage1_sceneA", "stage2_indoor")
TOL = dict(rtol=5e-4, atol=5e-5)


def _same_tree(got, want, path=""):
  """Exact equality of two trees: containers, keys, shapes, values."""
  if isinstance(want, dict):
    assert isinstance(got, dict) and sorted(got) == sorted(want), path
    for k in want:
      _same_tree(got[k], want[k], f"{path}/{k}")
  elif isinstance(want, (list, tuple)):
    assert type(got) is type(want) and len(got) == len(want), path
    for i, (g, w) in enumerate(zip(got, want)):
      _same_tree(g, w, f"{path}/{i}")
  else:
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    w = np.asarray(want)
    assert g.dtype == w.dtype and g.shape == w.shape, path
    np.testing.assert_array_equal(g, w, err_msg=path)


@pytest.mark.parametrize("stage", STAGES)
def test_export_equals_orbax(stage):
  want = jax.tree_util.tree_map(
      np.asarray, jckpt.load_params_values(os.path.join(ORBAX, stage)))
  got = tckpt.load_params_values(os.path.join(tpre.ASSETS, stage))
  _same_tree(got, want)
  assert tckpt.load_meta(os.path.join(tpre.ASSETS, stage)) == \
      jckpt.load_meta(os.path.join(ORBAX, stage))


@pytest.mark.parametrize("loader", ["load", "load_stage12"])
def test_loaders_match_jax(loader):
  jcfg, jparams = getattr(jpre, loader)(ORBAX, scene="sceneA")
  tcfg, tparams = getattr(tpre, loader)(scene="sceneA", device="cpu")
  assert dataclasses.asdict(tcfg.scoordnet) == dataclasses.asdict(
      jcfg.scoordnet)
  assert dataclasses.asdict(tcfg.oflownet) == dataclasses.asdict(
      jcfg.oflownet)
  for f in ("chi2_threshold", "invalid_cov", "w_scale",
            "adaptive_alpha_max"):
    assert getattr(tcfg, f) == getattr(jcfg, f), f
  _same_tree(tparams, convert.params_from_jax(
      jax.tree_util.tree_map(np.asarray, jparams)))
  assert all(p.device.type == "cpu" for p in L.tree_leaves(tparams))


def test_loading_without_a_device_raises_without_cuda():
  if torch.cuda.is_available():
    pytest.skip("this host has a CUDA device")
  with pytest.raises(RuntimeError, match="device='cpu'"):
    tpre.load()


def test_bf16_export_round_trip_matches_jax(tmp_path):
  """A bf16 release export (``params_dtype``): written by the port's
  writer and by orbax from the same bf16 tree, loaded by both loaders and
  cast back to the template's float32: the same values."""
  jcfg, jparams = jpre.load(ORBAX, scene="sceneA")
  bf16 = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16),
                                jparams)
  meta = dict(jckpt.load_meta(os.path.join(ORBAX, "stage3_sceneA")),
              params_dtype="bfloat16")
  jckpt.export_params(str(tmp_path / "orbax" / "stage3_sceneA"), bf16, meta)
  tckpt.save_params(str(tmp_path / "npz" / "stage3_sceneA"),
                    jax.tree_util.tree_map(np.asarray, bf16), meta)
  saved = np.load(tmp_path / "npz" / "stage3_sceneA" / "params.npz")
  assert saved["scoordnet/0/0/w"].dtype == np.uint16  # the bf16 bits
  _, want = jpre.load(str(tmp_path / "orbax"), scene="sceneA")
  _, got = tpre.load(str(tmp_path / "npz"), scene="sceneA", device="cpu")
  assert all(p.dtype == torch.float32 for p in L.tree_leaves(got))
  _same_tree(got, convert.params_from_jax(
      jax.tree_util.tree_map(np.asarray, want)))


@pytest.mark.parametrize("dtype", ["float16", np.float32])
def test_load_params_values_casts_every_leaf(dtype):
  """``load_params_values(path, dtype=...)`` casts every leaf, as the JAX
  package's does (kfnet_tpu/utils/checkpoint.py:98)."""
  stage = "stage3_sceneA"
  want = jax.tree_util.tree_map(np.asarray, jckpt.load_params_values(
      os.path.join(ORBAX, stage), dtype=np.dtype(dtype)))
  got = tckpt.load_params_values(os.path.join(tpre.ASSETS, stage),
                                 dtype=dtype)
  _same_tree(got, want)
  assert all(a.dtype == np.dtype(dtype)
             for a in jax.tree_util.tree_leaves(got))


def test_wrong_geometry_and_structure_are_loud(tmp_path):
  tckpt.save_params(str(tmp_path / "a"), {"w": np.zeros((2, 3), np.float32)},
                    {"params_dtype": "bfloat16"})
  with pytest.raises(ValueError, match="shapes"):
    tpre._load_params_cast(str(tmp_path / "a"), {"w": torch.zeros(4, 3)},
                           "cpu")
  with pytest.raises(ValueError, match="structure"):
    tpre._load_params_cast(str(tmp_path / "a"),
                           {"w": torch.zeros(2, 3), "b": torch.zeros(3)},
                           "cpu")


def test_checkpoint_keeps_the_tree_and_refuses_strays(tmp_path):
  tree = {"a": [np.arange(3, dtype=np.float32), {}],
          "b": (np.ones((2, 2), np.int32), [np.zeros(1, np.float32)]),
          "c": {"d": np.float32(2.5)}}
  tckpt.save_params(str(tmp_path / "t"), tree, {"k": 1})
  _same_tree(tckpt.load_params_values(str(tmp_path / "t")), tree)
  assert tckpt.load_meta(str(tmp_path / "t")) == {"k": 1}
  path = tmp_path / "t" / "params.npz"
  with np.load(path) as f:
    arrays = {k: f[k] for k in f.files}
  np.savez(path, **arrays, stray=np.zeros(1))
  with pytest.raises(ValueError, match="does not name"):
    tckpt.load_params_values(str(tmp_path / "t"))
  arrays.pop("a/0")
  np.savez(path, **arrays)
  with pytest.raises(ValueError, match="missing"):
    tckpt.load_params_values(str(tmp_path / "t"))
  tree_json = json.loads(str(arrays["__tree__"]))
  assert list(tree_json["dict"]["b"]) == ["tuple"]


def test_entry_points_move_bridged_params():
  """``convert``'s output lives on the CPU; an entry point given another
  device moves it there, and leaves params already there as they are (the
  same object, so that a kept graph still fits)."""
  _, params = tpre.load(device="cpu")
  same, dev = tseq.placed(params, "cpu")
  assert same is params and dev == torch.device("cpu")
  moved, dev = tseq.placed(params, "meta")
  assert dev.type == "meta"
  assert all(p.device.type == "meta" for p in L.tree_leaves(moved))
  assert tseq.placed(moved, None)[0] is moved


def test_run_filter_trained_weights_matches_jax():
  jcfg, jparams = jpre.load(ORBAX, scene="sceneA")
  tcfg, tparams = tpre.load(scene="sceneA", device="cpu")
  data = jsyn.make_sequence(4, height=96, width=128, seed=0, traj_seed=99,
                            duration=4 / 48.0)
  images = np.asarray(data["images"])
  jxs, jPs, _ = jax.jit(lambda p, im: jseq.run_filter(p, jcfg, im))(
      jparams, jnp.asarray(images))
  txs, tPs, _ = tseq.run_filter(tparams, tcfg, images)
  np.testing.assert_allclose(txs.numpy(), np.asarray(jxs), **TOL)
  np.testing.assert_allclose(tPs.numpy(), np.asarray(jPs), **TOL)


def test_port_relocalizes_scene_a():
  """The port alone, from the committed export and its own renderer:
  sceneA's held-out trajectory (seed 0, trajectory seed 99) at constant
  motion a frame, 16 frames."""
  cfg, params = tpre.load(scene="sceneA", device="cpu")
  meta = tckpt.load_meta(os.path.join(tpre.ASSETS, "stage3_sceneA"))
  T = 16
  data = tsyn.make_sequence(T, height=int(meta["height"]),
                            width=int(meta["width"]), seed=0, traj_seed=99,
                            duration=T / 48.0, device="cpu")
  res = teval.evaluate_sequence(
      params, cfg, data["images"], data["K"].numpy(),
      gt_poses=data["poses"].numpy(), scene="sceneA",
      ransac_config=transac.RansacConfig(num_hypotheses=256, top_k=512),
      timing_reps=1)
  assert res.report["median_translation_m"] < 0.5, res.report
  assert res.report["median_rotation_deg"] < 8.0, res.report
