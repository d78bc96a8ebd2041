"""The port's three train scripts (kfnet_tpu_torch/train/train_scoordnet.py,
train_oflownet.py, train_kfnet.py) on a small fixture the port wrote, on
the CPU at --net_scale tiny, and their loaders against the JAX package's.

Held: the step counts, metrics.jsonl, the checkpoints and exports (with
the coordinate normalisation in meta.json); the scene statistics against
JAX's make_scene_loader at rtol 1e-6 (float64 sums of float32 labels made
by two frameworks); the first batch's loss under the JAX-initialised
weights carried across by ``convert`` at the goldens' rtol 5e-4 / atol
5e-5, the loss tolerance the port's objective tests hold against JAX
(tests/test_torch_train.py); a batch split over several GPUs trains
(over a CPU mesh here).
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfnet_tpu.data import pipeline as jpipe
from kfnet_tpu.models import kfnet as jkfnet
from kfnet_tpu.models import oflownet as joflow
from kfnet_tpu.models import scoordnet as jscoord
from kfnet_tpu.train import objectives as jobj
from kfnet_tpu.train import train_kfnet as jtk
from kfnet_tpu.train import train_oflownet as jto
from kfnet_tpu.train import train_scoordnet as jts
from kfnet_tpu.utils import config as jconfig
from kfnet_tpu_torch import convert
from kfnet_tpu_torch.data import fixture, pipeline as tpipe
from kfnet_tpu_torch.models import kfnet as tkfnet
from kfnet_tpu_torch.nn import layers as L
from kfnet_tpu_torch.train import objectives as tobj
from kfnet_tpu_torch.train import train_kfnet as ttk
from kfnet_tpu_torch.train import train_oflownet as tto
from kfnet_tpu_torch.train import train_scoordnet as tts
from kfnet_tpu_torch.train import trainer as ttrainer
from kfnet_tpu_torch.utils import checkpoint as tckpt
from kfnet_tpu_torch.utils import config as tconfig

GOLDEN = dict(rtol=5e-4, atol=5e-5)


@pytest.fixture(scope="module")
def data_root(tmp_path_factory):
  root = str(tmp_path_factory.mktemp("fixture"))
  fixture.write_seven_scenes_fixture(root, train_frames=6, test_frames=2,
                                     height=48, width=64, device="cpu")
  return root


def flags(root, model_folder, *extra):
  return ["--input_folder", root, "--scene", "chess",
          "--model_folder", str(model_folder), "--net_scale", "tiny",
          "--batch_size", "2", "--device", "cpu", *extra]


@pytest.fixture(scope="module")
def trained(data_root, tmp_path_factory):
  """The three stages in order, each from the one before."""
  models = tmp_path_factory.mktemp("models")
  states = {
      "scoordnet": tts.main(flags(data_root, models, "--max_steps", "3")),
      "oflownet": tto.main(flags(data_root, models, "--scenes", "chess",
                                 "--max_steps", "2")),
  }
  states["kfnet"] = ttk.main(flags(
      data_root, models, "--max_steps", "2", "--window_size", "3",
      "--remat", "--scoordnet_ckpt", str(models / "scoordnet_chess"),
      "--oflownet_ckpt", str(models / "oflownet_7scenes")))
  return models, states


@pytest.mark.parametrize("stage,out,steps", [
    ("scoordnet", "scoordnet_chess", 3), ("oflownet", "oflownet_7scenes", 2),
    ("kfnet", "kfnet_chess", 2)])
def test_cli_writes_its_tree(trained, stage, out, steps):
  models, states = trained
  assert states[stage].step == steps
  assert states[stage].opt_state.count == steps
  out_dir = models / out
  assert (out_dir / "metrics.jsonl").exists()
  assert tckpt.Checkpointer(str(out_dir)).latest_step() == steps
  export = str(out_dir / "export")
  assert tckpt.has_params(export)
  meta = tckpt.load_meta(export)
  if stage == "oflownet":
    assert meta == {"dataset": "7scenes", "scenes": ["chess"]}
  else:
    assert len(meta["coord_offset"]) == 3 and meta["coord_scale"] > 0
  # the export is the trained params in the JAX package's layouts
  saved = convert.params_from_jax(tckpt.load_params_values(export))
  for a, b in zip(L.tree_leaves(saved), L.tree_leaves(states[stage].params)):
    assert torch.equal(a, b.to(a.dtype))
  assert all(torch.isfinite(p).all()
             for p in L.tree_leaves(states[stage].params))


def test_scoordnet_meta_is_written_first_and_read_by_kfnet(trained):
  models, states = trained
  meta = tckpt.load_meta(str(models / "scoordnet_chess"))
  assert meta["scene"] == "chess"
  exp, _ = _exps("/unused")
  cfg, params = ttk.load_pretrained(
      exp, (48, 64, 3), str(models / "scoordnet_chess"),
      str(models / "oflownet_7scenes"), device="cpu")
  assert list(cfg.scoordnet.coord_offset) == meta["coord_offset"]
  assert cfg.scoordnet.coord_scale == meta["coord_scale"]
  for a, b in zip(L.tree_leaves(params["oflownet"]),
                  L.tree_leaves(states["oflownet"].params)):
    assert torch.equal(a, b)


def test_native_and_python_loaders_train_alike(data_root, tmp_path):
  """--no_native_loader takes the per-frame path: the same shuffle, the
  same batches up to label rounding, so the same trained params."""
  a = tts.main(flags(data_root, tmp_path / "a", "--max_steps", "2"))
  b = tts.main(flags(data_root, tmp_path / "b", "--max_steps", "2",
                     "--no_native_loader"))
  for x, y in zip(L.tree_leaves(a.params), L.tree_leaves(b.params)):
    torch.testing.assert_close(x, y, rtol=1e-4, atol=1e-5)


def _exps(root):
  import argparse
  argv = flags(root, "/unused")
  t = tconfig.from_args(tconfig.add_common_flags(
      argparse.ArgumentParser()).parse_args(argv))
  j = jconfig.from_args(jconfig.add_common_flags(
      argparse.ArgumentParser()).parse_args(argv[:-2]))
  return t, j


def test_scene_statistics_equal_jax(data_root):
  texp, jexp = _exps(data_root)
  _, (tm, ts), tnat = tts.make_scene_loader(texp)
  _, (jm, js), jnat = jts.make_scene_loader(jexp)
  np.testing.assert_allclose(tm, jm, rtol=1e-6)
  np.testing.assert_allclose(ts, js, rtol=1e-6)
  t, j = tnat(), jnat()
  assert sorted(t) == sorted(j)
  for k in t:
    np.testing.assert_array_equal(np.asarray(t[k]), np.asarray(j[k]),
                                  err_msg=k)


def _first(batches):
  b = next(batches)
  batches.close()
  return b


@pytest.mark.parametrize("stage", ["scoordnet", "oflownet", "kfnet_window"])
def test_first_batch_loss_equals_jax(data_root, stage):
  texp, jexp = _exps(data_root)
  key = jax.random.key(3)
  if stage == "scoordnet":
    tfns, (mean, std), _ = tts.make_scene_loader(texp)
    jfns, _, _ = jts.make_scene_loader(jexp)
    norm = dict(coord_offset=tuple(float(x) for x in mean),
                coord_scale=float(std))
    jcfg = dataclasses.replace(jexp.scoordnet, **norm)
    tcfg = dataclasses.replace(texp.scoordnet, **norm)
    jp = jscoord.init(key, jcfg, (48, 64, 3))
    jloss, tloss = (jobj.scoordnet_objective(jcfg),
                    tobj.scoordnet_objective(tcfg))
  elif stage == "oflownet":
    tfns = tto.make_pair_loaders(texp, ["chess"])
    jfns = jto.make_pair_loaders(jexp, ["chess"])
    jp = joflow.init(key, jexp.oflownet, (48, 64, 3))
    jloss = jobj.oflownet_objective(jexp.oflownet)
    tloss = tobj.oflownet_objective(texp.oflownet)
  else:
    tfns = ttk.make_window_loaders(texp, ["chess"], 3)
    jfns = jtk.make_window_loaders(jexp, ["chess"], 3)
    jcfg = jkfnet.KFNetConfig(scoordnet=jexp.scoordnet,
                              oflownet=jexp.oflownet)
    tcfg = tkfnet.KFNetConfig(scoordnet=texp.scoordnet,
                              oflownet=texp.oflownet)
    jp = jkfnet.init(key, jcfg, (48, 64, 3))
    jloss = jobj.kfnet_window_objective(jcfg)
    tloss = tobj.kfnet_window_objective(tcfg)
  assert len(tfns) == len(jfns)
  tb = _first(tpipe.batched(tfns, 2, seed=0, to_device=True, device="cpu"))
  jb = _first(jpipe.batched(jfns, 2, seed=0, to_device=False))
  for k in jb:
    np.testing.assert_allclose(tb[k].numpy(), jb[k], rtol=1e-5, atol=1e-5,
                               err_msg=k)
  want, _ = jax.jit(jloss)(jp, {k: jnp.asarray(v) for k, v in jb.items()})
  got, _ = tloss(convert.params_from_jax(
      jax.tree_util.tree_map(np.asarray, jp)), tb)
  np.testing.assert_allclose(float(got), float(want), **GOLDEN)


def test_window_loaders_skip_depthless_frames(tmp_path):
  """BPTT windows touching a frame without depth are skipped, as pairs
  are (the JAX package's tests/test_data.py case, on the port's Cambridge
  fixture)."""
  import glob

  from kfnet_tpu_torch import configs
  fixture.write_cambridge_fixture(str(tmp_path), train_frames=6,
                                  test_frames=2, device="cpu")
  exp = configs.get("cambridge", "KingsCollege", input_folder=str(tmp_path))
  fns = ttk.make_window_loaders(exp, ["KingsCollege"], window=3)
  assert len(fns) == 4
  ex = fns[0]()
  assert ex["images"].shape == (3, 272, 480, 3)
  assert ex["coords"].shape == (3, 34, 60, 3)
  depths = sorted(glob.glob(
      os.path.join(str(tmp_path), "KingsCollege", "seq1", "*.depth.png")))
  os.remove(depths[2])
  assert len(ttk.make_window_loaders(exp, ["KingsCollege"], window=3)) == 1
  for d in depths[:2] + depths[3:]:
    os.remove(d)
  with pytest.raises(ValueError, match="windows with depth"):
    ttk.make_window_loaders(exp, ["KingsCollege"], window=3)


def test_pairs_objective_runs_the_composition(data_root, tmp_path):
  """--window_size 2 trains pairs on the composition (the pair objective
  needs the prior, which the fused kernel does not return)."""
  state = ttk.main(flags(data_root, tmp_path, "--max_steps", "1"))
  assert state.step == 1


def test_a_batch_split_over_several_gpus_raises(tmp_path, monkeypatch):
  """The JAX package's multi-scene data-parallel case
  (tests/test_train_cli.py:49): batch 8 over 8 devices. Data parallelism
  is ported now, so the split trains rather than raising: with eight
  GPUs visible, each script asks ``trainer.default_mesh`` for a mesh of
  eight (given here over the CPU); a device given with its index, the
  CPU and one GPU train on one device."""
  from kfnet_tpu_torch.parallel import mesh as tmesh
  monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
  assert ttrainer.default_mesh(8, "cuda").size == 8
  assert ttrainer.default_mesh(8, "cuda:0") is None
  assert ttrainer.default_mesh(8, "cpu") is None
  monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
  assert ttrainer.default_mesh(8, "cuda") is None
  root = str(tmp_path / "data")
  fixture.write_seven_scenes_fixture(root, train_frames=10, test_frames=2,
                                     height=48, width=64, device="cpu")
  meshes = []

  def eight_entries(batch_size, device):
    meshes.append((batch_size, str(device)))
    return tmesh.Mesh(["cpu"] * 8)

  monkeypatch.setattr(ttrainer, "default_mesh", eight_entries)
  models = str(tmp_path / "models")
  argv = ["--input_folder", root, "--scenes", "chess",
          "--model_folder", models, "--net_scale", "tiny",
          "--batch_size", "8", "--max_steps", "2", "--device", "cpu"]
  states = [tto.main(argv), tts.main(argv[:2] + ["--scene", "chess"]
                                     + argv[4:])]
  states.append(ttk.main(argv[:2] + ["--scene", "chess"] + argv[4:] + [
      "--window_size", "3", "--scoordnet_ckpt", f"{models}/scoordnet_chess",
      "--oflownet_ckpt", f"{models}/oflownet_7scenes"]))
  assert meshes == [(8, "cpu")] * 3
  for s in states:
    assert s.step == s.opt_state.count == 2
