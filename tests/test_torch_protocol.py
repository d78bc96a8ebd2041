"""The port's protocol rehearsal (kfnet_tpu_torch/tools/protocol.py) on the
CPU, against the JAX package's: the scene data's labels, the stages'
training from JAX's initial weights and data (each stage's loss and
update), the stage cache (its directories and meta schema, the held-out
exclusions, a strict re-run that trains nothing and loads the same
params bit for bit, the strict miss, both norm guards, a norm="none"
cache honoured without the flag — tests/test_protocol_norm_meta.py, fast
here), evaluate_scenes on JAX's trained stages, stress_images, and
main's flags.

Tolerances: the labels as tests/test_torch_synthetic.py holds the
renderer (valid masks equal but for at most 0.1% of cells, coordinates
within 1e-4 where both are valid); the filtered coordinate maps behind
median_coord_err_m and the stages' losses at the goldens' rtol 5e-4 /
atol 5e-5, their updates as test_stages_train_as_jax_from_the_same_start
states; meta fields and row keys exactly. The stress draws come from
another generator than JAX's: same seed, same frames; the flicker within
±3·stress; the noise's σ within 5% of stress over more than 10⁵ pixels.
"""

import argparse
import os
import unittest.mock as mock

import jax
import numpy as np
import pytest
import torch

from kfnet_tpu.eval import eval_sequence as jeval_sequence
from kfnet_tpu.models import oflownet as joflownet
from kfnet_tpu.models import scoordnet as jscoordnet
from kfnet_tpu.tools import protocol as jprotocol
from kfnet_tpu.utils import checkpoint as jckpt
from kfnet_tpu_torch import convert
from kfnet_tpu_torch.eval import eval_sequence
from kfnet_tpu_torch.nn import layers as L
from kfnet_tpu_torch.tools import protocol
from kfnet_tpu_torch.train import trainer
from kfnet_tpu_torch.utils import checkpoint as ckpt_lib
from tests.test_torch_models import port_config

MINI = dict(H=48, W=64, train_frames=6, test_frames=4, sc_steps=1,
            of_steps=1, joint_steps=1, log=None)
SCENES = tuple(s for s in protocol.DEFAULT_SCENES
               if s.name in ("sceneA", "heldout"))
JSCENES = tuple(s for s in jprotocol.DEFAULT_SCENES
                if s.name in ("sceneA", "heldout"))
GOLDEN = dict(rtol=5e-4, atol=5e-5)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def _counting_updates():
  """A patch of the optimizer's update that counts its calls."""
  calls = []
  real = trainer.Adam.update

  def update(self, *a, **kw):
    calls.append(1)
    return real(self, *a, **kw)

  return mock.patch.object(trainer.Adam, "update", update), calls


@pytest.fixture(scope="module")
def caches(tmp_path_factory):
  """Both packages' stage caches of sceneA + heldout at 48x64, the port's
  results of its first and strict second call and its optimizer steps."""
  root = tmp_path_factory.mktemp("protocol")
  jdir, tdir = str(root / "jax"), str(root / "port")
  inits = []  # JAX's initial weights, in the order prepare_stages draws them

  def recorded(real):
    def init(*a, **kw):
      params = real(*a, **kw)
      inits.append(jax.tree_util.tree_map(np.asarray, params))
      return params
    return init

  with mock.patch.object(jscoordnet, "init", recorded(jscoordnet.init)), \
      mock.patch.object(joflownet, "init", recorded(joflownet.init)):
    jout = jprotocol.prepare_stages(work_dir=jdir, scenes=JSCENES, **MINI)
  patch, calls = _counting_updates()
  with patch:
    first = protocol.prepare_stages(work_dir=tdir, scenes=SCENES,
                                    device="cpu", **MINI)
    steps_first = len(calls)
    second = protocol.prepare_stages(work_dir=tdir, scenes=SCENES,
                                     strict_cache=True, device="cpu", **MINI)
  # the port's stages from JAX's initial weights and rendered data
  queue = list(inits)
  jdata = jout[0]
  fdir = str(root / "port_from_jax")
  with mock.patch.object(protocol.scoordnet, "init",
                         lambda *a, **kw: convert.params_from_jax(
                             queue.pop(0))), \
      mock.patch.object(protocol.oflownet, "init",
                        lambda *a, **kw: convert.params_from_jax(
                            queue.pop(0))), \
      mock.patch.object(protocol, "_scene_data",
                        lambda spec, *a, **kw: _to_torch(jdata[spec.name])):
    protocol.prepare_stages(work_dir=fdir, scenes=SCENES, device="cpu",
                            **MINI)
  assert not queue
  return {"jdir": jdir, "tdir": tdir, "jout": jout, "first": first,
          "second": second, "steps": (steps_first, len(calls) - steps_first),
          "jax_inits": inits, "from_jax_dir": fdir}


def test_scene_data_labels_match_jax():
  spec = SCENES[0]
  want = jprotocol._scene_data(JSCENES[0], 48, 64, 6, 4)
  got = protocol._scene_data(spec, 48, 64, 6, 4, device="cpu")
  for c, v in (("coords", "valid"), ("test_coords", "test_valid")):
    gv, wv = got[v].numpy(), np.asarray(want[v])
    assert (gv != wv).mean() <= 1e-3, v
    both = gv & wv
    np.testing.assert_allclose(got[c].numpy()[both],
                               np.asarray(want[c])[both], atol=1e-4)
  for k in ("poses", "K"):
    np.testing.assert_allclose(got["test"][k].numpy(),
                               np.asarray(want["test"][k]), atol=1e-5)


def test_stage_dirs_and_meta_schema_equal_jax(caches):
  jstages, tstages = sorted(os.listdir(caches["jdir"])), sorted(
      os.listdir(caches["tdir"]))
  assert tstages == jstages == ["stage1_heldout", "stage1_sceneA",
                                "stage2_indoor", "stage3_sceneA"]
  for stage in tstages:
    d = os.path.join(caches["tdir"], stage)
    assert ckpt_lib.has_params(d), stage
    tmeta = ckpt_lib.load_meta(d)
    jmeta = ckpt_lib.load_meta(os.path.join(caches["jdir"], stage))
    assert list(tmeta) == list(jmeta), stage
    for k in ("scene", "seed", "height", "width", "full_size",
              "scoordnet_norm", "dataset", "scenes"):
      if k in jmeta:
        assert tmeta[k] == jmeta[k], (stage, k)
    assert np.isfinite(tmeta["final_loss"])


def test_held_out_scene_excluded(caches):
  _, of, ots, joint = caches["first"]
  assert ots == {"indoor": ["sceneA"]}
  meta = ckpt_lib.load_meta(os.path.join(caches["tdir"], "stage2_indoor"))
  assert meta["scenes"] == ["sceneA"]
  assert not os.path.exists(os.path.join(caches["tdir"], "stage3_heldout"))
  # the held-out scene filters with its stage-1 net and the frozen OFlowNet
  assert joint["heldout"][1]["oflownet"] is of["indoor"][1]


def _leaves(tree):
  return [np.asarray(x, np.float32) for x in jax.tree_util.tree_leaves(tree)]


def test_stages_train_as_jax_from_the_same_start(caches):
  """From JAX's initial weights and rendered data, one optimizer step a
  stage: each stage's loss (its meta's final_loss) at the goldens'
  tolerance, so the same rows, pair layout (coords_prev / valid_prev),
  batch and flow regularizer; each stage's update at its learning rate
  (Adam's first step moves a weight by lr where its gradient is not
  noise: the median |update| is lr, and lr x 0.1 in stage 3); and each
  weight's update within the goldens' tolerance of JAX's, but for at most
  0.1% of a stage's weights whose gradient is so near 0 that the two
  frameworks' summation orders give it opposite signs (measured: 26 of
  110852 in heldout's stage 1, none or 1-4 elsewhere), each of those
  within 2 lr."""
  jdir, fdir = caches["jdir"], caches["from_jax_dir"]
  inits = dict(zip(["stage1_sceneA", "stage1_heldout", "stage2_indoor"],
                   caches["jax_inits"]))
  lr = 2e-3  # prepare_stages' default

  def stage_params(root, stage, jax_side):
    d = os.path.join(root, stage)
    return jckpt.load_params(d) if jax_side else \
        ckpt_lib.load_params_values(d)

  def start(root, stage, jax_side):
    if stage in inits:
      return inits[stage]
    return {"oflownet": stage_params(root, "stage2_indoor", jax_side),
            "scoordnet": stage_params(root, "stage1_sceneA", jax_side)}

  for stage, stage_lr in (("stage1_sceneA", lr), ("stage1_heldout", lr),
                          ("stage2_indoor", lr), ("stage3_sceneA", lr * 0.1)):
    tmeta = ckpt_lib.load_meta(os.path.join(fdir, stage))
    jmeta = ckpt_lib.load_meta(os.path.join(jdir, stage))
    np.testing.assert_allclose(tmeta["final_loss"], jmeta["final_loss"],
                               **GOLDEN, err_msg=stage)
    updates = []
    for root, jax_side in ((fdir, False), (jdir, True)):
      after = _leaves(stage_params(root, stage, jax_side))
      before = _leaves(start(root, stage, jax_side))
      assert [a.shape for a in after] == [b.shape for b in before], stage
      updates.append(np.concatenate([(a - b).ravel()
                                     for a, b in zip(after, before)]))
    got, want = updates
    for u in (got, want):
      np.testing.assert_allclose(np.median(np.abs(u)), stage_lr, rtol=1e-3,
                                 err_msg=stage)
    off = np.abs(got - want) > GOLDEN["atol"] + GOLDEN["rtol"] * np.abs(want)
    assert off.mean() <= 1e-3, (stage, int(off.sum()))
    assert np.all(np.abs(got - want) <= 2 * stage_lr + GOLDEN["atol"]), stage


def test_strict_rerun_trains_nothing_and_loads_the_same_params(caches):
  steps_first, steps_second = caches["steps"]
  assert steps_first == MINI["sc_steps"] * 2 + MINI["of_steps"] + \
      MINI["joint_steps"]
  assert steps_second == 0
  a, b = caches["first"][3], caches["second"][3]
  for name in ("sceneA", "heldout"):
    assert a[name][0] == b[name][0]
    la, lb = L.tree_leaves(a[name][1]), L.tree_leaves(b[name][1])
    assert len(la) == len(lb)
    assert all(torch.equal(x, y) for x, y in zip(la, lb)), name


def test_strict_run_reads_the_jax_packages_cache(caches):
  """The JAX package's orbax stage cache, read by the port's strict run:
  no optimizer step, and each scene's joint params those JAX trained
  (bit for bit, in the port's layouts)."""
  patch, calls = _counting_updates()
  with patch:
    got = protocol.prepare_stages(work_dir=caches["jdir"], scenes=SCENES,
                                  strict_cache=True, device="cpu", **MINI)
  assert not calls
  jjoint = caches["jout"][3]
  for name in ("sceneA", "heldout"):
    want = convert.params_from_jax(jax.tree_util.tree_map(
        np.asarray, jjoint[name][1]))
    lg, lw = L.tree_leaves(got[3][name][1]), L.tree_leaves(want)
    assert len(lg) == len(lw)
    assert all(torch.equal(a, b) for a, b in zip(lg, lw)), name


def test_strict_cache_raises_on_a_miss(tmp_path):
  with pytest.raises(RuntimeError, match="not cached"):
    protocol.prepare_stages(work_dir=str(tmp_path), scenes=SCENES[:1],
                            strict_cache=True, device="cpu", **MINI)


def test_norm_guards(caches, tmp_path):
  # an explicit norm other than the cache's: refused
  with pytest.raises(RuntimeError, match="trained with norm='group'"):
    protocol.prepare_stages(work_dir=caches["tdir"], scenes=SCENES[:1],
                            strict_cache=True, scoordnet_norm="none",
                            device="cpu", **MINI)
  # a stage 3 whose norm is not its stage 1's: refused
  d = str(tmp_path / "mixed")
  for stage in ("stage1_sceneA", "stage2_indoor", "stage3_sceneA"):
    src = os.path.join(caches["tdir"], stage)
    os.makedirs(os.path.join(d, stage))
    for f in os.listdir(src):
      with open(os.path.join(src, f), "rb") as a, \
          open(os.path.join(d, stage, f), "wb") as b:
        b.write(a.read())
  meta = ckpt_lib.load_meta(os.path.join(d, "stage3_sceneA"))
  ckpt_lib.save_meta(os.path.join(d, "stage3_sceneA"),
                     dict(meta, scoordnet_norm="none"))
  with pytest.raises(RuntimeError, match="mixes trunks"):
    protocol.prepare_stages(work_dir=d, scenes=SCENES[:1], strict_cache=True,
                            device="cpu", **MINI)


def test_nonorm_cache_is_honoured_without_the_flag(tmp_path):
  d = str(tmp_path / "nonorm")
  protocol.prepare_stages(work_dir=d, scenes=SCENES[:1],
                          scoordnet_norm="none", device="cpu", **MINI)
  *_, joint = protocol.prepare_stages(work_dir=d, scenes=SCENES[:1],
                                      strict_cache=True,
                                      scoordnet_norm="none", device="cpu",
                                      **MINI)
  assert joint["sceneA"][0].scoordnet.norm == "none"
  *_, joint = protocol.prepare_stages(work_dir=d, scenes=SCENES[:1],
                                      strict_cache=True, device="cpu",
                                      **MINI)
  assert joint["sceneA"][0].scoordnet.norm == "none"
  with pytest.raises(RuntimeError, match="trained with norm='none'"):
    protocol.prepare_stages(work_dir=d, scenes=SCENES[:1], strict_cache=True,
                            scoordnet_norm="group", device="cpu", **MINI)


def _to_torch(tree):
  if isinstance(tree, dict):
    return {k: _to_torch(v) for k, v in tree.items()}
  if isinstance(tree, (jax.Array, np.ndarray)):
    return torch.from_numpy(np.array(tree))
  return tree


def _capturing(module):
  """Patch ``module.coord_accuracy_report`` to keep each call's coords."""
  seen = []
  real = module.coord_accuracy_report

  def report(coords, *a, **kw):
    seen.append(np.asarray(coords))
    return real(coords, *a, **kw)

  return mock.patch.object(module, "coord_accuracy_report", report), seen


def test_evaluate_scenes_on_jax_stages(caches):
  """JAX's trained stages and rendered data, carried across: the rows'
  keys in JAX's order, and the filtered maps within the goldens'
  tolerance."""
  jdata, jof, jots, jjoint = caches["jout"]
  data = {k: _to_torch(v) for k, v in jdata.items()}
  of = {k: (c, None, loss) for k, (c, _, loss) in jof.items()}
  joint = {k: (port_config(c), convert.params_from_jax(
      jax.tree_util.tree_map(np.asarray, p))) for k, (c, p) in jjoint.items()}
  jpatch, jmaps = _capturing(jeval_sequence)
  with jpatch:
    want = jprotocol.evaluate_scenes(jdata, jof, jots, jjoint,
                                     scenes=JSCENES, log=None)
  tpatch, tmaps = _capturing(eval_sequence)
  with tpatch:
    got = protocol.evaluate_scenes(data, of, jots, joint, scenes=SCENES,
                                   log=None)
  assert [list(r) for r in got] == [list(r) for r in want]
  for g, w in zip(got, want):
    for k in ("scene", "dataset", "held_out", "world_scale",
              "oflownet_trained_on", "chi2_threshold", "w_scale",
              "adaptive_alpha_max", "frames", "stress"):
      assert g[k] == w[k], k
    assert np.isfinite(g["median_translation_m"])
  assert len(tmaps) == len(jmaps) == len(SCENES)
  for g, w in zip(tmaps, jmaps):
    np.testing.assert_allclose(g, w, **GOLDEN)


def test_stress_images():
  rng = np.random.default_rng(0)
  imgs = torch.from_numpy(rng.uniform(0.3, 0.7, (4, 160, 160, 3))
                          .astype(np.float32))
  before = imgs.clone()
  stress = 0.02
  a = protocol.stress_images(imgs, stress, seed=5)
  b = protocol.stress_images(imgs, stress, seed=5)
  c = protocol.stress_images(imgs, stress, seed=6)
  assert torch.equal(a, b) and not torch.equal(a, c)
  assert torch.equal(imgs, before)          # the stream given is untouched
  assert a.shape == imgs.shape and a.dtype == torch.float32
  assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
  d = (a - imgs).reshape(4, -1)             # inputs in [0.3, 0.7]: no clip
  flicker = d.mean(dim=1)
  assert float(flicker.abs().max()) <= 3 * stress + 1e-3
  noise = d - flicker[:, None]
  assert noise.numel() > 1e5
  assert abs(float(noise.std()) / stress - 1.0) <= 0.05


def _flags(main_fn, argv):
  """The parser's option strings and defaults, and the parse of argv, as
  ``main_fn`` builds them (parse_args patched to stop there)."""
  seen = {}
  real = argparse.ArgumentParser.parse_args

  def stop(self, args=None, namespace=None):
    seen["options"] = {a.option_strings[0]: a.default for a in self._actions
                       if a.option_strings and a.dest != "help"}
    seen["args"] = vars(real(self, args, namespace))
    raise StopIteration

  with mock.patch.object(argparse.ArgumentParser, "parse_args", stop):
    with pytest.raises(StopIteration):
      main_fn(argv)
  return seen


def test_main_flags_equal_jax():
  argv = ["--fast", "--scenes", "sceneA,heldout", "--work_dir", "w"]
  want = _flags(jprotocol.main, argv)
  got = _flags(protocol.main, argv + ["--device", "cpu"])
  assert set(got["options"]) - set(want["options"]) == {"--device"}
  assert {k: v for k, v in got["options"].items() if k != "--device"} == \
      want["options"]
  assert {k: v for k, v in got["args"].items() if k != "device"} == \
      want["args"]


def test_main_fast_passes_jax_settings():
  """main(["--fast", ...]) hands run_protocol the JAX tool's settings."""
  argv = ["--fast", "--scenes", "sceneA", "--stress", "0.05"]
  kws = []
  with mock.patch.object(jprotocol, "run_protocol",
                         lambda **kw: kws.append(kw) or []):
    jprotocol.main(argv)
  with mock.patch.object(protocol, "run_protocol",
                         lambda **kw: kws.append(kw) or []):
    protocol.main(argv + ["--device", "cpu"])
  want, got = kws
  assert got.pop("device") == torch.device("cpu")
  assert [s.name for s in got.pop("scenes")] == [
      s.name for s in want.pop("scenes")]
  assert got == want
