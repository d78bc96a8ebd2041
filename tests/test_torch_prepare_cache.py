"""The port's training-only cache builder
(kfnet_tpu_torch/tools/prepare_cache.py) on the CPU:
tests/test_prepare_cache.py's cases (a paired-trunk cache inherits the
base cache's stage-2 OFlowNet value for value, trains only its own trunk,
and strict-loads as the trunk it was trained with; a re-copy is a no-op;
an empty source is refused) and the flags against the JAX tool's."""

import os

import numpy as np
import pytest
import torch

from kfnet_tpu.tools import prepare_cache as jprepare_cache
from kfnet_tpu_torch.nn import layers as L
from kfnet_tpu_torch.tools import prepare_cache, protocol
from kfnet_tpu_torch.utils import checkpoint as ckpt_lib
from tests.test_torch_protocol import _flags

MINI = ["--height", "48", "--width", "64", "--train_frames", "6",
        "--sc_steps", "2", "--of_steps", "2", "--joint_steps", "1",
        "--device", "cpu"]
MINI_KW = dict(H=48, W=64, train_frames=6, test_frames=4, sc_steps=2,
               of_steps=2, joint_steps=1, log=lambda *a: None, device="cpu")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


def test_prepare_cache_pairs_trunks_and_strict_loads(tmp_path):
  base = str(tmp_path / "base")
  prepare_cache.main(["--work_dir", base, "--scenes", "sceneA,heldout",
                      *MINI])
  for stage in ("stage1_sceneA", "stage1_heldout", "stage2_indoor",
                "stage3_sceneA"):
    assert ckpt_lib.has_params(os.path.join(base, stage)), stage

  ws = str(tmp_path / "ws")
  prepare_cache.main(["--work_dir", ws, "--scenes", "sceneA",
                      "--scoordnet_norm", "ws",
                      "--copy_stage2_from", base, *MINI])

  # stage 2 is the base cache's weights, value for value
  src = ckpt_lib.load_params_values(os.path.join(base, "stage2_indoor"))
  dst = ckpt_lib.load_params_values(os.path.join(ws, "stage2_indoor"))
  la, lb = L.tree_leaves(src), L.tree_leaves(dst)
  assert len(la) == len(lb)
  for a, b in zip(la, lb):
    np.testing.assert_array_equal(a, b)

  # the ws cache strict-loads as the trunk it was trained with
  scenes = tuple(s for s in protocol.DEFAULT_SCENES if s.name == "sceneA")
  *_, joint = protocol.prepare_stages(work_dir=ws, scenes=scenes,
                                      strict_cache=True,
                                      scoordnet_norm="ws", **MINI_KW)
  assert joint["sceneA"][0].scoordnet.norm == "ws"

  # re-copy is a no-op (stage-level resume), not an overwrite
  copied = prepare_cache.copy_stage2(base, ws, log=lambda *a: None)
  assert copied == []


def test_copy_stage2_requires_a_trained_source(tmp_path):
  empty = str(tmp_path / "empty")
  os.makedirs(empty)
  with pytest.raises(RuntimeError, match="no stage2"):
    prepare_cache.copy_stage2(empty, str(tmp_path / "dst"),
                              log=lambda *a: None)


def test_unknown_scene_is_refused(tmp_path):
  with pytest.raises(SystemExit, match="unknown scenes"):
    prepare_cache.main(["--work_dir", str(tmp_path), "--scenes", "nowhere",
                        *MINI])


def test_flags_equal_jax():
  argv = ["--work_dir", "w", "--full_size", "--scoordnet_norm", "none"]
  want = _flags(jprepare_cache.main, argv)
  got = _flags(prepare_cache.main, argv + ["--device", "cpu"])
  assert set(got["options"]) - set(want["options"]) == {"--device"}
  assert {k: v for k, v in got["args"].items() if k != "device"} == \
      want["args"]
