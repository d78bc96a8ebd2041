"""The port's cache manifest (kfnet_tpu_torch/tools/cache_manifest.py) on
the CPU: tests/test_cache_manifest.py's manifest cases (build and verify;
a flipped byte, a missing stage and a corrupt params.npz are each
reported; the protocol's regeneration is bit-deterministic), and the
digest of one params tree through the JAX package's orbax export and
_stage_hash against the port's .npz export and _stage_hash: equal, or the
leaf whose path or dtype differs is named."""

import os

import jax
import ml_dtypes
import numpy as np
import pytest
import torch

from kfnet_tpu.models import kfnet as jkfnet
from kfnet_tpu.tools import cache_manifest as jcache_manifest
from kfnet_tpu.utils import checkpoint as jckpt_lib
from kfnet_tpu_torch.tools import cache_manifest, protocol
from kfnet_tpu_torch.utils import checkpoint as ckpt_lib
from tests import tiny_configs as tc


def _fake_stage(work_dir, name, seed):
  params = {"w": np.full((4, 3), seed, np.float32),
            "b": np.arange(3, dtype=np.float32)}
  ckpt_lib.save_params(os.path.join(work_dir, name), params,
                       meta={"seed": seed})


def test_manifest_write_verify_and_tamper(tmp_path):
  d = str(tmp_path / "cache")
  _fake_stage(d, "stage1_a", 1)
  _fake_stage(d, "stage2_x", 2)
  m = cache_manifest.build_manifest(d)
  assert set(m["stages"]) == {"stage1_a", "stage2_x"}
  assert cache_manifest.verify_manifest(d, m) == []
  # same content elsewhere → same hashes (path-independent)
  d2 = str(tmp_path / "cache2")
  _fake_stage(d2, "stage1_a", 1)
  _fake_stage(d2, "stage2_x", 2)
  assert cache_manifest.build_manifest(d2)["stages"] == m["stages"]
  # one flipped byte of one export file → that stage flagged
  victim = os.path.join(d, "stage2_x", ckpt_lib.PARAMS_FILE)
  with open(victim, "r+b") as f:
    data = bytearray(f.read())
    i = data.index(np.float32(2.0).tobytes())  # inside the "w" array
    data[i] ^= 0xFF
    f.seek(0)
    f.write(bytes(data))
  problems = cache_manifest.verify_manifest(d, m)
  assert len(problems) == 1 and "stage2_x" in problems[0]
  # a missing stage is flagged, twice for a missing cache
  problems = cache_manifest.verify_manifest(str(tmp_path / "cache3"), m)
  assert len(problems) == 2 and all("missing" in p for p in problems)


def test_corrupt_npz_is_reported(tmp_path):
  d = str(tmp_path / "cache")
  _fake_stage(d, "stage1_a", 1)
  m = cache_manifest.build_manifest(d)
  p = os.path.join(d, "stage1_a", ckpt_lib.PARAMS_FILE)
  with open(p, "r+b") as f:
    f.truncate(os.path.getsize(p) // 2)
  problems = cache_manifest.verify_manifest(d, m)
  assert len(problems) == 1 and "unreadable" in problems[0]


def test_main_write_and_verify(tmp_path, capsys):
  d = str(tmp_path / "cache")
  _fake_stage(d, "stage1_a", 1)
  out = str(tmp_path / "manifest.json")
  assert cache_manifest.main(["write", d, "--out", out]) == 0
  assert cache_manifest.main(["verify", d, "--manifest", out]) == 0
  _fake_stage(d, "stage1_a", 2)
  assert cache_manifest.main(["verify", d, "--manifest", out]) == 1
  assert "1 mismatches" in capsys.readouterr().out
  with pytest.raises(SystemExit):
    cache_manifest.main(["verify", d])


@pytest.mark.parametrize("bf16_leaf", [False, True])
def test_digest_equals_jax(tmp_path, bf16_leaf):
  """The same params and meta: JAX's orbax export hashed by JAX, the
  port's .npz export hashed by the port."""
  params = jax.tree_util.tree_map(
      np.asarray, jkfnet.init(jax.random.key(0), tc.tiny_kfnet(), tc.IMG))
  if bf16_leaf:
    params["scoordnet"][7]["b"] = params["scoordnet"][7]["b"].astype(
        ml_dtypes.bfloat16)
  meta = {"scene": "sceneA", "seed": 0, "coord_scale": 0.75,
          "coord_offset": [0.5, -1.0, 2.0]}
  jdir, tdir = str(tmp_path / "jax"), str(tmp_path / "port")
  jckpt_lib.export_params(jdir, params, meta=meta)
  ckpt_lib.save_params(tdir, params, meta=meta)
  jleaves = jax.tree_util.tree_leaves_with_path(
      jckpt_lib.load_params_values(jdir))
  want = [(jax.tree_util.keystr(p), str(np.asarray(v).dtype))
          for p, v in jleaves]
  got = [(p, dt) for p, dt, _ in cache_manifest.stage_leaves(tdir)]
  for (gp, gd), (wp, wd) in zip(got, want):
    assert (gp, gd) == (wp, wd), f"leaf {wp}: {gd} in the port, {wd} in JAX"
  assert len(got) == len(want)
  assert cache_manifest._stage_hash(tdir) == jcache_manifest._stage_hash(jdir)


def test_protocol_regen_is_bit_deterministic(tmp_path):
  """Two identical miniature trainings give bitwise-identical stage
  exports on a fixed host — what makes a kept manifest verifiable after
  regeneration."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  try:
    scenes = tuple(s for s in protocol.DEFAULT_SCENES if s.name == "sceneA")
    kw = dict(H=48, W=64, train_frames=6, test_frames=4, sc_steps=4,
              of_steps=4, joint_steps=2, scenes=scenes,
              log=lambda *a: None, device="cpu")
    manifests = []
    for sub in ("a", "b"):
      d = str(tmp_path / sub)
      protocol.prepare_stages(work_dir=d, **kw)
      manifests.append(cache_manifest.build_manifest(d)["stages"])
  finally:
    torch.set_num_threads(threads)
  assert manifests[0] == manifests[1]
