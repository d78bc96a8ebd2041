"""The port's release export (kfnet_tpu_torch/tools/export_release.py) on
the CPU: a train script's export cast to bf16 (torch's round to nearest
even) and read back by pretrained.load equals a bf16 rounding of the
source, leaf for leaf; the meta carries params_dtype,
release_source_stage and the serving point, which pretrained.load applies;
the bf16 bits equal the JAX package's ml_dtypes cast of the same values;
the float32 form is the source exactly; a stage without meta is refused."""

import json
import os

import ml_dtypes
import numpy as np
import pytest
import torch

from kfnet_tpu_torch import configs, pretrained
from kfnet_tpu_torch.models import kfnet
from kfnet_tpu_torch.nn import layers as L
from kfnet_tpu_torch.tools import export_release
from kfnet_tpu_torch.utils import checkpoint as ckpt_lib


@pytest.fixture(scope="module")
def stage(tmp_path_factory):
  """A small-config stage export, as a train script writes it, with the
  self-describing meta pretrained.load needs."""
  src = tmp_path_factory.mktemp("src")
  cfg = kfnet.KFNetConfig(scoordnet=configs.small_scoordnet((0.5, -1.0, 2.0),
                                                            1.5),
                          oflownet=configs.small_oflownet())
  params = kfnet.init(0, cfg, (96, 128, 3), "cpu")
  meta = {"scene": "sceneA", "height": 96, "width": 128,
          "coord_offset": [0.5, -1.0, 2.0], "coord_scale": 1.5,
          "scoordnet_norm": "group"}
  ckpt_lib.export_params(str(src / "stage3_sceneA"), params, meta=meta)
  return str(src), cfg, params


def test_bf16_release_reads_back_as_a_rounding_of_the_source(stage,
                                                             tmp_path):
  src, cfg, params = stage
  out = tmp_path / "rel" / "stage3_sceneA"
  export_release.main(["--src", src, "--stage", "stage3_sceneA", "--out",
                       str(out), "--serving_w_scale", "2.0",
                       "--serving_chi2_threshold", "5.5"])
  meta = ckpt_lib.load_meta(str(out))
  assert meta["params_dtype"] == "bfloat16"
  assert meta["release_source_stage"] == "stage3_sceneA"
  assert meta["serving_w_scale"] == 2.0
  assert meta["serving_chi2_threshold"] == 5.5
  with np.load(out / "params.npz") as f:
    tree = json.loads(str(f["__tree__"]))
    assert all(a.dtype == np.uint16 for k, a in f.items() if k != "__tree__")
  assert '"dtype": "bfloat16"' in json.dumps(tree)
  rcfg, rparams = pretrained.load(str(tmp_path / "rel"), device="cpu")
  assert rcfg.w_scale == 2.0 and rcfg.chi2_threshold == 5.5
  assert rcfg.scoordnet.coord_scale == 1.5
  for got, want in zip(L.tree_leaves(rparams), L.tree_leaves(params)):
    assert got.dtype == want.dtype
    assert torch.equal(got, want.to(torch.bfloat16).to(want.dtype))


def test_bf16_bits_equal_ml_dtypes(stage, tmp_path):
  """torch's cast and the JAX tool's ml_dtypes cast give the same bits."""
  src, _, _ = stage
  out = tmp_path / "rel"
  export_release.main(["--src", src, "--stage", "stage3_sceneA", "--out",
                       str(out)])
  values = ckpt_lib.load_params_values(os.path.join(src, "stage3_sceneA"))
  with np.load(out / "params.npz") as f:
    for key in f.files:
      if key == "__tree__":
        continue
      node = values
      for part in key.split("/"):
        node = node[int(part)] if isinstance(node, list) else node[part]
      want = np.asarray(node, np.float32).astype(ml_dtypes.bfloat16)
      np.testing.assert_array_equal(f[key], want.view(np.uint16))


def test_float32_release_is_the_source(stage, tmp_path):
  src, _, params = stage
  out = tmp_path / "rel" / "stage3_sceneA"
  export_release.main(["--src", src, "--stage", "stage3_sceneA", "--out",
                       str(out), "--dtype", "float32"])
  assert ckpt_lib.load_meta(str(out))["params_dtype"] == "float32"
  _, rparams = pretrained.load(str(tmp_path / "rel"), device="cpu")
  for got, want in zip(L.tree_leaves(rparams), L.tree_leaves(params)):
    assert torch.equal(got, want)


def test_stage_without_meta_is_refused(tmp_path):
  ckpt_lib.save_params(str(tmp_path / "s"), {"w": np.zeros(2, np.float32)})
  with pytest.raises(FileNotFoundError, match="no meta.json"):
    export_release.main(["--src", str(tmp_path), "--stage", "s", "--out",
                         str(tmp_path / "o")])
