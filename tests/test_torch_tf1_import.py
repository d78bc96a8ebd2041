"""The port's TF1 weight import (kfnet_tpu_torch/utils/tf1_import.py): the
cases of tests/test_tf1_import.py, each held against the JAX package's
import of the same fabricated flat dict (TF1 names, HWIO kernels): the
port's result equal to convert.params_from_jax of the JAX result, leaf for
leaf, and the same report. Plus the full-width reference-parity
architecture imported by the three one-call helpers in the port, and a
filter step of the imported joint model finite."""

import dataclasses

import jax
import numpy as np
import pytest
import torch

from kfnet_tpu.models import oflownet as joflow
from kfnet_tpu.models import scoordnet as jscoord
from kfnet_tpu.utils import tf1_import as jtf1
from kfnet_tpu_torch import convert
from kfnet_tpu_torch.models import kfnet as tkfnet
from kfnet_tpu_torch.models import oflownet as toflow
from kfnet_tpu_torch.models import scoordnet as tscoord
from kfnet_tpu_torch.nn import layers as L
from kfnet_tpu_torch.utils import tf1_import
from tests import tiny_configs as tc


def _port(tree):
  return convert.params_from_jax(jax.tree_util.tree_map(np.asarray, tree))


def _equal(got, want_jax):
  want = L.tree_leaves(_port(want_jax))
  got = L.tree_leaves(got)
  assert len(got) == len(want)
  for a, b in zip(got, want):
    assert a.shape == b.shape and torch.equal(a, b)


def _fabricate_flat(mapping, template, seed=0):
  """A TF1-style flat checkpoint, shapes read off a JAX template."""
  rng = np.random.default_rng(seed)
  flat = {}
  for name, path in mapping.items():
    node = template
    for k in path[:-1]:
      node = node[k]
    flat[name] = (rng.normal(size=np.asarray(node[path[-1]]).shape)
                  .astype(np.float32) * 0.05)
  return flat


def tiny_noname_cfg():
  return dataclasses.replace(tc.tiny_scoordnet(), norm="none", stem_s2d=1)


@pytest.fixture(scope="module")
def scoord():
  jp = jscoord.init(jax.random.key(0), tiny_noname_cfg(), tc.IMG)
  return jp, _port(jp)


def test_mappings_equal_jax():
  assert tf1_import.scoordnet_mapping(6) == jtf1.scoordnet_mapping(6)
  assert tf1_import.oflownet_mapping(3) == jtf1.oflownet_mapping(3)
  assert tf1_import.kfnet_mapping(14, 6) == jtf1.kfnet_mapping(14, 6)


def test_import_flat_roundtrip(scoord):
  jp, tp = scoord
  mapping = tf1_import.scoordnet_mapping(num_blocks=6)
  flat = _fabricate_flat(mapping, jp)
  out, report = tf1_import.import_flat(flat, mapping, tp)
  jout, jreport = jtf1.import_flat(flat, mapping, jp)
  assert report == jreport
  assert not report["missing"] and not report["mismatched"]
  _equal(out, jout)
  # the HWIO kernel landed as the port's (out, in, kh, kw)
  np.testing.assert_array_equal(
      out[0][0]["w"].numpy(),
      flat["scoordnet/conv1/weights"].transpose(3, 2, 0, 1))
  # the template is untouched
  assert not np.array_equal(tp[0][0]["w"].numpy(),
                            out[0][0]["w"].numpy())
  # each leaf keeps its template leaf's device and dtype
  for a, b in zip(L.tree_leaves(out), L.tree_leaves(tp)):
    assert a.dtype == b.dtype and a.device == b.device


def test_import_flat_strict_errors(scoord):
  jp, tp = scoord
  mapping = tf1_import.scoordnet_mapping(num_blocks=6)
  for mod, tmpl in ((tf1_import, tp), (jtf1, jp)):
    with pytest.raises(ValueError, match="missing"):
      mod.import_flat({}, mapping, tmpl)
    flat = {"scoordnet/conv1/weights": np.zeros((1, 1, 1, 1), np.float32)}
    with pytest.raises(ValueError, match="mismatched"):
      mod.import_flat(flat, {"scoordnet/conv1/weights": (0, 0, "w")}, tmpl)


def test_import_oflownet_tiny_roundtrip():
  cfg = dataclasses.replace(tc.tiny_oflownet(), norm="none", stem_s2d=1)
  jp = joflow.init(jax.random.key(0), cfg, tc.IMG)
  mapping = tf1_import.oflownet_mapping(len(cfg.encoder_channels))
  flat = _fabricate_flat(mapping, jp)
  out, rep = tf1_import.import_oflownet(flat, _port(jp))
  jout, jrep = jtf1.import_oflownet(flat, jp)
  assert rep == jrep and not rep["missing"] and not rep["mismatched"]
  _equal(out, jout)
  np.testing.assert_array_equal(out["head"]["b"].numpy(),
                                flat["oflownet/flow/biases"])
  # a transposed conv (up0, up1) lands flipped as the port stores it
  np.testing.assert_array_equal(
      out["up0"]["w"].numpy(),
      flat["oflownet/up0/weights"][::-1, ::-1].transpose(2, 3, 0, 1))


def test_import_flat_unmapped_path_reported_separately():
  """A checkpoint variable whose mapped path the template lacks (a biased
  conv's mapping on a bias-free net) is 'unmapped', not 'missing'."""
  jparams = {"a": [{"w": np.zeros((2, 2), np.float32)}]}
  tparams = {"a": [{"w": torch.zeros(2, 2)}]}
  mapping = {"x/w": ("a", 0, "w"), "x/b": ("a", 0, "b")}
  flat = {"x/w": np.ones((2, 2), np.float32),
          "x/b": np.ones((2,), np.float32)}
  with pytest.raises(ValueError, match="unmapped"):
    tf1_import.import_flat(flat, mapping, tparams)
  out, rep = tf1_import.import_flat(flat, mapping, tparams, strict=False)
  _, jrep = jtf1.import_flat(flat, mapping, jparams, strict=False)
  assert rep == jrep
  assert rep["unmapped"] and not rep["missing"] and not rep["mismatched"]
  assert rep["imported"] == ["x/w"]
  np.testing.assert_array_equal(out["a"][0]["w"].numpy(), flat["x/w"])


def test_import_full_parity_arch_end_to_end():
  """The full-width reference-parity architecture (norm "none", stem_s2d
  1, float32): a fabricated TF1 checkpoint imported by the three one-call
  helpers; the joint import equals the two subsystem imports, every
  mapped leaf changed, and one filter step of the imported model is
  finite with a positive covariance."""
  cfg = tkfnet.KFNetConfig(
      scoordnet=dataclasses.replace(tscoord.SCoordNetConfig(), norm="none",
                                    stem_s2d=1, compute_dtype="float32"),
      oflownet=dataclasses.replace(toflow.OFlowNetConfig(), norm="none",
                                   stem_s2d=1, compute_dtype="float32"),
      use_fused_kernel=False)
  img_shape = (48, 64, 3)
  params = tkfnet.init(0, cfg, img_shape, "cpu")
  jtemplate = convert.params_to_jax(params)
  mapping = tf1_import.kfnet_mapping(len(cfg.scoordnet.channels),
                                     len(cfg.oflownet.encoder_channels))
  flat = _fabricate_flat(mapping, jtemplate)
  sc, rep = tf1_import.import_scoordnet(flat, params["scoordnet"])
  assert not rep["missing"] and not rep["mismatched"]
  of, rep = tf1_import.import_oflownet(flat, params["oflownet"])
  assert not rep["missing"] and not rep["mismatched"]
  joint, rep = tf1_import.import_kfnet(flat, params)
  assert not rep["missing"] and not rep["mismatched"]
  for a, b in zip(L.tree_leaves({"scoordnet": sc, "oflownet": of}),
                  L.tree_leaves(joint)):
    assert torch.equal(a, b)
  changed = sum(not torch.equal(a, b) for a, b in
                zip(L.tree_leaves(params), L.tree_leaves(joint)))
  assert changed == len(flat)
  rng = np.random.default_rng(1)
  imgs = torch.from_numpy(rng.uniform(0, 1, (2,) + img_shape).astype(
      np.float32))
  with torch.no_grad():
    x0, P0, f0 = tkfnet.first_step(joint, cfg, imgs[0])
    x1, P1, _, _ = tkfnet.filter_step(joint, cfg, x0, P0, f0, imgs[1])
  assert torch.isfinite(x1).all() and (P1 > 0).all()
