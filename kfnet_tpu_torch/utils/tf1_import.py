"""TF1 -> port weight import (port of ``kfnet_tpu/utils/tf1_import.py``):
the TF1 variable-name mapping onto the params tree, for parity runs
against the reference's released checkpoints.

The reference ships TF1 checkpoints (per-scene SCoordNet, per-dataset
OFlowNet). TF1 conv kernels are HWIO, as the JAX package's are, so the
mapping is names and shape checks in the JAX package's layouts. The port
keeps its own copy of that mapping and lands in its own layouts through
``convert``: ``import_flat`` takes the port's params as its template, maps
the names onto ``convert.params_to_jax`` of it, and converts back with
``convert.params_from_jax``, each leaf on its template leaf's device and in
its dtype. The concrete variable names are the caffe-tensorflow
convention of this codebase family (``<scope>/<layer>/weights`` /
``biases``) and are PROVISIONAL, as in the JAX package: to be checked
against a real checkpoint reader; the mechanism (``import_flat``) is exact
and tested either way.

Usage:
    flat = dict(np.load("tf1_ckpt_as_npz.npz"))   # name -> np.ndarray
    params, report = import_flat(flat, mapping, params_template)
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from kfnet_tpu_torch import convert


def scoordnet_mapping(num_blocks: int = 14) -> dict:
  """PROVISIONAL name map: TF1 variable name -> param path.

  Assumes the reference-parity architecture: ``norm="none"`` (biased
  convs) and ``stem_s2d=1`` (plain conv stem, so block i is param index i).

  The SCoordNet params are ``[block_0, ..., block_{n-1}, head_block,
  head_conv]`` with each conv block = [conv, (norm), act] sublists.
  The reference trunk convs are expected at ``scoordnet/convN/weights``.
  """
  mapping = {}
  for i in range(num_blocks):
    mapping[f"scoordnet/conv{i+1}/weights"] = (i, 0, "w")
    mapping[f"scoordnet/conv{i+1}/biases"] = (i, 0, "b")
  mapping["scoordnet/head/weights"] = (num_blocks, 0, "w")
  mapping["scoordnet/head/biases"] = (num_blocks, 0, "b")
  mapping["scoordnet/output/weights"] = (num_blocks + 1, "w")
  mapping["scoordnet/output/biases"] = (num_blocks + 1, "b")
  return mapping


def oflownet_mapping(num_encoder: int = 6) -> dict:
  """PROVISIONAL name map for OFlowNet (reference-parity arch:
  ``norm="none"``, ``stem_s2d=1``).

  The OFlowNet params: ``encoder`` = list of conv blocks; U-Net stages
  ``enc0/down1/down2`` = serial of two conv blocks; ``up1/up0`` =
  transpose convs; ``fuse1/fuse0`` = one conv block; ``head`` = plain
  conv. TF1 names follow the same caffe-tensorflow convention as
  :func:`scoordnet_mapping` (``oflownet/<layer>/weights|biases``).
  """
  mapping = {}
  for i in range(num_encoder):
    mapping[f"oflownet/conv{i+1}/weights"] = ("encoder", i, 0, "w")
    mapping[f"oflownet/conv{i+1}/biases"] = ("encoder", i, 0, "b")
  for stage in ("enc0", "down1", "down2"):
    for j in range(2):
      mapping[f"oflownet/{stage}_{j+1}/weights"] = (stage, j, 0, "w")
      mapping[f"oflownet/{stage}_{j+1}/biases"] = (stage, j, 0, "b")
  for stage in ("up1", "up0"):  # deconv upsampling
    mapping[f"oflownet/{stage}/weights"] = (stage, "w")
    mapping[f"oflownet/{stage}/biases"] = (stage, "b")
  for stage in ("fuse1", "fuse0"):  # single conv block: conv at index 0
    mapping[f"oflownet/{stage}/weights"] = (stage, 0, "w")
    mapping[f"oflownet/{stage}/biases"] = (stage, 0, "b")
  mapping["oflownet/flow/weights"] = ("head", "w")
  mapping["oflownet/flow/biases"] = ("head", "b")
  return mapping


def kfnet_mapping(num_blocks: int = 14, num_encoder: int = 6) -> dict:
  """Joint-model map: both subsystem maps re-rooted under the combined
  tree's ``scoordnet``/``oflownet`` keys (the reference's KFNet checkpoint
  holds both subgraphs)."""
  mapping = {}
  for name, path in scoordnet_mapping(num_blocks).items():
    mapping[name] = ("scoordnet",) + path
  for name, path in oflownet_mapping(num_encoder).items():
    mapping[name] = ("oflownet",) + path
  return mapping


def import_scoordnet(flat, template, strict: bool = True):
  """One-call import of a TF1 SCoordNet checkpoint (flat npz dict)."""
  n_blocks = _count_trunk_blocks(template)
  return import_flat(flat, scoordnet_mapping(n_blocks), template,
                     strict=strict)


def import_oflownet(flat, template, strict: bool = True):
  """One-call import of a TF1 OFlowNet checkpoint (flat npz dict)."""
  return import_flat(flat, oflownet_mapping(len(template["encoder"])),
                     template, strict=strict)


def import_kfnet(flat, template, strict: bool = True):
  """One-call import of a TF1 joint-KFNet checkpoint (flat npz dict)."""
  n_blocks = _count_trunk_blocks(template["scoordnet"])
  return import_flat(
      flat,
      kfnet_mapping(n_blocks, len(template["oflownet"]["encoder"])),
      template, strict=strict)


def _count_trunk_blocks(scoordnet_template) -> int:
  """Trunk blocks = total serial entries minus head block + head conv."""
  return len(scoordnet_template) - 2


def _placed_like(template, tree):
  """``tree``'s leaves on the devices and in the dtypes of ``template``'s."""
  if isinstance(template, dict):
    return {k: _placed_like(v, tree[k]) for k, v in template.items()}
  if isinstance(template, (list, tuple)):
    return [_placed_like(t, x) for t, x in zip(template, tree)]
  return tree.to(device=template.device, dtype=template.dtype)


def import_flat(flat: Mapping[str, np.ndarray], mapping: Mapping[str, tuple],
                template, strict: bool = True):
  """Copy TF1 variables into a copy of a params tree.

  Args:
    flat: TF1 variable name -> array (HWIO convolution kernels).
    mapping: TF1 name -> path tuple into the tree (the JAX package's paths).
    template: the port's params tree (its shapes are the contract; the
      template itself is not changed).
    strict: raise on missing names, shape mismatches or unmapped paths.

  Returns:
    (the new params tree in the port's layouts, a report of the imported,
    missing, mismatched and unmapped names).
  """
  out = convert.params_to_jax(template)  # new numpy arrays, HWIO layouts
  imported, missing, mismatched, unmapped = [], [], [], []
  for name, path in mapping.items():
    if name not in flat:
      missing.append(name)
      continue
    src = np.asarray(flat[name])
    node = out
    try:
      for k in path[:-1]:
        node = node[k]
      dst = node[path[-1]]
    except (KeyError, IndexError, TypeError):
      # the variable EXISTS in the checkpoint — the MODEL has no leaf at
      # the mapped path (e.g. a biased-conv mapping applied to a
      # bias-free norm="group" template). Reporting this as "missing"
      # would point the operator at the wrong artifact.
      unmapped.append(f"{name} -> {path} (no such path in template)")
      continue
    if tuple(dst.shape) != tuple(src.shape):
      mismatched.append(f"{name}: ckpt {src.shape} vs model {dst.shape}")
      continue
    node[path[-1]] = src.astype(np.float32)
    imported.append(name)
  if strict and (missing or mismatched or unmapped):
    raise ValueError(
        f"TF1 import failed: missing(ckpt lacks variable)={missing} "
        f"mismatched={mismatched} "
        f"unmapped(model lacks mapped path — wrong net config, e.g. "
        f"norm/stem mismatch)={unmapped}")
  out = _placed_like(template, convert.params_from_jax(out))
  return out, {"imported": imported, "missing": missing,
               "mismatched": mismatched, "unmapped": unmapped}
