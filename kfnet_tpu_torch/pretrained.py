"""The shipped pretrained weights (port of ``kfnet_tpu/pretrained.py``):

    from kfnet_tpu_torch import pretrained
    cfg, params = pretrained.load()                 # on cuda
    xs, Ps, _ = filter.sequence.run_filter(params, cfg, images)

The port reads the JAX package's orbax exports under ``artifacts/``
without orbax (``utils/checkpoint.py``, ``utils/ocdbt.py``), and its own
``.npz`` exports. ``ASSETS`` is the synthetic-scene set, exported once to
``kfnet_tpu_torch/assets/pretrained_synthetic`` by
``tools_port/export_pretrained_npz.py`` (the ``.npz`` path's fixture; a
test holds every leaf equal to the orbax one). The full-size 640x480
releases are read straight from the repo's ``artifacts/``:
``FULL_ASSETS`` (``artifacts/pretrained_full``: GroupNorm trunks) and
``FULL_NONORM_ASSETS`` (``artifacts/pretrained_full_nonorm``: the
reference-parity ``norm="none"`` trunks, served at their calibrated
``serving_w_scale`` 2), each with ``stage3_sceneA`` and
``stage3_outdoor_train``: ``load(FULL_NONORM_ASSETS, "outdoor_train")``.
Each stage carries its ``meta.json`` (scene, resolution, coordinate
normalisation, trunk norm, serving point), from which the config is
built. The JAX package's layouts become the port's in
``convert.params_from_jax`` only.
"""

from __future__ import annotations

import dataclasses
import os

import torch

import kfnet_tpu_torch
from kfnet_tpu_torch import configs, convert
from kfnet_tpu_torch.models import kfnet, oflownet, scoordnet
from kfnet_tpu_torch.utils import checkpoint as ckpt_lib

_HERE = os.path.dirname(os.path.abspath(__file__))
ASSETS = os.path.join(_HERE, "assets", "pretrained_synthetic")
_ARTIFACTS = os.path.join(os.path.dirname(_HERE), "artifacts")
# the full-size releases (a 23.6M-parameter SCoordNet and its OFlowNet,
# 640x480), stored as bf16 and read back into float32 master weights;
# stage3_sceneA of FULL_ASSETS is the flagship
FULL_ASSETS = os.path.join(_ARTIFACTS, "pretrained_full")
FULL_NONORM_ASSETS = os.path.join(_ARTIFACTS, "pretrained_full_nonorm")


def _scoordnet_config(meta) -> scoordnet.SCoordNetConfig:
  fn = (configs.full_scoordnet if meta.get("full_size")
        else configs.small_scoordnet)
  cfg = fn(tuple(meta["coord_offset"]), float(meta["coord_scale"]))
  # exports written before meta carried the field were all GroupNorm
  # trunks: a missing field means "group", not the current default
  return dataclasses.replace(cfg, norm=meta.get("scoordnet_norm", "group"))


def _oflownet_config(meta) -> oflownet.OFlowNetConfig:
  return (configs.full_oflownet() if meta.get("full_size")
          else configs.small_oflownet())


def _apply_serving(cfg: kfnet.KFNetConfig, meta) -> kfnet.KFNetConfig:
  """The serving point the export's meta records (``serving_w_scale``,
  ``serving_chi2_threshold``), else the config's defaults."""
  kw = {}
  if meta.get("serving_w_scale") is not None:
    kw["w_scale"] = float(meta["serving_w_scale"])
  if meta.get("serving_chi2_threshold") is not None:
    kw["chi2_threshold"] = float(meta["serving_chi2_threshold"])
  return dataclasses.replace(cfg, **kw) if kw else cfg


def _structure(tree):
  if isinstance(tree, dict):
    return {k: _structure(tree[k]) for k in sorted(tree)}
  if isinstance(tree, (list, tuple)):
    return [_structure(v) for v in tree]
  return "*"


def _leaves_with_path(tree, path=""):
  if isinstance(tree, dict):
    return [x for k in sorted(tree)
            for x in _leaves_with_path(tree[k], f"{path}/{k}")]
  if isinstance(tree, (list, tuple)):
    return [x for i, v in enumerate(tree)
            for x in _leaves_with_path(v, f"{path}/{i}")]
  return [(path, tree)]


def _load_params_cast(path: str, template, device):
  """The export at ``path`` in the port's layouts on ``device``, each leaf
  cast to its template leaf's dtype (a bf16 export's ``params_dtype``
  included); raises unless its tree and shapes are the template's."""
  raw = convert.params_from_jax(ckpt_lib.load_params_values(path))
  ref, got = _structure(template), _structure(raw)
  if ref != got:
    raise ValueError(f"release export at {path} does not match the "
                     f"config's param structure:\n saved: {got}\n "
                     f"want:  {ref}")
  # the same tree with other shapes is an export of another geometry,
  # which would otherwise fail much later inside a conv
  bad = [f"  {kp}: saved {tuple(x.shape)}, want {tuple(t.shape)}"
         for (kp, t), (_, x) in zip(_leaves_with_path(template),
                                    _leaves_with_path(raw))
         if tuple(t.shape) != tuple(x.shape)]
  if bad:
    raise ValueError(
        f"release export at {path} does not match the config's param "
        "shapes (wrong-geometry export?):\n" + "\n".join(bad[:8]) +
        ("" if len(bad) <= 8 else f"\n  … and {len(bad) - 8} more"))
  return _cast(template, raw, device)


def _cast(template, tree, device):
  """``tree``'s leaves on ``device`` in the dtypes of ``template``'s."""
  if isinstance(template, dict):
    return {k: _cast(v, tree[k], device) for k, v in template.items()}
  if isinstance(template, (list, tuple)):
    return [_cast(t, x, device) for t, x in zip(template, tree)]
  return tree.to(device=device, dtype=template.dtype)


def _template(cfg: kfnet.KFNetConfig, meta):
  """The params' shapes and dtypes for ``cfg`` at the export's frame size,
  from the nets' own ``init`` on the meta device (no weights)."""
  shape = (int(meta["height"]), int(meta["width"]), 3)
  gen = torch.Generator()
  return {"scoordnet": scoordnet.init(gen, cfg.scoordnet, shape, "meta"),
          "oflownet": oflownet.init(gen, cfg.oflownet, shape, "meta")}


def _meta(stage: str) -> dict:
  meta = ckpt_lib.load_meta(stage)
  if not meta or "coord_scale" not in meta:
    raise ValueError(f"{stage}: export has no self-describing meta")
  return meta


def _config(meta) -> kfnet.KFNetConfig:
  return _apply_serving(
      kfnet.KFNetConfig(scoordnet=_scoordnet_config(meta),
                        oflownet=_oflownet_config(meta)), meta)


def load(root: str = ASSETS, scene: str = "sceneA", device=None):
  """(KFNetConfig, params on ``device``) from an export directory: the
  joint fine-tuned ``stage3_<scene>`` when there is one, else
  ``load_stage12``. ``device``: ``cuda`` unless given."""
  device = kfnet_tpu_torch.resolve_device(device)
  stage3 = os.path.join(root, f"stage3_{scene}")
  if not ckpt_lib.has_params(stage3):
    return load_stage12(root, scene, device)
  meta = _meta(stage3)
  cfg = _config(meta)
  return cfg, _load_params_cast(stage3, _template(cfg, meta), device)


def load_stage12(root: str = ASSETS, scene: str = "sceneA", device=None):
  """``stage1_<scene>`` (SCoordNet) with the ``stage2_*`` OFlowNet whose
  meta lists the scene (else the last one by name): the pair before the
  joint fine-tune."""
  device = kfnet_tpu_torch.resolve_device(device)
  stage1 = os.path.join(root, f"stage1_{scene}")
  if not ckpt_lib.has_params(stage1):
    raise FileNotFoundError(
        f"no stage3_{scene} or stage1_{scene} export under {root!r}")
  meta1 = _meta(stage1)
  stage2 = None
  for name in sorted(os.listdir(root)):
    if name.startswith("stage2_") and ckpt_lib.has_params(
        os.path.join(root, name)):
      stage2 = os.path.join(root, name)
      if scene in (ckpt_lib.load_meta(stage2) or {}).get("scenes", []):
        break  # the OFlowNet trained on this scene's dataset
  if stage2 is None:
    raise FileNotFoundError(f"no stage2_* export under {root!r}")
  cfg = _config(meta1)
  template = _template(cfg, meta1)
  return cfg, {
      "scoordnet": _load_params_cast(stage1, template["scoordnet"], device),
      "oflownet": _load_params_cast(stage2, template["oflownet"], device),
  }
