"""Joint KFNet fine-tune from a dataset on disk (port of
``kfnet_tpu/train/train_kfnet.py``; the reference's ``KFNet/train.py``):
loads the stage-1 SCoordNet (per scene) and stage-2 OFlowNet (per
dataset) exports the port's train scripts wrote, and trains the posterior
NLL through both nets.

    python -m kfnet_tpu_torch.train.train_kfnet \\
        --input_folder /data/7scenes --scene chess \\
        --scoordnet_ckpt /ckpts/scoordnet_chess \\
        --oflownet_ckpt /ckpts/oflownet_7scenes \\
        --model_folder /ckpts --window_size 4 --remat --device cuda

``--window_size`` above 2 trains T-frame windows by BPTT
(``kfnet_window_objective``) with the fused update kernel in every filter
step's forward (``--remat`` launches it again in the recompute); 2 trains
pairs (``kfnet_objective``) on the warp and update composition, which
alone returns the prior that objective needs.
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os

import numpy as np

import kfnet_tpu_torch
from kfnet_tpu_torch import pretrained
from kfnet_tpu_torch.data import pipeline, registry
from kfnet_tpu_torch.models import kfnet
from kfnet_tpu_torch.train import objectives, trainer
from kfnet_tpu_torch.train.train_oflownet import make_pair_loaders
from kfnet_tpu_torch.train.train_scoordnet import frame_labels, train_split
from kfnet_tpu_torch.utils import checkpoint as ckpt_lib
from kfnet_tpu_torch.utils import config as config_lib
from kfnet_tpu_torch.utils import logging as log_lib


def _export_dir(path: str) -> str:
  """A stage's export: ``path`` itself, or the ``export/`` a train script
  wrote under it."""
  for p in (path, os.path.join(path, "export")):
    if ckpt_lib.has_params(p):
      return p
  raise FileNotFoundError(f"no params.npz in {path!r} or its export/")


def load_pretrained(exp: config_lib.ExperimentConfig, image_shape,
                    scoordnet_ckpt: str | None, oflownet_ckpt: str | None,
                    seed: int = 0, device=None):
  """(KFNetConfig, params on ``device``): weights drawn from ``seed``,
  each net's then replaced by its stage export where one is given.

  The SCoordNet output directory's ``meta.json`` (train_scoordnet writes
  it first) carries the scene's coordinate normalisation, which goes back
  into the config, so that the restored net gives metric coordinates.
  """
  device = kfnet_tpu_torch.resolve_device(device)
  scfg = exp.scoordnet
  if scoordnet_ckpt:
    meta = ckpt_lib.load_meta(scoordnet_ckpt)
    if meta and "coord_scale" in meta:
      scfg = dataclasses.replace(
          scfg, coord_offset=tuple(float(x) for x in meta["coord_offset"]),
          coord_scale=float(meta["coord_scale"]))
  cfg = kfnet.KFNetConfig(scoordnet=scfg, oflownet=exp.oflownet)
  params = kfnet.init(seed, cfg, image_shape, device)
  for name, path in (("scoordnet", scoordnet_ckpt),
                     ("oflownet", oflownet_ckpt)):
    if path:
      params[name] = pretrained._load_params_cast(
          _export_dir(path), params[name], device)
  return cfg, params


def make_window_loaders(exp: config_lib.ExperimentConfig, scenes,
                        window: int):
  """T-frame sliding-window examples for the BPTT objective
  (images (T, H, W, 3), coords / valid (T, h, w[, 3]) per example)."""
  adapter = registry.get(exp.dataset.name)
  load_fns = []
  for scene in scenes:
    split = train_split(adapter, exp, scene)

    def load_window(frames, K=split.intrinsics, split=split):
      exs = [adapter.load_frame_with_split(split, fr) for fr in frames]
      cs, vs = zip(*[frame_labels(exp, K, e) for e in exs])
      return {"images": np.stack([e["image"] for e in exs]),
              "coords": np.stack(cs), "valid": np.stack(vs)}

    for seq_frames in adapter.iter_sequences(split):
      for i in range(len(seq_frames) - window + 1):
        win = seq_frames[i:i + window]
        # every frame needs depth for its labels: windows touching a
        # frame without depth are skipped, as pairs are
        if not all(fr.depth_path for fr in win):
          continue
        load_fns.append(functools.partial(load_window, win))
  if not load_fns:
    raise ValueError(
        f"no {window}-frame windows with depth on every frame across "
        "the requested scenes — cannot build BPTT training labels")
  return load_fns


def main(argv=None):
  parser = config_lib.add_common_flags(argparse.ArgumentParser())
  parser.add_argument("--scoordnet_ckpt", default="")
  parser.add_argument("--oflownet_ckpt", default="")
  parser.add_argument("--posterior_weight", type=float, default=1.0)
  parser.add_argument("--measurement_weight", type=float, default=0.5)
  parser.add_argument("--prior_weight", type=float, default=0.5)
  parser.add_argument("--window_size", type=int, default=2,
                      help=">2 trains the T-frame BPTT window objective "
                           "(kfnet_window_objective) instead of the "
                           "2-frame pair objective")
  parser.add_argument("--remat", action="store_true",
                      help="recompute each filter step in the backward "
                           "(torch.utils.checkpoint): activation memory "
                           "flat in window_size, at about 1.3x the step's "
                           "work; for long windows at full resolution")
  args = parser.parse_args(argv)
  exp = config_lib.from_args(args)
  device = kfnet_tpu_torch.resolve_device(exp.device)
  mesh = trainer.default_mesh(exp.batch_size, device)

  image_shape = exp.dataset.image_size + (3,)
  cfg, params = load_pretrained(
      exp, image_shape, args.scoordnet_ckpt or None,
      args.oflownet_ckpt or None, seed=exp.seed, device=device)
  weights = objectives.JointLossWeights(
      posterior=args.posterior_weight,
      measurement=args.measurement_weight,
      prior=args.prior_weight)
  if args.window_size > 2:
    loss_fn = objectives.kfnet_window_objective(cfg, weights,
                                                remat=args.remat)
    load_fns = make_window_loaders(exp, [exp.scene], args.window_size)
  else:
    loss_fn = objectives.kfnet_objective(
        dataclasses.replace(cfg, use_fused_kernel=False), weights)
    load_fns = make_pair_loaders(exp, [exp.scene])
  out_dir = os.path.join(exp.model_folder, f"kfnet_{exp.scene}")
  logger = log_lib.MetricLogger(
      jsonl_path=os.path.join(out_dir, "metrics.jsonl"),
      tensorboard_dir=os.path.join(out_dir, "tb"))
  loop = dataclasses.replace(exp.loop, checkpoint_dir=out_dir)
  # K steps a call stack K host batches, so those stay on the host
  batches = pipeline.batched(load_fns, exp.batch_size, seed=exp.seed,
                             to_device=loop.steps_per_dispatch <= 1,
                             device=device)
  state = trainer.fit(loss_fn, params, batches,
                      optimizer_cfg=exp.optimizer, loop_cfg=loop,
                      mesh=mesh, logger=logger, device=device)
  ckpt_lib.export_params(
      os.path.join(out_dir, "export"), state.params,
      meta={"scene": exp.scene,
            "coord_offset": list(cfg.scoordnet.coord_offset),
            "coord_scale": float(cfg.scoordnet.coord_scale)})
  logger.log_text(f"done at step {int(state.step)}")
  return state


if __name__ == "__main__":
  main()
