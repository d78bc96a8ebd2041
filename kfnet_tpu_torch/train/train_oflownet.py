"""Per-dataset OFlowNet training on consecutive-frame pairs from a dataset
on disk (port of ``kfnet_tpu/train/train_oflownet.py``; the reference's
``OFlowNet/train.py``). Scene-agnostic: pairs come from every scene given.

    python -m kfnet_tpu_torch.train.train_oflownet \\
        --input_folder /data/7scenes --scenes chess,fire,heads \\
        --model_folder /ckpts --device cuda

Writes ``<model_folder>/oflownet_<dataset>/`` (``metrics.jsonl``,
checkpoints, ``export/``).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os

import torch

import kfnet_tpu_torch
from kfnet_tpu_torch.data import pipeline, registry
from kfnet_tpu_torch.models import oflownet
from kfnet_tpu_torch.train import objectives, trainer
from kfnet_tpu_torch.train.train_scoordnet import frame_labels, train_split
from kfnet_tpu_torch.utils import checkpoint as ckpt_lib
from kfnet_tpu_torch.utils import config as config_lib
from kfnet_tpu_torch.utils import logging as log_lib


def make_pair_loaders(exp: config_lib.ExperimentConfig, scenes: list[str],
                      frame_gap: int = 1):
  """Consecutive-frame pair examples across all requested scenes."""
  adapter = registry.get(exp.dataset.name)
  load_fns = []
  for scene in scenes:
    split = train_split(adapter, exp, scene)

    def load_pair(fr_prev, fr_cur, K=split.intrinsics, split=split):
      a = adapter.load_frame_with_split(split, fr_prev)
      b = adapter.load_frame_with_split(split, fr_cur)
      ca, va = frame_labels(exp, K, a)
      cb, vb = frame_labels(exp, K, b)
      return {"image_prev": a["image"], "image": b["image"],
              "coords_prev": ca, "valid_prev": va,
              "coords": cb, "valid": vb}

    for seq_frames in adapter.iter_sequences(split):
      for i in range(len(seq_frames) - frame_gap):
        pair = (seq_frames[i], seq_frames[i + frame_gap])
        # both frames need depth for the warped ground-truth labels;
        # frames without a depth file are for evaluation only
        if not (pair[0].depth_path and pair[1].depth_path):
          continue
        load_fns.append(functools.partial(load_pair, *pair))
  if not load_fns:
    raise ValueError("no frame pairs with depth across the requested "
                     "scenes — cannot build OFlowNet training labels")
  return load_fns


def main(argv=None):
  parser = config_lib.add_common_flags(argparse.ArgumentParser())
  parser.add_argument("--scenes", default="",
                      help="comma-separated; default = the selected "
                           "--dataset's full canonical scene list")
  parser.add_argument("--frame_gap", type=int, default=1)
  parser.add_argument("--flow_reg_weight", type=float, default=0.0)
  args = parser.parse_args(argv)
  exp = config_lib.from_args(args)
  device = kfnet_tpu_torch.resolve_device(exp.device)
  mesh = trainer.default_mesh(exp.batch_size, device)
  scenes = ([s for s in args.scenes.split(",") if s]
            or registry.default_scenes(exp.dataset.name))

  load_fns = make_pair_loaders(exp, scenes, args.frame_gap)
  gen = torch.Generator(device=device).manual_seed(exp.seed)
  params = oflownet.init(gen, exp.oflownet, exp.dataset.image_size + (3,),
                         device)
  loss_fn = objectives.oflownet_objective(
      exp.oflownet, flow_reg_weight=args.flow_reg_weight)

  out_dir = os.path.join(exp.model_folder, f"oflownet_{exp.dataset.name}")
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
  ckpt_lib.export_params(os.path.join(out_dir, "export"), state.params,
                         meta={"dataset": exp.dataset.name,
                               "scenes": scenes})
  logger.log_text(f"done at step {int(state.step)}")
  return state


if __name__ == "__main__":
  main()
