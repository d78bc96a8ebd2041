"""Per-scene SCoordNet training from a dataset on disk (port of
``kfnet_tpu/train/train_scoordnet.py``; the reference's
``SCoordNet/train.py``):

    python -m kfnet_tpu_torch.train.train_scoordnet \\
        --input_folder /data/7scenes --scene chess \\
        --model_folder /ckpts --device cuda

Frames decode on the host (the port's PNG codec), labels come from depth
and the ground-truth pose, and the batches go to the device, where
``trainer.fit`` trains on one device, or data-parallel over the visible
GPUs that divide the batch (``--device cuda``; ``trainer.default_mesh``,
as in each train script). Writes
``<model_folder>/scoordnet_<scene>/``: ``meta.json`` (the scene's
coordinate normalisation), ``metrics.jsonl``, a checkpoint a step
directory, and the release ``export/`` (``params.npz`` in the JAX
package's layouts + ``meta.json``). The first use builds the port's host
data library (``data/csrc``).
"""

from __future__ import annotations

import argparse
import dataclasses
import functools
import os

import numpy as np
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch.data import labels, pipeline, registry
from kfnet_tpu_torch.data import seven_scenes as s7
from kfnet_tpu_torch.models import scoordnet
from kfnet_tpu_torch.train import objectives, trainer
from kfnet_tpu_torch.utils import checkpoint as ckpt_lib
from kfnet_tpu_torch.utils import config as config_lib
from kfnet_tpu_torch.utils import logging as log_lib


def frame_labels(exp: config_lib.ExperimentConfig, K, example: dict):
  """(coords (h, w, 3), valid (h, w)) numpy labels of a loaded frame, made
  on the host from its depth and pose."""
  c, v = labels.generate(
      torch.from_numpy(np.ascontiguousarray(example["depth"])),
      torch.from_numpy(np.asarray(K, np.float32)),
      torch.from_numpy(np.asarray(example["pose"], np.float32)),
      stride=exp.dataset.stride, min_depth=exp.dataset.min_depth,
      max_depth=exp.dataset.max_depth)
  return c.numpy(), v.numpy()


def train_split(adapter, exp: config_lib.ExperimentConfig, scene: str):
  """The scene's train split; Cambridge derives its own intrinsics."""
  if adapter.name == "cambridge":
    return adapter.load_split(exp.input_folder, scene, "train")
  return adapter.load_split(exp.input_folder, scene, "train",
                            intrinsics=exp.dataset.intrinsics)


def make_scene_loader(exp: config_lib.ExperimentConfig):
  """Returns (load_fns, scene_stats, native_meta) for per-frame SCoordNet
  examples; ``native_meta`` is None, or a function giving the batch
  loader's arguments where every train frame is a PNG pair."""
  adapter = registry.get(exp.dataset.name)
  split = train_split(adapter, exp, exp.scene)
  K = split.intrinsics

  # labels come from depth and pose: frames without a depth file are for
  # evaluation only
  train_frames = [fr for fr in split.frames if fr.depth_path]
  if not train_frames:
    raise ValueError(f"scene {exp.scene}: no frames with depth — cannot "
                     "generate coordinate labels for training")

  def load(frame):
    ex = adapter.load_frame_with_split(split, frame)
    return {"image": ex["image"], "depth": ex["depth"], "pose": ex["pose"]}

  # pass 1 (up to 200 frames, evenly spaced): the scene coordinates'
  # statistics for the net's normalisation
  sample = train_frames[::max(1, len(train_frames) // 200)]
  cs, vs = [], []
  img_hw = exp.dataset.image_size
  for fr in sample[:200]:
    ex = load(fr)
    img_hw = tuple(np.asarray(ex["image"]).shape[:2])
    c, v = frame_labels(exp, K, ex)
    cs.append(c)
    vs.append(v)
  mean, std = labels.scene_statistics(cs, vs)

  def load_with_labels(frame):
    ex = load(frame)
    c, v = frame_labels(exp, K, ex)
    return {"image": ex["image"], "coords": c, "valid": v}

  load_fns = [functools.partial(load_with_labels, fr) for fr in train_frames]

  # the batch loader reads PNG pairs at their size on disk: not Cambridge
  # (resized on load) nor JPEG colour (12-Scenes); its poses are read only
  # when it is taken
  native_meta = None
  native_ok = adapter.name != "cambridge" and all(
      fr.color_path.endswith(".png") and fr.depth_path.endswith(".png")
      for fr in train_frames)
  if native_ok:
    def native_meta():
      return {
          "color_paths": [fr.color_path for fr in train_frames],
          "depth_paths": [fr.depth_path for fr in train_frames],
          "poses": np.stack([s7.read_pose(fr.pose_path)
                             for fr in train_frames]),
          "K": np.asarray(K, np.float32),
          "image_size": img_hw,  # the frames' size on disk
          "stride": exp.dataset.stride,
          "depth_scale": exp.dataset.depth_scale,
          "min_depth": exp.dataset.min_depth,
          "max_depth": exp.dataset.max_depth,
      }
  return load_fns, (mean, std), native_meta


def main(argv=None):
  parser = config_lib.add_common_flags(argparse.ArgumentParser())
  parser.add_argument("--no_native_loader", action="store_true",
                      help="load frame by frame in Python instead of the "
                           "C++ batch loader (both decode with the port's "
                           "host library)")
  args = parser.parse_args(argv)
  exp = config_lib.from_args(args)
  device = kfnet_tpu_torch.resolve_device(exp.device)
  mesh = trainer.default_mesh(exp.batch_size, device)

  load_fns, (mean, std), native_meta = make_scene_loader(exp)
  net_cfg = dataclasses.replace(
      exp.scoordnet, coord_offset=tuple(float(x) for x in mean),
      coord_scale=float(std))
  gen = torch.Generator(device=device).manual_seed(exp.seed)
  params = scoordnet.init(gen, net_cfg, exp.dataset.image_size + (3,),
                          device)
  loss_fn = objectives.scoordnet_objective(net_cfg)

  out_dir = os.path.join(exp.model_folder, f"scoordnet_{exp.scene}")
  logger = log_lib.MetricLogger(
      jsonl_path=os.path.join(out_dir, "metrics.jsonl"),
      tensorboard_dir=os.path.join(out_dir, "tb"))
  # the normalisation first, so that any checkpoint in out_dir (of an
  # interrupted run too) restores with the net's config
  meta = {"scene": exp.scene,
          "coord_offset": [float(x) for x in mean],
          "coord_scale": float(std)}
  ckpt_lib.save_meta(out_dir, meta)
  loop = dataclasses.replace(exp.loop, checkpoint_dir=out_dir)
  # no crop by default, so that the pixel grid is evaluation's; K steps a
  # call stack K host batches, so those stay on the host
  to_device = loop.steps_per_dispatch <= 1
  aug = pipeline.AugmentConfig(crop=None)
  if native_meta and not args.no_native_loader:
    logger.log_text("using native batch loader (kfn_load_batch)")
    batches = pipeline.batched_native(
        batch_size=exp.batch_size, seed=exp.seed, augment=aug,
        to_device=to_device, device=device, **native_meta())
  else:
    batches = pipeline.batched(
        load_fns, exp.batch_size, seed=exp.seed, augment=aug,
        to_device=to_device, device=device)
  state = trainer.fit(loss_fn, params, batches,
                      optimizer_cfg=exp.optimizer, loop_cfg=loop,
                      mesh=mesh, logger=logger, device=device)
  ckpt_lib.export_params(os.path.join(out_dir, "export"), state.params, meta)
  logger.log_text(f"done at step {int(state.step)}; "
                  f"coord normalization mean={mean.tolist()} std={std}")
  return state


if __name__ == "__main__":
  main()
