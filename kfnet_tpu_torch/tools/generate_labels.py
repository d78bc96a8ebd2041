"""Offline coordinate-map label generation CLI (port of
``kfnet_tpu/tools/generate_labels.py``; the reference's label step): depth
+ GT pose → per-frame .npz label blobs + a scene-statistics file.

    python -m kfnet_tpu_torch.tools.generate_labels \
        --input_folder /data/7scenes --scene chess --split train \
        --output_folder /labels/chess [--device cuda]

Uses the port's C++ fused decode+label path (``data/native_io.py``) where
the host library builds and the dataset is not Cambridge, else
``data/labels.generate`` on ``--device`` (``cuda`` unless given; raises
without one), the one flag the JAX tool lacks.
"""

from __future__ import annotations

import argparse
import json
import os

import numpy as np
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch.data import labels, native_io, registry
from kfnet_tpu_torch.data import seven_scenes as s7
from kfnet_tpu_torch.utils import config as config_lib


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--input_folder", required=True)
  p.add_argument("--output_folder", required=True)
  p.add_argument("--dataset", default="7scenes", choices=sorted(
      config_lib.PRESETS))
  p.add_argument("--scene", default="chess")
  p.add_argument("--split", default="train", choices=("train", "test"))
  p.add_argument("--stride", type=int, default=8)
  p.add_argument("--device", default=None,
                 help="cuda (the default; raises without one) or cpu")
  args = p.parse_args(argv)
  device = kfnet_tpu_torch.resolve_device(args.device)
  preset = config_lib.PRESETS[args.dataset]

  # Dispatch through the dataset registry like the train/eval CLIs —
  # Cambridge has its own disk layout (dataset_*.txt + poses in the
  # split file, depth resized to the working resolution), which the
  # 7-Scenes loader cannot read.
  adapter = registry.get(args.dataset)
  if adapter.name == "cambridge":
    split = adapter.load_split(args.input_folder, args.scene, args.split)
  else:
    split = adapter.load_split(args.input_folder, args.scene, args.split,
                               intrinsics=preset.intrinsics)
  K = split.intrinsics
  os.makedirs(args.output_folder, exist_ok=True)
  # The native fused decode+label path reads the depth FILE at its
  # on-disk resolution — correct for 7/12-Scenes; Cambridge depth must
  # go through the adapter (resize to the working res the intrinsics
  # describe), so it always takes the generic path.
  use_native = native_io.available() and adapter.name != "cambridge"
  K_dev = torch.as_tensor(np.asarray(K, np.float32), device=device)
  all_c, all_v = [], []
  n = 0
  for fr in split.frames:
    if fr.depth_path is None:
      continue
    if use_native:
      pose = s7.read_pose(fr.pose_path)
      c, v = native_io.depth_png_to_labels(
          fr.depth_path, K, pose, stride=args.stride,
          depth_scale=preset.depth_scale, min_depth=preset.min_depth,
          max_depth=preset.max_depth)
    else:
      ex = adapter.load_frame_with_split(split, fr)
      c, v = labels.generate(
          torch.as_tensor(np.asarray(ex["depth"], np.float32),
                          device=device), K_dev,
          torch.as_tensor(np.asarray(ex["pose"], np.float32),
                          device=device),
          stride=args.stride, min_depth=preset.min_depth,
          max_depth=preset.max_depth)
      c, v = c.cpu().numpy(), v.cpu().numpy()
    labels.save(os.path.join(args.output_folder, fr.seq,
                             f"frame-{fr.index:06d}.npz"), c, v)
    all_c.append(c)
    all_v.append(v)
    n += 1
  mean, std = labels.scene_statistics(all_c, all_v)
  stats = {"scene": args.scene, "split": args.split, "frames": n,
           "coord_mean": mean.tolist(), "coord_std": std,
           "native_path": use_native}
  with open(os.path.join(args.output_folder, "stats.json"), "w") as f:
    json.dump(stats, f, indent=2)
  print(json.dumps(stats))
  return stats


if __name__ == "__main__":
  main()
