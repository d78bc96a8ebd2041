"""The JAX package's pose medians of the full-size shipped stages on the
CPU, over the frames ``chip_smoke.py`` phase "pretrained_full" serves
them on the card: sceneA's held-out trajectory (seed 0, trajectory seed
99) and, for ``outdoor_train``, the protocol table's row (seed 50, world
scale 20, trajectory seed 149), PRE_T frames at 640x480, one frame in
48 of the orbit apart; served by the JAX ``OnlineRelocalizer`` (its
default RANSAC, seed 0). The phase's outdoor gate is twice these
medians.

    JAX_PLATFORMS=cpu python tools_port/jax_full_medians.py \
        [--stages pretrained_full/stage3_outdoor_train,...] [--frames 16]

One process, about a minute a stage; its address space is capped at
``--max_gib`` so that it cannot crowd a shared host. Prints one JSON line
a stage. This script lives outside both packages; it imports JAX only.
"""

from __future__ import annotations

import argparse
import json
import os
import resource
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

STAGES = ("pretrained_full/stage3_sceneA",
          "pretrained_full/stage3_outdoor_train",
          "pretrained_full_nonorm/stage3_sceneA",
          "pretrained_full_nonorm/stage3_outdoor_train")


def medians(stage: str, frames: int) -> dict:
  import numpy as np

  from kfnet_tpu import pretrained
  from kfnet_tpu.data import synthetic
  from kfnet_tpu.eval.online import OnlineRelocalizer
  from kfnet_tpu.pose import metrics
  from kfnet_tpu.tools import protocol

  root, name = os.path.split(os.path.join(ROOT, "artifacts", stage))
  scene = name[len("stage3_"):]
  spec = {s.name: s for s in protocol.DEFAULT_SCENES}[scene]
  seed, scale = spec.seed, spec.scale
  t0 = time.time()
  cfg, params = pretrained.load(root, scene=scene)
  data = synthetic.make_sequence(frames, height=480, width=640, seed=seed,
                                 scale=scale, traj_seed=seed + 99,
                                 duration=frames / 48.0)
  reloc = OnlineRelocalizer(params, cfg, np.asarray(data["K"]), seed=0)
  poses = np.stack([reloc.process(f)[0] for f in data["images"]])
  t_err, r_err = metrics.median_errors(poses, np.asarray(data["poses"]))
  return {"stage": stage, "frames": frames, "norm": cfg.scoordnet.norm,
          "w_scale": cfg.w_scale, "median_translation_m": float(t_err),
          "median_rotation_deg": float(r_err),
          "seconds": round(time.time() - t0, 1)}


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--stages", default=",".join(STAGES))
  p.add_argument("--frames", type=int, default=16)
  p.add_argument("--max_gib", type=float, default=24.0)
  args = p.parse_args(argv)
  cap = int(args.max_gib * 2 ** 30)
  resource.setrlimit(resource.RLIMIT_AS, (cap, cap))
  import jax
  jax.config.update("jax_platforms", "cpu")
  for stage in args.stages.split(","):
    print(json.dumps(medians(stage, args.frames)), flush=True)


if __name__ == "__main__":
  main()
