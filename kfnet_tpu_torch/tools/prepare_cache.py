"""Training-only protocol cache builder, no evaluations (port of
``kfnet_tpu/tools/prepare_cache.py``).

``tools/protocol.py`` regenerates the protocol's stage caches but always
runs the per-scene eval pass at the end. This tool runs ONLY
``protocol.prepare_stages`` — same hyperparameters, same seeds, same
per-stage caching — so cache regeneration costs exactly the training
time, and adds the one ingredient the norm studies need that protocol.py
cannot express: seeding a fresh cache dir with another cache's stage-2
OFlowNet exports.

Copying stage 2 across trunk-norm cache dirs is the PAIRING DISCIPLINE
of the norm studies (``tools/norm_study.py``): OFlowNet never sees the
measurement trunk, so a ``norm="ws"``/``"none"`` cache that reuses the
GroupNorm run's stage-2 weights differs from the GN cache in the
measurement trunk ONLY — any paired delta is attributable to the trunk:

    # 1) GN base (all scenes)
    python -m kfnet_tpu_torch.tools.prepare_cache --full_size \
        --work_dir .protocol_cache/full
    # 2) ws trunk, stage 2 inherited from the GN run
    python -m kfnet_tpu_torch.tools.prepare_cache --full_size \
        --work_dir .protocol_cache/ws_all --scoordnet_norm ws \
        --copy_stage2_from .protocol_cache/full \
        --scenes sceneA,heldout,outdoor,outdoor_train

A stage counts as present where it holds ``params.npz``
(``checkpoint.has_params``). ``--device`` (``cuda`` unless given; raises
without one) is the one flag the JAX tool lacks.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import shutil

import kfnet_tpu_torch
from kfnet_tpu_torch.tools import protocol
from kfnet_tpu_torch.utils import checkpoint as ckpt_lib


def copy_stage2(src_dir: str, dst_dir: str, log=print) -> list[str]:
  """Copy every ``stage2_*`` export from src cache to dst cache.

  Skips stages already present in dst (stage-level resume semantics,
  matching protocol._cached_stage). Returns the copied stage names."""
  copied = []
  os.makedirs(dst_dir, exist_ok=True)
  for name in sorted(os.listdir(src_dir)):
    if not name.startswith("stage2_"):
      continue
    src = os.path.join(src_dir, name)
    dst = os.path.join(dst_dir, name)
    if not ckpt_lib.has_params(src):
      continue
    if ckpt_lib.has_params(dst):
      log(f"copy_stage2: {name} already in {dst_dir}, keeping it")
      continue
    shutil.copytree(src, dst)
    copied.append(name)
    log(f"copy_stage2: {src} -> {dst}")
  if not copied and not any(
      n.startswith("stage2_") for n in os.listdir(dst_dir)):
    raise RuntimeError(
        f"no stage2_* exports found in {src_dir!r} — the source cache "
        "must hold trained OFlowNets before a paired-trunk cache can "
        "inherit them")
  return copied


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--work_dir", required=True,
                 help="per-stage checkpoint dir to build (resumable)")
  p.add_argument("--height", type=int, default=96)
  p.add_argument("--width", type=int, default=128)
  p.add_argument("--train_frames", type=int, default=48)
  p.add_argument("--sc_steps", type=int, default=1200)
  p.add_argument("--of_steps", type=int, default=1000)
  p.add_argument("--joint_steps", type=int, default=None)
  p.add_argument("--learning_rate", type=float, default=2e-3)
  p.add_argument("--seed_offset", type=int, default=0)
  p.add_argument("--scenes", default="",
                 help="comma-separated subset of the default scene set")
  p.add_argument("--scoordnet_norm", default=None,
                 choices=("group", "none", "ws"))
  p.add_argument("--copy_stage2_from", default="",
                 help="seed this cache with another cache's stage2_* "
                      "exports BEFORE training (the norm studies' "
                      "pairing discipline — see module docstring)")
  p.add_argument("--full_size", action="store_true")
  p.add_argument("--device", default=None,
                 help="cuda (the default; raises without one) or cpu")
  args = p.parse_args(argv)
  device = kfnet_tpu_torch.resolve_device(args.device)

  # mirror protocol.main's --full_size overrides EXACTLY: a cache built
  # here must be interchangeable with one built by protocol.py (manifest
  # verification depends on identical hyperparameters).
  joint_steps = 200 if args.joint_steps is None else args.joint_steps
  kw = dict(H=args.height, W=args.width, train_frames=args.train_frames,
            sc_steps=args.sc_steps, of_steps=args.of_steps,
            joint_steps=joint_steps, lr=args.learning_rate,
            work_dir=args.work_dir, scoordnet_norm=args.scoordnet_norm,
            device=device)
  if args.full_size:
    kw.update(H=480, W=640, full_size=True, lr=3e-4,
              sc_steps=max(args.sc_steps, 3000),
              of_steps=max(args.of_steps, 2000),
              joint_steps=(400 if args.joint_steps is None
                           else args.joint_steps))
  scenes = protocol.DEFAULT_SCENES
  if args.seed_offset:
    scenes = tuple(dataclasses.replace(s, seed=s.seed + args.seed_offset)
                   for s in scenes)
  if args.scenes:
    keep = set(args.scenes.split(","))
    unknown = keep - {s.name for s in scenes}
    if unknown:
      raise SystemExit(f"--scenes names unknown scenes: {sorted(unknown)}")
    scenes = tuple(s for s in scenes if s.name in keep)

  if args.copy_stage2_from:
    copy_stage2(args.copy_stage2_from, args.work_dir)

  # test data is not used by training; render the minimum that keeps
  # make_sequence happy so prepare_stages doesn't pay full-size test
  # renders that nothing reads.
  protocol.prepare_stages(scenes=scenes, test_frames=4, **kw)
  print(f"cache ready: {args.work_dir}", flush=True)


if __name__ == "__main__":
  main()
