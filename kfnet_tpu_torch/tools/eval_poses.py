"""Offline pose evaluation from dumped coordinate maps (port of
``kfnet_tpu/tools/eval_poses.py``; the reference's ``tools/`` pose-eval
scripts: load the fused coordinate map and its uncertainty, solve PnP with
RANSAC, report the per-scene median translation and rotation).

Reads a dump directory written by ``eval/main.py --dump_dir`` (one ``.npz``
a frame with coords / covariance / pose / pose_gt, and a ``meta.json`` with
the intrinsics and the stride), solves a pose per frame again with the
batched PnP-RANSAC on the device, and writes the per-sequence median
report. This separates the pose solve from the nets, as the reference
workflow does: sweep RANSAC settings offline without running the filter
again.

    python -m kfnet_tpu_torch.eval.main ... --dump_dir /tmp/dump
    python -m kfnet_tpu_torch.tools.eval_poses --dump_dir /tmp/dump \\
        --pnp_solver p3p --inlier_threshold_px 5 --report poses.json

The hypotheses are drawn from one ``torch.Generator`` seeded with
``--seed`` (the JAX tool splits a key a frame), as ``eval.main``'s batch
eval draws them: with the same seed, solver settings and device, the poses
of a dump are ``eval.main``'s. ``--device`` (``cuda`` unless given) is the
port's own flag.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch.eval import eval_sequence
from kfnet_tpu_torch.pose import metrics as pose_metrics
from kfnet_tpu_torch.pose import ransac, smoothing


def load_dump_sequence(seq_dir: str, keys: tuple[str, ...] | None = None):
  """One sequence's dumped frames, sorted by frame index: a dict of stacked
  arrays, coords (T, h, w, 3), covariance (T, h, w, 1), pose (T, 4, 4),
  pose_gt (T, 4, 4) or None.

  keys: only these (e.g. ("pose", "pose_gt") for a pose-only pass such as
  smoothing): inflating the coordinate and covariance blobs of a
  1000-frame dump costs tens of MB that a pose pass does not need.
  """
  files = sorted(glob.glob(os.path.join(seq_dir, "frame-*.npz")))
  if not files:
    raise FileNotFoundError(f"no frame-*.npz dumps in {seq_dir}")
  frames = []
  for f in files:
    # copy the arrays and close each file at once: np.load keeps the zip
    # open lazily, and a 1000-frame sequence would run out of the default
    # number of open files if every handle stayed live
    with np.load(f) as fr:
      want = fr.files if keys is None else [k for k in keys if k in fr.files]
      frames.append({k: np.asarray(fr[k]) for k in want})
  stack_keys = ("coords", "covariance", "pose") if keys is None else tuple(
      k for k in keys if k != "pose_gt" and k in frames[0])
  out = {k: np.stack([fr[k] for fr in frames]) for k in stack_keys}
  if keys is None or "pose_gt" in keys:
    out["pose_gt"] = (np.stack([fr["pose_gt"] for fr in frames])
                      if "pose_gt" in frames[0] else None)
  return out


def solve_sequence(coords: np.ndarray, covariance: np.ndarray,
                   K: np.ndarray, stride: int,
                   config: ransac.RansacConfig,
                   seed: int = 0, device=None) -> np.ndarray:
  """The batched per-frame PnP over a whole dumped sequence -> (T, 4, 4),
  on ``device`` (``cuda`` unless given), its hypotheses drawn from one
  generator seeded with ``seed``."""
  device = kfnet_tpu_torch.resolve_device(device)
  solve = eval_sequence.make_pose_solver(K, stride=stride, config=config)
  gen = torch.Generator(device=device).manual_seed(seed)
  out = solve(torch.from_numpy(np.ascontiguousarray(coords)).to(device),
              torch.from_numpy(np.ascontiguousarray(covariance)).to(device),
              gen)
  return out["T_wc"].cpu().numpy()


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--dump_dir", required=True)
  p.add_argument("--report", default="")
  p.add_argument("--pnp_solver", default="dlt", choices=("dlt", "p3p"))
  p.add_argument("--num_hypotheses", type=int, default=256)
  p.add_argument("--inlier_threshold_px", type=float, default=10.0)
  p.add_argument("--stride", type=int, default=None,
                 help="override meta.json (map-cell stride in pixels)")
  p.add_argument("--intrinsics", default="",
                 help="fx,fy,cx,cy — overrides meta.json")
  p.add_argument("--pose_smooth_beta", type=float, default=0.0,
                 help="gated constant-velocity SE(3) smoothing of the "
                      "re-solved trajectory (pose/smoothing.py; 0 = off)")
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--device", default="cuda",
                 help="torch device of the pose solve (cpu for tests)")
  args = p.parse_args(argv)

  meta = {}
  meta_path = os.path.join(args.dump_dir, "meta.json")
  if os.path.exists(meta_path):
    with open(meta_path) as f:
      meta = json.load(f)
  if args.intrinsics:
    fx, fy, cx, cy = (float(v) for v in args.intrinsics.split(","))
    K = np.asarray([[fx, 0, cx], [0, fy, cy], [0, 0, 1]], np.float32)
  elif "intrinsics" in meta:
    K = np.asarray(meta["intrinsics"], np.float32)
  else:
    raise SystemExit("no intrinsics: pass --intrinsics fx,fy,cx,cy "
                     "(dump has no meta.json)")
  stride = args.stride if args.stride is not None else meta.get("stride", 8)
  rcfg = ransac.RansacConfig(
      solver=args.pnp_solver, num_hypotheses=args.num_hypotheses,
      inlier_threshold_px=args.inlier_threshold_px,
      refine_threshold_px=args.inlier_threshold_px)

  seq_dirs = sorted(
      d for d in glob.glob(os.path.join(args.dump_dir, "*"))
      if os.path.isdir(d))
  if not seq_dirs:
    raise SystemExit(f"no sequence directories under {args.dump_dir}")
  reports = []
  for seq_dir in seq_dirs:
    seq = os.path.basename(seq_dir)
    data = load_dump_sequence(seq_dir)
    poses = solve_sequence(data["coords"], data["covariance"], K, stride,
                           rcfg, seed=args.seed, device=args.device)
    if args.pose_smooth_beta > 0.0:
      poses = smoothing.smooth_trajectory(
          poses, smoothing.SmootherConfig(beta=args.pose_smooth_beta))
    scene = f"{meta.get('scene', '')}/{seq}".lstrip("/")
    if data["pose_gt"] is not None:
      rep = pose_metrics.report(scene, poses, data["pose_gt"])
    else:
      # no ground truth in the dump: the drift from the poses solved at
      # dump time (a check of the solver settings, labelled as such)
      rep = pose_metrics.report(scene, poses, data["pose"])
      rep["gt_source"] = "dumped_poses_no_gt"
    if args.pose_smooth_beta > 0.0:
      rep["pose_smooth_beta"] = args.pose_smooth_beta
    reports.append(rep)
    print(json.dumps(rep))
  if args.report:
    eval_sequence.write_report(args.report, reports)
  return reports


if __name__ == "__main__":
  main()
