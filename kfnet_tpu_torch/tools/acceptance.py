"""One-command acceptance runner for real datasets (port of
``kfnet_tpu/tools/acceptance.py``: the training recipe's stages over an
actual 7-Scenes / 12-Scenes / Cambridge tree):

    python -m kfnet_tpu_torch.tools.acceptance \
        --dataset 7scenes --root /data/7scenes \
        --work_dir /out/7scenes_acceptance --report /out/ACCEPTANCE.json \
        [--device cuda]

Orchestrates the real CLI entry points, per-stage-cached in work_dir
(a crashed or re-run invocation skips finished stages):

  stage 1  train_scoordnet per scene          -> work_dir/scoordnet_<scene>/export
  stage 2  train_oflownet across all scenes   -> work_dir/oflownet_<dataset>/export
  stage 3  train_kfnet joint per scene        -> work_dir/kfnet_<scene>/export
  eval     eval.main per scene: filtered + measurement-only, per test
           sequence -> one JSON + BASELINE.md comparison table.

The reference repo has no such runner (each stage is a manual script
run); this makes the full protocol one command. The tests run the whole
path on generated fixtures in the datasets' on-disk layouts (PNG and
JPEG colour, 16-bit depth, split files, pose files), so split parsing,
both image decoders, the C++ batch loader, pose IO and the CLIs run end
to end (tests/test_torch_acceptance.py).

A stage counts as done where its export holds ``params.npz``
(``utils/checkpoint.has_params``), so a re-run trains nothing that is
there. ``--device`` (``cuda`` unless given) is passed down to every CLI:
it is the port's counterpart of the JAX package's ``JAX_PLATFORMS``, and
the one flag the JAX runner lacks.
"""

from __future__ import annotations

import argparse
import glob
import json
import os

import numpy as np

from kfnet_tpu_torch.data import registry
from kfnet_tpu_torch.eval import main as eval_main
from kfnet_tpu_torch.pose import metrics as pose_metrics
from kfnet_tpu_torch.pose import smoothing
from kfnet_tpu_torch.tools import eval_poses
from kfnet_tpu_torch.train import train_kfnet, train_oflownet, train_scoordnet
from kfnet_tpu_torch.utils import checkpoint as ckpt_lib

# Paper-recalled 7-Scenes acceptance anchors (provisional, as in the JAX
# package: to be checked against the tables of arXiv:2003.10629).
BASELINE_7SCENES = {
    "dsac++": {"median_translation_m": 0.036, "median_rotation_deg": 1.10},
    "kfnet_paper": {"median_translation_m": 0.027,
                    "median_rotation_deg": 0.88},
    "scoordnet_paper": {"median_translation_m": 0.031,
                        "median_rotation_deg": 1.0},
}


def _done(path: str) -> bool:
  return ckpt_lib.has_params(path)


def _common(args, scene: str) -> list[str]:
  out = ["--input_folder", args.root, "--dataset", args.dataset,
         "--scene", scene, "--model_folder", args.work_dir,
         "--batch_size", str(args.batch_size),
         "--net_scale", args.net_scale,
         "--seed", str(args.seed), "--device", args.device]
  if args.steps_per_dispatch > 1:
    out += ["--steps_per_dispatch", str(args.steps_per_dispatch)]
  return out


def run_acceptance(args) -> dict:
  scenes = [s for s in args.scenes.split(",") if s]
  if not scenes:
    raise SystemExit(
        "acceptance: empty scene list (check --scenes) — stages would "
        "silently no-op and stage 2 would crash on scenes[0]")
  os.makedirs(args.work_dir, exist_ok=True)
  log = lambda msg: print(f"[acceptance] {msg}", flush=True)

  # ---- stage 1: SCoordNet per scene ----------------------------------
  for scene in scenes:
    export = os.path.join(args.work_dir, f"scoordnet_{scene}", "export")
    if _done(export):
      log(f"stage1[{scene}]: cached ({export})")
      continue
    log(f"stage1[{scene}]: training SCoordNet ({args.sc_steps} steps)")
    train_scoordnet.main(_common(args, scene) + [
        "--max_steps", str(args.sc_steps),
        "--learning_rate", str(args.learning_rate),
        "--decay_steps", str(max(1, args.sc_steps // 3))])

  # ---- stage 2: one OFlowNet across the dataset's scenes -------------
  of_export = os.path.join(args.work_dir, f"oflownet_{args.dataset}",
                           "export")
  if _done(of_export):
    log(f"stage2: cached ({of_export})")
  else:
    log(f"stage2: training OFlowNet on {scenes} ({args.of_steps} steps)")
    train_oflownet.main(_common(args, scenes[0]) + [
        "--scenes", ",".join(scenes),
        "--max_steps", str(args.of_steps),
        "--learning_rate", str(args.learning_rate),
        "--decay_steps", str(max(1, args.of_steps // 3))])

  # ---- stage 3: joint fine-tune per scene ----------------------------
  for scene in scenes:
    export = os.path.join(args.work_dir, f"kfnet_{scene}", "export")
    if _done(export):
      log(f"stage3[{scene}]: cached ({export})")
      continue
    if args.joint_steps <= 0:
      continue
    log(f"stage3[{scene}]: joint fine-tune ({args.joint_steps} steps)")
    train_kfnet.main(_common(args, scene) + [
        "--scoordnet_ckpt",
        os.path.join(args.work_dir, f"scoordnet_{scene}", "export"),
        "--oflownet_ckpt", of_export,
        "--max_steps", str(args.joint_steps),
        "--learning_rate", str(args.learning_rate * 0.1),
        "--decay_steps", str(max(1, args.joint_steps))])

  # ---- eval: filtered + measurement-only per scene -------------------
  results = {"dataset": args.dataset, "scenes": {},
             "baseline": BASELINE_7SCENES if args.dataset == "7scenes"
             else {}}
  eval_common_extra = []
  if args.chi2_threshold is not None:
    eval_common_extra += ["--chi2_threshold", str(args.chi2_threshold)]
  if args.w_scale is not None:
    eval_common_extra += ["--w_scale", str(args.w_scale)]
  for scene in scenes:
    joint_export = os.path.join(args.work_dir, f"kfnet_{scene}", "export")
    if args.joint_steps > 0 and _done(joint_export):
      ckpt_flags = ["--kfnet_ckpt", joint_export]
    else:
      ckpt_flags = [
          "--scoordnet_ckpt",
          os.path.join(args.work_dir, f"scoordnet_{scene}", "export"),
          "--oflownet_ckpt", of_export]
    base = _common(args, scene) + ckpt_flags + eval_common_extra
    dump_dir = ""
    if args.pose_smooth_beta > 0.0:
      # dump the filtered run's maps and poses, so that the smoothed block
      # is a host pass over the same trajectory (no second run of the nets
      # or of RANSAC: smoothing is a few-KB numpy pass a sequence)
      dump_dir = os.path.join(args.work_dir, "dump", scene)
    log(f"eval[{scene}]: filtered")
    filt = eval_main.main(
        base + (["--dump_dir", dump_dir] if dump_dir else []))
    log(f"eval[{scene}]: measurement-only")
    meas = eval_main.main(base + ["--measurement_only"])
    modes = {"filtered": filt, "measurement_only": meas}
    if args.pose_smooth_beta > 0.0:
      log(f"eval[{scene}]: filtered + pose smoothing "
          f"(beta={args.pose_smooth_beta}, from dumped poses)")
      sm_rows = []
      for seq_dir in sorted(glob.glob(os.path.join(dump_dir, "*"))):
        if not os.path.isdir(seq_dir):
          continue
        data = eval_poses.load_dump_sequence(
            seq_dir, keys=("pose", "pose_gt"))  # skip the big map blobs
        poses = smoothing.smooth_trajectory(
            data["pose"],
            smoothing.SmootherConfig(beta=args.pose_smooth_beta))
        rep = pose_metrics.report(
            f"{scene}/{os.path.basename(seq_dir)}", poses,
            data["pose_gt"])
        rep["pose_smooth_beta"] = args.pose_smooth_beta
        sm_rows.append(rep)
        print(json.dumps(rep), flush=True)
      modes["filtered_smoothed"] = sm_rows

    def agg(rows, key):
      return float(np.mean([r[key] for r in rows])) if rows else float("nan")

    results["scenes"][scene] = {
        mode: {
            "median_translation_m": agg(rows, "median_translation_m"),
            "median_rotation_deg": agg(rows, "median_rotation_deg"),
            "accuracy_5cm_5deg": agg(rows, "accuracy_5cm_5deg"),
            "sequences": rows,
        } for mode, rows in modes.items()
    }

  rows = list(results["scenes"].values())
  if rows:
    results["average"] = {
        mode: {k: float(np.mean([r[mode][k] for r in rows]))
               for k in ("median_translation_m", "median_rotation_deg",
                         "accuracy_5cm_5deg")}
        for mode in rows[0]}
  if args.report:
    with open(args.report, "w") as f:
      json.dump(results, f, indent=2)
    log(f"report -> {args.report}")
  return results


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--dataset", default="7scenes",
                 choices=("7scenes", "12scenes", "cambridge"))
  p.add_argument("--root", required=True, help="dataset root directory")
  p.add_argument("--scenes", default="",
                 help="comma-separated scene list (default: the "
                      "dataset's canonical scenes)")
  p.add_argument("--work_dir", required=True,
                 help="stage exports + checkpoints (re-runs skip "
                      "finished stages)")
  p.add_argument("--report", default="")
  p.add_argument("--net_scale", default="full",
                 choices=("full", "small", "tiny"))
  p.add_argument("--batch_size", type=int, default=8)
  p.add_argument("--learning_rate", type=float, default=1e-4)
  p.add_argument("--sc_steps", type=int, default=300_000)
  p.add_argument("--of_steps", type=int, default=200_000)
  p.add_argument("--joint_steps", type=int, default=50_000)
  p.add_argument("--steps_per_dispatch", type=int, default=1)
  p.add_argument("--chi2_threshold", type=float, default=None)
  p.add_argument("--w_scale", type=float, default=None)
  p.add_argument("--pose_smooth_beta", type=float, default=0.0,
                 help="also evaluate the serving recommendation: a "
                      "third filtered_smoothed result block per scene "
                      "with pose-space smoothing at this beta")
  p.add_argument("--seed", type=int, default=0)
  p.add_argument("--device", default="cuda",
                 help="torch device every stage and eval runs on (cpu for "
                      "tests)")
  args = p.parse_args(argv)
  if not args.scenes:
    args.scenes = ",".join(registry.default_scenes(args.dataset))
  return run_acceptance(args)


if __name__ == "__main__":
  main()
