"""GroupNorm-vs-no-norm study (port of ``kfnet_tpu/tools/norm_study.py``).

``SCoordNetConfig.norm`` defaults to GroupNorm; ``norm="none"`` is the
reference-parity trunk (plain conv+ReLU — the TF1 original has no
normalization). This tool measures both the speed and the accuracy cost
on trained full-size stages:

  * ACCURACY: evaluate the GN-trained stage3 (from the protocol cache)
    and a norm="none"-trained stage3 (``tools/prepare_cache.py --scenes
    sceneA --scoordnet_norm none --copy_stage2_from <gn cache>
    --work_dir <nonorm_dir>``: the GN run's stage2 OFlowNet copied in, so
    ONLY the measurement trunk differs) on the same fresh trajectory, same
    pose-solver draws — paired per-frame deltas with moving-block-
    bootstrap CIs (eval/stats.py), for measurement-only and filtered
    modes.
  * SPEED: the headline timing protocol (``eval/benchmark.filter_fps``:
    warm-up, median of k batches, each ending in a sync) on both configs,
    weights from a seed, the fused update kernel on the card.

    python -m kfnet_tpu_torch.tools.norm_study \
        --gn_dir .protocol_cache/full --nonorm_dir .protocol_cache/nonorm \
        --report NORM_STUDY.json [--device cuda]

``STAGES`` holds the protocol settings of the caches the study loads.
The MFU is the analytic FLOP count over the card's dense bf16 peak
(``eval/flops.peak_flops``); null on a device with no known peak (the
CPU). ``--device`` (``cuda`` unless given; raises without one) is the one
flag the JAX tool lacks.
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch import configs
from kfnet_tpu_torch.eval import benchmark, eval_sequence, stats
from kfnet_tpu_torch.eval import flops as flops_lib
from kfnet_tpu_torch.models import kfnet
from kfnet_tpu_torch.pose import metrics as pose_metrics
from kfnet_tpu_torch.tools import protocol

# the protocol settings of the caches the study loads (the full-size run's)
STAGES = dict(H=480, W=640, full_size=True, lr=3e-4, sc_steps=3000,
              of_steps=2000, joint_steps=400)


def bench_fps(cfg, params, images, reps=3, k=3):
  """The headline timing protocol, via the shared implementation
  (eval/benchmark.filter_fps) so the two can never diverge."""
  return benchmark.filter_fps(cfg, params, images, reps=reps, k=k)


def _load(work_dir, scene, test_frames, eval_traj_offset, norm,
          seed_offset=0, device=None):
  specs = tuple(s for s in protocol.DEFAULT_SCENES if s.name == scene)
  if seed_offset:
    # mirror protocol.py's --seed_offset: shift the scene-generation seeds
    # so a seed-2 cache is evaluated on the data it was trained against
    specs = tuple(dataclasses.replace(s, seed=s.seed + seed_offset)
                  for s in specs)
  data, _, _, joint = protocol.prepare_stages(
      test_frames=test_frames, work_dir=work_dir, strict_cache=True,
      eval_traj_offset=eval_traj_offset, scoordnet_norm=norm, scenes=specs,
      device=device, **STAGES)
  cfg, params = joint[scene]
  d = data[scene]
  d["test"].pop("depths", None)
  return cfg, params, d


def _eval_one(cfg, params, d, scene, rcfg, rng_seed=0):
  gt = d["test"]["poses"].cpu().numpy()
  K = d["train"]["K"].cpu().numpy()
  res_m = eval_sequence.evaluate_measurement_only(
      params, cfg, d["test"]["images"], K, gt_poses=gt, scene=scene,
      ransac_config=rcfg, seed=rng_seed)
  res_f = eval_sequence.evaluate_sequence(
      params, cfg, d["test"]["images"], K, gt_poses=gt, scene=scene,
      ransac_config=rcfg, seed=rng_seed)
  acc = eval_sequence.coord_accuracy_report(
      res_f.coords, d["test_coords"].cpu().numpy(),
      d["test_valid"].cpu().numpy())
  t_m, r_m = pose_metrics.pose_errors(res_m.poses, gt)
  t_f, r_f = pose_metrics.pose_errors(res_f.poses, gt)
  return {
      "errors": {"t_meas": t_m, "r_meas": r_m, "t_filt": t_f, "r_filt": r_f},
      "report": {
          "median_translation_meas_m": float(np.median(t_m)),
          "median_rotation_meas_deg": float(np.median(r_m)),
          "median_translation_filt_m": float(np.median(t_f)),
          "median_rotation_filt_deg": float(np.median(r_f)),
          "median_coord_err_m": acc["median_coord_err_m"],
      },
  }


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--gn_dir", default=".protocol_cache/full")
  p.add_argument("--nonorm_dir", default=".protocol_cache/nonorm")
  p.add_argument("--alt_norm", default="none",
                 help="trunk norm of the --nonorm_dir cache: 'none' "
                      "(reference parity) or 'ws' (weight-standardized) "
                      "— the study is always <alt> paired against the "
                      "GroupNorm baseline in --gn_dir")
  p.add_argument("--scene", default="sceneA")
  p.add_argument("--test_frames", type=int, default=480)
  p.add_argument("--eval_traj_offset", type=int, default=7)
  p.add_argument("--bench_frames", type=int, default=32)
  p.add_argument("--block", type=int, default=24)
  p.add_argument("--seed_offset", type=int, default=0,
                 help="scene-seed offset of the caches (1000 = seed 2)")
  p.add_argument("--skip_perf", action="store_true",
                 help="skip the speed re-measurement (identical across "
                      "scenes/seeds; only the paired accuracy runs)")
  p.add_argument("--report", default="")
  p.add_argument("--device", default=None,
                 help="cuda (the default; raises without one) or cpu")
  args = p.parse_args(argv)
  device = kfnet_tpu_torch.resolve_device(args.device)

  alt = args.alt_norm
  rcfg = configs.synthetic_ransac(True)
  out = {"scene": args.scene, "test_frames": args.test_frames,
         "eval_traj_offset": args.eval_traj_offset,
         "alt_norm": alt,
         "seed_offset": args.seed_offset}

  # ---- speed first (random-content frames; weights don't matter) -------
  rng = np.random.default_rng(0)
  bimgs = torch.from_numpy(rng.uniform(
      0, 1, (args.bench_frames, 480, 640, 3)).astype(np.float32)).to(device)
  on_card = device.type == "cuda"
  peak = flops_lib.peak_flops(device)
  perf = {}
  for norm in () if args.skip_perf else ("group", alt):
    cfg = kfnet_config_for(norm, on_card)
    params = init_for(cfg, device)
    fps = bench_fps(cfg, params, bimgs)
    flops_per_frame = flops_lib.filter_step_flops(cfg, 480, 640)
    perf[norm] = {"fps": round(fps, 2),
                  "mfu": None if peak is None
                  else round(flops_per_frame * fps / peak, 4)}
    del params
  if perf:
    perf[f"{alt}_over_group_speedup"] = round(
        perf[alt]["fps"] / perf["group"]["fps"], 4)
    out["perf"] = perf
    print(json.dumps({"perf": perf}), flush=True)

  # ---- accuracy: paired eval on the same fresh trajectory --------------
  runs = {}
  for norm, d_dir in (("group", args.gn_dir), (alt, args.nonorm_dir)):
    # norm is passed explicitly for BOTH sides (never None = "config
    # default"): each cache must be loaded as the trunk it was trained
    # with, regardless of what the shipped default is.
    cfg, params, d = _load(d_dir, args.scene, args.test_frames,
                           args.eval_traj_offset, norm,
                           seed_offset=args.seed_offset, device=device)
    assert cfg.scoordnet.norm == norm, (cfg.scoordnet.norm, norm)
    runs[norm] = _eval_one(cfg, params, d, args.scene, rcfg)
    out[f"{norm}_report"] = runs[norm]["report"]
    print(json.dumps({norm: runs[norm]["report"]}), flush=True)
    del cfg, params, d

  paired = {}
  eg, en = runs["group"]["errors"], runs[alt]["errors"]
  for mode in ("meas", "filt"):
    for met, pre in (("t", "translation_"), ("r", "rotation_")):
      paired[f"{mode}_{pre}{alt}_minus_group"] = stats.paired_delta_report(
          en[f"{met}_{mode}"], eg[f"{met}_{mode}"], block=args.block,
          prefix="")
  out["paired"] = paired
  print(json.dumps({"paired": paired}), flush=True)
  if args.report:
    with open(args.report, "w") as f:
      json.dump(out, f, indent=2)
  return out


def kfnet_config_for(norm: str, use_fused_kernel: bool):
  cfg = kfnet.KFNetConfig(use_fused_kernel=use_fused_kernel)
  return dataclasses.replace(
      cfg, scoordnet=dataclasses.replace(cfg.scoordnet, norm=norm))


def init_for(cfg, device=None):
  return kfnet.init(0, cfg, (480, 640, 3), device=device)


if __name__ == "__main__":
  main()
