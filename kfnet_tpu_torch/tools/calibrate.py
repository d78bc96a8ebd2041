"""Eval-time calibration of the Kalman fusion (χ² gate + process-noise
temperature) on cached protocol stages (port of
``kfnet_tpu/tools/calibrate.py``).

On HELD-OUT scenes the filtered translation error can be WORSE than
measurement-only: the frozen OFlowNet's process noise W is calibrated on
its training scenes, so on unseen scenes the prior can out-weigh the
measurement it should defer to. This tool answers "is that a calibration
problem, and what fixes it?" with paired per-frame statistics, WITHOUT
retraining.

The networks are calibration-invariant: SCoordNet's (z, V) and OFlowNet's
(flow, W) do not depend on chi2_threshold / w_scale — only the scalar
Kalman recursion does. So the network series is computed ONCE per scene
(one pass of the CNNs) and only the cheap fusion recursion re-runs, with
the calibration knobs as tensors: a grid point re-runs no Python-side
setup and builds no new config.

    python -m kfnet_tpu_torch.tools.calibrate --work_dir .protocol_cache/full \
        --full_size --test_frames 480 --stress 0.0 \
        --report CALIBRATION_SWEEP.json [--device cuda]

Fit mode (--fit) selects a per-scene w_scale on that scene's TRAIN
sequence (legitimate calibration data — never the test stream) and
re-evaluates the test stream at the chosen temperature.

The recursion here is the warp ∘ ``kalman_update`` composition
(``core/warp.py``, ``core/kalman.py``); ``sequence.run_filter`` on the
card runs the same step as the fused update kernel. The pose solves draw
from a generator seeded with the sweep's seed before each solve, so every
grid point's poses come from the same draws (the JAX tool's fixed keys).
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch import configs
from kfnet_tpu_torch.core import kalman
from kfnet_tpu_torch.core import warp as warp_lib
from kfnet_tpu_torch.eval import eval_sequence, stats
from kfnet_tpu_torch.filter import sequence
from kfnet_tpu_torch.models import kfnet
from kfnet_tpu_torch.pose import metrics as pose_metrics
from kfnet_tpu_torch.pose import smoothing
from kfnet_tpu_torch.tools import protocol


@torch.no_grad()
def precompute_series(params, config: kfnet.KFNetConfig, images):
  """One pass of both CNNs over a (T, H, W, 3) sequence, where the params
  live.

  Returns dict(z0, V0, z, V, flow, W): frame-0 measurement plus the
  per-transition series for frames 1..T-1 — everything the Kalman
  recursion consumes. ``config.w_scale`` must be 1 so W is the RAW
  network output (the sweep applies its own temperature).
  """
  params, device = sequence.placed(params, None)
  images = kfnet.preprocess_images(
      config, sequence.frames_to_device(images, device))
  z0, V0 = kfnet.measure(params, config, images[0])
  feat_prev = kfnet.encode(params, config, images[0])
  rest = {k: [] for k in ("z", "V", "flow", "W")}
  for image in images[1:]:
    z, V = kfnet.measure(params, config, image)
    feat = kfnet.encode(params, config, image)
    flow, W = kfnet.flow_from_features(params, config, feat_prev, feat)
    for k, v in (("z", z), ("V", V), ("flow", flow), ("W", W)):
      rest[k].append(v)
    feat_prev = feat
  return {"z0": z0, "V0": V0,
          **{k: torch.stack(v) for k, v in rest.items()}}


def _scalar(v, like: torch.Tensor) -> torch.Tensor:
  return torch.as_tensor(v, dtype=torch.float32, device=like.device)


@torch.no_grad()
def filter_from_series(config: kfnet.KFNetConfig, series, chi2, w_scale,
                       alpha_max=0.0, adaptive_stat: str = "s"):
  """The Kalman recursion alone, with the calibration knobs as tensors.

  Numerically the composition of ``filter/sequence.run_filter`` at
  matching config values (parity-tested); chi2 / w_scale / alpha_max are
  0-d tensors (or numbers, made tensors here) on the series' device.

  alpha_max >= 1 enables innovation-adaptive prior inflation (classic
  IAE / covariance-matching adaptive Kalman): per frame, the clipped
  mean Mahalanobis statistic m̄ of the innovation under S = P⁻+V has
  expectation 3 (dof) when calibration is right; m̄ > 3 means the prior
  is overconfident (the held-out transfer failure mode), so P⁻ inflates
  by α = clip(m̄/3, 1, alpha_max) before the gain. Scene-agnostic, no
  per-scene fitting. alpha_max < 1 disables (α ≡ 1).

  adaptive_stat picks the statistic: "s" = innovation vs S = P⁻+V (the
  calibrated form above). "v" = V-weighted: per-pixel ‖inn‖²/V
  normalized by its own calibrated expectation 3·mean(S/V) — identical
  expectation 1-ish under calibration, but the V-weighting emphasizes
  CONFIDENT-measurement pixels, where prior drag does the most PnP
  damage while staying inside the S band (the clean-stream failure the
  "s" statistic cannot see).

  Returns (xs (T, h, w, 3), Ps (T, h, w, 1)).
  """
  r = float(config.oflownet.search_radius)
  z0 = series["z0"]
  chi2, w_scale, alpha_max = (_scalar(v, z0)
                              for v in (chi2, w_scale, alpha_max))
  x, P = z0, series["V0"]
  xs, Ps = [x], [P]
  for t in range(series["z"].shape[0]):
    z, V = series["z"][t], series["V"][t]
    flow = torch.clamp(series["flow"][t], -r, r)
    x_pr, P_pr, valid = warp_lib.warp_state_cov(
        x, P, flow, series["W"][t] * w_scale,
        invalid_cov=config.invalid_cov)
    inn2 = torch.sum(torch.square(z - x_pr), dim=-1, keepdim=True)
    S = P_pr + V
    # statistics average over WARP-VALID pixels only, matching the
    # model's adaptive path: the out-of-bounds band carries
    # P⁻ = invalid_cov, whose near-zero maha would dilute m̄ exactly in
    # the high-motion frames adaptation exists for
    v = valid.to(torch.float32)
    vsum = torch.clamp_min(torch.sum(v), 1.0)
    if adaptive_stat == "s":
      # clip per-pixel maha: χ²-reset-grade outliers (prior plainly
      # wrong) must not dominate the inflation estimate
      m_bar = torch.sum(torch.clamp_max(inn2 / S, 25.0) * v) / vsum
      ratio = m_bar / 3.0
    else:
      mv = torch.sum(torch.clamp_max(inn2 / V, 250.0) * v) / vsum
      expect = 3.0 * torch.sum(
          torch.clamp_max(S / V, 250.0 / 3.0) * v) / vsum
      ratio = mv / expect
    alpha = torch.where(alpha_max >= 1.0,
                        torch.minimum(torch.clamp_min(ratio, 1.0),
                                      alpha_max),
                        torch.ones_like(ratio))
    x, P, _ = kalman.kalman_update(x_pr, alpha * P_pr, z, V,
                                   threshold=chi2)
    xs.append(x)
    Ps.append(P)
  return torch.stack(xs), torch.stack(Ps)


def measurement_maps(series):
  zs = torch.cat([series["z0"][None], series["z"]])
  Vs = torch.cat([series["V0"][None], series["V"]])
  return zs, Vs


def _solve_poses(solver, xs, Ps, gen, seed):
  return solver(xs, Ps, gen.manual_seed(seed))["T_wc"].cpu().numpy()


def sweep_scene(params, cfg, images, K, gt, chi2_grid, w_grid,
                rcfg, block=24, rng_seed=0, alpha_grid=(0.0,),
                adaptive_stat="s", smooth_grid=(0.0,)):
  """Grid-sweep one scene's cached models. Returns (rows, meas_row).

  smooth_grid: pose-space smoothing betas (pose/smoothing.py) crossed
  with the Kalman grid; beta=0 is the raw solver trajectory. Non-zero
  betas also emit base="measurement" rows (smoothed measurement-only
  poses) so the study separates "smoothing helps PnP scatter" from
  "filtering helps coordinates". Every row is paired against the RAW
  measurement-only trajectory — the reference baseline.
  """
  cfg1 = dataclasses.replace(cfg, w_scale=1.0)
  series = precompute_series(params, cfg1, images)
  solver = eval_sequence.make_pose_solver(np.asarray(K), config=rcfg)
  gen = torch.Generator(device=series["z0"].device)
  zs, Vs = measurement_maps(series)
  T_m = _solve_poses(solver, zs, Vs, gen, rng_seed)
  t_m, r_m = pose_metrics.pose_errors(T_m, gt)
  meas_row = {"median_translation_m": float(np.median(t_m)),
              "median_rotation_deg": float(np.median(r_m))}

  def paired_row(T, base, **extra):
    t_f, r_f = pose_metrics.pose_errors(T, gt)
    row = {"base": base,
           "median_translation_m": float(np.median(t_f)),
           "median_rotation_deg": float(np.median(r_f)), **extra}
    row.update(stats.paired_delta_report(
        t_f, t_m, block=block, prefix="translation_"))
    row.update(stats.paired_delta_report(
        r_f, r_m, block=block, prefix="rotation_"))
    return row

  rows = []
  for beta in smooth_grid:
    if beta > 0.0:
      T_ms = smoothing.smooth_trajectory(
          T_m, smoothing.SmootherConfig(beta=float(beta)))
      rows.append(paired_row(T_ms, "measurement", smooth_beta=float(beta)))
  for chi2 in chi2_grid:
    for ws in w_grid:
      for am in alpha_grid:
        xs, Ps = filter_from_series(cfg1, series, chi2, ws, am,
                                    adaptive_stat=adaptive_stat)
        T_f = _solve_poses(solver, xs, Ps, gen, rng_seed)
        for beta in smooth_grid:
          T = T_f
          if beta > 0.0:
            T = smoothing.smooth_trajectory(
                T_f, smoothing.SmootherConfig(beta=float(beta)))
          rows.append(paired_row(
              T, "filtered", chi2_threshold=float(chi2),
              w_scale=float(ws), alpha_max=float(am),
              adaptive_stat=adaptive_stat, smooth_beta=float(beta)))
  return rows, meas_row


def fit_w_scale(params, cfg, train_images, K, gt_train, w_grid, rcfg,
                rng_seed=0):
  """Pick w_scale minimizing mean translation error on the TRAIN
  sequence (never test data). Returns (best_w, per-candidate means)."""
  cfg1 = dataclasses.replace(cfg, w_scale=1.0)
  series = precompute_series(params, cfg1, train_images)
  solver = eval_sequence.make_pose_solver(np.asarray(K), config=rcfg)
  gen = torch.Generator(device=series["z0"].device)
  means = {}
  for ws in w_grid:
    xs, Ps = filter_from_series(cfg1, series, cfg1.chi2_threshold, ws)
    t_f, _ = pose_metrics.pose_errors(
        _solve_poses(solver, xs, Ps, gen, rng_seed), gt_train)
    means[float(ws)] = float(t_f.mean())
  best = min(means, key=means.get)
  return best, means


def parse_grid(text: str):
  return [float(v) for v in text.split(",") if v.strip()]


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--work_dir", required=True,
                 help="protocol --work_dir with cached stage exports")
  p.add_argument("--report", default="")
  p.add_argument("--full_size", action="store_true")
  p.add_argument("--height", type=int, default=96)
  p.add_argument("--width", type=int, default=128)
  p.add_argument("--train_frames", type=int, default=48)
  p.add_argument("--test_frames", type=int, default=480)
  p.add_argument("--stress", type=float, default=0.0)
  p.add_argument("--seed_offset", type=int, default=0)
  p.add_argument("--scenes", default="",
                 help="comma-separated subset (default: all)")
  p.add_argument("--chi2_grid", default="1.21,2.37,4.64,7.81,11.34,16.27")
  p.add_argument("--w_grid", default="0.5,1,2,4,8,16,64")
  p.add_argument("--alpha_grid", default="0",
                 help="innovation-adaptive inflation caps to cross with "
                      "the grid (0 = off; see filter_from_series)")
  p.add_argument("--adaptive_stat", default="s", choices=("s", "v"),
                 help="adaptation statistic (see filter_from_series)")
  p.add_argument("--smooth_grid", default="0",
                 help="pose-space smoothing betas to cross with the grid "
                      "(0 = raw trajectory; see pose/smoothing.py)")
  p.add_argument("--eval_traj_offset", type=int, default=0,
                 help="evaluate on a FRESH held-out camera trajectory "
                      "(same scene/stages) — out-of-sample validation of "
                      "a point the sweeps selected (protocol.py semantics)")
  p.add_argument("--fit", action="store_true",
                 help="fit per-scene w_scale on TRAIN sequences, then "
                      "evaluate the test stream at the fitted value")
  p.add_argument("--fit_stress", type=float, default=None,
                 help="stress level for the TRAIN fit stream (default: "
                      "same as --stress)")
  p.add_argument("--block", type=int, default=24,
                 help="bootstrap block length (frames)")
  p.add_argument("--scoordnet_norm", default=None,
                 help="norm of the cached stages ('none' for a "
                      "--scoordnet_norm-trained cache); must match the "
                      "cache or the strict load fails loudly")
  p.add_argument("--device", default=None,
                 help="cuda (the default; raises without one) or cpu")
  args = p.parse_args(argv)
  device = kfnet_tpu_torch.resolve_device(args.device)

  kw = dict(H=args.height, W=args.width, train_frames=args.train_frames,
            test_frames=args.test_frames, work_dir=args.work_dir,
            eval_traj_offset=args.eval_traj_offset,
            scoordnet_norm=args.scoordnet_norm, device=device)
  if args.full_size:
    kw.update(H=480, W=640, full_size=True, lr=3e-4, sc_steps=3000,
              of_steps=2000, joint_steps=400)
  scenes = protocol.DEFAULT_SCENES
  if args.seed_offset:
    scenes = tuple(dataclasses.replace(s, seed=s.seed + args.seed_offset)
                   for s in scenes)
  if args.scenes:
    keep = set(args.scenes.split(","))
    scenes = tuple(s for s in scenes if s.name in keep)

  chi2_grid = parse_grid(args.chi2_grid)
  w_grid = parse_grid(args.w_grid)
  rcfg = configs.synthetic_ransac(args.full_size)
  out = {"stress": args.stress, "test_frames": args.test_frames,
         "eval_traj_offset": args.eval_traj_offset, "scenes": []}
  for s in scenes:
    # one scene at a time: a long full-size render + depth + stage params
    # is gigabytes of device memory per scene.
    # strict_cache: a sweep must NEVER silently retrain a missing stage.
    data, of, _, joint = protocol.prepare_stages(
        scenes=(s,), strict_cache=True, **kw)
    cfg, params = joint[s.name]
    d = data[s.name]
    K = d["train"]["K"].cpu().numpy()
    gt = d["test"]["poses"].cpu().numpy()
    d["test"].pop("depths", None)  # unused here
    imgs = d["test"]["images"]
    if args.stress > 0:
      imgs = protocol.stress_images(imgs, args.stress, s.seed + 5)
      d["test"]["images"] = None  # only the stressed copy is needed
    entry = {"scene": s.name, "held_out": s.held_out,
             "dataset": s.dataset}
    if args.fit:
      fit_stress = (args.stress if args.fit_stress is None
                    else args.fit_stress)
      train_imgs = d["train"]["images"]
      if fit_stress > 0:
        # different noise seed than the test stream on purpose
        train_imgs = protocol.stress_images(train_imgs, fit_stress,
                                            s.seed + 77)
      best_w, means = fit_w_scale(
          params, cfg, train_imgs, K, d["train"]["poses"].cpu().numpy(),
          w_grid, rcfg)
      entry["fitted_w_scale"] = best_w
      entry["fit_train_mean_translation_by_w"] = means
      rows, meas = sweep_scene(params, cfg, imgs, K, gt,
                               [cfg.chi2_threshold], [best_w], rcfg,
                               block=args.block,
                               alpha_grid=parse_grid(args.alpha_grid),
                               adaptive_stat=args.adaptive_stat,
                               smooth_grid=parse_grid(args.smooth_grid))
    else:
      rows, meas = sweep_scene(params, cfg, imgs, K, gt, chi2_grid,
                               w_grid, rcfg, block=args.block,
                               alpha_grid=parse_grid(args.alpha_grid),
                               adaptive_stat=args.adaptive_stat,
                               smooth_grid=parse_grid(args.smooth_grid))
    entry["measurement_only"] = meas
    entry["points"] = rows
    out["scenes"].append(entry)
    print(json.dumps({"scene": s.name, "measurement_only": meas,
                      "n_points": len(rows)}), flush=True)
    del data, joint, params, d, imgs  # free device memory before the next
  if args.report:
    with open(args.report, "w") as f:
      json.dump(out, f, indent=2)
  return out


if __name__ == "__main__":
  main()
