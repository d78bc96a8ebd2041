"""Self-contained end-to-end demo, no dataset files needed (port of
``kfnet_tpu/tools/demo.py``).

Renders a procedural synthetic scene on the device (``data/synthetic.py``),
trains SCoordNet (stage 1), OFlowNet (stage 2) and, with
``--joint_steps``, the joint filter fine-tune (stage 3, on T-frame windows
with BPTT through the fused update kernel when ``--joint_window`` > 2,
else on 2-frame pairs), then runs the recursive filter + PnP over a
held-out camera trajectory and prints JSON reports (median pose error,
fps), measurement-only and filtered.

    python -m kfnet_tpu_torch.tools.demo [--steps 1500] [--height 96]
        [--width 128] [--full_size] [--device cuda]
"""

from __future__ import annotations

import argparse
import dataclasses
import json

import numpy as np
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch import configs
from kfnet_tpu_torch.data import labels, synthetic
from kfnet_tpu_torch.eval import eval_sequence
from kfnet_tpu_torch.filter import sequence as seq_lib
from kfnet_tpu_torch.models import kfnet, oflownet, scoordnet
from kfnet_tpu_torch.train import objectives
from kfnet_tpu_torch.train.device_fit import fit_on_device
from kfnet_tpu_torch.utils import checkpoint as ckpt_lib


def label_maps(depths, poses, K, stride: int = 8):
  """Per-frame scene-coordinate labels of a rendered sequence, on its
  device: ((T, h, w, 3) coordinates, (T, h, w) validity)."""
  maps = [labels.generate(d, K, T, stride=stride)
          for d, T in zip(depths, poses)]
  return (torch.stack([c for c, _ in maps]),
          torch.stack([v for _, v in maps]))


def render_frames(scene, poses, K, height: int, width: int):
  """(T, H, W, 3) images and (T, H, W) depths of ``poses``, rendered a
  bounded chunk of frames at a time."""
  chunk = synthetic.render_chunk(height, width, len(scene.radii))
  parts = [synthetic.render(scene, poses[i:i + chunk], K, height, width)
           for i in range(0, poses.shape[0], chunk)]
  return (torch.cat([p[0] for p in parts]), torch.cat([p[1] for p in parts]))


def consistency_experiment(params, cfg, scene, K, H, W, base_poses):
  """Sequence-level demonstration of the χ² consistency examination (paper
  §3.4): teleport the camera a third of the trajectory ahead
  mid-sequence, then filter with the χ² reset on and disabled. Returns a
  JSON-able report: the mask collapses at the jump frame, the posterior
  re-locks within a couple of frames, and the no-reset ablation stays
  broken.

  ``base_poses`` should be the TRAINING trajectory: there the model's
  uncertainties are calibrated, so the χ² statistic isolates the injected
  failure instead of the train→test generalization gap."""
  tA = torch.as_tensor(base_poses, device=K.device)
  n_frames = tA.shape[0]
  if n_frames < 12:
    raise ValueError(
        f"consistency experiment needs >= 12 frames (got {n_frames}): the "
        "report reads errors at jump+4 and medians over frames 2..jump")
  jump = n_frames // 2
  # teleport a third of the trajectory ahead at the splice: the camera
  # position and viewing angle change abruptly (a REAL jump)
  tB = torch.roll(tA, -(n_frames // 3), dims=0)
  poses = torch.cat([tA[:jump], tB[jump:]], dim=0)
  imgs, depths = render_frames(scene, poses, K, H, W)
  gt_maps, gt_valid = (a.cpu().numpy() for a in label_maps(depths, poses, K))

  def run(chi2_threshold):
    # the composition: the diagnostics need aux's x_prior and P_prior,
    # which the fused kernel does not return
    c = dataclasses.replace(cfg, chi2_threshold=chi2_threshold,
                            use_fused_kernel=False)
    xs, _, _, aux = seq_lib.run_filter(params, c, imgs, return_aux=True)
    aux = {k: v.cpu().numpy() for k, v in aux.items()}
    err = np.where(gt_valid,
                   np.linalg.norm(xs.cpu().numpy() - gt_maps, axis=-1),
                   np.nan)
    med_err = np.nanmedian(err.reshape(err.shape[0], -1), axis=1)
    # aux covers frames 1..T-1
    frac = aux["consistent"].mean(axis=(1, 2, 3))
    frac = np.concatenate([[1.0], frac])
    # innovation chi^2 statistic + learned process noise, per frame
    innov = aux["z"] - aux["x_prior"]
    S = aux["P_prior"][..., 0] + aux["V"][..., 0]
    maha = (innov ** 2).sum(-1) / S
    med_maha = np.concatenate(
        [[0.0], np.median(maha.reshape(maha.shape[0], -1), axis=1)])
    Wm = aux["W"][..., 0]
    med_W = np.concatenate(
        [[0.0], np.median(Wm.reshape(Wm.shape[0], -1), axis=1)])
    return med_err, frac, med_maha, med_W

  err_on, frac_on, maha_on, W_on = run(cfg.chi2_threshold)
  err_off, _, _, _ = run(1e12)

  pre_jump = float(np.median(err_on[2:jump]))
  relock = next((int(t) for t in range(jump + 1, n_frames)
                 if err_on[t] <= 2.0 * pre_jump), -1)
  healthy = np.r_[2:jump, jump + 2:n_frames]
  return {
      "jump_frame": jump,
      "consistent_frac_at_jump": float(frac_on[jump]),
      "consistent_frac_healthy_min": float(frac_on[healthy].min()),
      # detection power: innovation chi^2 statistic (3 dof, threshold 7.81)
      "median_chi2_healthy": float(np.median(maha_on[healthy])),
      "median_chi2_at_jump": float(maha_on[jump]),
      # learned process noise at/off the jump
      "median_W_healthy": float(np.median(W_on[healthy])),
      "median_W_at_jump": float(W_on[jump]),
      "median_coord_err_pre_jump_m": pre_jump,
      "relock_frame": relock,
      "frames_to_relock": relock - jump if relock >= 0 else -1,
      "err_on_at_jump_plus_4_m": float(err_on[jump + 4]),
      "err_off_at_jump_plus_4_m": float(err_off[jump + 4]),
      "median_err_on_after_jump_m": float(np.median(err_on[jump + 2:])),
      "median_err_off_after_jump_m": float(np.median(err_off[jump + 2:])),
  }


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--steps", type=int, default=1500)
  p.add_argument("--oflownet_steps", type=int, default=1000)
  p.add_argument("--joint_steps", type=int, default=0)
  p.add_argument("--joint_window", type=int, default=0,
                 help=">2: stage 3 trains the T-frame BPTT window "
                      "objective (each filter step checkpointed: O(1) "
                      "activation memory in T), with the fused update "
                      "kernel, instead of 2-frame pairs")
  p.add_argument("--height", type=int, default=96)
  p.add_argument("--width", type=int, default=128)
  p.add_argument("--train_frames", type=int, default=48)
  p.add_argument("--test_frames", type=int, default=48)
  p.add_argument("--learning_rate", type=float, default=2e-3)
  p.add_argument("--save", default="",
                 help="export the trained params here (params.npz)")
  p.add_argument("--consistency", action="store_true",
                 help="also run the χ² consistency-examination experiment "
                      "(abrupt mid-sequence pose jump; filter with the "
                      "reset on vs disabled) and print its report")
  p.add_argument("--full_size", action="store_true",
                 help="full-width bf16 models at 640x480 (overrides "
                      "--height/--width)")
  p.add_argument("--device", default="cuda",
                 help="cuda (the default) or cpu")
  args = p.parse_args(argv)
  if args.full_size:
    args.height, args.width = 480, 640
    args.learning_rate = 3e-4
    args.steps = max(args.steps, 3000)
    args.oflownet_steps = max(args.oflownet_steps, 2000)
    if args.joint_steps == 0:
      args.joint_steps = 400
  H, W = args.height, args.width
  device = kfnet_tpu_torch.resolve_device(args.device)

  scene = synthetic.make_scene(0)
  train = synthetic.make_sequence(args.train_frames, height=H, width=W,
                                  seed=0, device=device)
  K = train["K"]
  test_poses = torch.as_tensor(
      synthetic.orbit_trajectory(args.test_frames, seed=99), device=device)
  test_imgs, test_depths = render_frames(scene, test_poses, K, H, W)
  test_coords, test_valid = label_maps(test_depths, test_poses, K)

  coords, valid = label_maps(train["depths"], train["poses"], K)
  mean, std = labels.scene_statistics([coords.cpu().numpy()],
                                      [valid.cpu().numpy()])
  sc_cfg = (configs.full_scoordnet(mean, std) if args.full_size
            else configs.small_scoordnet(mean, std))
  gen = torch.Generator(device=device)
  params_sc = scoordnet.init(gen.manual_seed(0), sc_cfg, (H, W, 3), device)
  loss_fn = objectives.scoordnet_objective(sc_cfg)
  batch_all = {"image": train["images"], "coords": coords, "valid": valid}
  state, _ = fit_on_device(loss_fn, params_sc, batch_all, args.steps,
                           args.learning_rate, tag="scoordnet",
                           device=device)

  of_cfg = (configs.full_oflownet() if args.full_size
            else configs.small_oflownet())
  of_params = oflownet.init(gen.manual_seed(1), of_cfg, (H, W, 3), device)

  if args.oflownet_steps > 0:
    # stage 2: process system on consecutive pairs of the training video
    of_loss = objectives.oflownet_objective(of_cfg, flow_reg_weight=0.01)
    pair_all = {
        "image_prev": train["images"][:-1], "image": train["images"][1:],
        "coords_prev": coords[:-1], "valid_prev": valid[:-1],
        "coords": coords[1:], "valid": valid[1:]}
    of_state, _ = fit_on_device(of_loss, of_params, pair_all,
                                args.oflownet_steps, args.learning_rate,
                                tag="oflownet", seed=1, device=device)
    of_params = of_state.params

  cfg = kfnet.KFNetConfig(scoordnet=sc_cfg, oflownet=of_cfg)
  params = {"scoordnet": state.params, "oflownet": of_params}

  if args.joint_steps > 0:
    # stage 3: joint filtering fine-tune (posterior NLL through both nets)
    if args.joint_window > 2:
      # T-frame BPTT, each step checkpointed, the fused kernel in the
      # forward: windows gather on the device from the raw video
      joint_loss = objectives.kfnet_window_objective(cfg, remat=True)
      seq_all = {"images": train["images"], "coords": coords,
                 "valid": valid}
      joint_state, _ = fit_on_device(
          joint_loss, params, seq_all, args.joint_steps,
          args.learning_rate * 0.1, batch=1 if args.full_size else 2,
          chunk=50 if args.full_size else 250, tag="joint-bptt", seed=2,
          window=args.joint_window, device=device)
    else:
      # the pair objective's prior NLL needs the composition's prior
      joint_loss = objectives.kfnet_objective(
          dataclasses.replace(cfg, use_fused_kernel=False))
      pair_all = {
          "image_prev": train["images"][:-1], "image": train["images"][1:],
          "coords": coords[1:], "valid": valid[1:]}
      joint_state, _ = fit_on_device(
          joint_loss, params, pair_all, args.joint_steps,
          args.learning_rate * 0.1, batch=2 if args.full_size else 4,
          chunk=50 if args.full_size else 250, tag="joint", seed=2,
          device=device)
    params = joint_state.params

  rcfg = configs.synthetic_ransac(args.full_size)
  gt = test_poses.cpu().numpy()
  K_host = K.cpu().numpy()
  res_m = eval_sequence.evaluate_measurement_only(
      params, cfg, test_imgs, K_host, gt_poses=gt,
      scene="synthetic(measurement-only)", ransac_config=rcfg)
  res_f = eval_sequence.evaluate_sequence(
      params, cfg, test_imgs, K_host, gt_poses=gt,
      scene="synthetic(filtered)", ransac_config=rcfg)
  for res in (res_m, res_f):
    res.report.update(eval_sequence.coord_accuracy_report(
        res.coords, test_coords.cpu().numpy(), test_valid.cpu().numpy()))
    print(json.dumps(res.report, indent=2))
  if args.consistency:
    rep = consistency_experiment(params, cfg, scene, K, H, W,
                                 base_poses=train["poses"])
    rep["scene"] = "synthetic(consistency: chi2 reset on vs off)"
    print(json.dumps(rep, indent=2))
  if args.save:
    ckpt_lib.export_params(args.save, params)
    print("saved params to", args.save)


if __name__ == "__main__":
  main()
