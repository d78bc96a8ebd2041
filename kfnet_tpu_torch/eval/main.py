"""Recursive-filter evaluation CLI (port of ``kfnet_tpu/eval/main.py``; the
reference's ``KFNet/eval.py`` and its pose scripts):

    python -m kfnet_tpu_torch.eval.main \\
        --input_folder /data/7scenes --scene chess \\
        --scoordnet_ckpt ... --oflownet_ckpt ... \\
        --report /tmp/chess_report.json [--measurement_only] [--device cuda]

Runs the filter over every test sequence of the scene (each filter step a
CUDA graph on the card, the fused update kernel in every step), solves a
pose per frame with the batched PnP-RANSAC, and writes a JSON report
(median m / deg, 5 cm 5 deg accuracy, fps, and the coordinate-map accuracy
against ground-truth maps made from depth where the frames have it).

The flags are the JAX script's, with two differences. ``--use_pallas`` is
gone: the JAX config's fused kernel is off by default and the flag turned
it on, whereas the port's ``KFNetConfig.use_fused_kernel`` is on by
default, so the flag would do nothing. ``--device`` (``cuda`` unless given,
``utils/config.add_common_flags``) stands where the JAX script reads
``JAX_PLATFORMS``. ``--profile_dir`` writes a ``torch.profiler`` trace of
the first sequence there (Chrome trace JSON, ``trace.json``).

``--kfnet_ckpt`` reads a combined export: a ``train_kfnet`` export, or a
bf16 release such as the committed ``kfnet_tpu_torch/assets/
pretrained_full/stage3_sceneA``. Its meta's coordinate normalisation, its
trunk's norm and its serving point apply (as ``pretrained.load`` applies
them); explicit ``--chi2_threshold`` / ``--w_scale`` /
``--adaptive_alpha_max`` win over both.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import functools
import json
import os

import numpy as np
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch import pretrained
from kfnet_tpu_torch.data import labels as labels_lib
from kfnet_tpu_torch.data import registry
from kfnet_tpu_torch.eval import eval_sequence
from kfnet_tpu_torch.models import kfnet as kfnet_lib
from kfnet_tpu_torch.models import oflownet, scoordnet
from kfnet_tpu_torch.pose import metrics as pose_metrics
from kfnet_tpu_torch.pose import ransac, smoothing
from kfnet_tpu_torch.train.train_kfnet import load_pretrained
from kfnet_tpu_torch.utils import checkpoint as ckpt_lib
from kfnet_tpu_torch.utils import config as config_lib


def _parser() -> argparse.ArgumentParser:
  """The JAX script's flags (``--use_pallas`` apart) and ``--device``."""
  parser = config_lib.add_common_flags(argparse.ArgumentParser())
  parser.add_argument("--scoordnet_ckpt", default="")
  parser.add_argument("--oflownet_ckpt", default="")
  parser.add_argument("--kfnet_ckpt", default="",
                      help="combined stage-3 export ({scoordnet, "
                           "oflownet} tree from train_kfnet, or a release "
                           "export) — alternative to the two per-subnet "
                           "exports")
  parser.add_argument("--report", default="")
  parser.add_argument("--measurement_only", action="store_true")
  parser.add_argument("--streaming", action="store_true",
                      help="memory-bounded chunked eval (O(chunk) device "
                           "memory) for arbitrarily long sequences")
  parser.add_argument("--chunk_size", type=int, default=32)
  parser.add_argument("--uint8_stream", action="store_true",
                      help="with --streaming: upload uint8 frames (cast "
                           "and scaled on the device) — 4x fewer bytes "
                           "over the host link per chunk. For 8-bit "
                           "sources the re-quantization of the loaders' "
                           "n/255 is lossless; the device's cast "
                           "multiplies by 1/255 (the JAX package's "
                           "arithmetic), which may differ from n/255 in "
                           "the last place")
  parser.add_argument("--chi2_threshold", type=float, default=None,
                      help="override the consistency-test threshold "
                           "(chi-square 3 dof; default p=0.05 -> 7.81)")
  parser.add_argument("--w_scale", type=float, default=None,
                      help="eval-time process-noise temperature W <- s*W "
                           "(>1 deflates an overconfident OFlowNet on "
                           "scenes it never saw; see KFNetConfig.w_scale)")
  parser.add_argument("--adaptive_alpha_max", type=float, default=None,
                      help="innovation-adaptive prior inflation cap "
                           "(scene-agnostic alternative to --w_scale; "
                           "see KFNetConfig.adaptive_alpha_max)")
  parser.add_argument("--pose_smooth_beta", type=float, default=0.0,
                      help="gated constant-velocity SE(3) smoothing of "
                           "the solved trajectory (pose/smoothing.py; "
                           "0 = off, the reference protocol). Smoothed "
                           "poses flow into the report AND --dump_dir.")
  parser.add_argument("--pose_smooth_gate_factor", type=float, default=3.0,
                      help="relock gate in multiples of the stream's "
                           "frame-to-frame motion scale")
  parser.add_argument("--pose_smooth_rot_gate_deg", type=float, default=30.0,
                      help="relock when prediction and measurement "
                           "disagree by more than this rotation (deg)")
  parser.add_argument("--pnp_solver", default="dlt", choices=("dlt", "p3p"),
                      help="RANSAC minimal solver (p3p = 3-pt Grunert, "
                           "survives lower inlier ratios and is faster; "
                           "dlt = 6-pt, most robust on noisy maps)")
  parser.add_argument("--num_hypotheses", type=int, default=256)
  parser.add_argument("--inlier_threshold_px", type=float, default=10.0)
  parser.add_argument("--dump_dir", default="",
                      help="dump per-frame fused coord+uncertainty maps "
                           "(.npz) like the reference eval scripts")
  parser.add_argument("--profile_dir", default="",
                      help="write a torch.profiler trace (Chrome trace "
                           "JSON) of the first sequence into this dir")
  return parser


def load_kfnet_export(exp: config_lib.ExperimentConfig, path: str,
                      image_shape, device):
  """(KFNetConfig, params on ``device``) of a combined export: the
  experiment's nets with the meta's coordinate normalisation and trunk
  norm, its serving point (``pretrained._apply_serving``), and the
  weights cast to the config's dtypes (a bf16 release included)."""
  meta = ckpt_lib.load_meta(path) or {}
  scfg = exp.scoordnet
  if "coord_scale" in meta:
    scfg = dataclasses.replace(
        scfg, coord_offset=tuple(float(x) for x in meta["coord_offset"]),
        coord_scale=float(meta["coord_scale"]))
  if meta.get("scoordnet_norm"):
    # a self-describing export: the trunk the weights were trained with
    # wins over the config default (pretrained._scoordnet_config's rule)
    scfg = dataclasses.replace(scfg, norm=meta["scoordnet_norm"])
  cfg = pretrained._apply_serving(
      kfnet_lib.KFNetConfig(scoordnet=scfg, oflownet=exp.oflownet), meta)
  # the params' shapes and dtypes from the nets' init on the meta device
  gen = torch.Generator()
  template = {
      "scoordnet": scoordnet.init(gen, cfg.scoordnet, image_shape, "meta"),
      "oflownet": oflownet.init(gen, cfg.oflownet, image_shape, "meta")}
  return cfg, pretrained._load_params_cast(path, template, device)


def _write_dump_meta(dump_dir: str, meta: dict):
  """Fail fast on a stale dump directory (before any sequence runs): a
  meta.json of another scene or camera would make tools/eval_poses.py
  solve the new maps with the wrong intrinsics."""
  meta_path = os.path.join(dump_dir, "meta.json")
  if os.path.exists(meta_path):
    with open(meta_path) as f:
      old = json.load(f)
    if old != meta:
      raise ValueError(
          f"--dump_dir {dump_dir} already holds a dump for "
          f"{old.get('dataset')}/{old.get('scene')} with different "
          f"meta; use a fresh directory per scene/run")
  else:
    os.makedirs(dump_dir, exist_ok=True)
    with open(meta_path, "w") as f:
      json.dump(meta, f, indent=2)


@contextlib.contextmanager
def _profiled(profile_dir: str, device: torch.device):
  """A torch.profiler trace of the block, written to
  ``<profile_dir>/trace.json`` (host ops, and the card's where it runs)."""
  from torch.profiler import ProfilerActivity, profile
  acts = [ProfilerActivity.CPU] + (
      [ProfilerActivity.CUDA] if device.type == "cuda" else [])
  os.makedirs(profile_dir, exist_ok=True)
  with profile(activities=acts) as prof:
    yield
  if device.type == "cuda":
    torch.cuda.synchronize(device)
  prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))


def main(argv=None):
  parser = _parser()
  args = parser.parse_args(argv)
  if args.uint8_stream and not args.streaming:
    parser.error("--uint8_stream requires --streaming (the batch eval "
                 "commits float32 frames up front; a silently ignored flag "
                 "would mislabel the measurement)")
  exp = config_lib.from_args(args)
  device = kfnet_tpu_torch.resolve_device(exp.device)

  image_shape = exp.dataset.image_size + (3,)
  if args.kfnet_ckpt:
    if args.scoordnet_ckpt or args.oflownet_ckpt:
      raise ValueError("--kfnet_ckpt replaces --scoordnet_ckpt/"
                       "--oflownet_ckpt; pass one or the other")
    cfg, params = load_kfnet_export(exp, args.kfnet_ckpt, image_shape,
                                    device)
  else:
    cfg, params = load_pretrained(
        exp, image_shape, args.scoordnet_ckpt or None,
        args.oflownet_ckpt or None, seed=exp.seed, device=device)
  if args.chi2_threshold is not None:
    cfg = dataclasses.replace(cfg, chi2_threshold=args.chi2_threshold)
  if args.w_scale is not None:
    cfg = dataclasses.replace(cfg, w_scale=args.w_scale)
  if args.adaptive_alpha_max is not None:
    cfg = dataclasses.replace(cfg,
                              adaptive_alpha_max=args.adaptive_alpha_max)

  adapter = registry.get(exp.dataset.name)
  if adapter.name == "cambridge":
    split = adapter.load_split(exp.input_folder, exp.scene, "test")
  else:
    split = adapter.load_split(exp.input_folder, exp.scene, "test",
                               intrinsics=exp.dataset.intrinsics)
  K = np.asarray(split.intrinsics, np.float32)
  if args.dump_dir:
    _write_dump_meta(args.dump_dir, {
        "intrinsics": K.tolist(), "stride": exp.dataset.stride,
        "scene": exp.scene, "dataset": exp.dataset.name})
  rcfg = ransac.RansacConfig(
      solver=args.pnp_solver, num_hypotheses=args.num_hypotheses,
      inlier_threshold_px=args.inlier_threshold_px,
      refine_threshold_px=args.inlier_threshold_px)
  if args.measurement_only:
    # always chunk-bounded (measure_chunked); with --streaming the stack
    # also stays on the host and is uploaded a chunk at a time
    evaluate = functools.partial(eval_sequence.evaluate_measurement_only,
                                 chunk_size=args.chunk_size)
  elif args.streaming:
    evaluate = functools.partial(eval_sequence.evaluate_sequence_streaming,
                                 chunk_size=args.chunk_size)
  else:
    evaluate = eval_sequence.evaluate_sequence
  reports = []
  for i, seq_frames in enumerate(adapter.iter_sequences(split)):
    frames = [adapter.load_frame_with_split(split, fr) for fr in seq_frames]
    scene = f"{exp.scene}/{seq_frames[0].seq}"
    # streaming keeps the stack on the host, so that the chunked runner
    # uploads one chunk at a time; the batch eval uploads it whole
    host_stack = np.stack([f["image"] for f in frames])
    if args.streaming and args.uint8_stream:
      # the exact inverse of the loaders' /255 (see --uint8_stream)
      host_stack = np.clip(np.round(host_stack * 255.0), 0,
                           255).astype(np.uint8)
    images = (host_stack if args.streaming
              else torch.from_numpy(host_stack).to(device))
    gt = np.stack([f["pose"] for f in frames])
    profiling = (_profiled(args.profile_dir, device)
                 if args.profile_dir and i == 0 else contextlib.nullcontext())
    with profiling:
      res = evaluate(params, cfg, images, K, gt_poses=gt, scene=scene,
                     stride=exp.dataset.stride, ransac_config=rcfg,
                     device=device)
    if args.pose_smooth_beta > 0.0:
      res.poses = smoothing.smooth_trajectory(
          res.poses, smoothing.SmootherConfig(
              beta=args.pose_smooth_beta,
              gate_factor=args.pose_smooth_gate_factor,
              rot_gate_deg=args.pose_smooth_rot_gate_deg))
      if res.report is not None:
        fps = res.report["frames_per_sec"]
        res.report = pose_metrics.report(scene, res.poses, gt)
        res.report["frames_per_sec"] = fps
        res.report["pose_smooth_beta"] = args.pose_smooth_beta
    if args.dump_dir:
      # one file a frame, as the reference eval scripts dump their maps;
      # meta.json makes the dump self-contained for tools/eval_poses.py
      seq_dir = os.path.join(args.dump_dir, seq_frames[0].seq)
      os.makedirs(seq_dir, exist_ok=True)
      for t, fr in enumerate(seq_frames):
        np.savez_compressed(
            os.path.join(seq_dir, f"frame-{fr.index:06d}"),
            coords=res.coords[t], covariance=res.covariance[t],
            pose=res.poses[t], pose_gt=gt[t])
    if all("depth" in f for f in frames):
      # coordinate accuracy against the depth and pose's ground-truth maps
      depths = torch.from_numpy(np.stack([f["depth"] for f in frames])).to(
          device)
      K_dev = torch.from_numpy(K).to(device)
      T_dev = torch.from_numpy(gt.astype(np.float32)).to(device)
      maps = [labels_lib.generate(d, K_dev, T, stride=exp.dataset.stride,
                                  min_depth=exp.dataset.min_depth,
                                  max_depth=exp.dataset.max_depth)
              for d, T in zip(depths, T_dev)]
      res.report.update(eval_sequence.coord_accuracy_report(
          res.coords, torch.stack([m[0] for m in maps]).cpu().numpy(),
          torch.stack([m[1] for m in maps]).cpu().numpy()))
    reports.append(res.report)
    print(json.dumps(res.report))
  if args.report:
    eval_sequence.write_report(args.report, reports)
  return reports


if __name__ == "__main__":
  main()
