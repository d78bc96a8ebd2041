"""Multi-scene dress rehearsal of the full three-stage KFNet training recipe
on procedural synthetic scenes (port of ``kfnet_tpu/tools/protocol.py``):
the closest stand-in for the 7-Scenes acceptance protocol without the
dataset.

  stage 1  SCoordNet per scene (every scene, held-out and outdoor included)
  stage 2  one OFlowNet per "dataset", trained across that dataset's
           training scenes, the held-out scene excluded: OFlowNet is
           scene-agnostic (paper §4.2), so the held-out scene's eval with
           the frozen net tests the transfer claim directly.
  stage 3  the joint filtering fine-tune per training scene (2-frame
           pairs, ``objectives.kfnet_objective``: its prior NLL needs the
           warped prior, so it trains through the composition).
  eval     the recursive filter + PnP per scene, filtered against
           measurement-only medians; the held-out row uses an OFlowNet
           that never saw the scene, the outdoor row runs at a
           Cambridge-like world scale (coordinates about 20x, depth tens of
           metres). On the card the filtered runs take the fused update
           kernel.

    python -m kfnet_tpu_torch.tools.protocol [--report report.json] [--fast]
        [--full_size --work_dir DIR] [--device cuda]

``--fast`` is the miniature; ``--full_size`` the flagship nets at 640x480.

A stage's cache is ``<work_dir>/<stage>/params.npz`` + ``meta.json``
(``utils/checkpoint.export_params``, the JAX package's layouts), found by
``checkpoint.has_params``, which also finds the JAX package's orbax stage
caches (``<stage>/params`` + ``meta.json``); both are read.
``--device`` (``cuda`` unless given; raises without one) is the one
flag the JAX tool lacks.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import torch

import kfnet_tpu_torch
from kfnet_tpu_torch import configs as _presets
from kfnet_tpu_torch.data import labels, synthetic
from kfnet_tpu_torch.eval import eval_sequence
from kfnet_tpu_torch.eval import stats as stats_lib
from kfnet_tpu_torch.models import kfnet, oflownet, scoordnet
from kfnet_tpu_torch.nn import layers as L
from kfnet_tpu_torch.pose import metrics as pose_metrics
from kfnet_tpu_torch.train import objectives
from kfnet_tpu_torch.train.device_fit import fit_on_device
from kfnet_tpu_torch.utils import checkpoint as ckpt_lib


@dataclasses.dataclass(frozen=True)
class SceneSpec:
  name: str
  seed: int
  scale: float = 1.0        # world scale (20 ≈ Cambridge outdoor)
  dataset: str = "indoor"   # OFlowNet is trained per dataset
  held_out: bool = False    # excluded from OFlowNet (+joint) training


DEFAULT_SCENES = (
    SceneSpec("sceneA", seed=0),
    SceneSpec("sceneB", seed=10),
    SceneSpec("sceneC", seed=20),
    SceneSpec("heldout", seed=30, held_out=True),
    # the outdoor "dataset": OFlowNet trains on outdoor_train only, so the
    # outdoor eval scene is also a transfer test at 20x coordinate scale
    SceneSpec("outdoor_train", seed=50, scale=20.0, dataset="outdoor"),
    SceneSpec("outdoor", seed=40, scale=20.0, dataset="outdoor",
              held_out=True),
)


def _labels_of(seq, max_depth):
  maps = [labels.generate(d, seq["K"], T, stride=8, max_depth=max_depth)
          for d, T in zip(seq["depths"], seq["poses"])]
  return (torch.stack([c for c, _ in maps]),
          torch.stack([v for _, v in maps]))


def _scene_data(spec: SceneSpec, H, W, train_frames, test_frames,
                eval_traj_offset=0, device=None):
  train = synthetic.make_sequence(train_frames, height=H, width=W,
                                  seed=spec.seed, scale=spec.scale,
                                  traj_seed=spec.seed + 1, device=device)
  # Test duration scales with length so per-frame motion stays constant:
  # a longer eval sequence (for statistical power) must not shrink
  # inter-frame flow, or the filtering task gets easier as T grows.
  # eval_traj_offset draws a DIFFERENT held-out camera trajectory over
  # the same scene: the final validation of a calibration chosen on the
  # default test streams must run out of sample (fresh trajectories).
  test = synthetic.make_sequence(test_frames, height=H, width=W,
                                 seed=spec.seed, scale=spec.scale,
                                 traj_seed=spec.seed + 99 + eval_traj_offset,
                                 duration=test_frames / float(train_frames),
                                 device=device)
  max_depth = 10.0 * spec.scale
  coords, valid = _labels_of(train, max_depth)
  tcoords, tvalid = _labels_of(test, max_depth)
  return {"spec": spec, "train": train, "test": test,
          "coords": coords, "valid": valid,
          "test_coords": tcoords, "test_valid": tvalid}


def _cached_meta_norm(work_dir, name):
  """Trunk norm recorded in a cached stage's meta (None if no cache or
  the meta predates the field). Stage exports are self-describing
  (scoordnet_norm is written at train time); the loader must trust the
  cache over the config default, or a GroupNorm cache evaluated after a
  default change (or a norm="none" cache loaded without the flag) would
  rebuild the wrong graph around the stored weights."""
  if not work_dir:
    return None
  d = os.path.join(work_dir, name)
  if not ckpt_lib.has_params(d):
    return None
  return (ckpt_lib.load_meta(d) or {}).get("scoordnet_norm")


def _cached_stage(work_dir, name, template, fit_fn, strict=False,
                  meta=None):
  """Stage-level resume: if ``work_dir/name`` holds an export, restore it
  instead of re-training (long full-size runs survive a crash, at
  protocol granularity). The export is read into ``template``'s
  structure, devices and dtypes, and refused where its tree or shapes
  differ. Returns (params, final_loss)."""
  from kfnet_tpu_torch import pretrained
  if work_dir:
    d = os.path.join(work_dir, name)
    if ckpt_lib.has_params(d):
      meta = ckpt_lib.load_meta(d) or {}
      return (pretrained._load_params_cast(
          d, template, L.tree_leaves(template)[0].device),
              float(meta.get("final_loss", float("nan"))))
  if strict:
    raise RuntimeError(
        f"stage {name!r} is not cached in {work_dir!r} (no "
        f"{ckpt_lib.PARAMS_FILE} or orbax export) but strict_cache was "
        "requested (eval-only reuse, e.g. "
        "tools/calibrate.py) — a silent retrain here would evaluate "
        "different weights than the run being analyzed")
  params, m = fit_fn()
  loss = float(m["loss"])
  if work_dir:
    # meta makes the export SELF-DESCRIBING (a fresh clone can rebuild
    # the exact net config without regenerating scene data)
    ckpt_lib.export_params(os.path.join(work_dir, name), params,
                           meta={"final_loss": loss, **(meta or {})})
  return params, loss


def prepare_stages(H=96, W=128, train_frames=48, test_frames=48,
                   sc_steps=1200, of_steps=1000, joint_steps=200,
                   lr=2e-3, scenes=DEFAULT_SCENES, log=print,
                   full_size=False, work_dir=None, strict_cache=False,
                   eval_traj_offset=0, scoordnet_norm=None, device=None):
  """Stages 1–3 of the protocol (training; cached per stage in work_dir),
  on ``device`` (``cuda`` unless given).

  Returns (data, of, of_train_scenes, joint): per-scene rendered data,
  per-dataset frozen OFlowNets, their training-scene lists, and per-scene
  (KFNetConfig, params). Split from evaluation so calibration sweeps
  (tools/calibrate.py) can re-evaluate cached stages without retraining;
  strict_cache=True makes any cache miss an error (and lets callers pass
  a SINGLE scene while stage 2/3 load per-dataset caches trained on the
  full scene set — training pair data is only assembled when a stage
  actually trains)."""
  device = kfnet_tpu_torch.resolve_device(device)
  data = {s.name: _scene_data(s, H, W, train_frames, test_frames,
                              eval_traj_offset=eval_traj_offset,
                              device=device)
          for s in scenes}
  sc_cfg_fn = (_presets.full_scoordnet if full_size
               else _presets.small_scoordnet)
  if scoordnet_norm is not None:
    # normalization ablation (norm="none" ≈ the reference's plain
    # conv+ReLU trunk — see tools/norm_study.py); stage names do NOT
    # encode the norm, so point work_dir at a dedicated cache dir
    base_fn = sc_cfg_fn
    sc_cfg_fn = lambda mean, std: dataclasses.replace(  # noqa: E731
        base_fn(mean, std), norm=scoordnet_norm)
  of_cfg_fn = (_presets.full_oflownet if full_size
               else _presets.small_oflownet)
  # batch/chunk mirror demo --full_size
  sc_batch, sc_chunk = 8, 250
  joint_batch = 2 if full_size else 4
  joint_chunk = 50 if full_size else 250
  gen = torch.Generator(device=device)

  # ---- stage 1: SCoordNet per scene -------------------------------------
  sc = {}
  for s in scenes:
    d = data[s.name]
    mean, std = labels.scene_statistics([d["coords"].cpu().numpy()],
                                        [d["valid"].cpu().numpy()])
    cfg = sc_cfg_fn(mean, std)
    cached_norm = _cached_meta_norm(work_dir, f"stage1_{s.name}")
    if cached_norm is not None and cached_norm != cfg.norm:
      if scoordnet_norm is None:
        # no explicit request: honor the cache's own record
        cfg = dataclasses.replace(cfg, norm=cached_norm)
      else:
        raise RuntimeError(
            f"stage1_{s.name} in {work_dir!r} was trained with "
            f"norm={cached_norm!r} but --scoordnet_norm="
            f"{scoordnet_norm!r} was requested — refusing to rebuild a "
            "different graph around cached weights (point at the right "
            "cache dir, or drop the flag to honor the cache's meta)")
    params = scoordnet.init(gen.manual_seed(s.seed + 7), cfg, (H, W, 3),
                            device)
    loss_fn = objectives.scoordnet_objective(cfg)
    batch = {"image": d["train"]["images"], "coords": d["coords"],
             "valid": d["valid"]}
    trained, _ = _cached_stage(
        work_dir, f"stage1_{s.name}", params,
        lambda: (lambda st, m: (st.params, m))(*fit_on_device(
            loss_fn, params, batch, sc_steps, lr,
            batch=sc_batch, chunk=sc_chunk,
            tag=f"stage1[{s.name}]", log=log, device=device)),
        strict=strict_cache,
        meta={"scene": s.name, "seed": s.seed, "height": H, "width": W,
              "full_size": bool(full_size),
              "scoordnet_norm": cfg.norm,
              "coord_offset": [float(x) for x in mean],
              "coord_scale": float(std)})
    sc[s.name] = (cfg, trained)

  # ---- stage 2: one OFlowNet per dataset, held-out scenes excluded ------
  of = {}
  of_train_scenes = {}
  for dataset in sorted({s.dataset for s in scenes}):
    members = [s for s in scenes if s.dataset == dataset and not s.held_out]
    of_train_scenes[dataset] = [s.name for s in members]
    cfg = of_cfg_fn()
    params = oflownet.init(gen.manual_seed(101), cfg, (H, W, 3), device)

    def fit_stage2(members=members, cfg=cfg, params=params,
                   dataset=dataset):
      # pair data is assembled ONLY when the stage actually trains (a
      # cached load must not pay it); it stays on the device
      pair = {k: [] for k in ("image_prev", "image", "coords_prev",
                              "valid_prev", "coords", "valid")}
      for s in members:
        d = data[s.name]
        pair["image_prev"].append(d["train"]["images"][:-1])
        pair["image"].append(d["train"]["images"][1:])
        pair["coords_prev"].append(d["coords"][:-1])
        pair["valid_prev"].append(d["valid"][:-1])
        pair["coords"].append(d["coords"][1:])
        pair["valid"].append(d["valid"][1:])
      pair = {k: torch.cat(v) for k, v in pair.items()}
      loss_fn = objectives.oflownet_objective(cfg, flow_reg_weight=0.01)
      st, m = fit_on_device(loss_fn, params, pair, of_steps, lr,
                            tag=f"stage2[{dataset}]", seed=1, log=log,
                            device=device)
      return st.params, m

    trained, final_loss = _cached_stage(
        work_dir, f"stage2_{dataset}", params, fit_stage2,
        strict=strict_cache,
        meta={"dataset": dataset, "scenes": of_train_scenes[dataset],
              "height": H, "width": W, "full_size": bool(full_size)})
    if not of_train_scenes[dataset] and work_dir:
      # single-scene (eval_only) call for a held-out scene: the cached
      # OFlowNet WAS trained on scenes this invocation cannot see —
      # recover the list from the export meta so reports stay truthful
      m2 = ckpt_lib.load_meta(os.path.join(work_dir,
                                           f"stage2_{dataset}")) or {}
      of_train_scenes[dataset] = m2.get("scenes",
                                        ["<cached; meta predates list>"])
    of[dataset] = (cfg, trained, final_loss)

  # ---- stage 3: joint fine-tune per training scene ----------------------
  joint = {}
  for s in scenes:
    sc_cfg, sc_params = sc[s.name]
    of_cfg, of_params, _ = of[s.dataset]
    cfg = kfnet.KFNetConfig(scoordnet=sc_cfg, oflownet=of_cfg)
    params = {"scoordnet": sc_params, "oflownet": of_params}
    s3_norm = _cached_meta_norm(work_dir, f"stage3_{s.name}")
    if s3_norm is not None and s3_norm != cfg.scoordnet.norm:
      raise RuntimeError(
          f"stage3_{s.name} in {work_dir!r} records norm={s3_norm!r} but "
          f"stage1_{s.name} resolved to norm={cfg.scoordnet.norm!r} — "
          "the cache dir mixes trunks; regenerate it")
    if joint_steps > 0 and not s.held_out:
      def fit_stage3(cfg=cfg, params=params, name=s.name):
        d = data[name]  # assembled only on a real (non-cached) train
        pair = {"image_prev": d["train"]["images"][:-1],
                "image": d["train"]["images"][1:],
                "coords": d["coords"][1:], "valid": d["valid"][1:]}
        # the pair objective's prior NLL needs the composition's prior
        st, m = fit_on_device(
            objectives.kfnet_objective(
                dataclasses.replace(cfg, use_fused_kernel=False)),
            params, pair, joint_steps, lr * 0.1, batch=joint_batch,
            chunk=joint_chunk, tag=f"stage3[{name}]", seed=2, log=log,
            device=device)
        return st.params, m

      params, _ = _cached_stage(
          work_dir, f"stage3_{s.name}", params, fit_stage3,
          strict=strict_cache,
          meta={"scene": s.name, "seed": s.seed, "height": H, "width": W,
                "full_size": bool(full_size),
                "scoordnet_norm": cfg.scoordnet.norm,
                "coord_offset": list(cfg.scoordnet.coord_offset),
                "coord_scale": float(cfg.scoordnet.coord_scale)})
    joint[s.name] = (cfg, params)

  return data, of, of_train_scenes, joint


def stress_images(images, stress: float, seed: int):
  """Per-frame pixel noise + brightness flicker on a test stream (train
  stays clean): a flicker uniform in ±3·stress per frame, Gaussian noise
  of σ = stress per pixel, clipped to [0, 1]. On clean synthetic frames
  the measurement net is near-perfect and the filtered-vs-measurement
  delta is seed noise; independent per-frame corruption is the regime the
  temporal filter exists for (paper §1), so this is the discriminative
  variant of the protocol.

  Drawn on the frames' device from a ``torch.Generator`` seeded with
  ``seed``: the same seed gives the same frames, but not the JAX
  package's bits (its PRNG is another)."""
  images = torch.as_tensor(images)
  gen = torch.Generator(device=images.device).manual_seed(seed)
  T = images.shape[0]
  flicker = (torch.rand((T, 1, 1, 1), generator=gen, device=images.device)
             * (6 * stress) - 3 * stress)
  noise = torch.randn(images.shape, generator=gen,
                      device=images.device) * stress
  return torch.clamp(images.to(torch.float32) + flicker + noise, 0.0, 1.0)


def evaluate_scenes(data, of, of_train_scenes, joint,
                    scenes=DEFAULT_SCENES, full_size=False, log=print,
                    stress=0.0, chi2_threshold=None, w_scale=None,
                    per_scene_w_scale=None, bootstrap_block=24,
                    adaptive_alpha_max=None):
  """Filtered vs measurement-only eval per scene, where its params live,
  with PAIRED per-frame deltas + moving-block-bootstrap CIs (the decisive
  statistic — scene medians of short sequences are seed-noise-dominated;
  see eval/stats.py).

  chi2_threshold / w_scale (global) and per_scene_w_scale (dict
  scene→float, wins over global) override the filter calibration at eval
  time without touching trained weights.
  """
  rcfg = _presets.synthetic_ransac(full_size)  # mirrors demo --full_size
  reports = []
  for s in scenes:
    cfg, params = joint[s.name]
    overrides = {}
    if chi2_threshold is not None:
      overrides["chi2_threshold"] = float(chi2_threshold)
    ws = (per_scene_w_scale or {}).get(s.name, w_scale)
    if ws is not None:
      overrides["w_scale"] = float(ws)
    if adaptive_alpha_max is not None:
      overrides["adaptive_alpha_max"] = float(adaptive_alpha_max)
    if overrides:
      cfg = dataclasses.replace(cfg, **overrides)
    d = data[s.name]
    K = d["train"]["K"].cpu().numpy()
    gt = d["test"]["poses"].cpu().numpy()
    test_imgs = d["test"]["images"]
    if stress > 0:
      test_imgs = stress_images(test_imgs, stress, s.seed + 5)
    res_m = eval_sequence.evaluate_measurement_only(
        params, cfg, test_imgs, K, gt_poses=gt,
        scene=s.name, ransac_config=rcfg)
    res_f = eval_sequence.evaluate_sequence(
        params, cfg, test_imgs, K, gt_poses=gt,
        scene=s.name, ransac_config=rcfg)
    acc_f = eval_sequence.coord_accuracy_report(
        res_f.coords, d["test_coords"].cpu().numpy(),
        d["test_valid"].cpu().numpy())
    # paired per-frame deltas: the same frame under both modes
    t_f, r_f = pose_metrics.pose_errors(res_f.poses, gt)
    t_m, r_m = pose_metrics.pose_errors(res_m.poses, gt)
    paired = {}
    paired.update(stats_lib.paired_delta_report(
        t_f, t_m, block=bootstrap_block, prefix="translation_"))
    paired.update(stats_lib.paired_delta_report(
        r_f, r_m, block=bootstrap_block, prefix="rotation_"))
    # stage-2 NLL on this scene's pairs with its dataset's frozen OFlowNet
    # (the outdoor rows prove the loss stays finite at 20x coord scale)
    of_cfg, of_params, of_final_loss = of[s.dataset]
    row = {
        "scene": s.name,
        "dataset": s.dataset,
        "held_out": s.held_out,
        "world_scale": s.scale,
        "oflownet_trained_on": of_train_scenes[s.dataset],
        "coord_scale": joint[s.name][0].scoordnet.coord_scale,
        "chi2_threshold": float(cfg.chi2_threshold),
        "w_scale": float(cfg.w_scale),
        "adaptive_alpha_max": float(cfg.adaptive_alpha_max),
        "median_translation_m": res_f.report["median_translation_m"],
        "median_rotation_deg": res_f.report["median_rotation_deg"],
        "accuracy_5cm_5deg": res_f.report["accuracy_5cm_5deg"],
        "measurement_only_translation_m":
            res_m.report["median_translation_m"],
        "measurement_only_rotation_deg":
            res_m.report["median_rotation_deg"],
        **paired,
        "median_coord_err_m": acc_f["median_coord_err_m"],
        "stage2_final_loss": of_final_loss,
        "frames": int(gt.shape[0]),
        "stress": float(stress),
    }
    reports.append(row)
    if log:
      log(json.dumps(row))
  return reports


def run_protocol(H=96, W=128, train_frames=48, test_frames=48,
                 sc_steps=1200, of_steps=1000, joint_steps=200,
                 lr=2e-3, scenes=DEFAULT_SCENES, log=print,
                 full_size=False, work_dir=None, stress=0.0,
                 chi2_threshold=None, w_scale=None,
                 adaptive_alpha_max=None, eval_traj_offset=0,
                 eval_only=False, scoordnet_norm=None, device=None):
  """Full protocol = prepare_stages (cached training) + evaluate_scenes.

  full_size=True uses the flagship 23.6M-param bf16 SCoordNet and default
  OFlowNet (pair with H, W = 480, 640 and demo --full_size hyperparams).
  work_dir enables per-stage checkpointing (crash → rerun skips finished
  stages; an eval-only re-run with new test_frames/stress/calibration
  settings reuses all training).

  eval_only=True requires every stage cached (strict) and processes ONE
  scene at a time, freeing it before the next: a long full-size test
  render is gigabytes of device memory per scene."""
  common = dict(H=H, W=W, train_frames=train_frames,
                test_frames=test_frames, sc_steps=sc_steps,
                of_steps=of_steps, joint_steps=joint_steps, lr=lr,
                log=log, full_size=full_size, work_dir=work_dir,
                eval_traj_offset=eval_traj_offset,
                scoordnet_norm=scoordnet_norm, device=device)
  eval_kw = dict(full_size=full_size, log=log, stress=stress,
                 chi2_threshold=chi2_threshold, w_scale=w_scale,
                 adaptive_alpha_max=adaptive_alpha_max)
  if eval_only:
    reports = []
    for s in scenes:
      data, of, of_train_scenes, joint = prepare_stages(
          scenes=(s,), strict_cache=True, **common)
      data[s.name]["test"].pop("depths", None)  # labels already built
      reports += evaluate_scenes(data, of, of_train_scenes, joint,
                                 scenes=(s,), **eval_kw)
      del data, of, joint
    return reports
  data, of, of_train_scenes, joint = prepare_stages(scenes=scenes,
                                                    **common)
  return evaluate_scenes(data, of, of_train_scenes, joint, scenes=scenes,
                         **eval_kw)


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--report", default="")
  p.add_argument("--height", type=int, default=96)
  p.add_argument("--width", type=int, default=128)
  p.add_argument("--train_frames", type=int, default=48)
  p.add_argument("--test_frames", type=int, default=48)
  p.add_argument("--sc_steps", type=int, default=1200)
  p.add_argument("--of_steps", type=int, default=1000)
  p.add_argument("--joint_steps", type=int, default=None,
                 help="stage-3 steps (default 200; 400 under "
                      "--full_size). An explicit value always wins.")
  p.add_argument("--learning_rate", type=float, default=2e-3)
  p.add_argument("--stress", type=float, default=0.0,
                 help="per-frame measurement stress on the TEST stream "
                      "(pixel-noise sigma; also drives +-3x brightness "
                      "flicker). ~0.08 = the discriminative protocol "
                      "variant where temporal filtering must win")
  p.add_argument("--chi2_threshold", type=float, default=None,
                 help="override the filter's chi^2(3) consistency gate at "
                      "eval time (default: the trained config's)")
  p.add_argument("--w_scale", type=float, default=None,
                 help="eval-time process-noise temperature (W <- s*W); "
                      ">1 deflates an overconfident frozen OFlowNet on "
                      "unseen scenes (see KFNetConfig.w_scale)")
  p.add_argument("--adaptive_alpha_max", type=float, default=None,
                 help="innovation-adaptive prior inflation cap (scene-"
                      "agnostic; see KFNetConfig.adaptive_alpha_max)")
  p.add_argument("--eval_traj_offset", type=int, default=0,
                 help="offset the TEST trajectory seed only (fresh "
                      "out-of-sample camera path over the same scenes "
                      "and cached stages — use for final validation of "
                      "calibration chosen on the default streams)")
  p.add_argument("--seed_offset", type=int, default=0,
                 help="offset every scene's seed (fresh geometry, "
                      "trajectories, and inits) — run the protocol a "
                      "second time to separate real effects from "
                      "single-seed noise")
  p.add_argument("--scenes", default="",
                 help="comma-separated subset of the default scene set")
  p.add_argument("--fast", action="store_true",
                 help="miniature run")
  p.add_argument("--work_dir", default="",
                 help="per-stage checkpoint dir: a crashed run rerun with "
                      "the same flags skips finished stages")
  p.add_argument("--eval_only", action="store_true",
                 help="strict-cache, one-scene-at-a-time evaluation "
                      "(required for long statistical-power test "
                      "sequences at full size — see run_protocol)")
  p.add_argument("--scoordnet_norm", default=None,
                 choices=("group", "none", "ws"),
                 help="override SCoordNet trunk normalization (ablation; "
                      "'none' ≈ the reference's plain conv+ReLU trunk, "
                      "'ws' = scaled weight standardization). Use a "
                      "dedicated --work_dir: stage cache names do not "
                      "encode the norm")
  p.add_argument("--full_size", action="store_true",
                 help="flagship 23.6M-param bf16 nets at 640x480 (the "
                      "acceptance-protocol dress rehearsal). Overrides "
                      "size/step flags.")
  p.add_argument("--device", default=None,
                 help="cuda (the default; raises without one) or cpu")
  args = p.parse_args(argv)
  joint_steps = 200 if args.joint_steps is None else args.joint_steps
  kw = dict(H=args.height, W=args.width, train_frames=args.train_frames,
            test_frames=args.test_frames, sc_steps=args.sc_steps,
            of_steps=args.of_steps, joint_steps=joint_steps,
            lr=args.learning_rate, work_dir=args.work_dir or None,
            stress=args.stress, chi2_threshold=args.chi2_threshold,
            w_scale=args.w_scale,
            adaptive_alpha_max=args.adaptive_alpha_max,
            eval_traj_offset=args.eval_traj_offset,
            eval_only=args.eval_only, scoordnet_norm=args.scoordnet_norm,
            device=kfnet_tpu_torch.resolve_device(args.device))
  if args.fast:
    kw.update(H=48, W=64, train_frames=24, test_frames=16,
              sc_steps=300, of_steps=250,
              joint_steps=(50 if args.joint_steps is None
                           else args.joint_steps))
  if args.full_size:
    kw.update(H=480, W=640, full_size=True, lr=3e-4,
              sc_steps=max(args.sc_steps, 3000),
              of_steps=max(args.of_steps, 2000),
              joint_steps=(400 if args.joint_steps is None
                           else args.joint_steps))
  scenes = DEFAULT_SCENES
  if args.seed_offset:
    scenes = tuple(dataclasses.replace(s, seed=s.seed + args.seed_offset)
                   for s in scenes)
  if args.scenes:
    keep = set(args.scenes.split(","))
    scenes = tuple(s for s in scenes if s.name in keep)
  if scenes != DEFAULT_SCENES:
    kw["scenes"] = scenes
  reports = run_protocol(**kw)
  if args.report:
    with open(args.report, "w") as f:
      json.dump({"scenes": reports}, f, indent=2)
  return reports


if __name__ == "__main__":
  main()
