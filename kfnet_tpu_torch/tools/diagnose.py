"""Root-cause diagnostic for the held-out clean-stream filtering harm (port
of ``kfnet_tpu/tools/diagnose.py``).

On clean test streams the filtered pose can be WORSE than
measurement-only on held-out scenes even though the innovation statistics
are fully consistent (mean Mahalanobis ≤ 3 — the adaptive-S sweep never
fires there). This tool pins WHY, per scene, at three levels:

  1. FIELD statistics: coordinate-space error, spatial autocorrelation,
     per-frame global bias, RANSAC inlier ratio — if the filter improves
     or holds coordinate error while pose error worsens, the harm is not
     a mis-weighted average but a STRUCTURE change.
  2. STRUCTURE statistics: the per-frame Kabsch rigid / non-rigid split,
     its camera-implied (lever-arm-amplified) pose error, the same
     restricted to the σ-selected PnP pool, the pool's lever-arm
     geometry, σ-ranking quality, and the radial/tangential split of the
     residual wrt viewing rays (radial error reprojects identically —
     reprojection-threshold RANSAC cannot reject it). See
     ``residual_stats`` for each statistic's rationale.
  3. COUNTERFACTUAL solves (``--modes cf_``): re-run the unchanged solver
     on maps with the fitted rigid deformation removed (``cf_derigid`` /
     ``cf_derigid_pool``) or isolated (``cf_rigidonly``) — turning the
     correlational stats above into a causal attribution. See
     ``counterfactual_maps``.

    python -m kfnet_tpu_torch.tools.diagnose --work_dir .protocol_cache/full \
        --full_size --scene heldout --report DIAGNOSE_heldout_s1.json
    # targeted stat upgrade (merge keeps the other mode rows):
    ... --modes measurement_only --report <same file>
    # counterfactual modes only:
    ... --modes cf_ --report <same file>

The statistics are host numpy (float64), as in the JAX tool; the series
come from ``tools/calibrate.py`` on the device, and the pose solves draw
from a generator seeded with 0 before each solve. Table:
``tools/diagnose_summary.py``. ``--device`` (``cuda`` unless given; raises
without one) is the one flag the JAX tool lacks. The report also records
``seed_offset`` and ``scoordnet_norm``, which the JAX tool's does not, and
a ``--modes`` re-run merges only into a report made under the same
settings (``RUN_KEYS``); any other raises ``ValueError``.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os

import numpy as np
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch import configs
from kfnet_tpu_torch.core import kalman
from kfnet_tpu_torch.eval import eval_sequence
from kfnet_tpu_torch.pose import metrics as pose_metrics
from kfnet_tpu_torch.tools import calibrate, protocol


def _kabsch(p, g):
  """Best-fit rigid transform (R, t) mapping points p -> g (least
  squares over rows; standard Kabsch/Procrustes without scaling)."""
  pc, gc = p.mean(axis=0), g.mean(axis=0)
  H = (p - pc).T @ (g - gc)
  U, _, Vt = np.linalg.svd(H)
  d = np.sign(np.linalg.det(Vt.T @ U.T))
  R = Vt.T @ np.diag([1.0, 1.0, d]) @ U.T
  t = gc - R @ pc
  return R, t


def _rank(a):
  """Average ranks (ties share their mean rank — scipy.rankdata
  semantics) for a true Spearman correlation. Ordinal ranks would be
  wrong exactly where this statistic matters: a transfer scene's
  variance map saturates the head's log-variance clip in blocks, and
  raster-ordering those ties against a spatially-autocorrelated error
  field manufactures spurious correlation."""
  order = np.argsort(a, kind="stable")
  r = np.empty(a.size, np.float64)
  r[order] = np.arange(a.size, dtype=np.float64)
  s = a[order]
  # average the rank over each run of equal values
  boundaries = np.flatnonzero(np.r_[True, s[1:] != s[:-1], True])
  for i in range(boundaries.size - 1):
    lo, hi = boundaries[i], boundaries[i + 1]
    if hi - lo > 1:
      r[order[lo:hi]] = 0.5 * (lo + hi - 1)
  return r


def residual_stats(coords, gt_coords, valid, variance=None, top_k=None,
                   cam_centers=None):
  """Per-sequence coordinate residual: median norm, lag-1 spatial
  autocorrelation of the residual field (mean over frames/channels), and
  the per-frame GLOBAL bias ‖mean residual vector‖. The bias statistic
  separates two failure shapes PnP treats very differently: zero-mean
  scatter (RANSAC rejects or averages it out) vs a rigid shift of the
  whole coordinate field (every point stays an inlier, the pose absorbs
  the shift — invisible to both the median norm and lag-1 autocorr).

  Rigid (Kabsch) decomposition — the statistic the round-4 frame-bias
  number turned out to be too weak to see: per frame, fit the best rigid
  transform aligning the predicted field to GT.
    * median_rigid_move_m — how far that rigid correction moves the
      points (the POSE-SHAPED component of field error: a rotation /
      translation-correlated deformation that PnP cannot reject, because
      it IS a pose — every point stays an inlier and the solver returns
      the deformed pose with high confidence). A pure global shift is
      the special case frame_bias measures; rotation-like deformations
      have small mean but large rigid_move.
    * median_resid_after_rigid_m — the non-rigid remainder (what PnP can
      actually average out or reject).

  σ-ranking quality (needs ``variance``): the solver preselects the
  top-k lowest-σ cells (pose/ransac.select_confident), so a trunk whose
  σ mis-ranks under transfer feeds PnP a worse pool than the field
  median suggests. The pool here is the k lowest-σ cells among those
  valid in the ground truth: select_confident ranks every cell, but an
  error needs a GT label, so the statistics below cannot rank the cells
  the solver does where GT is missing.
    * median_topk_coord_err_m — field error restricted to that pool.
    * sigma_err_rank_corr — mean per-frame Spearman ρ(σ, ‖err‖); ~0
      means confidence is uninformative, <0 means anti-informative.

  Pool-restricted deformation + geometry (needs ``variance`` AND
  ``cam_centers``): the full-field Kabsch stats above can UNDERPREDICT
  the pose error when the harm lives inside the σ-selected pool — the
  round-5 outdoor s1 data showed exactly that shape (nonorm full-field
  implied_cam 0.52 m vs 2.12 m actual; GN tracked within 35%). Two
  sub-mechanisms, measured on the same top-k pool PnP consumes:
    * pool_rigid_rot_deg / pool_implied_cam_move_m /
      pool_resid_after_rigid_m — the Kabsch decomposition restricted to
      the pool. If σ selects a COHERENTLY-deformed subset (e.g. one
      facade whose depth is consistently mis-scaled), the pool's own
      rigid fit is pose-large even when the full field's is small, and
      pool_implied_cam_move predicts the pose error the solver returns.
    * pool_cloud_radius_m / pool_lever_arm_gain — GT geometry of the
      pool. If σ-selection spatially CONCENTRATES the pool (one nearby
      structure), the pool's lever arm d/r_pool exceeds the scene's;
      PnP conditioning degrades and point-small errors become
      pose-large even without a coherent deformation.

  Camera-implied deformation (needs ``cam_centers``, the GT camera
  positions per frame): rigid_move measures the deformation AT THE
  POINTS, but PnP recovers the CAMERA, and the two are related by a
  lever arm. The Kabsch fit gives A(p)=R·p+t mapping predicted→GT, so
  the predicted field is the GT world seen through A⁻¹; the pose PnP
  returns is then A⁻¹ of the true camera. A rotation by θ about the
  visible structure's centroid moves points only ~r·θ (r = cloud
  radius) but moves the implied camera ~d·θ (d = camera-to-centroid
  distance) — outdoors d ≫ r and a point-small deformation is
  pose-large. These statistics measure the deformation where the pose
  lives:
    * median_rigid_rot_deg — rotation angle of the per-frame Kabsch R
      (conjugation by A⁻¹ preserves the angle, so this IS the implied
      camera-orientation error).
    * median_implied_cam_move_m — ‖A⁻¹(c) − c‖ = ‖Rᵀ(c − t) − c‖: the
      camera-position error the fitted deformation alone predicts. If
      this tracks the measured pose error while rigid_move does not,
      the harm is a pose-shaped field deformation amplified by the
      camera's lever arm, not solver noise.
  """
  e = np.asarray(coords, np.float64) - np.asarray(gt_coords, np.float64)
  v = np.asarray(valid, bool)
  norms = np.linalg.norm(e, axis=-1)[v]
  frame_bias = [np.linalg.norm(e[t][v[t]].mean(axis=0))
                for t in range(e.shape[0]) if v[t].sum() > 100]
  # lag-1 horizontal autocorrelation of each frame's residual field,
  # valid-masked, averaged over frames and xyz channels
  cors = []
  for t in range(e.shape[0]):
    for c in range(3):
      a = e[t, :, :-1, c][v[t, :, :-1] & v[t, :, 1:]]
      b = e[t, :, 1:, c][v[t, :, :-1] & v[t, :, 1:]]
      if a.size > 100 and a.std() > 0 and b.std() > 0:
        cors.append(np.corrcoef(a, b)[0, 1])
  # rigid/non-rigid split per frame
  p_all = np.asarray(coords, np.float64)
  g_all = np.asarray(gt_coords, np.float64)
  rigid_move, resid_after = [], []
  rigid_rot, implied_cam = [], []
  radial_fracs = []
  for t in range(e.shape[0]):
    m = v[t]
    if m.sum() <= 100:
      continue
    p, g = p_all[t][m], g_all[t][m]
    R, tt = _kabsch(p, g)
    p_fit = p @ R.T + tt
    rigid_move.append(float(np.median(np.linalg.norm(p_fit - p, axis=-1))))
    resid_after.append(float(np.median(np.linalg.norm(p_fit - g, axis=-1))))
    if cam_centers is not None:
      cos = np.clip(0.5 * (np.trace(R) - 1.0), -1.0, 1.0)
      rigid_rot.append(float(np.degrees(np.arccos(cos))))
      c = np.asarray(cam_centers[t], np.float64)
      implied_cam.append(float(np.linalg.norm(R.T @ (c - tt) - c)))
      # radial/tangential split of the residual wrt the camera's viewing
      # rays: a point moved ALONG its own ray reprojects identically, so
      # PnP's reprojection-threshold RANSAC cannot see (or reject) the
      # radial component — it stays "inlier" and the pose absorbs it as
      # depth/translation error. |cos| of a 3D-isotropic residual vs the
      # ray is 0.5 in expectation; frac → 1 means depth-structured error.
      ray = g - c
      rn = np.linalg.norm(ray, axis=-1)
      en = np.linalg.norm(p - g, axis=-1)
      ok = (rn > 1e-9) & (en > 1e-9)
      if ok.sum() > 100:
        cosr = np.abs(np.sum((p - g)[ok] * ray[ok], axis=-1)) / (en[ok] * rn[ok])
        radial_fracs.append(float(np.median(cosr)))
  out = {
      "median_coord_err_m": float(np.median(norms)) if norms.size else None,
      "mean_coord_err_m": float(norms.mean()) if norms.size else None,
      "spatial_autocorr_lag1": float(np.mean(cors)) if cors else None,
      "median_frame_bias_m": (float(np.median(frame_bias))
                              if frame_bias else None),
      "median_rigid_move_m": (float(np.median(rigid_move))
                              if rigid_move else None),
      "median_resid_after_rigid_m": (float(np.median(resid_after))
                                     if resid_after else None),
  }
  if cam_centers is not None:
    out["median_rigid_rot_deg"] = (float(np.median(rigid_rot))
                                   if rigid_rot else None)
    out["median_implied_cam_move_m"] = (float(np.median(implied_cam))
                                        if implied_cam else None)
    out["median_radial_frac"] = (float(np.median(radial_fracs))
                                 if radial_fracs else None)
  if variance is not None:
    sig = np.asarray(variance, np.float64)[..., 0]
    err_n = np.linalg.norm(e, axis=-1)
    p_flat = p_all.reshape(p_all.shape[0], -1, 3)
    g_flat = g_all.reshape(g_all.shape[0], -1, 3)
    topk_errs, rhos = [], []
    pool_rot, pool_cam, pool_resid = [], [], []
    pool_rad, pool_gain = [], []
    pool_radial, pool_tangential = [], []
    for t in range(e.shape[0]):
      s_t, e_t, m = sig[t].ravel(), err_n[t].ravel(), v[t].ravel()
      if m.sum() <= 100:
        continue
      k = min(top_k or m.sum(), int(m.sum()))
      # the k lowest-σ cells among those VALID in the ground truth: the
      # solver's select_confident ranks every cell, but an error needs a
      # GT label, so the pool's statistics cannot follow it there
      order = np.argsort(np.where(m, s_t, np.inf), kind="stable")[:k]
      topk_errs.append(float(np.median(e_t[order])))
      sv, ev = s_t[m], e_t[m]
      if sv.std() > 0 and ev.std() > 0:
        rhos.append(float(np.corrcoef(_rank(sv), _rank(ev))[0, 1]))
      if cam_centers is not None:
        # Kabsch + lever-arm geometry of the σ-selected pool itself —
        # the subset PnP consumes, not the full field.
        p, g = p_flat[t][order], g_flat[t][order]
        R, tt = _kabsch(p, g)
        cos = np.clip(0.5 * (np.trace(R) - 1.0), -1.0, 1.0)
        pool_rot.append(float(np.degrees(np.arccos(cos))))
        c = np.asarray(cam_centers[t], np.float64)
        pool_cam.append(float(np.linalg.norm(R.T @ (c - tt) - c)))
        p_fit = p @ R.T + tt
        pool_resid.append(
            float(np.median(np.linalg.norm(p_fit - g, axis=-1))))
        # radial/tangential magnitudes of the pool residual (meters):
        # tangential error is what reprojection-threshold RANSAC can
        # see; radial error is reprojection-invisible depth error.
        ray = g - c
        rn = np.linalg.norm(ray, axis=-1)
        okr = rn > 1e-9
        if okr.sum() > 100:
          err = p[okr] - g[okr]
          rad = np.abs(np.sum(err * ray[okr], axis=-1)) / rn[okr]
          tan = np.sqrt(np.maximum(
              np.sum(err * err, axis=-1) - rad * rad, 0.0))
          pool_radial.append(float(np.median(rad)))
          pool_tangential.append(float(np.median(tan)))
        cen = g.mean(axis=0)
        r = float(np.median(np.linalg.norm(g - cen, axis=-1)))
        pool_rad.append(r)
        if r > 0:
          pool_gain.append(float(np.linalg.norm(c - cen)) / r)
    out["median_topk_coord_err_m"] = (float(np.median(topk_errs))
                                      if topk_errs else None)
    out["sigma_err_rank_corr"] = float(np.mean(rhos)) if rhos else None
    if cam_centers is not None:
      out["pool_rigid_rot_deg"] = (float(np.median(pool_rot))
                                   if pool_rot else None)
      out["pool_implied_cam_move_m"] = (float(np.median(pool_cam))
                                        if pool_cam else None)
      out["pool_resid_after_rigid_m"] = (float(np.median(pool_resid))
                                         if pool_resid else None)
      out["pool_cloud_radius_m"] = (float(np.median(pool_rad))
                                    if pool_rad else None)
      out["pool_lever_arm_gain"] = (float(np.median(pool_gain))
                                    if pool_gain else None)
      out["pool_radial_err_m"] = (float(np.median(pool_radial))
                                  if pool_radial else None)
      out["pool_tangential_err_m"] = (float(np.median(pool_tangential))
                                      if pool_tangential else None)
  return out


def scene_geometry(gt_coords, valid, cam_centers):
  """Lever-arm geometry of the scene itself — computable from GT labels
  alone, BEFORE any training. Per frame: centroid of the visible GT
  cloud, cloud radius r (median point-to-centroid distance) and camera-
  to-centroid distance d. ``lever_arm_gain`` = median(d/r) is the factor
  by which a rotation-shaped field deformation about the cloud centroid
  is amplified into implied camera motion (points move ~r·θ, the camera
  ~d·θ). Scenes with large gain are the ones where a point-small,
  pose-large deformation can invert a point-level accuracy win — the
  pre-training predictor the transfer-inversion study needed."""
  g = np.asarray(gt_coords, np.float64)
  v = np.asarray(valid, bool)
  ds, rs, gains = [], [], []
  for t in range(g.shape[0]):
    m = v[t]
    if m.sum() <= 100:
      continue
    pts = g[t][m]
    cen = pts.mean(axis=0)
    r = float(np.median(np.linalg.norm(pts - cen, axis=-1)))
    d = float(np.linalg.norm(np.asarray(cam_centers[t], np.float64) - cen))
    ds.append(d)
    rs.append(r)
    if r > 0:
      gains.append(d / r)
  return {
      "median_cam_centroid_dist_m": float(np.median(ds)) if ds else None,
      "median_cloud_radius_m": float(np.median(rs)) if rs else None,
      "lever_arm_gain": float(np.median(gains)) if gains else None,
  }


def counterfactual_maps(coords, gt_coords, valid, kind,
                        variance=None, top_k=None):
  """Causal-test measurement maps: edit the predicted field so exactly
  one hypothesized harm component is removed (or isolated), then let the
  UNCHANGED solver consume the edited map. The correlational statistics
  above say which component is *large*; these say which component
  *causes* the pose error:

    * ``derigid`` — apply each frame's full-field Kabsch fit A to the
      predictions (z' = A(z) = R·z + t). The best rigid (pose-shaped)
      deformation is removed; the non-rigid scatter is untouched. If the
      pose error collapses to the scatter-implied level, the deformation
      IS the mechanism; if it persists, the solver's interaction with
      the scatter is.
    * ``derigid_pool`` — same, but A is fitted on the σ-selected top-k
      pool (the subset PnP consumes). Distinguishes a coherently
      deformed pool from a deformed field.
    * ``rigidonly`` — the complement: z' = A⁻¹(gt) at valid cells — a
      noise-free field carrying ONLY the fitted deformation (invalid
      cells get the derigid value, so no garbage GT enters the pool).
      Shows the deformation alone is sufficient for the observed error.

  Frames with ≤100 valid cells pass through unchanged. Returns float32
  maps shaped like ``coords``; run through the same solver as the real
  modes.
  """
  p_all = np.asarray(coords, np.float64)
  g_all = np.asarray(gt_coords, np.float64)
  v = np.asarray(valid, bool)
  out = p_all.copy()
  for t in range(p_all.shape[0]):
    m = v[t]
    if m.sum() <= 100:
      continue
    if kind == "derigid_pool":
      s_t = np.asarray(variance, np.float64)[t][..., 0].ravel()
      mflat = m.ravel()
      k = min(top_k or mflat.sum(), int(mflat.sum()))
      order = np.argsort(np.where(mflat, s_t, np.inf), kind="stable")[:k]
      p = p_all[t].reshape(-1, 3)[order]
      g = g_all[t].reshape(-1, 3)[order]
    else:
      p, g = p_all[t][m], g_all[t][m]
    R, tt = _kabsch(p, g)
    derigid_t = p_all[t] @ R.T + tt
    if kind == "rigidonly":
      # A⁻¹(gt) = Rᵀ(gt − t): the GT world seen through the fitted
      # deformation — what a noiseless net with this bias would emit.
      out[t] = np.where(m[..., None], (g_all[t] - tt) @ R, derigid_t)
    else:
      out[t] = derigid_t
  return out.astype(np.float32)


def merge_modes(prev: dict, rows: list) -> list:
  """Merge a ``--modes``-filtered run into an existing report.

  Rows just run replace same-named rows of the previous artifact; every
  other previous row is kept. Targeted stat upgrades (e.g. re-running
  only ``measurement_only`` to add new pool statistics) must not
  clobber the rest of the full sweep.
  """
  ran = {r["mode"] for r in rows}
  return rows + [r for r in prev.get("modes", []) if r["mode"] not in ran]


# the settings a report's rows were computed under: a --modes re-run may
# merge its rows only into a report of the same settings
RUN_KEYS = ("scene", "stress", "test_frames", "seed_offset",
            "scoordnet_norm")


def check_same_run(prev: dict, settings: dict) -> None:
  """Raise ``ValueError`` unless the report ``prev`` was made under this
  run's ``settings`` (``RUN_KEYS``; a report that lacks one, as the JAX
  tool's lack ``seed_offset`` and ``scoordnet_norm``, does not match)."""
  missing = object()
  bad = {k: (prev.get(k, missing), settings[k]) for k in RUN_KEYS
         if prev.get(k, missing) != settings[k]}
  if bad:
    raise ValueError(
        "--report holds another run's rows; not merging. Differing "
        "settings (report's, this run's): " + ", ".join(
            f"{k}=({'missing' if a is missing else repr(a)}, {b!r})"
            for k, (a, b) in bad.items()))


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--work_dir", required=True)
  p.add_argument("--scene", default="heldout")
  p.add_argument("--seed_offset", type=int, default=0)
  p.add_argument("--full_size", action="store_true")
  p.add_argument("--test_frames", type=int, default=480)
  p.add_argument("--train_frames", type=int, default=48)
  p.add_argument("--height", type=int, default=96)
  p.add_argument("--width", type=int, default=128)
  p.add_argument("--stress", type=float, default=0.0)
  p.add_argument("--report", default="")
  p.add_argument("--modes", default="",
                 help="comma-separated substrings; only mode rows whose "
                      "name contains one run (cheap targeted re-runs, "
                      "e.g. --modes measurement_only)")
  p.add_argument("--scoordnet_norm", default=None,
                 help="norm of the cached stages ('none' for a "
                      "--scoordnet_norm-trained cache)")
  p.add_argument("--device", default=None,
                 help="cuda (the default; raises without one) or cpu")
  args = p.parse_args(argv)
  device = kfnet_tpu_torch.resolve_device(args.device)

  kw = dict(H=args.height, W=args.width, train_frames=args.train_frames,
            test_frames=args.test_frames, work_dir=args.work_dir,
            scoordnet_norm=args.scoordnet_norm, device=device)
  if args.full_size:
    kw.update(H=480, W=640, full_size=True, lr=3e-4, sc_steps=3000,
              of_steps=2000, joint_steps=400)
  scenes = protocol.DEFAULT_SCENES
  if args.seed_offset:
    scenes = tuple(dataclasses.replace(s, seed=s.seed + args.seed_offset)
                   for s in scenes)
  scenes = tuple(s for s in scenes if s.name == args.scene)
  settings = {"scene": args.scene, "stress": args.stress,
              "test_frames": args.test_frames,
              "seed_offset": args.seed_offset,
              "scoordnet_norm": args.scoordnet_norm}
  wanted = [w for w in args.modes.split(",") if w]
  prev = None
  if args.report and wanted and os.path.exists(args.report):
    with open(args.report) as f:
      prev = json.load(f)
    check_same_run(prev, settings)  # before the run, not after it
  data, of, _, joint = protocol.prepare_stages(
      scenes=scenes, strict_cache=True, **kw)
  s = scenes[0]
  cfg, params = joint[s.name]
  d = data[s.name]
  gt_poses = d["test"]["poses"].cpu().numpy()
  gt_coords = d["test_coords"].cpu().numpy()
  gt_valid = d["test_valid"].cpu().numpy()
  d["test"].pop("depths", None)  # labels already generated
  d["train"]["images"] = None    # only K/poses of train are used here
  imgs = d["test"]["images"]
  if args.stress > 0:
    imgs = protocol.stress_images(imgs, args.stress, s.seed + 5)
    d["test"]["images"] = None   # keep only the stressed copy

  cfg1 = dataclasses.replace(cfg, w_scale=1.0)
  series = calibrate.precompute_series(params, cfg1, imgs)
  rcfg = configs.synthetic_ransac(args.full_size)
  solver = eval_sequence.make_pose_solver(d["train"]["K"].cpu().numpy(),
                                          config=rcfg)
  gen = torch.Generator(device=device)

  def mode_report(name, xs, Ps):
    xs, Ps = (torch.as_tensor(a, device=device) for a in (xs, Ps))
    out = solver(xs, Ps, gen.manual_seed(0))
    t, r = pose_metrics.pose_errors(out["T_wc"].cpu().numpy(), gt_poses)
    rep = {"mode": name,
           "median_translation_m": float(np.median(t)),
           "mean_translation_m": float(t.mean()),
           "median_rotation_deg": float(np.median(r)),
           "mean_num_inliers": float(np.mean(
               out["num_inliers"].cpu().numpy())),
           "mean_inlier_ratio": float(np.mean(
               out["inlier_ratio"].cpu().numpy())),
           **residual_stats(xs.cpu().numpy(), gt_coords, gt_valid,
                            variance=Ps.cpu().numpy(), top_k=rcfg.top_k,
                            cam_centers=gt_poses[:, :3, 3])}
    print(json.dumps(rep), flush=True)
    return rep

  def want(name):
    return not wanted or any(w in name for w in wanted)

  rows = []
  cf_kinds = [k for k in ("derigid", "derigid_pool", "rigidonly")
              if want(f"cf_{k}")]
  if want("measurement_only") or cf_kinds:
    zs, Vs = calibrate.measurement_maps(series)
    if want("measurement_only"):
      rows.append(mode_report("measurement_only", zs, Vs))
    if cf_kinds:
      zs_np, Vs_np = zs.cpu().numpy(), Vs.cpu().numpy()
      for kind in cf_kinds:
        cz = counterfactual_maps(zs_np, gt_coords, gt_valid, kind,
                                 variance=Vs_np, top_k=rcfg.top_k)
        rows.append(mode_report(f"cf_{kind}", cz, Vs_np))
  # every filtered row's label EMBEDS its (chi2, w) so no row can drift
  # from its name. The paper point shows the mechanism at its largest; the
  # serving point shows what the shipped config actually does; the
  # w-sweep rows show the harm shrinking monotonically but not to zero
  # (the structural component pose smoothing addresses).
  for tag, chi2, w in (
      ("filtered_paper", kalman.CHI2_3DOF_P05, 1.0),
      ("filtered_serving", cfg.chi2_threshold, cfg.w_scale),
      ("filtered", 2.37, 8.0),
      ("filtered", 1.21, 64.0)):
    name = f"{tag}_chi{chi2:.2f}_w{w:g}"
    if not want(name):
      continue
    xs, Ps = calibrate.filter_from_series(cfg1, series, chi2, w)
    rows.append(mode_report(name, xs, Ps))

  out = {**settings,
         "scene_geometry": scene_geometry(gt_coords, gt_valid,
                                          gt_poses[:, :3, 3]),
         "modes": rows if prev is None else merge_modes(prev, rows)}
  if args.report:
    with open(args.report, "w") as f:
      json.dump(out, f, indent=2)
  return out


if __name__ == "__main__":
  main()
