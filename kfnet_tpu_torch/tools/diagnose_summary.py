"""Render GN-vs-alt diagnose pairs as one mechanism table (port of
``kfnet_tpu/tools/diagnose_summary.py``; for the same input files its
output is the JAX tool's, character for character, except that a scene
geometry of None, which the JAX tool cannot format, prints "—").

Each ``tools/diagnose.py`` artifact carries one (scene, trunk) cell with
field statistics (median/mean coord error, lag-1 autocorrelation,
per-frame global bias) plus the round-5 mechanism stats: the rigid
(Kabsch) decomposition — ``median_rigid_move_m`` (pose-shaped component
of field error) / ``median_resid_after_rigid_m`` (non-rigid remainder) —
and σ-ranking quality (``median_topk_coord_err_m`` over the PnP
preselection pool, ``sigma_err_rank_corr``), plus the pool-restricted
mechanism split: the Kabsch fit of the σ-selected pool itself
(``pool_rigid_rot_deg`` / ``pool_implied_cam_move_m`` /
``pool_resid_after_rigid_m`` — does σ select a coherently-deformed
subset the full-field fit dilutes away?) and the pool's GT geometry
(``pool_cloud_radius_m`` / ``pool_lever_arm_gain`` — does σ-selection
spatially concentrate the pool and degrade PnP conditioning?). This
tool pairs the GN and
alt artifacts per scene and prints the side-by-side rows the
transfer-inversion doc section cites (DESIGN.md §8), so the doc numbers
are mechanically regenerable:

    python -m kfnet_tpu_torch.tools.diagnose_summary \
        --pairs outdoor_s1:docs/DIAGNOSE_outdoor_s1.json:docs/DIAGNOSE_outdoor_nonorm_s1.json \
        --mode measurement_only [--markdown]

Pure json: it touches no device.
"""

from __future__ import annotations

import argparse
import json

STATS = (
    ("medT", "median_translation_m", 3),
    ("coordE", "median_coord_err_m", 3),
    ("topkE", "median_topk_coord_err_m", 3),
    ("rigid", "median_rigid_move_m", 3),
    ("rotK", "median_rigid_rot_deg", 2),
    ("camE", "median_implied_cam_move_m", 3),
    ("nonrig", "median_resid_after_rigid_m", 3),
    ("bias", "median_frame_bias_m", 3),
    ("σρ", "sigma_err_rank_corr", 2),
    ("inl", "mean_inlier_ratio", 3),
    ("autoc", "spatial_autocorr_lag1", 2),
    ("pRotK", "pool_rigid_rot_deg", 2),
    ("pCamE", "pool_implied_cam_move_m", 3),
    ("pNonrig", "pool_resid_after_rigid_m", 3),
    ("pRad", "pool_cloud_radius_m", 2),
    ("pGain", "pool_lever_arm_gain", 1),
    ("radF", "median_radial_frac", 2),
    ("pRadE", "pool_radial_err_m", 3),
    ("pTanE", "pool_tangential_err_m", 3),
)


def _mode(art: dict, mode: str) -> dict:
  for m in art["modes"]:
    if m["mode"] == mode or m["mode"].startswith(mode):
      return m
  raise KeyError(f"mode {mode!r} not in {[m['mode'] for m in art['modes']]}")


def rows_for(label, gn_path, alt_path, mode, alt_label="none"):
  with open(gn_path) as f:
    gn_art = json.load(f)
  with open(alt_path) as f:
    alt_art = json.load(f)
  gn, alt = _mode(gn_art, mode), _mode(alt_art, mode)
  out = []
  for trunk, m in (("group", gn), (alt_label, alt)):
    out.append([f"{label}/{trunk}"] +
               [_fmt(m.get(key), nd) for _, key, nd in STATS])
  return out, gn_art.get("scene_geometry")


def _fmt(value, nd: int) -> str:
  """``value`` to ``nd`` decimals, "—" for None (a statistic no frame had
  the valid cells for)."""
  return "—" if value is None else f"{value:.{nd}f}"


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--pairs", nargs="+", required=True,
                 help="label:gn.json:alt.json triples")
  p.add_argument("--mode", default="measurement_only",
                 help="mode row to compare (prefix match, e.g. "
                      "'filtered_serving')")
  p.add_argument("--markdown", action="store_true")
  p.add_argument("--alt_label", default="none",
                 help="trunk name of the second artifact in each pair "
                      "('none', 'ws', ...) — labels the table rows; the "
                      "diagnose artifacts do not record their trunk")
  args = p.parse_args(argv)

  header = ["cell"] + [name for name, _, _ in STATS]
  table, geoms = [], []
  for spec in args.pairs:
    label, gn_path, alt_path = spec.split(":")
    rows, geom = rows_for(label, gn_path, alt_path, args.mode,
                          alt_label=args.alt_label)
    table += rows
    if geom:
      geoms.append(
          f"{label}: lever_arm_gain={_fmt(geom['lever_arm_gain'], 1)} "
          f"(cam-centroid d={_fmt(geom['median_cam_centroid_dist_m'], 2)} m, "
          f"cloud radius r={_fmt(geom['median_cloud_radius_m'], 2)} m)")

  if args.markdown:
    print("| " + " | ".join(header) + " |")
    print("|" + "---|" * len(header))
    for r in table:
      print("| " + " | ".join(r) + " |")
  else:
    widths = [max(len(h), *(len(r[i]) for r in table))
              for i, h in enumerate(header)]
    print("  ".join(h.ljust(w) for h, w in zip(header, widths)))
    for r in table:
      print("  ".join(c.ljust(w) for c, w in zip(r, widths)))
  for g in geoms:
    # scene geometry is GT-only (trunk-independent); printed once per
    # pair so the lever-arm amplification each cell is exposed to sits
    # next to the per-trunk deformation stats it acts on
    print(g)
  return table


if __name__ == "__main__":
  main()
