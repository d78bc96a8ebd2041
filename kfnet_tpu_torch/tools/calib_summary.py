"""Aggregate calibration-sweep artifacts into the CALIBRATION.md tables
(port of ``kfnet_tpu/tools/calib_summary.py``; for the same input files its
output is the JAX tool's, character for character).

The round-3/4 calibration story rests on 24-cell designs — {seed 1,
seed 2} x {clean, stressed} x 6 scenes — whose per-cell paired
statistics live in ``docs/CALIBRATION_*.json`` (tools/calibrate.py
output). The doc tables (CI-wins / neutral / CI-harms / worst harm /
sum delta per grid point) were previously assembled by hand; this tool
makes them mechanically regenerable from the artifacts, so every table
row can be re-derived by anyone from the checked-in JSONs:

    python -m kfnet_tpu_torch.tools.calib_summary \
        docs/CALIBRATION_SWEEP_S1.json docs/CALIBRATION_SWEEP_S1_STRESS.json \
        docs/CALIBRATION_SWEEP_S2.json docs/CALIBRATION_SWEEP_S2_STRESS.json
    python -m kfnet_tpu_torch.tools.calib_summary docs/CALIBRATION_SMOOTH_*.json
    # per-cell breakdown of one grid point:
    python -m kfnet_tpu_torch.tools.calib_summary docs/CALIBRATION_SWEEP_*.json \
        --point "chi2=2.37,w=16"

Conventions mirror the doc: a cell is a CI-*win* when the paired
translation mean's 95% CI lies entirely below 0, a CI-*harm* when
entirely above, *neutral* otherwise; outdoor-scene translation deltas
are scale-normalized by the 20x world scale before summing; units mm.
Pure json: it touches no device.
"""

from __future__ import annotations

import argparse
import json
import os

# world scale per protocol scene (tools/protocol.py DEFAULT_SCENES);
# kept as data so this tool imports no model code.
SCENE_SCALE = {"sceneA": 1.0, "sceneB": 1.0, "sceneC": 1.0,
               "heldout": 1.0, "outdoor_train": 20.0, "outdoor": 20.0}

POINT_KEYS = ("chi2_threshold", "w_scale", "alpha_max", "adaptive_stat",
              "base", "smooth_beta")


def _label(path):
  """Condition label for a file: the artifact name minus the common
  ``CALIBRATION_`` prefix. The family (SWEEP/ADAPTIVE/SMOOTH/…) stays in
  the label so mixing families on one command line can never merge
  unrelated conditions into the same per-cell column."""
  name = os.path.basename(path).replace(".json", "")
  if name.startswith("CALIBRATION_"):
    return name[len("CALIBRATION_"):]
  return name


def _point_id(pt):
  """Canonical grid-point identity: no-op knob values (alpha off,
  smoothing off on the filtered base) are dropped so artifacts written
  by different calibrate.py generations — which differ only in which
  keys they record — aggregate into the same row."""
  pt = dict(pt)
  if not pt.get("alpha_max"):
    pt.pop("alpha_max", None)
    pt.pop("adaptive_stat", None)
  if not pt.get("smooth_beta") and pt.get("base") in (None, "filtered"):
    pt.pop("smooth_beta", None)
    pt.pop("base", None)
  return tuple((k, pt.get(k)) for k in POINT_KEYS if k in pt)


def _fmt_point(pid):
  parts = []
  short = {"chi2_threshold": "chi2", "w_scale": "w", "alpha_max": "amax",
           "adaptive_stat": "stat", "base": "base", "smooth_beta": "beta"}
  for k, v in pid:
    parts.append(f"{short[k]}={v}")
  return ", ".join(parts)


def load_cells(paths):
  """-> list of (condition_label, scene_name, held_out, points)."""
  cells = []
  for path in paths:
    with open(path) as f:
      d = json.load(f)
    for entry in d["scenes"]:
      if entry["scene"] not in SCENE_SCALE:
        # Fail loud: an unknown scene would otherwise be silently dropped
        # from the per-cell tables and summed at the wrong world scale.
        raise ValueError(
            f"{path}: scene {entry['scene']!r} has no entry in "
            f"SCENE_SCALE — add its world scale before aggregating")
      cells.append((_label(path), entry["scene"], entry.get("held_out"),
                    entry["points"]))
  return cells


def summarize(cells):
  """Aggregate every grid point over all cells -> summary rows."""
  by_point = {}
  for cond, scene, _, points in cells:
    scale = SCENE_SCALE[scene]  # membership enforced in load_cells
    for pt in points:
      row = by_point.setdefault(_point_id(pt), [])
      row.append((cond, scene, scale, pt))
  out = []
  for pid, entries in sorted(by_point.items(), key=lambda kv: str(kv[0])):
    wins = harms = neutral = rwins = rharms = 0
    total_mm = 0.0
    worst = None  # (delta_mm, cond, scene) among CI-harms
    worst_any = None
    for cond, scene, scale, pt in entries:
      lo, hi = pt["delta_translation_mean_ci95"]
      mean_mm = 1e3 * pt["delta_translation_mean"] / scale
      total_mm += mean_mm
      if hi < 0:
        wins += 1
      elif lo > 0:
        harms += 1
        if worst is None or mean_mm > worst[0]:
          worst = (mean_mm, cond, scene)
      else:
        neutral += 1
      if worst_any is None or mean_mm > worst_any[0]:
        worst_any = (mean_mm, cond, scene)
      rlo, rhi = pt["delta_rotation_mean_ci95"]
      rwins += rhi < 0
      rharms += rlo > 0
    out.append({
        "point": _fmt_point(pid),
        "cells": len(entries),
        "ci_wins": wins, "neutral": neutral, "ci_harms": harms,
        "worst_harm_mm": None if worst is None else round(worst[0], 1),
        "worst_harm_cell": None if worst is None else f"{worst[1]}/{worst[2]}",
        "worst_cell_mm": round(worst_any[0], 1),
        "worst_cell": f"{worst_any[1]}/{worst_any[2]}",
        "sum_delta_mm": round(total_mm, 1),
        "rot_wins": rwins, "rot_harms": rharms,
    })
  return out


def _match(pid_str, spec):
  """spec like 'chi2=2.37,w=16' or 'chi2=2.37,w=16,base=filtered,beta=0.4'.

  EXACT key-set match against the canonical point id: the spec must name
  every knob the point records (after ``_point_id`` drops no-op knobs)
  and nothing else. Subset matching would let e.g. 'chi2=4.64,w=1' match
  every adaptive alpha_max row too, and the per-cell table would then
  silently keep whichever matching point iterated last."""
  want = dict(kv.split("=") for kv in spec.split(","))
  have = dict(kv.split("=") for kv in pid_str.replace(" ", "").split(","))
  if set(want) != set(have):
    return False
  for k, v in want.items():
    if _isnum(have[k]) and _isnum(v):
      if abs(float(have[k]) - float(v)) > 1e-9:
        return False
    elif have[k] != v:
      return False
  return True


def _isnum(s):
  try:
    float(s)
    return True
  except (TypeError, ValueError):
    return False


def per_cell_table(cells, spec):
  """Per scene x condition mean paired delta-T (mm) at one grid point."""
  rows = {}
  conds = []
  for cond, scene, _, points in cells:
    if cond not in conds:
      conds.append(cond)
    scale = SCENE_SCALE[scene]  # membership enforced in load_cells
    for pt in points:
      if not _match(_fmt_point(_point_id(pt)), spec):
        continue
      if cond in rows.get(scene, {}):
        raise ValueError(
            f"--point {spec!r} matched more than one grid point in cell "
            f"{cond}/{scene}; specify every knob of the intended point")
      lo, hi = pt["delta_translation_mean_ci95"]
      mark = "*" if hi < 0 else ("!" if lo > 0 else "~")
      rows.setdefault(scene, {})[cond] = (
          f"{1e3 * pt['delta_translation_mean'] / scale:+.1f}{mark}")
  return conds, rows


def summary_markdown(summary):
  """The CALIBRATION.md aggregate table, as GitHub markdown lines."""
  lines = ["| point | CI-wins | neutral | CI-harms | worst harm "
           "| Σ delta | rot wins/harms |",
           "|---|---|---|---|---|---|---|"]
  for row in summary:
    worst = (f"+{row['worst_harm_mm']:.1f} mm"
             if row["worst_harm_mm"] is not None
             else f"{row['worst_cell_mm']:+.1f} mm~")
    lines.append(
        f"| ({row['point']}) | {row['ci_wins']} | {row['neutral']} "
        f"| {row['ci_harms']} | {worst} | {row['sum_delta_mm']:+.0f} mm "
        f"| {row['rot_wins']} / {row['rot_harms']} |")
  return lines


def per_cell_markdown(conds, rows):
  """The CALIBRATION.md per-cell grid (scene x condition), markdown."""
  lines = ["| scene | " + " | ".join(conds) + " |",
           "|---|" + "---|" * len(conds)]
  for scene in SCENE_SCALE:
    if scene in rows:
      lines.append("| " + scene + " | " +
                   " | ".join(rows[scene].get(c, "—") for c in conds) +
                   " |")
  return lines


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("files", nargs="+")
  p.add_argument("--point", default="",
                 help="per-cell table for one grid point, e.g. "
                      "'chi2=2.37,w=16'")
  p.add_argument("--markdown", action="store_true",
                 help="emit the CALIBRATION.md tables as GitHub markdown")
  p.add_argument("--report", default="")
  args = p.parse_args(argv)

  cells = load_cells(args.files)
  summary = summarize(cells)
  n_conds = len({c for c, *_ in cells})
  print(f"# {len(cells)} cells ({n_conds} conditions x "
        f"{len(cells) // max(n_conds, 1)} scenes)")
  if args.markdown:
    for line in summary_markdown(summary):
      print(line)
  else:
    hdr = ("point", "wins", "neutral", "harms", "worst_harm_mm",
           "sum_delta_mm", "rot w/h")
    print(" | ".join(hdr))
    for row in summary:
      print(" | ".join(str(x) for x in (
          row["point"], row["ci_wins"], row["neutral"], row["ci_harms"],
          row["worst_harm_mm"] if row["worst_harm_mm"] is not None
          else f"({row['worst_cell_mm']}~)",
          row["sum_delta_mm"], f"{row['rot_wins']}/{row['rot_harms']}")))

  out = {"summary": summary}
  if args.point:
    conds, rows = per_cell_table(cells, args.point)
    out["per_cell"] = {"point": args.point, "conditions": conds,
                       "rows": rows}
    print(f"\n# per-cell mean paired dT (mm) at {args.point} "
          "(* win, ! harm, ~ neutral)")
    if args.markdown:
      for line in per_cell_markdown(conds, rows):
        print(line)
    else:
      print("scene | " + " | ".join(conds))
      for scene in SCENE_SCALE:
        if scene in rows:
          print(scene + " | " +
                " | ".join(rows[scene].get(c, "-") for c in conds))
  if args.report:
    with open(args.report, "w") as f:
      json.dump(out, f, indent=2)
  return out


if __name__ == "__main__":
  main()
