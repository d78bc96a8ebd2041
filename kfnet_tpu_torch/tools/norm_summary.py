"""Aggregate NORM_STUDY_*.json artifacts into the GroupNorm-vs-none doc
table (port of ``kfnet_tpu/tools/norm_summary.py``; for the same input
files its output is the JAX tool's, character for character).

Each ``tools/norm_study.py`` artifact carries one (scene, seed) cell of
the paired GN-vs-``norm="none"`` comparison: per-frame paired deltas
(``none − group``; negative = ``none`` better) with moving-block-
bootstrap CIs on the same fresh 480-frame trajectory and the same PnP
keys. This tool renders the full set as one table so the doc rows are
mechanically regenerable from the checked-in JSONs:

    # one study at a time (the WS files are a separate alt):
    python -m kfnet_tpu_torch.tools.norm_summary $(ls docs/NORM_STUDY*.json | grep -v WS)
    python -m kfnet_tpu_torch.tools.norm_summary docs/NORM_STUDY_WS*.json --markdown
    # three-way (group baseline shared by the none and ws studies):
    python -m kfnet_tpu_torch.tools.norm_summary docs/NORM_STUDY*.json --three_way

Conventions mirror tools/calib_summary.py: a cell is a CI-*win* for
``none`` when the paired mean's 95% CI lies entirely below 0, a
CI-*harm* when entirely above, neutral otherwise; outdoor-scene
translation deltas are divided by the 20x world scale; translation in
mm, rotation in degrees. Pure json: it touches no device.
"""

from __future__ import annotations

import argparse
import json

from kfnet_tpu_torch.tools.calib_summary import SCENE_SCALE

def metrics_for(alt: str):
  """Column spec for an ``alt − group`` study (alt: "none", "ws", …)."""
  return (("meas ΔT mm", f"meas_translation_{alt}_minus_group", True),
          ("filt ΔT mm", f"filt_translation_{alt}_minus_group", True),
          ("meas Δrot°", f"meas_rotation_{alt}_minus_group", False),
          ("filt Δrot°", f"filt_rotation_{alt}_minus_group", False))


def _verdict(lo, hi):
  if hi < 0:
    return "win"
  if lo > 0:
    return "harm"
  return "~"


def _fmt_cell(stat, scale, translation):
  """'-12.3 [-14.0, -9.6]*' — mm (scale-normalized) or degrees."""
  unit = (1000.0 / scale) if translation else 1.0
  m = stat["delta_mean"] * unit
  lo, hi = (c * unit for c in stat["delta_mean_ci95"])
  mark = {"win": "*", "harm": "!", "~": "~"}[_verdict(lo, hi)]
  return f"{m:+.1f} [{lo:+.1f}, {hi:+.1f}]{mark}"


def load_rows(paths, allow_mixed=False):
  rows = []
  alts = set()
  for path in paths:
    with open(path) as f:
      art = json.load(f)
    scene = art["scene"]
    alt = art.get("alt_norm", "none")  # pre-field artifacts were GN-vs-none
    alts.add(alt)
    if len(alts) > 1 and not allow_mixed:
      raise SystemExit(f"mixed studies in one summary ({sorted(alts)}) — "
                       "summarize each alt norm separately, or pass "
                       "--three_way for the shared-baseline merged table")
    seed = 2 if art.get("seed_offset") else 1
    if scene not in SCENE_SCALE:
      # fail loud: an unknown scene would be normalized at the wrong
      # world scale (same rule as calib_summary.load_cells)
      raise SystemExit(f"{path}: scene {scene!r} not in "
                       f"calib_summary.SCENE_SCALE — add its world scale")
    scale = SCENE_SCALE[scene]
    cells = {}
    verdicts = {}
    for label, key, is_t in metrics_for(alt):
      stat = art["paired"][key]
      unit = (1000.0 / scale) if is_t else 1.0
      lo, hi = (c * unit for c in stat["delta_mean_ci95"])
      cells[label] = _fmt_cell(stat, scale, is_t)
      verdicts[label] = _verdict(lo, hi)
    rows.append({"path": path, "scene": scene, "seed": seed, "alt": alt,
                 "cells": cells, "verdicts": verdicts,
                 "perf": art.get("perf"),
                 "medians": {c: art[f"{c}_report"] for c in ("group", alt)
                             if f"{c}_report" in art}})
  rows.sort(key=lambda r: (r["seed"], r["scene"]))
  return rows


def three_way(rows, markdown=False):
  """Merged table for studies sharing the ``group`` baseline: one row
  per (scene, seed), one Δ-translation column pair per alt norm. This
  is the round-5 three-way trunk-norm verdict table (DESIGN.md §8) —
  ``none − group`` and ``ws − group`` are directly comparable because
  both studies were paired against the SAME trained GN stages on the
  same fresh trajectories and PnP keys."""
  alts = sorted({r["alt"] for r in rows})
  by = {}
  for r in rows:
    key = (r["seed"], r["scene"])
    if r["alt"] in by.setdefault(key, {}):
      raise SystemExit(f"duplicate cell {key} for alt {r['alt']!r}")
    by[key][r["alt"]] = r
  heads = ["scene", "seed"] + [f"{a}−group {m}" for a in alts
                               for m in ("meas ΔT mm", "filt ΔT mm")]
  if markdown:
    print("| " + " | ".join(heads) + " |")
    print("|" + "---|" * len(heads))
    line = "| {} |"
  else:
    print(" | ".join(heads))
    line = "{}"
  for (seed, scene), cells in sorted(by.items()):
    cols = [scene, str(seed)]
    for a in alts:
      r = cells.get(a)
      for m in ("meas ΔT mm", "filt ΔT mm"):
        cols.append(r["cells"][m] if r else "—")
    print(line.format(" | ".join(cols)))
  print()
  for a in alts:
    arows = [r for r in rows if r["alt"] == a]
    for label in ("meas ΔT mm", "filt ΔT mm"):
      vs = [r["verdicts"][label] for r in arows]
      print(f"{a} {label}: {vs.count('win')} win / {vs.count('~')} neutral"
            f" / {vs.count('harm')} harm of {len(vs)}")


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("artifacts", nargs="+", help="NORM_STUDY_*.json files")
  p.add_argument("--markdown", action="store_true",
                 help="emit a GitHub-markdown table (doc-ready)")
  p.add_argument("--three_way", action="store_true",
                 help="merge studies of different alt norms (shared "
                      "group baseline) into one row per (scene, seed)")
  args = p.parse_args(argv)

  rows = load_rows(args.artifacts, allow_mixed=args.three_way)
  if args.three_way:
    three_way(rows, markdown=args.markdown)
    return
  alt = rows[0]["alt"]
  metrics = metrics_for(alt)
  heads = ["scene", "seed"] + [m[0] for m in metrics]
  if args.markdown:
    print("| " + " | ".join(heads) + " |")
    print("|" + "---|" * len(heads))
    line = "| {} |"
  else:
    print(" | ".join(heads))
    line = "{}"
  for r in rows:
    cols = [r["scene"], str(r["seed"])] + [r["cells"][m[0]] for m in metrics]
    print(line.format(" | ".join(cols)))

  # aggregate verdict counts per metric
  print()
  for label, _, _ in metrics:
    vs = [r["verdicts"][label] for r in rows]
    print(f"{label}: {vs.count('win')} win / {vs.count('~')} neutral / "
          f"{vs.count('harm')} harm of {len(vs)}")
  perfs = [r["perf"][f"{alt}_over_group_speedup"] for r in rows if r["perf"]]
  if perfs:
    print(f"speedup {alt}/group: {perfs} "
          "(weight-independent; measured once)")


if __name__ == "__main__":
  main()
