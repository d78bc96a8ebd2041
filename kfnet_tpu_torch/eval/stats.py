"""Paired per-frame statistics for filtered-vs-measurement comparisons
(port of ``kfnet_tpu/eval/stats.py``: plain numpy, the same seeded draws,
so the results are the JAX package's bit for bit).

The reference (and round-2 protocol reports) compared per-scene MEDIANS of
48-frame sequences — underpowered by construction: two medians of noisy
per-frame errors can invert from seed noise alone, which is exactly what
the round-2 two-seed replication showed. The decisive statistic is the
PAIRED per-frame delta (filtered − measurement on the SAME frame), whose
frame-to-frame noise cancels, summarized with a bootstrap confidence
interval.

Filter errors are serially correlated (the Kalman state carries across
frames), so an iid bootstrap understates the interval; we use a moving-
block bootstrap (Künsch 1989): resample whole blocks of consecutive
frames, preserving within-block autocorrelation.
"""

from __future__ import annotations

import numpy as np


def moving_block_bootstrap_ci(x: np.ndarray, stat=np.mean,
                              n_boot: int = 2000, block: int = 24,
                              alpha: float = 0.05, seed: int = 0):
  """Percentile CI of ``stat`` over serially-correlated samples ``x``.

  Resamples ceil(T/block) overlapping blocks of ``block`` consecutive
  frames with replacement, concatenates, trims to T, applies ``stat``.

  Returns (lo, hi) at the (alpha/2, 1-alpha/2) percentiles.
  """
  x = np.asarray(x, np.float64)
  T = x.shape[0]
  if T < 2:
    v = float(stat(x)) if T else float("nan")
    return v, v
  block = int(max(1, min(block, T)))
  n_blocks = int(np.ceil(T / block))
  rng = np.random.default_rng(seed)
  # start positions of every length-`block` window (overlapping blocks)
  starts = rng.integers(0, T - block + 1, size=(n_boot, n_blocks))
  # gather: (n_boot, n_blocks, block) -> trim to T
  idx = starts[..., None] + np.arange(block)
  samples = x[idx].reshape(n_boot, -1)[:, :T]
  stats = stat(samples, axis=-1)
  lo, hi = np.percentile(stats, [100 * alpha / 2, 100 * (1 - alpha / 2)])
  return float(lo), float(hi)


def paired_delta_report(err_filtered: np.ndarray,
                        err_measurement: np.ndarray,
                        block: int = 24, n_boot: int = 2000,
                        seed: int = 0, prefix: str = "") -> dict:
  """Paired comparison of two per-frame error series on the same frames.

  Returns mean/median of the per-frame delta (filtered − measurement;
  negative = filtering helps), 95% moving-block-bootstrap CIs for both,
  and the fraction of frames the filter wins. ``prefix`` namespaces the
  keys (e.g. "translation_" / "rotation_").
  """
  f = np.asarray(err_filtered, np.float64)
  m = np.asarray(err_measurement, np.float64)
  if f.shape != m.shape:
    raise ValueError(f"paired series must align: {f.shape} vs {m.shape}")
  d = f - m
  mean_lo, mean_hi = moving_block_bootstrap_ci(
      d, np.mean, n_boot=n_boot, block=block, seed=seed)
  med_lo, med_hi = moving_block_bootstrap_ci(
      d, np.median, n_boot=n_boot, block=block, seed=seed + 1)
  return {
      f"delta_{prefix}mean": float(d.mean()),
      f"delta_{prefix}mean_ci95": [mean_lo, mean_hi],
      f"delta_{prefix}median": float(np.median(d)),
      f"delta_{prefix}median_ci95": [med_lo, med_hi],
      f"{prefix}win_frac": float((d < 0).mean()),
      f"{prefix}frames": int(d.shape[0]),
  }


def significant(ci: list[float]) -> int:
  """-1 if the CI is entirely below 0 (filter wins), +1 entirely above
  (filter hurts), 0 if it straddles zero (undecided)."""
  lo, hi = ci
  if hi < 0:
    return -1
  if lo > 0:
    return 1
  return 0
