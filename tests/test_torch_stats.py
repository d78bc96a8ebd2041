"""The port's paired statistics (kfnet_tpu_torch/eval/stats.py): the seven
cases of tests/test_stats.py on the port's functions, and every result
bit-equal to the JAX package's on the same seeded inputs (both are numpy
with the same default_rng draws)."""

import numpy as np
import pytest

from kfnet_tpu.eval import stats as jstats
from kfnet_tpu_torch.eval import stats


def test_bootstrap_ci_covers_true_mean():
  rng = np.random.default_rng(0)
  x = rng.normal(0.5, 1.0, size=400)
  lo, hi = stats.moving_block_bootstrap_ci(x, np.mean, block=20, seed=1)
  assert lo < x.mean() < hi
  assert 0.05 < hi - lo < 0.5


def test_bootstrap_ci_wider_under_autocorrelation():
  rng = np.random.default_rng(2)
  e = rng.normal(size=600)
  x = np.empty(600)
  x[0] = e[0]
  for i in range(1, 600):
    x[i] = 0.9 * x[i - 1] + e[i]
  lo_b, hi_b = stats.moving_block_bootstrap_ci(x, np.mean, block=50, seed=3)
  shuffled = rng.permutation(x)
  lo_i, hi_i = stats.moving_block_bootstrap_ci(
      shuffled, np.mean, block=1, seed=3)  # block=1 is the iid bootstrap
  assert (hi_b - lo_b) > 1.5 * (hi_i - lo_i)


def test_bootstrap_tiny_inputs():
  lo, _ = stats.moving_block_bootstrap_ci(np.array([]), np.mean)
  assert np.isnan(lo)
  lo, hi = stats.moving_block_bootstrap_ci(np.array([3.0]), np.mean)
  assert lo == hi == 3.0
  lo, hi = stats.moving_block_bootstrap_ci(np.array([1.0, 2.0]), np.mean,
                                           block=24)
  assert 1.0 <= lo <= hi <= 2.0


def test_paired_delta_detects_small_consistent_win():
  rng = np.random.default_rng(4)
  base = np.abs(rng.normal(0.1, 0.05, size=480))
  meas = base + rng.normal(0, 0.005, size=480)
  filt = base * 0.98 + rng.normal(0, 0.005, size=480)
  rep = stats.paired_delta_report(filt, meas, block=24, prefix="t_")
  assert rep["delta_t_mean"] < 0
  assert stats.significant(rep["delta_t_mean_ci95"]) == -1
  assert rep["t_win_frac"] > 0.5
  assert rep["t_frames"] == 480


def test_paired_delta_undecided_on_noise():
  rng = np.random.default_rng(5)
  meas = np.abs(rng.normal(0.1, 0.02, size=200))
  filt = meas + rng.normal(0, 0.02, size=200)
  rep = stats.paired_delta_report(filt, meas, prefix="")
  assert stats.significant(rep["delta_mean_ci95"]) == 0


def test_paired_delta_shape_mismatch():
  with pytest.raises(ValueError):
    stats.paired_delta_report(np.zeros(3), np.zeros(4))


def test_significant():
  assert stats.significant([-2.0, -1.0]) == -1
  assert stats.significant([1.0, 2.0]) == 1
  assert stats.significant([-1.0, 1.0]) == 0


@pytest.mark.parametrize("stat", [np.mean, np.median])
@pytest.mark.parametrize("T,block", [(1, 24), (2, 24), (37, 5), (480, 24)])
def test_bootstrap_bit_equal_to_jax(stat, T, block):
  x = np.random.default_rng(T).normal(size=T)
  assert (stats.moving_block_bootstrap_ci(x, stat, block=block, seed=7)
          == jstats.moving_block_bootstrap_ci(x, stat, block=block, seed=7))


def test_paired_delta_report_bit_equal_to_jax():
  rng = np.random.default_rng(11)
  f, m = rng.normal(size=(2, 96))
  for prefix in ("", "rotation_"):
    assert (stats.paired_delta_report(f, m, block=12, seed=3, prefix=prefix)
            == jstats.paired_delta_report(f, m, block=12, seed=3,
                                          prefix=prefix))
  for ci in ([-2.0, -1.0], [1.0, 2.0], [-1.0, 1.0], [0.0, 0.0]):
    assert stats.significant(ci) == jstats.significant(ci)
