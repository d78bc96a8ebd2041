"""The device's idle share of the traced part of the window, in %: one
minus the union of its kernels, copies and fills over the part's length."""

from perfbench.metrics._common import idle_share as read  # noqa: F401
