"""Functional layer toolkit (conv, group norm, space-to-depth, pools)."""

from kfnet_tpu_torch.nn import layers  # noqa: F401
from kfnet_tpu_torch.nn.layers import (  # noqa: F401
    Layer, conv, conv_transpose, conv_block, group_norm, relu, elu,
    max_pool, avg_pool, upsample_nearest, serial, activation, param_count)
