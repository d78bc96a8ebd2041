"""Per-pixel Kalman filtering primitives: the update and the warp."""
