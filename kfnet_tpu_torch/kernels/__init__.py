"""Kernels: the fused warp + Kalman update (CUDA) and the cost volume."""
