"""Kernels: the fused filter update, the conv kernels and the pose solve's
kernels (CUDA, with their plain PyTorch versions), the cost volume, and the
kernels' launch counts."""
