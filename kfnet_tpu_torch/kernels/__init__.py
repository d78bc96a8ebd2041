"""Kernels: the fused filter update and the conv kernels (CUDA, with their
plain PyTorch versions), the cost volume, and the kernels' launch counts."""
