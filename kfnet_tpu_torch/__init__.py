"""kfnet_tpu_torch — the PyTorch / NVIDIA H100 port of ``kfnet_tpu``.

The package mirrors ``kfnet_tpu``'s module layout. It imports ``torch``,
``numpy`` and the standard library only. Convolutions run through
``torch.nn.functional`` (cuDNN on the card), and the one TPU kernel of the
serving path, the fused warp + Kalman update, is a hand-written CUDA
kernel (``kernels/csrc/fused_filter.cu``) built with ``nvcc`` at first use.

Public functions keep the JAX package's layouts: (h, w, C) maps and
(..., H, W, 3) NHWC frames. Inside, the nets run NCHW-shaped tensors in
channels-last memory, so the layout change at the boundary is a view.

Entry points (``models.kfnet.init``, ``eval.online.OnlineRelocalizer``,
``eval.benchmark.run``, ``python -m kfnet_tpu_torch.bench``) run on
``cuda`` unless the caller passes ``device="cpu"``. Functions on tensors
run where their inputs live; the sequence and eval functions
(``filter.sequence``, ``eval.eval_sequence``) where the params live,
unless given a ``device``.
"""

from __future__ import annotations

import torch

__version__ = "0.1.0"


def resolve_device(device=None) -> torch.device:
  """The device an entry point runs on: ``cuda`` unless one is given.

  Raises rather than carrying on silently on the CPU when no device is
  given and CUDA is absent."""
  if device is None:
    if not torch.cuda.is_available():
      raise RuntimeError(
          "kfnet_tpu_torch runs on a CUDA device by default and none is "
          "available; pass device='cpu' to run on the CPU")
    device = "cuda"
  device = torch.device(device)
  if device.type == "cuda":
    set_fp32_precision()
  return device


def set_fp32_precision() -> dict:
  """Full float32 for float32 convolutions and matrix products.

  The f32 heads (SCoordNet's 1x1, OFlowNet's 3x3) and the pose solver
  need more than TF32's ~3 decimal digits. cuDNN runs float32
  convolutions in TF32 by default, so this turns that off (and states the
  matmul default). bfloat16 convolutions are unaffected. Returns the
  settings in force."""
  torch.backends.cudnn.allow_tf32 = False
  torch.backends.cuda.matmul.allow_tf32 = False
  return {"cudnn.allow_tf32": torch.backends.cudnn.allow_tf32,
          "cuda.matmul.allow_tf32": torch.backends.cuda.matmul.allow_tf32,
          "float32_matmul_precision": torch.get_float32_matmul_precision()}
