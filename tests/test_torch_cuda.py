"""Tests of the port that need an NVIDIA GPU and nvcc (marker ``cuda``).

They skip where there is no CUDA device. This file imports only torch,
numpy and kfnet_tpu_torch, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(tests/conftest.py configures JAX, hence ``--noconftest``.)

The kernel is held against its plain PyTorch version on the card at the
tolerances of tests/test_pallas_fused.py: atol 2e-5 on x, rtol 2e-5 on P,
the consistency mask equal.
"""

import numpy as np
import pytest
import torch

from kfnet_tpu_torch.eval.online import OnlineRelocalizer
from kfnet_tpu_torch.kernels import fused_filter as tff
from kfnet_tpu_torch.models import kfnet, oflownet, scoordnet

pytestmark = pytest.mark.cuda

CASES = [
    # seed, oob, h, w, radius, threshold
    (0, False, 12, 16, 3, 7.814728),
    (1, True, 12, 16, 3, 7.814728),
    (2, True, 17, 23, 3, 7.814728),
    (5, True, 60, 80, 4, 2.365974),
]


@pytest.fixture
def cuda():
  if not torch.cuda.is_available():
    pytest.skip("needs a CUDA device and nvcc")
  return torch.device("cuda")


def make_inputs(seed, h, w, r, oob):
  rng = np.random.default_rng(seed)
  x = rng.normal(size=(h, w, 3)).astype(np.float32)
  P = rng.uniform(0.05, 2.0, (h, w, 1)).astype(np.float32)
  lim = r if oob else 1.5
  flow = rng.uniform(-lim, lim, (h, w, 2)).astype(np.float32)
  W = rng.uniform(0.01, 0.5, (h, w, 1)).astype(np.float32)
  z = x + rng.normal(size=(h, w, 3)).astype(np.float32) * 0.3
  V = rng.uniform(0.05, 2.0, (h, w, 1)).astype(np.float32)
  return [torch.from_numpy(a) for a in (x, P, flow, W, z, V)]


@pytest.mark.parametrize("seed,oob,h,w,r,thr", CASES)
def test_kernel_matches_plain(cuda, seed, oob, h, w, r, thr):
  args = [a.to(cuda) for a in make_inputs(seed, h, w, r, oob)]
  before = tff.fused_warp_kalman.launches
  got = tff.fused_warp_kalman(*args, radius=r, threshold=thr)
  torch.cuda.synchronize()
  assert tff.fused_warp_kalman.launches == before + 1
  want = tff.fused_warp_kalman_reference(*args, radius=r, threshold=thr)
  np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                             atol=2e-5)
  np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                             rtol=2e-5)
  assert torch.equal(got[2], want[2])


def test_kernel_rejects_bad_inputs(cuda):
  args = [a.to(cuda) for a in make_inputs(0, 12, 16, 3, False)]
  with pytest.raises(TypeError):
    tff.fused_warp_kalman(args[0].double(), *args[1:], radius=3)
  with pytest.raises(ValueError):
    tff.fused_warp_kalman(args[0], args[1], args[2].transpose(0, 1), *args[3:],
                          radius=3)
  with pytest.raises(ValueError):
    tff.fused_warp_kalman(args[0], args[1].cpu(), *args[2:], radius=3)


def test_online_tiny_on_card_matches_cpu(cuda):
  cfg = kfnet.KFNetConfig(
      scoordnet=scoordnet.SCoordNetConfig(
          channels=(8, 8, 16, 16, 16, 16), strides=(1, 2, 1, 2, 1, 2),
          head_channels=16, compute_dtype="float32"),
      oflownet=oflownet.OFlowNetConfig(
          encoder_channels=(8, 8, 16), encoder_strides=(2, 2, 2),
          search_radius=2, unet_channels=(8, 8, 16),
          compute_dtype="float32"))
  params = kfnet.init(0, cfg, (48, 64, 3), device="cpu")
  K = np.asarray([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)
  frames = np.random.default_rng(0).integers(0, 256, (4, 48, 64, 3),
                                             dtype=np.uint8)
  on_card = OnlineRelocalizer(params, cfg, K, solve_pose=False, device=cuda)
  on_cpu = OnlineRelocalizer(params, cfg, K, solve_pose=False, device="cpu")
  before = tff.fused_warp_kalman.launches
  for f in frames:
    on_card.process(f)
    on_cpu.process(f)
  assert tff.fused_warp_kalman.launches == before + 3
  for g, w in zip(on_card.state, on_cpu.state):
    np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=1e-4,
                               atol=2e-5)
