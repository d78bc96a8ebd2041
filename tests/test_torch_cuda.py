"""Tests of the port that need an NVIDIA GPU and nvcc (marker ``cuda``).

They skip where there is no CUDA device. This file imports only torch,
numpy and kfnet_tpu_torch, so it runs on a machine without JAX:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py

(tests/conftest.py configures JAX, hence ``--noconftest``.)

The fused filter kernel is held against its plain PyTorch version on the
card at the tolerances of tests/test_pallas_fused.py: atol 2e-5 on x, rtol
2e-5 on P, the consistency mask equal. The conv kernels are held against
theirs at chip_smoke.py's: float32 outputs and Σy within 3e-5 of the
largest |value|, Σy² within rtol 5e-5, bf16 outputs within one bf16
rounding step (the kernels sum the same exact bf16 products in another
order), at every distinct shape of the conv-kernel path, under every launch
plan; conv3x3_gn_chain, and conv3x3_same where it splits K, give the same
bits twice. Gradients through the fused kernel's autograd node on the card
are held against autograd through the plain version on the CPU at the
golden tolerance (rtol 5e-4, atol 5e-5). The small float32
conv-kernel configuration on the card is held against the same on the CPU
at tests/test_torch_conv3x3.py's tolerances for that config.
"""

import numpy as np
import pytest
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch.eval.online import OnlineRelocalizer
from kfnet_tpu_torch.kernels import conv3x3 as tc3
from kfnet_tpu_torch.kernels import fused_filter as tff
from kfnet_tpu_torch.models import kfnet, oflownet, scoordnet
from kfnet_tpu_torch.nn import layers as L
from kfnet_tpu_torch.tools import conv_tiles

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
  kfnet_tpu_torch.set_fp32_precision()  # the plain versions' f32 products
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


def conv_inputs(dev, h, w, cin, cout, seed=0):
  gen = torch.Generator(device=dev).manual_seed(seed)
  x = torch.randn((h, w, cin), generator=gen, device=dev).bfloat16()
  wt = torch.randn((cout, cin, 3, 3), generator=gen, device=dev) * (
      2.0 / (9 * cin)) ** 0.5
  b = torch.randn((cout,), generator=gen, device=dev)
  scale = torch.rand((cin,), generator=gen, device=dev) + 0.5
  shift = torch.randn((cin,), generator=gen, device=dev) * 0.3
  return x, wt, b, scale, shift


def assert_held(got, want, rtol, atol_of_max):
  g, w = got.float().cpu().numpy(), want.float().cpu().numpy()
  np.testing.assert_allclose(g, w, rtol=rtol,
                             atol=atol_of_max * np.abs(w).max())


# every distinct shape of the conv-kernel configuration's filter step at
# 640x480 (kfnet.kernel_shapes; held on the CPU by
# tests/test_torch_conv3x3.py::test_conv_tiles_main_path_shapes), the odd
# 17x23 map, and a 13x21 map, whose rows and columns are not multiples of
# the 8 x 8 pixel tile, at cout 128 and 512
SAME_SHAPES = [(60, 80, 128, 128), (30, 40, 128, 128), (15, 20, 256, 256),
               (30, 40, 256, 128), (60, 80, 256, 128), (17, 23, 256, 128),
               (13, 21, 128, 128), (13, 21, 128, 512)]
CHAIN_SHAPES = [(60, 80, 128, 256, False), (60, 80, 256, 256, True),
                (60, 80, 256, 512, True), (60, 80, 512, 512, True),
                (17, 23, 256, 128, True), (13, 21, 128, 128, True),
                (13, 21, 256, 512, True)]


@pytest.mark.parametrize("h,w,cin,cout", SAME_SHAPES)
def test_conv3x3_same_kernel_matches_plain(cuda, h, w, cin, cout):
  x, wt, b, _, _ = conv_inputs(cuda, h, w, cin, cout)
  before = tc3.conv3x3_same.launches
  for bias, relu, od in ((b, True, torch.float32),
                         (None, False, torch.bfloat16)):
    got = tc3.conv3x3_same(x, wt, bias, relu, od)
    want = tc3.conv3x3_same_reference(x, wt, bias, relu, od)
    torch.cuda.synchronize()
    assert got.dtype == od
    assert_held(got, want, 0.0 if od == torch.float32 else 2.0 ** -7, 3e-5)
  assert tc3.conv3x3_same.launches == before + 2


@pytest.mark.parametrize("h,w,cin,cout,relu", CHAIN_SHAPES)
def test_gn_chain_kernel_matches_plain(cuda, h, w, cin, cout, relu):
  x, wt, _, scale, shift = conv_inputs(cuda, h, w, cin, cout)
  before = tc3.conv3x3_gn_chain.launches
  got = tc3.conv3x3_gn_chain(x, scale, shift, wt, relu)
  again = tc3.conv3x3_gn_chain(x, scale, shift, wt, relu)
  want = tc3.conv3x3_gn_chain_reference(x, scale, shift, wt, relu)
  torch.cuda.synchronize()
  assert tc3.conv3x3_gn_chain.launches == before + 2
  assert all(torch.equal(a, b) for a, b in zip(got, again))
  assert_held(got[0], want[0], 2.0 ** -7, 3e-5)
  assert_held(got[1], want[1], 0.0, 3e-5)
  assert_held(got[2], want[2], 5e-5, 0.0)


def run_plan(x, wt, b, scale, shift, pl_, chain):
  """One conv kernel call under launch plan ``pl_`` (float32 output for
  conv3x3_same, with bias and ReLU), launched alone as the timing tool
  launches it."""
  if chain:
    run, out = conv_tiles.kernel_call(
        "conv3x3_gn_chain", (x, scale, shift, wt, True), pl_=pl_)
  else:
    run, out = conv_tiles.kernel_call(
        "conv3x3_same", (x, wt, b, True, torch.float32), pl_=pl_)
  run()
  return out


@pytest.mark.parametrize("h,w,cin,cout", [(15, 20, 256, 256),
                                          (13, 21, 128, 512),
                                          (60, 80, 256, 128)])
def test_conv3x3_same_every_plan_matches_plain(cuda, h, w, cin, cout):
  # one or two consumer warpgroups, every split of K (the split-K path
  # sums its float32 partials in split order: the same bits twice)
  x, wt, b, _, _ = conv_inputs(cuda, h, w, cin, cout, seed=1)
  want = tc3.conv3x3_same_reference(x, wt, b, True, torch.float32)
  chunks = cin // tc3.CIN_STEP
  for wgs in (1, 2):
    for splits in [s for s in range(1, chunks + 1) if chunks % s == 0]:
      pl_ = tc3.plan(h, w, cin, cout, wgs=wgs, splits=splits)
      got = run_plan(x, wt, b, None, None, pl_, False)
      again = run_plan(x, wt, b, None, None, pl_, False)
      torch.cuda.synchronize()
      assert torch.equal(got, again), (wgs, splits)
      assert_held(got, want, 0.0, 3e-5)


@pytest.mark.parametrize("h,w,cin,cout", [(13, 21, 128, 128),
                                          (60, 80, 256, 512)])
def test_gn_chain_both_plans_match_plain(cuda, h, w, cin, cout):
  x, wt, _, scale, shift = conv_inputs(cuda, h, w, cin, cout, seed=2)
  want = tc3.conv3x3_gn_chain_reference(x, scale, shift, wt, True)
  for wgs in (1, 2):
    pl_ = tc3.plan(h, w, cin, cout, chain=True, wgs=wgs)
    got = run_plan(x, wt, None, scale, shift, pl_, True)
    torch.cuda.synchronize()
    assert_held(got[0], want[0], 2.0 ** -7, 3e-5)
    assert_held(got[1], want[1], 0.0, 3e-5)
    assert_held(got[2], want[2], 5e-5, 0.0)


def test_conv_kernels_refuse_grad_on_card(cuda):
  x, wt, _, scale, shift = conv_inputs(cuda, 12, 16, 128, 128)
  wt.requires_grad_(True)
  with pytest.raises(RuntimeError, match="no backward"):
    tc3.conv3x3_same(x, wt)
  with pytest.raises(RuntimeError, match="no backward"):
    tc3.conv3x3_gn_chain(x, scale, shift, wt)
  with torch.no_grad():
    tc3.conv3x3_same(x, wt)
    tc3.conv3x3_gn_chain(x, scale, shift, wt)
  torch.cuda.synchronize()


def test_prepared_weights_follow_updates_on_card(cuda):
  # an in-place update to a layer's weights reaches the kernel: the
  # prepared bf16 copy is made again, never reused stale
  layer = L.conv(128, 3, 1, impl="pallas_3x3")
  params, _ = layer.init(torch.Generator(device=cuda).manual_seed(0),
                         (20, 24, 128), cuda)
  x = torch.randn((1, 128, 20, 24), device=cuda).contiguous(
      memory_format=torch.channels_last)
  before = tc3.conv3x3_same.launches
  y0 = layer.apply(params, x)
  params["w"].mul_(-0.5)
  y1 = layer.apply(params, x)
  params["w"][0].zero_()
  y2 = layer.apply(params, x)
  torch.cuda.synchronize()
  assert tc3.conv3x3_same.launches == before + 3
  assert not torch.equal(y0, y1)
  fresh = {k: v.clone() for k, v in params.items()}
  assert torch.equal(y2, layer.apply(fresh, x))
  # output channel 0 now sees only its bias
  assert torch.equal(y2[0, 0], params["b"][0].to(y2.dtype).expand(20, 24))


def test_fused_kernel_grads_on_card_match_cpu(cuda):
  """A loss on the fused update's outputs on the card: every one of its six
  inputs gets the gradient that autograd gives through the plain version
  on the CPU (golden tolerance rtol 5e-4, atol 5e-5); the forward is the
  kernel's launch."""
  h, w, r, thr = 17, 23, 3, 7.814728
  args = make_inputs(12, h, w, r, False)
  rng = np.random.default_rng(3)
  gx = torch.from_numpy(rng.normal(size=(h, w, 3)).astype(np.float32))
  gP = torch.from_numpy(rng.normal(size=(h, w, 1)).astype(np.float32))
  grads = {}
  for dev in (cuda, torch.device("cpu")):
    ts = [a.to(dev).requires_grad_(True) for a in args]
    before = tff.fused_warp_kalman.launches
    x, P, cons = tff.fused_warp_kalman(*ts, radius=r, threshold=thr)
    assert tff.fused_warp_kalman.launches == before + (dev.type == "cuda")
    assert x.requires_grad and P.requires_grad and not cons.requires_grad
    loss = torch.sum(x * gx.to(dev)) + torch.sum(P * gP.to(dev))
    grads[dev.type] = [g.cpu().numpy() for g in torch.autograd.grad(loss,
                                                                    ts)]
  for name, g, want in zip(("x_prev", "P_prev", "flow", "W", "z", "V"),
                           grads["cuda"], grads["cpu"]):
    assert np.abs(want).max() > 0, name
    np.testing.assert_allclose(g, want, rtol=5e-4, atol=5e-5, err_msg=name)


def test_conv_kernels_reject_bad_inputs(cuda):
  x, wt, _, scale, shift = conv_inputs(cuda, 12, 16, 128, 128)
  with pytest.raises(TypeError):
    tc3.conv3x3_same(x.float(), wt)
  shifted = x.reshape(-1)[1:1 + 12 * 15 * 128].view(12, 15, 128)
  with pytest.raises(ValueError, match="aligned"):  # 2 bytes off
    tc3.conv3x3_same(shifted, wt)
  with pytest.raises(ValueError, match="contiguous"):
    tc3.conv3x3_same(x.transpose(0, 1), wt)
  with pytest.raises(ValueError, match="is on"):
    tc3.conv3x3_gn_chain(x, scale.cpu(), shift, wt)


def test_conv_kernel_slice_on_card_matches_cpu(cuda):
  """The conv-kernel configuration, small and float32: the card (the
  kernels) against the CPU (their plain versions, with the same rounding
  points), first_step and two filter_steps on the same weights and frames.
  Tolerances: tests/test_torch_conv3x3.py's for this config against the
  JAX package, about 3x the deviation measured there."""
  cfg = kfnet.KFNetConfig(
      scoordnet=scoordnet.SCoordNetConfig(
          channels=(8, 16, 128, 128), strides=(2, 2, 2, 1),
          head_channels=128, stem_s2d=1, compute_dtype="float32",
          conv_impl="pallas_fused"),
      oflownet=oflownet.OFlowNetConfig(
          encoder_channels=(8, 16, 128, 128), encoder_strides=(2, 2, 2, 1),
          search_radius=2, stem_s2d=1, compute_dtype="float32",
          conv_impl="pallas_3x3"))
  params = kfnet.init(0, cfg, (48, 64, 3), device="cpu")
  frames = np.random.default_rng(0).uniform(0, 1, (3, 48, 64, 3)).astype(
      np.float32)
  before = (tc3.conv3x3_same.launches, tc3.conv3x3_gn_chain.launches)
  runs = {}
  for dev in (cuda, torch.device("cpu")):
    p = L.tree_map(lambda t: t.to(dev), params)
    imgs = [torch.from_numpy(f).to(dev) for f in frames]
    x, P, feat = kfnet.first_step(p, cfg, imgs[0])
    for img in imgs[1:]:
      x, P, feat, aux = kfnet.filter_step(p, cfg, x, P, feat, img)
    runs[dev.type] = {k: v.cpu().numpy() for k, v in
                      dict(aux, x=x, P=P).items()}
  first = kfnet.kernel_shapes(cfg, (48, 64, 3), first=True)
  later = kfnet.kernel_shapes(cfg, (48, 64, 3))
  assert tc3.conv3x3_same.launches - before[0] == (
      len(first["conv3x3_same"]) + 2 * len(later["conv3x3_same"])) == 13
  assert tc3.conv3x3_gn_chain.launches - before[1] == (
      len(first["conv3x3_gn_chain"]) + 2 * len(later["conv3x3_gn_chain"]))
  got, want = runs["cuda"], runs["cpu"]
  for k in ("x", "P", "z", "V", "flow", "W"):
    assert np.isfinite(got[k]).all(), k
  for k, atol in (("x", 1.5e-2), ("z", 1.5e-2), ("flow", 3.5e-2)):
    np.testing.assert_allclose(got[k], want[k], rtol=0, atol=atol,
                               err_msg=k)
  for k, rtol in (("P", 1.5e-2), ("V", 1.5e-2), ("W", 2e-2)):
    np.testing.assert_allclose(got[k], want[k], rtol=rtol, err_msg=k)
