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

The fused update's heads-in entry (fused_filter_step) is held against its
plain version, one map and a batch of four: flow, W,
z and V within 4 units in the last place (libdevice's tanhf and expf on
both sides), x and P at the fused kernel's tolerances, the mask equal away
from χ² ties; its gradients against the CPU's at the golden tolerance.
Each C entry captured in a CUDA graph and replayed gives its eager call's
bits and counts once per replay; the relocaliser's graphed filter step
gives the eager step's bits (held at rtol = atol = 1e-3), follows weights
updated in place between two ticks, is replayed from the new carry after a
reset without a second capture, and counts its launches under replay.
The sequence path's graphed run_filter, its chunked, resumed and batched
forms and its aux are held against the eager loop at rtol = atol = 1e-3
with launches counted under replay; the batched pose solve against each
frame's solve on the same index sets at rtol 1e-4 / atol 1e-6 on T_wc.
"""

import numpy as np
import pytest
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch.eval.online import OnlineRelocalizer
from kfnet_tpu_torch.kernels import conv3x3 as tc3
from kfnet_tpu_torch.kernels import fused_filter as tff
from kfnet_tpu_torch.kernels import launches
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
  before = tff.fused_filter_step.launches  # the main path's entry
  for f in frames:
    on_card.process(f)
    on_cpu.process(f)
  assert tff.fused_filter_step.launches == before + 3
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


# ------------------------------------- the heads-in entry and the CUDA graph

STEP_KW = dict(w_scale=16.0, coord_scale=1.5, coord_offset=(0.5, -1.0, 2.0),
               log_w_clip=oflownet.LOG_VAR_CLIP,
               log_v_clip=scoordnet.LOG_VAR_CLIP)


def make_heads(seed, h, w, batch=None, extreme=True):
  """Raw heads and a previous state (tests/test_torch_fused_filter.py's
  draw): with ``extreme``, raw flows deep in tanh's saturation and
  log-variances past ±12."""
  rng = np.random.default_rng(seed)
  lead = (h, w) if batch is None else (batch, h, w)
  x = rng.normal(size=lead + (3,)).astype(np.float32)
  P = rng.uniform(0.05, 2.0, lead + (1,)).astype(np.float32)
  fl = (rng.normal(size=lead + (2,)) * 0.4).astype(np.float32)
  lw = np.log(rng.uniform(0.01, 0.5, lead + (1,)) / 16.0).astype(np.float32)
  off = np.asarray(STEP_KW["coord_offset"], np.float32)
  z = x + (rng.normal(size=lead + (3,)) * 0.3).astype(np.float32)
  rc = ((z - off) / STEP_KW["coord_scale"]).astype(np.float32)
  lv = np.log(rng.uniform(0.05, 2.0, lead + (1,)) / 2.25).astype(np.float32)
  if extreme:
    fl.reshape(-1)[::11], fl.reshape(-1)[5::13] = 30.0, -30.0
    lw.reshape(-1)[::7], lw.reshape(-1)[3::7] = 20.0, -20.0
    lv.reshape(-1)[::5], lv.reshape(-1)[2::9] = 15.0, -15.0
  return [torch.from_numpy(a) for a in (np.concatenate([fl, lw], -1),
                                        np.concatenate([rc, lv], -1), x, P)]


def ulps(a, b):
  def ordered(t):
    i = t.contiguous().view(torch.int32).to(torch.int64)
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)
  return int((ordered(a) - ordered(b)).abs().max().item())


@pytest.mark.parametrize("batch", [None, 4])
def test_step_kernel_matches_plain(cuda, batch):
  args = [a.to(cuda) for a in make_heads(40, 60, 80, batch)]
  r, thr = 4, 2.365974
  want = tff.fused_filter_step_reference(*args, radius=r, threshold=thr,
                                         **STEP_KW)
  got = tff._launch_step(*args, r, *STEP_KW.values(), thr, 1e8)
  torch.cuda.synchronize()
  for name, g, w in zip(("flow", "W", "z", "V"), got[3:], want[3:]):
    assert ulps(g, w) <= 4, name
  np.testing.assert_allclose(got[0].cpu().numpy(), want[0].cpu().numpy(),
                             atol=2e-5)
  np.testing.assert_allclose(got[1].cpu().numpy(), want[1].cpu().numpy(),
                             rtol=2e-5)
  flow, W, z, V = want[3:]
  near = [tff.fused_warp_kalman_reference(args[2], args[3], flow, W, z, V, r,
                                          thr * f)[2]
          for f in (1 - 1e-5, 1 + 1e-5)]
  away = near[0] == near[1]
  assert torch.equal(got[2][away], want[2][away])
  assert (want[3].abs() == r).any()  # saturated heads reach the bound


def test_step_kernel_counts_and_rejects_bad_inputs(cuda):
  args = [a.to(cuda) for a in make_heads(41, 12, 16)]
  before = tff.fused_filter_step.launches
  out = tff.fused_filter_step(*args, radius=3, **STEP_KW)
  torch.cuda.synchronize()
  assert tff.fused_filter_step.launches == before + 1
  assert [o.shape[-1] for o in out] == [3, 1, 1, 2, 1, 3, 1]
  assert out[2].dtype == torch.bool
  with pytest.raises(TypeError):
    tff.fused_filter_step(args[0].double(), *args[1:], radius=3, **STEP_KW)
  with pytest.raises(ValueError, match="aligned"):  # 4 bytes off
    shifted = torch.empty(12 * 16 * 4 + 1, device=cuda)[1:].view(12, 16, 4)
    tff.fused_filter_step(args[0], shifted, *args[2:], radius=3, **STEP_KW)
  with pytest.raises(ValueError, match="shape"):
    tff.fused_filter_step(args[0], args[1][:, :8], *args[2:], radius=3,
                          **STEP_KW)
  with pytest.raises(ValueError, match="is on"):
    tff.fused_filter_step(args[0], args[1].cpu(), *args[2:], radius=3,
                          **STEP_KW)


def test_step_grads_on_card_match_cpu(cuda):
  """A loss on the heads-in entry's six differentiable outputs on the card:
  the raw heads, x_prev and P_prev get the CPU plain version's gradients
  (golden tolerance rtol 5e-4, atol 5e-5); the forward is the kernel's."""
  args = make_heads(42, 17, 23, extreme=False)
  rng = np.random.default_rng(4)
  cots = [torch.from_numpy(rng.normal(size=(17, 23, c)).astype(np.float32))
          for c in (3, 1, 2, 1, 3, 1)]
  grads = {}
  for dev in (cuda, torch.device("cpu")):
    ts = [a.to(dev).requires_grad_(True) for a in args]
    before = tff.fused_filter_step.launches
    out = tff.fused_filter_step(*ts, radius=3, threshold=7.814728,
                                **STEP_KW)
    assert tff.fused_filter_step.launches == before + (dev.type == "cuda")
    assert not out[2].requires_grad
    diff = [o for i, o in enumerate(out) if i != 2]
    loss = sum(torch.sum(o * c.to(dev)) for o, c in zip(diff, cots))
    grads[dev.type] = [g.cpu().numpy() for g in torch.autograd.grad(loss,
                                                                    ts)]
  for name, g, want in zip(("raw_flow_head", "raw_coord_head", "x_prev",
                            "P_prev"), grads["cuda"], grads["cpu"]):
    assert np.abs(want).max() > 0, name
    np.testing.assert_allclose(g, want, rtol=5e-4, atol=5e-5, err_msg=name)


def _entry_calls(dev):
  """One call of each C entry, on inputs made once: name -> (wrapper,
  call)."""
  heads = [a.to(dev) for a in make_heads(43, 60, 80)]
  fwk = [a.to(dev) for a in make_inputs(5, 60, 80, 4, True)]
  x, wt, b, scale, shift = conv_inputs(dev, 15, 20, 256, 256)
  xc, wc, _, sc, sh = conv_inputs(dev, 60, 80, 256, 512, seed=1)
  return {
      "fused_filter_step": (
          tff.fused_filter_step, lambda: tff.fused_filter_step(
              *heads, radius=4, threshold=2.365974, **STEP_KW)),
      "fused_warp_kalman": (
          tff.fused_warp_kalman, lambda: tff.fused_warp_kalman(
              *fwk, radius=4, threshold=2.365974)),
      "conv3x3_same": (tc3.conv3x3_same, lambda: tc3.conv3x3_same(
          x, wt, b, True, torch.float32)),
      "conv3x3_gn_chain": (tc3.conv3x3_gn_chain, lambda: tc3.conv3x3_gn_chain(
          xc, sc, sh, wc, True)),
  }


@pytest.mark.parametrize("entry", ["fused_filter_step", "fused_warp_kalman",
                                   "conv3x3_same", "conv3x3_gn_chain"])
def test_entry_captured_and_replayed_equals_eager(cuda, entry):
  wrapper, call = _entry_calls(cuda)[entry]
  eager = call()
  torch.cuda.synchronize()
  g = torch.cuda.CUDAGraph()
  before = wrapper.launches
  with launches.recorded() as record, torch.cuda.graph(
      g, capture_error_mode="thread_local"):
    out = call()
  assert wrapper.launches == before and record == {wrapper: 1}
  for _ in range(2):
    g.replay()
    launches.replayed(record)
  torch.cuda.synchronize()
  assert wrapper.launches == before + 2
  outs = out if isinstance(out, tuple) else (out,)
  wants = eager if isinstance(eager, tuple) else (eager,)
  assert all(torch.equal(o, w) for o, w in zip(outs, wants))


def _small_configs():
  default = kfnet.KFNetConfig(
      scoordnet=scoordnet.SCoordNetConfig(
          channels=(8, 8, 16, 16, 16, 16), strides=(1, 2, 1, 2, 1, 2),
          head_channels=16),
      oflownet=oflownet.OFlowNetConfig(
          encoder_channels=(8, 8, 16), encoder_strides=(2, 2, 2),
          search_radius=2, unet_channels=(8, 8, 16)))
  conv = kfnet.KFNetConfig(
      scoordnet=scoordnet.SCoordNetConfig(
          channels=(8, 16, 128, 128), strides=(2, 2, 2, 1),
          head_channels=128, stem_s2d=1, conv_impl="pallas_fused"),
      oflownet=oflownet.OFlowNetConfig(
          encoder_channels=(8, 16, 128, 128), encoder_strides=(2, 2, 2, 1),
          search_radius=2, stem_s2d=1, conv_impl="pallas_3x3"))
  return {"default": default, "conv_kernels": conv}


K_SMALL = np.asarray([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)


def _served(params, cfg, dev, frames, **kw):
  rl = OnlineRelocalizer(params, cfg, K_SMALL, device=dev, seed=0, **kw)
  return rl, [rl.tick(f).cpu() for f in frames]


@pytest.mark.parametrize("config", ["default", "conv_kernels"])
def test_graphed_relocaliser_matches_eager_and_counts_under_replay(cuda,
                                                                   config):
  cfg = _small_configs()[config]
  params = kfnet.init(0, cfg, (48, 64, 3), device=cuda)
  frames = np.random.default_rng(1).integers(0, 256, (5, 48, 64, 3),
                                             dtype=np.uint8)
  counters = (tff.fused_filter_step, tc3.conv3x3_same, tc3.conv3x3_gn_chain)
  before = [c.launches for c in counters]
  graphed, packed_g = _served(params, cfg, cuda, frames)
  ran = [c.launches - b for c, b in zip(counters, before)]
  assert graphed._step is not None  # captured, then replayed
  eager, packed_e = _served(params, cfg, cuda, frames, graph=False)
  first = kfnet.kernel_shapes(cfg, (48, 64, 3), first=True)
  later = kfnet.kernel_shapes(cfg, (48, 64, 3))
  assert ran == [4] + [len(first[k]) + 4 * len(later[k])
                       for k in ("conv3x3_same", "conv3x3_gn_chain")]
  for g, e in zip(packed_g, packed_e):
    np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=1e-3, atol=1e-3)
  for g, e in zip(graphed.state, eager.state):
    np.testing.assert_allclose(g.float().cpu().numpy(),
                               e.float().cpu().numpy(), rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("config", ["default", "conv_kernels"])
def test_weight_update_between_ticks_reaches_the_replay(cuda, config):
  cfg = _small_configs()[config]
  params = kfnet.init(0, cfg, (48, 64, 3), device=cuda)
  frames = np.random.default_rng(2).integers(0, 256, (4, 48, 64, 3),
                                             dtype=np.uint8)
  graphed = OnlineRelocalizer(params, cfg, K_SMALL, device=cuda,
                              solve_pose=False)
  eager = OnlineRelocalizer(params, cfg, K_SMALL, device=cuda,
                            solve_pose=False, graph=False)
  for f in frames[:3]:
    graphed.process(f)
    eager.process(f)
  step = graphed._step
  stale = OnlineRelocalizer(  # the carry and weights before the update
      params, cfg, K_SMALL, device=cuda, solve_pose=False, graph=False)
  stale._carry = tuple(t.clone() for t in eager.state)
  stale.tick(frames[3])
  x_stale = stale.state[0].clone()
  # the head block's conv (a conv kernel's weights in the conv-kernel
  # config) and the head, both updated in place between two ticks
  convs = [p for p in L.tree_leaves(params["scoordnet"]) if p.dim() == 4]
  gen = torch.Generator(device=cuda).manual_seed(3)
  with torch.no_grad():
    for w in convs[-2:]:
      w.add_(torch.randn(w.shape, generator=gen, device=cuda) * w.std())
  graphed.process(frames[3])
  eager.process(frames[3])
  assert graphed._step is not step  # captured again
  for g, e in zip(graphed.state, eager.state):
    np.testing.assert_allclose(g.float().cpu().numpy(),
                               e.float().cpu().numpy(), rtol=1e-3, atol=1e-3)
  assert not torch.allclose(graphed.state[0], x_stale, rtol=1e-3, atol=1e-3)


@pytest.mark.parametrize("config", ["default", "conv_kernels"])
def test_reset_replays_the_graph_from_the_new_carry(cuda, config):
  """After reset() the graph is kept: frame 0 of the new track runs
  first_step eagerly and the next frame replays from that carry, equal to
  the eager relocaliser reset at the same frame, with no second capture."""
  cfg = _small_configs()[config]
  params = kfnet.init(0, cfg, (48, 64, 3), device=cuda)
  frames = np.random.default_rng(4).integers(0, 256, (6, 48, 64, 3),
                                             dtype=np.uint8)
  graphed = OnlineRelocalizer(params, cfg, K_SMALL, device=cuda,
                              solve_pose=False)
  eager = OnlineRelocalizer(params, cfg, K_SMALL, device=cuda,
                            solve_pose=False, graph=False)
  for rl in (graphed, eager):
    for f in frames[:3]:
      rl.process(f)
  step = graphed._step
  before = tff.fused_filter_step.launches
  packed = []
  for rl in (graphed, eager):
    rl.reset()
    assert rl.state is None
    packed.append([rl.tick(f).cpu() for f in frames[3:]])
  assert graphed._step is step  # replayed, not captured again
  assert tff.fused_filter_step.launches == before + 2 * 2
  for g, e in zip(*packed):
    np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=1e-3, atol=1e-3)
  for g, e in zip(graphed.state, eager.state):
    np.testing.assert_allclose(g.float().cpu().numpy(),
                               e.float().cpu().numpy(), rtol=1e-3, atol=1e-3)


# The sequence path on the card (filter/sequence.py): run_filter with each
# filter step a CUDA graph replay, its chunked and resumed forms and the
# batched form, against the eager loop (held at rtol = atol = 1e-3, as the
# graphed relocaliser), launches counted under replay; the batched pose
# solve against each frame's solve on the same index sets (rtol 1e-4, atol
# 1e-6 on T_wc, chip_smoke.py's).

@pytest.mark.parametrize("config", ["default", "conv_kernels"])
def test_graphed_run_filter_matches_eager_and_counts(cuda, config):
  from kfnet_tpu_torch.filter import sequence
  cfg = _small_configs()[config]
  params = kfnet.init(0, cfg, (48, 64, 3), device=cuda)
  frames = np.random.default_rng(5).integers(0, 256, (7, 48, 64, 3),
                                             dtype=np.uint8)
  dev_frames = torch.from_numpy(frames).to(cuda)
  counters = (tff.fused_filter_step, tc3.conv3x3_same, tc3.conv3x3_gn_chain)
  first = kfnet.kernel_shapes(cfg, (48, 64, 3), first=True)
  later = kfnet.kernel_shapes(cfg, (48, 64, 3))
  want = [6] + [len(first[k]) + 6 * len(later[k])
                for k in ("conv3x3_same", "conv3x3_gn_chain")]
  ref = sequence.run_filter_python_loop(params, cfg, dev_frames)

  def held(got):
    for g, e in zip(got, ref):
      np.testing.assert_allclose(g.cpu().numpy(), e.cpu().numpy(),
                                 rtol=1e-3, atol=1e-3)

  runs = {
      "graphed": lambda: sequence.run_filter(params, cfg, dev_frames)[:2],
      "eager": lambda: sequence.run_filter(params, cfg, dev_frames,
                                           graph=False)[:2],
      "chunked": lambda: tuple(torch.cat(p) for p in zip(
          *sequence.run_filter_chunked_arrays(params, cfg, list(frames),
                                              chunk_size=2))),
      "resumed": lambda: (lambda a: tuple(torch.cat(p) for p in zip(
          a[:2], sequence.run_filter(params, cfg, dev_frames[3:],
                                     carry=a[2])[:2])))(
          sequence.run_filter(params, cfg, dev_frames[:3])),
  }
  for name, run in runs.items():
    before = [c.launches for c in counters]
    got = run()
    torch.cuda.synchronize()
    assert [c.launches - b for c, b in zip(counters, before)] == want, name
    held(got)
  # a second graphed call replays the kept graph from frame 1 on
  key = sequence._graph_key(cfg, kfnet.preprocess_images(cfg, dev_frames[1]),
                            False)
  step = sequence._graphs[key]
  held(runs["graphed"]())
  assert sequence._graphs[key] is step
  _, _, _, aux = sequence.run_filter(params, cfg, dev_frames,
                                     return_aux=True)
  _, _, _, aux_e = sequence.run_filter(params, cfg, dev_frames,
                                       return_aux=True, graph=False)
  assert set(aux) == set(aux_e) and aux["z"].shape[0] == 6
  for k in aux:
    np.testing.assert_allclose(aux[k].float().cpu().numpy(),
                               aux_e[k].float().cpu().numpy(), rtol=1e-3,
                               atol=1e-3)
  if config == "default":  # a batch: one fused launch a step, B maps
    batch = dev_frames[:, None].expand(7, 2, 48, 64, 3)
    before = tff.fused_filter_step.launches
    xs, Ps = sequence.run_filter_batched(params, cfg, batch)
    torch.cuda.synchronize()
    assert tff.fused_filter_step.launches == before + 6
    held((xs[:, 1], Ps[:, 1]))


def test_batched_pose_solve_matches_per_frame_on_card(cuda):
  from kfnet_tpu_torch.core import geometry
  from kfnet_tpu_torch.pose import ransac
  rng = np.random.default_rng(6)
  T, n = 4, 3000
  K = np.asarray([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]])
  uvs, Xs, poses = [], [], []
  for _ in range(T):
    w = rng.normal(size=3) * 0.3
    th = np.linalg.norm(w)
    k = w / th
    Kx = np.array([[0, -k[2], k[1]], [k[2], 0, -k[0]], [-k[1], k[0], 0]])
    R = np.eye(3) + np.sin(th) * Kx + (1 - np.cos(th)) * Kx @ Kx
    tv = rng.normal(size=3)
    pc = np.stack([rng.uniform(-1.5, 1.5, n), rng.uniform(-1, 1, n),
                   rng.uniform(1, 5, n)], -1)
    X = pc @ R.T + tv
    out = rng.choice(n, n // 4, replace=False)
    X[out] += rng.normal(size=(len(out), 3)) * 2.0
    uvs.append(pc[:, :2] / pc[:, 2:] * 525.0 + K[:2, 2])
    Xs.append(X)
    T_wc = np.eye(4)
    T_wc[:3, :3], T_wc[:3, 3] = R, tv
    poses.append(T_wc)
  f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=cuda)
  rc = ransac.RansacConfig()
  uv, X, w = ransac.select_confident(
      f32(np.stack(uvs)), f32(np.stack(Xs)), f32(rng.uniform(0.5, 2, (T, n))),
      torch.ones((T, n), dtype=torch.bool, device=cuda), rc.top_k)
  idx = ransac.sample_hypotheses(w, rc.num_hypotheses, rc.sample_size,
                                 torch.Generator(device=cuda).manual_seed(0))
  got = ransac.solve_with_indices(uv, X, w, f32(K), idx, rc)
  for f in range(T):
    one = ransac.solve_with_indices(uv[f], X[f], w[f], f32(K), idx[f], rc)
    np.testing.assert_allclose(got["T_wc"][f].cpu().numpy(),
                               one["T_wc"].cpu().numpy(), rtol=1e-4,
                               atol=1e-6)
    assert geometry.translation_error(got["T_wc"][f],
                                      f32(poses[f])).item() < 0.01
    assert geometry.rotation_error_deg(got["T_wc"][f],
                                       f32(poses[f])).item() < 0.1
