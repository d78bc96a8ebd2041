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
The graphed FleetRelocalizer is held against the eager one at rtol = atol
= 1e-3 with one capture across a per-slot reset and launches counted
under replay; the graphed pose solve of both surfaces, DLT and P3P,
against the eager surface bit for bit over frames with resets, with one
capture and the generator's state equal after the same solves; P3P on
the card on well-conditioned triangles from known
poses (the CPU's candidate nearest the truth within 1e-4 of it): every
candidate finite, the nearest within 1e-3 of the truth, as
tests/test_torch_p3p.py holds the CPU, and within 1e-3 of the CPU's (the
card rounds otherwise, and float32 P3P amplifies it: 1.7e-4 seen); params
on the CPU moved to the card by the sequence entry points. Over a mesh of
one card named four (or two) times: the fleet's streams against the
one-device batch at the card-against-CPU tolerance above, the mesh
relocaliser's poses against the one-device fleet's at atol 1e-3, and
fit(mesh=) against fit on the card at tests/test_sharding.py's loss rtol
1e-5 and the gradients at tests/test_torch_train.py's tolerance. The
root entry points' counterpart (graft_entry): entry()'s step on the card,
one fused launch a call, against the composition at rtol = atol = 1e-3
(chip_smoke.py's TOL_PATH); dryrun_multichip(2) on the card named twice.
"""

import unittest.mock as mock

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
  assert "step" in graphed._graphs  # captured, then replayed
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
  step = graphed._graphs.get("step")
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
  assert graphed._graphs.get("step") is not step  # captured again
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
  step = graphed._graphs.get("step")
  before = tff.fused_filter_step.launches
  packed = []
  for rl in (graphed, eager):
    rl.reset()
    assert rl.state is None
    packed.append([rl.tick(f).cpu() for f in frames[3:]])
  assert graphed._graphs.get("step") is step  # replayed, not captured again
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
  kept = dict(sequence._graphs)
  assert kept
  held(runs["graphed"]())
  assert sequence._graphs == kept  # the same graph under each key
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


# This slice on the card: FleetRelocalizer (the filter step one graph for B
# slots, the reset mask copied into it), P3P without a host sync, params
# bridged from the CPU moved to the card by the sequence entry points.

@pytest.mark.parametrize("config", ["default", "conv_kernels"])
def test_graphed_fleet_matches_eager_and_keeps_its_graph(cuda, config):
  """The graphed fleet against the eager one (rtol = atol = 1e-3, as the
  graphed relocaliser), a per-slot reset replayed without a capture, one
  fused launch a tick and kernel_shapes' conv calls times B."""
  from kfnet_tpu_torch.eval.online import FleetRelocalizer
  cfg = _small_configs()[config]
  params = kfnet.init(0, cfg, (48, 64, 3), device=cuda)
  B, T = 3, 5
  ticks = np.random.default_rng(7).integers(0, 256, (T, B, 48, 64, 3),
                                            dtype=np.uint8)
  resets = [None, None, None, np.array([False, True, False]), None]
  counters = (tff.fused_filter_step, tc3.conv3x3_same, tc3.conv3x3_gn_chain)
  first = kfnet.kernel_shapes(cfg, (48, 64, 3), first=True)
  later = kfnet.kernel_shapes(cfg, (48, 64, 3))
  runs = {}
  for graph in (True, False):
    fleet = FleetRelocalizer(params, cfg, K_SMALL, batch_size=B, device=cuda,
                             graph=graph)
    before = [c.launches for c in counters]
    out = []
    for t in range(T):
      out.append(fleet.tick(ticks[t], reset=resets[t]).cpu())
      if t == 1:
        step = fleet._graphs.get("step")
    assert [c.launches - b for c, b in zip(counters, before)] == (
        [T - 1] + [B * (len(first[k]) + (T - 1) * len(later[k]))
                   for k in ("conv3x3_same", "conv3x3_gn_chain")])
    runs[graph] = (out, [s.clone() for s in fleet.state])
    if graph:
      assert step is not None and fleet._graphs.get("step") is step
  for g, e in zip(runs[True][0], runs[False][0]):
    np.testing.assert_allclose(g.numpy(), e.numpy(), rtol=1e-3, atol=1e-3)
    assert g.shape == (B, 19)
  assert runs[True][0][3][1, 0] == 0.0  # the reset slot's consistent_frac
  for g, e in zip(runs[True][1], runs[False][1]):
    np.testing.assert_allclose(g.float().cpu().numpy(),
                               e.float().cpu().numpy(), rtol=1e-3, atol=1e-3)


def _p3p_triangles(n, seed=1):
  """n well-conditioned triangles seen from known poses, float32: (uv (n,
  3, 2), X (n, 3, 3), T_cw (n, 4, 4), K), as tests/test_torch_p3p.py
  makes them."""
  from kfnet_tpu_torch.core import geometry as geo
  rng = np.random.default_rng(seed)
  K = np.asarray([[525.0, 0, 320.0], [0, 525.0, 240.0], [0, 0, 1]],
                 np.float32)
  uvs, Xs, Ts = [], [], []
  while len(uvs) < n:
    w = torch.from_numpy((rng.normal(size=3) * 0.4).astype(np.float32))
    R_wc = geo.axis_angle_to_matrix(w).numpy()
    t_wc = rng.normal(size=3).astype(np.float32)
    pc = np.stack([rng.uniform(-1, 1, 3), rng.uniform(-0.8, 0.8, 3),
                   rng.uniform(1.5, 4, 3)], -1).astype(np.float32)
    a, b = pc[1] - pc[0], pc[2] - pc[0]
    if (min(np.linalg.norm(pc[i] - pc[j]) for i, j in ((0, 1), (0, 2), (1, 2)))
        < 0.5 or np.linalg.norm(np.cross(a, b)) < 0.3):
      continue
    uv = pc @ K.T
    uvs.append(uv[:, :2] / uv[:, 2:])
    Xs.append(pc @ R_wc.T + t_wc)
    T_cw = np.eye(4, dtype=np.float32)
    T_cw[:3, :3], T_cw[:3, 3] = R_wc.T, -R_wc.T @ t_wc
    Ts.append(T_cw)
  return (np.stack(uvs).astype(np.float32), np.stack(Xs).astype(np.float32),
          np.stack(Ts), K)


def _nearest_candidate(Rs, ts, T_cw):
  err = [np.abs(Rs[i] - T_cw[:3, :3]).max() + np.abs(ts[i] - T_cw[:3, 3]).max()
         for i in range(Rs.shape[0])]
  i = int(np.argmin(err))
  return i, err[i]


def test_p3p_on_card_matches_cpu(cuda):
  from kfnet_tpu_torch.pose import p3p
  n = 64
  uv, X, T_cw, K = _p3p_triangles(n)
  t = torch.from_numpy
  gR, gt = p3p.p3p_grunert(t(uv).to(cuda), t(X).to(cuda), t(K).to(cuda))
  assert torch.isfinite(gR).all() and torch.isfinite(gt).all()
  gR, gt = gR.cpu().numpy(), gt.cpu().numpy()
  wR, wt = (a.numpy() for a in p3p.p3p_grunert(t(uv), t(X), t(K)))
  held = 0
  for k in range(n):
    wi, werr = _nearest_candidate(wR[k], wt[k], T_cw[k])
    if werr > 1e-4:  # not well conditioned in float32
      continue
    gi, gerr = _nearest_candidate(gR[k], gt[k], T_cw[k])
    assert gerr < 1e-3, (k, gerr)
    np.testing.assert_allclose(gR[k, gi], wR[k, wi], atol=1e-3)
    np.testing.assert_allclose(gt[k, gi], wt[k, wi], atol=1e-3)
    held += 1
  assert held >= n // 2, held


def test_sequence_entry_points_move_cpu_params_to_the_card(cuda):
  from kfnet_tpu_torch.filter import sequence
  cfg = _small_configs()["default"]
  params = kfnet.init(0, cfg, (48, 64, 3), device=cuda)
  cpu_params = L.tree_map(lambda p: p.cpu(), params)
  frames = np.random.default_rng(9).integers(0, 256, (3, 48, 64, 3),
                                             dtype=np.uint8)
  xs, Ps, _ = sequence.run_filter(cpu_params, cfg, frames, device="cuda")
  want, _, _ = sequence.run_filter(params, cfg, frames)
  assert xs.device.type == "cuda" and torch.equal(xs, want)
  same, _ = sequence.placed(params, "cuda")
  assert same is params


# The served pose solve as one CUDA graph (pose/ransac.GraphedSolve): each
# surface against its eager twin (graph=False, same seed) bit for bit over
# frames with a restart (and a per-slot reset in the fleet), one capture
# and replays after it, and the two generators in one state after the
# same solves (the capture draws no block of keys).

@pytest.mark.parametrize("solver", ["dlt", "p3p"])
@pytest.mark.parametrize("surface", ["stream", "fleet"])
def test_graphed_pose_solve_equals_the_eager_surface(cuda, surface, solver):
  from kfnet_tpu_torch.eval.online import FleetRelocalizer
  from kfnet_tpu_torch.pose import ransac
  from kfnet_tpu_torch.utils import tracing
  cfg = _small_configs()["default"]
  params = kfnet.init(0, cfg, (48, 64, 3), device=cuda)
  rcfg = ransac.RansacConfig(solver=solver)
  B, n = 4, 9
  ticks = np.random.default_rng(10).integers(0, 256, (n, B, 48, 64, 3),
                                             dtype=np.uint8)

  def serve(graph):
    if surface == "stream":
      rl = OnlineRelocalizer(params, cfg, K_SMALL, ransac_config=rcfg,
                             seed=5, device=cuda, graph=graph)
      tick = lambda t: rl.tick(ticks[t, 0])
    else:
      rl = FleetRelocalizer(params, cfg, K_SMALL, batch_size=B,
                            ransac_config=rcfg, seed=5, device=cuda,
                            graph=graph)
      tick = lambda t: rl.tick(ticks[t], reset=(
          [False, True, False, False] if t == 6 else None))
    out = []
    for t in range(n):
      if t == 4:
        rl.reset()
      out.append(tick(t).cpu())
    return rl, out

  tracing.enable()
  try:
    graphed, got = serve(None)
  finally:
    tracing.disable()
  counters = tracing.snapshot()["counters"]
  eager, want = serve(False)
  assert graphed._solver is not None and eager._solver is None
  assert counters["pose.captures"] == 1
  assert counters["pose.replays"] == n - 1
  for t, (g, w) in enumerate(zip(got, want)):
    assert torch.equal(g, w), (t, (g - w).abs().max().item())
  assert torch.equal(graphed._gen.get_state(), eager._gen.get_state())


def _train_data(h=48, w=64, n=6):
  """A rendered sequence and its labels on the CPU, and the tiny float32
  configs normalised to it."""
  from kfnet_tpu_torch import configs
  from kfnet_tpu_torch.data import labels, synthetic
  from kfnet_tpu_torch.tools.demo import label_maps
  seq = synthetic.make_sequence(n, height=h, width=w, seed=0, device="cpu")
  coords, valid = label_maps(seq["depths"], seq["poses"], seq["K"])
  mean, std = labels.scene_statistics([coords.numpy()], [valid.numpy()])
  cfg = kfnet.KFNetConfig(scoordnet=configs.tiny_scoordnet(mean, std),
                          oflownet=configs.tiny_oflownet())
  return seq["images"], coords, valid, cfg


def _grads_close(got, want):
  """tests/test_torch_train.py's grad tolerance: rtol 2e-3 and an atol of
  1e-5 plus 5e-4 of the leaf's largest |value| (float32 sums in another
  order)."""
  for g, w in zip(got, want):
    np.testing.assert_allclose(g.cpu().numpy(), w.numpy(), rtol=2e-3,
                               atol=1e-5 + 5e-4 * w.abs().max().item())


def test_train_step_on_card_matches_cpu(cuda):
  """One training step of the tiny float32 stage-1 config: the loss at the
  golden tolerance, the grads at _grads_close's, the updated params
  within 1e-6 where both grads are clear of zero and within 2·lr (one
  Adam step of opposite sign) everywhere."""
  from kfnet_tpu_torch.train import objectives, trainer
  images, coords, valid, cfg = _train_data()
  batch = {"image": images[:4], "coords": coords[:4], "valid": valid[:4]}
  loss_fn = objectives.scoordnet_objective(cfg.scoordnet)
  opt_cfg = trainer.OptimizerConfig(learning_rate=1e-3)
  cpu = kfnet.init(0, cfg, (48, 64, 3), device="cpu")["scoordnet"]
  out = {}
  for dev in ("cpu", cuda):
    opt = trainer.make_optimizer(opt_cfg)
    state = trainer.create_state(trainer.clone_params(cpu, dev), opt)
    _, _, grads = trainer.value_and_grad(loss_fn, state.params,
                                         trainer.to_device(batch, dev))
    state, m = trainer.make_train_step(loss_fn, opt)(
        state, trainer.to_device(batch, dev))
    out[str(dev)] = (m["loss"].item(), [g.cpu() for g in grads],
                     [p.cpu() for p in L.tree_leaves(state.params)])
  (lc, gc, pc), (lg, gg, pg) = out["cpu"], out[str(cuda)]
  np.testing.assert_allclose(lg, lc, rtol=5e-4, atol=5e-5)
  _grads_close(gg, gc)
  for g1, g2, a, b in zip(gg, gc, pg, pc):
    clear = (g1.abs() > 1e-5) & (g2.abs() > 1e-5) & (g1 * g2 > 0)
    assert torch.all((a - b).abs()[clear] <= 1e-6)
    assert torch.all((a - b).abs() <= 2e-3 + 1e-6)


def test_window_grads_kernel_on_card_match_composition(cuda):
  """BPTT through the fused kernel on the card (FusedFilterStep: the
  kernel's forward, autograd through the plain version) against the
  composition on the card, remat on: loss within 1e-5 relative, grads
  within 1e-4 of each leaf's largest |value| (float32: the kernel is
  bit-equal to its plain version, the composition orders the same
  arithmetic otherwise); two launches a filter step."""
  import dataclasses
  from kfnet_tpu_torch.train import objectives, trainer
  images, coords, valid, cfg = _train_data()
  batch = {"images": torch.stack([images[:4], images[2:]]),
           "coords": torch.stack([coords[:4], coords[2:]]),
           "valid": torch.stack([valid[:4], valid[2:]])}
  batch = trainer.to_device(batch, cuda)
  params = kfnet.init(0, cfg, (48, 64, 3), device=cuda)
  tff.fused_filter_step.launches = 0
  lk, _, gk = trainer.value_and_grad(
      objectives.kfnet_window_objective(cfg, remat=True), params, batch)
  torch.cuda.synchronize()
  assert tff.fused_filter_step.launches == 3 * 2
  off = dataclasses.replace(cfg, use_fused_kernel=False)
  lc, _, gc = trainer.value_and_grad(
      objectives.kfnet_window_objective(off, remat=True), params, batch)
  assert abs((lk - lc) / lc).item() <= 1e-5
  for a, b in zip(gk, gc):
    assert (a - b).abs().max() <= 1e-4 * b.abs().max()


def test_fit_on_device_keeps_its_data_on_the_card(cuda):
  """Host data goes up once: every batch the loss sees, and the trained
  params, are on the card; the rows are gathered there."""
  from kfnet_tpu_torch.train import device_fit, objectives
  images, coords, valid, cfg = _train_data()
  loss_fn = objectives.scoordnet_objective(cfg.scoordnet)
  seen = []

  def watched(params, batch):
    seen.extend(v.device.type for v in batch.values())
    seen.extend(p.device.type for p in L.tree_leaves(params))
    return loss_fn(params, batch)

  data = {"image": images.numpy(), "coords": coords.numpy(),
          "valid": valid.numpy()}
  with mock.patch.object(torch, "from_numpy",
                         wraps=torch.from_numpy) as uploads:
    state, m = device_fit.fit_on_device(
        watched, kfnet.init(0, cfg, (48, 64, 3), device="cpu")["scoordnet"],
        data, steps=4, lr=1e-3, batch=2, chunk=2, log=None)
  assert uploads.call_count == len(data)  # the data once, not per step
  assert set(seen) == {"cuda"}
  assert all(p.device.type == "cuda" for p in L.tree_leaves(state.params))
  assert np.isfinite(m["loss"].item())


def test_full_size_weights_load_and_measure_on_card(cuda):
  """The full-size flagship (artifacts/pretrained_full, the JAX package's
  orbax export, read by the port's own reader on the card's host) on the
  card: float32 master weights there, and one 640x480 measurement finite
  with positive variances."""
  from kfnet_tpu_torch import pretrained
  cfg, params = pretrained.load(pretrained.FULL_ASSETS, device=cuda)
  leaves = L.tree_leaves(params)
  assert all(p.device.type == "cuda" and p.dtype == torch.float32
             for p in leaves)
  img = torch.rand((480, 640, 3), generator=torch.Generator().manual_seed(0))
  z, V = kfnet.measure(params, cfg, kfnet.preprocess_images(
      cfg, img.to(cuda)))
  assert z.shape == (60, 80, 3) and V.shape == (60, 80, 1)
  assert torch.isfinite(z).all() and (V > 0).all()


def test_batches_go_to_the_card_from_pinned_memory(cuda, tmp_path,
                                                   monkeypatch):
  """The host library builds on the card's host; a batch of either loader
  with ``to_device`` is pinned in the prefetch thread and arrives on the
  card, equal to the host batch."""
  import threading
  from kfnet_tpu_torch.data import fixture, pipeline
  pinned = []
  pin = pipeline.pin_batch

  def recording_pin(batch, device):
    out = pin(batch, device)
    pinned.append((threading.current_thread(),
                   all(v.is_pinned() for v in out.values())))
    return out

  monkeypatch.setattr(pipeline, "pin_batch", recording_pin)
  from kfnet_tpu_torch.train import train_scoordnet
  from kfnet_tpu_torch.utils import config as config_lib
  fixture.write_seven_scenes_fixture(str(tmp_path), train_frames=4,
                                     test_frames=2, height=48, width=64,
                                     device=cuda)
  exp = config_lib.ExperimentConfig(input_folder=str(tmp_path))
  load_fns, _, native_meta = train_scoordnet.make_scene_loader(exp)
  host = next(pipeline.batched_native(batch_size=2, seed=1, epochs=1,
                                      to_device=False, **native_meta()))
  for it in (pipeline.batched_native(batch_size=2, seed=1, epochs=1,
                                     device=cuda, **native_meta()),
             pipeline.batched(load_fns, 2, seed=1, epochs=1, device=cuda)):
    dev = next(it)
    assert all(v.device.type == "cuda" for v in dev.values())
    np.testing.assert_array_equal(dev["image"].cpu().numpy(), host["image"])
    np.testing.assert_array_equal(dev["valid"].cpu().numpy(), host["valid"])
    it.close()
  assert pinned and all(ok and t is not threading.current_thread()
                        for t, ok in pinned)


def test_train_scripts_on_card_at_tiny_width(cuda, tmp_path):
  """The three train scripts on the card (tiny nets, a 48x64 fixture):
  steps, exports, params on the card, finite; BPTT windows launch the
  fused kernel 2 (T - 1) times a step with remat."""
  from kfnet_tpu_torch.data import fixture
  from kfnet_tpu_torch.train import train_kfnet, train_oflownet
  from kfnet_tpu_torch.train import train_scoordnet
  root, models = str(tmp_path / "data"), str(tmp_path / "models")
  fixture.write_seven_scenes_fixture(root, train_frames=5, test_frames=2,
                                     height=48, width=64, device=cuda)
  common = ["--input_folder", root, "--model_folder", models,
            "--net_scale", "tiny", "--batch_size", "2", "--device", "cuda"]
  states = [train_scoordnet.main(common + ["--max_steps", "2"]),
            train_oflownet.main(common + ["--scenes", "chess",
                                          "--max_steps", "2"])]
  tff.fused_filter_step.launches = 0
  states.append(train_kfnet.main(common + [
      "--max_steps", "2", "--window_size", "3", "--remat",
      "--scoordnet_ckpt", f"{models}/scoordnet_chess",
      "--oflownet_ckpt", f"{models}/oflownet_7scenes"]))
  torch.cuda.synchronize()
  assert tff.fused_filter_step.launches == 2 * 2 * (3 - 1)
  for s in states:
    assert s.step == 2
    assert all(p.device.type == "cuda" and torch.isfinite(p).all()
               for p in L.tree_leaves(s.params))


def tiny_cfg():
  return kfnet.KFNetConfig(
      scoordnet=scoordnet.SCoordNetConfig(
          channels=(8, 8, 16, 16, 16, 16), strides=(1, 2, 1, 2, 1, 2),
          head_channels=16, compute_dtype="float32"),
      oflownet=oflownet.OFlowNetConfig(
          encoder_channels=(8, 8, 16), encoder_strides=(2, 2, 2),
          search_radius=2, unet_channels=(8, 8, 16),
          compute_dtype="float32"))


def test_fleet_over_a_repeated_card_mesh(cuda):
  """run_filter_fleet and FleetRelocalizer over a 4-entry mesh of one card
  (cuda:0 four times): each entry its own graph and one fused launch a
  step; the fleet's streams equal to the one-device batch (rtol 1e-4,
  atol 2e-5, as the card against the CPU above), the relocaliser's poses
  to the one-device fleet's (atol 1e-3) with one host wait a tick."""
  from kfnet_tpu_torch.eval.online import FleetRelocalizer
  from kfnet_tpu_torch.filter import sequence
  from kfnet_tpu_torch.parallel import mesh as tmesh
  cfg = tiny_cfg()
  params = kfnet.init(0, cfg, (48, 64, 3), device=cuda)
  mesh = tmesh.Mesh([torch.device("cuda", 0)] * 4)
  frames = np.random.default_rng(1).integers(0, 256, (5, 4, 48, 64, 3),
                                             dtype=np.uint8)
  tff.fused_filter_step.launches = 0
  xs, Ps = sequence.run_filter_fleet(params, cfg, frames, mesh)
  torch.cuda.synchronize()
  assert tff.fused_filter_step.launches == 4 * 4
  xs0, Ps0 = sequence.run_filter_batched(params, cfg, frames)
  for got, want in ((xs, xs0), (Ps, Ps0)):
    assert all(s.device.type == "cuda" for s in got.shards)
    np.testing.assert_allclose(got.full().cpu().numpy(), want.cpu().numpy(),
                               rtol=1e-4, atol=2e-5)
  K = np.asarray([[60.0, 0, 32], [0, 60.0, 24], [0, 0, 1]], np.float32)
  one = FleetRelocalizer(params, cfg, K, batch_size=4, device=cuda)
  split = FleetRelocalizer(params, cfg, K, batch_size=4, mesh=mesh)
  for t in range(5):
    p1, _ = one.process(frames[t])
    p4, _ = split.process(frames[t])
    np.testing.assert_allclose(p4, p1, atol=1e-3)
  steps = [e._graphs.get("step") for e in split._entries]
  assert len({id(s) for s in steps}) == 4 and None not in steps


def test_fit_on_a_repeated_card_mesh(cuda):
  """fit(mesh=) over two entries of one card against fit on the card, one
  step on a batch whose rows hold different valid counts (the pooled
  loss): the loss at rtol 1e-5 (tests/test_sharding.py's) and the gradient
  given to the optimizer at tests/test_torch_train.py's rtol 2e-3, atol
  1e-5 plus 5e-4 of the leaf's largest |value|; the params stay on the
  card."""
  from kfnet_tpu_torch.parallel import mesh as tmesh
  from kfnet_tpu_torch.train import objectives, trainer
  from kfnet_tpu_torch.utils import logging as log_lib
  cfg = tiny_cfg().scoordnet
  gen = torch.Generator(device=cuda).manual_seed(0)
  params = scoordnet.init(gen, cfg, (48, 64, 3), cuda)
  rng = np.random.default_rng(0)
  batch = {"image": rng.uniform(0, 1, (4, 48, 64, 3)).astype(np.float32),
           "coords": rng.normal(size=(4, 6, 8, 3)).astype(np.float32),
           "valid": rng.uniform(size=(4, 6, 8)) > np.linspace(0, 0.6, 4)[
               :, None, None]}
  loss_fn = objectives.scoordnet_objective(cfg)
  loop = trainer.TrainLoopConfig(max_steps=1, log_every=1)
  update = trainer.Adam.update
  runs = []
  for kw in ({"device": cuda},
             {"mesh": tmesh.Mesh([torch.device("cuda", 0)] * 2)}):
    fed, rows = [], []

    class Rec(log_lib.MetricLogger):
      def log_metrics(self, step, metrics):
        rows.append(metrics)

    def recording(self, grads, state, p, fed=fed):
      fed.append([g.clone() for g in grads])
      return update(self, grads, state, p)

    with mock.patch.object(trainer.Adam, "update", recording):
      state = trainer.fit(loss_fn, params, iter([batch]), loop_cfg=loop,
                          logger=Rec(), **kw)
    assert all(p.device.type == "cuda" for p in L.tree_leaves(state.params))
    runs.append((rows[0]["loss"], fed[0]))
  (l0, g0), (l1, g1) = runs
  np.testing.assert_allclose(l1, l0, rtol=1e-5)
  for a, b in zip(g0, g1):
    a, b = a.cpu().numpy(), b.cpu().numpy()
    np.testing.assert_allclose(b, a, rtol=2e-3,
                               atol=1e-5 + 5e-4 * np.abs(a).max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_winograd_conv_on_card_and_in_a_graph(cuda, dtype):
  """kernels/winograd.py on the card (bf16: the bmm with a float32
  output) against cuDNN's direct conv at tests/test_winograd.py's bounds
  (float32 1e-4; bf16 0.015 of the largest |y|), with a bias and a batch;
  the same call captured in a CUDA graph and replayed gives its bits."""
  import torch.nn.functional as F
  from kfnet_tpu_torch.kernels import winograd
  gen = torch.Generator().manual_seed(3)
  x = torch.randn((2, 64, 60, 80), generator=gen).to(cuda)
  w = (torch.randn((96, 64, 3, 3), generator=gen) / 24).to(cuda)
  b = torch.randn((96,), generator=gen).to(cuda)
  y = winograd.conv3x3_winograd(x, w, b, compute_dtype=dtype)
  ref = F.conv2d(x.to(dtype), w.to(dtype), padding=1)
  ref = (ref.float() + b[:, None, None]).to(dtype).float()
  err = (y.float() - ref).abs().max().item()
  scale = ref.abs().max().item()
  assert err <= (1e-4 * max(scale, 1.0) if dtype == torch.float32
                 else 0.015 * scale), (err, scale)
  stream = torch.cuda.Stream()
  with torch.cuda.stream(stream):
    winograd.conv3x3_winograd(x, w, b, compute_dtype=dtype)  # warm up
  torch.cuda.current_stream().wait_stream(stream)
  graph = torch.cuda.CUDAGraph()
  with torch.cuda.graph(graph):
    out = winograd.conv3x3_winograd(x, w, b, compute_dtype=dtype)
  graph.replay()
  torch.cuda.synchronize()
  assert torch.equal(out, y)


def test_winograd_gradients_on_card(cuda):
  """Gradients through the bf16 route on the card (the contraction's
  operands upcast where a gradient is needed) against autograd through
  the float32 direct conv, at tests/test_winograd.py's rtol 1e-3 / atol
  1e-4 in float32 and finite in bf16."""
  import torch.nn.functional as F
  from kfnet_tpu_torch.kernels import winograd
  gen = torch.Generator().manual_seed(4)
  x = torch.randn((1, 4, 6, 8), generator=gen).to(cuda)
  w0 = torch.randn((4, 4, 3, 3), generator=gen).to(cuda)
  grads = []
  for fn in (lambda w: winograd.conv3x3_winograd(
                 x, w, compute_dtype=torch.float32),
             lambda w: F.conv2d(x, w, padding=1)):
    w = w0.clone().requires_grad_(True)
    torch.sum(torch.sin(fn(w))).backward()
    grads.append(w.grad)
  torch.testing.assert_close(grads[0], grads[1], rtol=1e-3, atol=1e-4)
  w = w0.clone().requires_grad_(True)
  winograd.conv3x3_winograd(x, w).float().sum().backward()
  assert torch.isfinite(w.grad).all()


def test_graft_entry_on_card_matches_the_composition(cuda):
  import dataclasses
  from kfnet_tpu_torch import graft_entry
  fn, args = graft_entry.entry()
  params, img_prev, img_cur = args
  assert fn.config.use_fused_kernel
  assert all(t.device.type == "cuda"
             for t in L.tree_leaves(params) + [img_prev, img_cur])
  tff.fused_filter_step.launches = 0
  tc3.conv3x3_same.launches = tc3.conv3x3_gn_chain.launches = 0
  got = fn(*args)
  fn(*args)
  torch.cuda.synchronize()
  assert tff.fused_filter_step.launches == 2
  assert tc3.conv3x3_same.launches == tc3.conv3x3_gn_chain.launches == 0
  plain = graft_entry.Step(dataclasses.replace(fn.config,
                                               use_fused_kernel=False))
  for g, w in zip(got, plain(*args)):
    assert torch.isfinite(g).all()
    torch.testing.assert_close(g, w, rtol=1e-3, atol=1e-3)
  assert (got[1] > 0).all()


def test_graft_dryrun_on_a_repeated_card(cuda):
  from kfnet_tpu_torch import graft_entry
  assert graft_entry.dryrun_mesh(2).devices == (torch.device("cuda", 0),) * 2
  tff.fused_filter_step.launches = 0
  graft_entry.dryrun_multichip(2)
  torch.cuda.synchronize()
  assert tff.fused_filter_step.launches == 0  # the composition


# ESAC's serving surface (models/esac.py, eval/online.EsacRelocalizer) at a
# small width on the card: the graphed gating, draw, expert passes and
# multi-map solve give the eager surface's bits, tick after tick, at B = 1
# and 4; the generator's state is the same after the same ticks; the first
# tick captures the gating, the draw, the expert pass of every size and the
# solve, and the later ticks replay them (one replay an expert pass). ESAC
# keeps no state between ticks: the frames jump to another sequence at
# tick 4 (a track restart) with nothing to reset.

@pytest.mark.parametrize("B", [1, 4])
def test_graphed_esac_surface_equals_the_eager_one(cuda, B):
  from kfnet_tpu_torch.eval.online import (EsacRelocalizer, PASS_PAIRS,
                                           pair_passes)
  from kfnet_tpu_torch.models import esac
  from kfnet_tpu_torch.pose import ransac
  from kfnet_tpu_torch.utils import tracing
  cfg = esac.EsacConfig(num_experts=5, stem_channels=(8, 16, 32, 64),
                        res_channels=128, head_channels=128,
                        gating_channels=(2, 4, 8, 16))
  params = esac.init(0, cfg, device=cuda)
  rcfg = ransac.RansacConfig(solver="p3p", num_hypotheses=64)
  n = 9
  rng = np.random.default_rng(11)
  ticks = rng.integers(0, 256, (n, B, 48, 64, 3), dtype=np.uint8)
  ticks[4:] = rng.integers(0, 256, (n - 4, B, 48, 64, 3), dtype=np.uint8)

  def serve(graph):
    rl = EsacRelocalizer(params, cfg, K_SMALL, batch_size=B,
                         ransac_config=rcfg, seed=5, device=cuda,
                         graph=graph)
    out, passes = [], 0
    for t in range(n):
      out.append(rl.tick(ticks[t]).cpu())
      passes += len(pair_passes(rl.last[2].numel())) if t else 0
    return rl, out, passes

  tracing.enable()
  try:
    graphed, got, passes = serve(None)
  finally:
    tracing.disable()
  counters = tracing.snapshot()["counters"]
  eager, want, _ = serve(False)
  sizes = min(PASS_PAIRS, B * cfg.num_experts)
  assert counters["esac.captures"] == 2 + sizes
  assert counters["esac.replays"] == 2 * (n - 1) + passes
  assert counters["pose.captures"] == 1
  assert counters["pose.replays"] == n - 1
  for t, (g, w) in enumerate(zip(got, want)):
    assert torch.isfinite(g).all()
    assert torch.equal(g, w), (t, (g - w).abs().max().item())
  assert torch.equal(graphed._gen.get_state(), eager._gen.get_state())
