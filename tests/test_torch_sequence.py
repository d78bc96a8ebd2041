"""The port's sequence path (kfnet_tpu_torch/filter/sequence.py) on the CPU:
the cases of tests/test_filter.py (but its slow soak) and the run_filter /
chunked cases of tests/test_uint8_ingest.py, each also held against the
JAX package's function on the tiny config with JAX-initialised weights
converted by convert.params_from_jax and frames from numpy seeds.

use_fused_kernel is matched by use_pallas on the JAX side, whose Pallas
kernel runs in interpret mode there (as its own tests run it on the CPU).

Tolerances: the port against JAX at the goldens' rtol 5e-4 / atol 5e-5
(tests/test_goldens.py); the port's forms against each other at the JAX
tests' own (atol 2e-5 on x and 1e-5 on P for the loop against the run,
1e-5 for chunked and resumed against whole; rtol 1e-5 / atol 2e-5 for
uint8 against float32), except where they are bit-equal on the CPU, which
is asserted as such.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kfnet_tpu.filter import sequence as jseq
from kfnet_tpu.kernels import fused_filter as jff
from kfnet_tpu.models import kfnet as jkfnet
from kfnet_tpu_torch import convert
from kfnet_tpu_torch.filter import sequence as tseq
from kfnet_tpu_torch.models import kfnet as tkfnet
from tests import tiny_configs as tc
from tests.test_torch_models import port_config

GOLDEN = dict(rtol=5e-4, atol=5e-5)
FUSED = [True, False]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
  """Small tensors on one thread: the suite runs in several processes at
  once, and torch's pool of a thread per core in each oversubscribes the
  host, which slows small-tensor work by an order of magnitude."""
  threads = torch.get_num_threads()
  torch.set_num_threads(1)
  yield
  torch.set_num_threads(threads)


@pytest.fixture(autouse=True)
def pallas_interpret(monkeypatch):
  """The JAX package's fused kernel in interpret mode (no TPU here)."""
  monkeypatch.setattr(jff, "fused_warp_kalman",
                      functools.partial(jff.fused_warp_kalman,
                                        interpret=True))


@functools.lru_cache(maxsize=None)
def weights(seed, **cfg_kw):
  jcfg = tc.tiny_kfnet(**cfg_kw)
  jparams = jkfnet.init(jax.random.key(seed), jcfg, tc.IMG)
  return jparams, convert.params_from_jax(
      jax.tree_util.tree_map(np.asarray, jparams))


def configs(fused, **cfg_kw):
  jcfg = dataclasses.replace(tc.tiny_kfnet(**cfg_kw), use_pallas=fused)
  return jcfg, port_config(jcfg, fused)


def frames(T, seed):
  return np.array(tc.random_images(T, seed=seed))


def close(got, want, **tol):
  np.testing.assert_allclose(got.numpy(), np.asarray(want), **(tol or GOLDEN))


@pytest.mark.parametrize("fused", FUSED)
def test_run_filter_matches_python_loop_and_jax(fused):
  jcfg, tcfg = configs(fused)
  jparams, tparams = weights(7)
  imgs = frames(5, 3)
  xs_l, Ps_l = tseq.run_filter_python_loop(tparams, tcfg, imgs)
  xs, Ps, carry = tseq.run_filter(tparams, tcfg, imgs)
  assert xs.shape == (5, 6, 8, 3) and Ps.shape == (5, 6, 8, 1)
  np.testing.assert_allclose(xs.numpy(), xs_l.numpy(), atol=2e-5)
  np.testing.assert_allclose(Ps.numpy(), Ps_l.numpy(), atol=1e-5)
  jxs, jPs, jcarry = jseq.run_filter(jparams, jcfg, jnp.asarray(imgs))
  close(xs, jxs)
  close(Ps, jPs)
  for g, w in zip(carry, jcarry):
    close(g, w)
  # frame 0 is measurement-only
  z0, V0 = tkfnet.measure(tparams, tcfg, torch.from_numpy(imgs[0]))
  assert torch.equal(xs[0], z0) and torch.equal(Ps[0], V0)


@pytest.mark.parametrize("fused", FUSED)
def test_return_aux_matches_jax(fused):
  jcfg, tcfg = configs(fused)
  jparams, tparams = weights(7)
  imgs = frames(4, 4)
  xs, Ps, _, aux = tseq.run_filter(tparams, tcfg, imgs, return_aux=True)
  jxs, _, _, jaux = jseq.run_filter(jparams, jcfg, jnp.asarray(imgs),
                                    return_aux=True)
  assert set(aux) == set(jaux)
  assert ("x_prior" in aux) == (not fused)
  close(xs, jxs)
  for k, v in aux.items():
    assert v.shape[0] == 3, k  # frames 1..T-1
    if k == "consistent":
      np.testing.assert_array_equal(v.numpy(), np.asarray(jaux[k]))
    else:
      close(v, jaux[k])
  # the aux of the last step is the step's own
  x, P, feat = tkfnet.first_step(tparams, tcfg, torch.from_numpy(imgs[0]))
  for t in range(1, 4):
    x, P, feat, step_aux = tkfnet.filter_step(tparams, tcfg, x, P, feat,
                                              torch.from_numpy(imgs[t]))
  for k, v in step_aux.items():
    assert torch.equal(aux[k][-1], v), k


@pytest.mark.parametrize("fused", FUSED)
def test_chunked_streaming_matches_full_and_jax(fused):
  jcfg, tcfg = configs(fused)
  jparams, tparams = weights(7)
  imgs = frames(9, 3)
  xs, Ps, _ = tseq.run_filter(tparams, tcfg, imgs)
  outs = list(tseq.run_filter_chunked(tparams, tcfg, list(imgs),
                                      chunk_size=3))
  assert len(outs) == 9
  xs_c = torch.stack([x for x, _ in outs])
  Ps_c = torch.stack([P for _, P in outs])
  np.testing.assert_allclose(xs_c.numpy(), xs.numpy(), atol=1e-5)
  np.testing.assert_allclose(Ps_c.numpy(), Ps.numpy(), atol=1e-5)
  jouts = list(jseq.run_filter_chunked(jparams, jcfg, list(imgs),
                                       chunk_size=3))
  close(xs_c, np.stack([np.asarray(x) for x, _ in jouts]))
  close(Ps_c, np.stack([np.asarray(P) for _, P in jouts]))


@pytest.mark.parametrize("fused", FUSED)
def test_resume_carry_matches_unbroken_and_jax(fused):
  jcfg, tcfg = configs(fused)
  jparams, tparams = weights(7)
  imgs = frames(6, 3)
  xs_full, _, _ = tseq.run_filter(tparams, tcfg, imgs)
  xs_a, _, carry = tseq.run_filter(tparams, tcfg, imgs[:3])
  xs_b, Ps_b, _ = tseq.run_filter(tparams, tcfg, imgs[3:], carry=carry)
  np.testing.assert_allclose(torch.cat([xs_a, xs_b]).numpy(),
                             xs_full.numpy(), atol=1e-5)
  _, _, jcarry = jseq.run_filter(jparams, jcfg, jnp.asarray(imgs[:3]))
  jxs_b, jPs_b, _ = jseq.run_filter(jparams, jcfg, jnp.asarray(imgs[3:]),
                                    carry=jcarry)
  close(xs_b, jxs_b)
  close(Ps_b, jPs_b)


@pytest.mark.parametrize("fused", FUSED)
def test_batched_filter_matches_per_sequence_and_jax(fused):
  jcfg, tcfg = configs(fused)
  jparams, tparams = weights(7)
  imgs_a, imgs_b = frames(4, 11), frames(4, 12)
  xs_a, Ps_a, _ = tseq.run_filter(tparams, tcfg, imgs_a)
  xs_b, _, _ = tseq.run_filter(tparams, tcfg, imgs_b)
  batch = np.stack([imgs_a, imgs_b], axis=1)  # (T, B, H, W, 3)
  xs, Ps = tseq.run_filter_batched(tparams, tcfg, batch)
  assert xs.shape == (4, 2, 6, 8, 3) and Ps.shape == (4, 2, 6, 8, 1)
  np.testing.assert_allclose(xs[:, 0].numpy(), xs_a.numpy(), atol=2e-5)
  np.testing.assert_allclose(xs[:, 1].numpy(), xs_b.numpy(), atol=2e-5)
  np.testing.assert_allclose(Ps[:, 0].numpy(), Ps_a.numpy(), atol=1e-5)
  jxs, jPs = jseq.run_filter_batched(jparams, jcfg, jnp.asarray(batch))
  close(xs, jxs)
  close(Ps, jPs)


def test_batched_adaptive_composition_matches_jax_vmap():
  """The adaptive path's inflation statistic m̄ is one per map, as under the
  JAX package's vmap: on a batch whose maps differ (one prior pushed off
  its measurement, one not) the two maps inflate by different factors
  (about 1.4 and 1 here; one mean over the batch would give both the
  same factor, 1)."""
  jcfg, tcfg = configs(False, adaptive_alpha_max=4.0)
  jparams, tparams = weights(12, adaptive_alpha_max=4.0)
  prev, cur = frames(2, 21), frames(2, 22)
  jfirst = jax.vmap(lambda im: jkfnet.first_step(jparams, jcfg, im))(
      jnp.asarray(prev))
  jx = jfirst[0].at[0].add(5.0)  # map 0 disagrees with its measurement
  jout = jax.vmap(lambda x, P, f, im: jkfnet.filter_step(
      jparams, jcfg, x, P, f, im))(jx, jfirst[1], jfirst[2],
                                   jnp.asarray(cur))
  tout = tkfnet.filter_step(tparams, tcfg, torch.from_numpy(np.array(jx)),
                            torch.from_numpy(np.array(jfirst[1])),
                            torch.from_numpy(np.array(jfirst[2])),
                            torch.from_numpy(cur))
  for i in (0, 1):
    close(tout[i], jout[i])
  close(tout[3]["P_prior"], jout[3]["P_prior"])
  # each map alone gives its own part of the batch
  for b in (0, 1):
    one = tkfnet.filter_step(tparams, tcfg,
                             torch.from_numpy(np.array(jx[b])),
                             torch.from_numpy(np.array(jfirst[1][b])),
                             torch.from_numpy(np.array(jfirst[2][b])),
                             torch.from_numpy(cur[b]))
    np.testing.assert_allclose(tout[3]["P_prior"][b].numpy(),
                               one[3]["P_prior"].numpy(), rtol=1e-4,
                               atol=2e-5)
  # the two maps' inflation factors differ (a global mean would tie them)
  W = tout[3]["W"]
  _, P_plain, _ = tkfnet.warp_lib.warp_state_cov(
      torch.from_numpy(np.array(jx)), torch.from_numpy(
          np.asarray(jfirst[1])), tout[3]["flow"], W)
  alpha = (tout[3]["P_prior"] / P_plain).flatten(1).median(dim=1).values
  assert alpha[0] > 1.2 and alpha[1] == 1.0


def test_batched_adaptive_run_matches_jax():
  jcfg, tcfg = configs(False, adaptive_alpha_max=4.0)
  jparams, tparams = weights(12, adaptive_alpha_max=4.0)
  batch = np.stack([frames(3, 31), frames(3, 32)], axis=1)
  xs, Ps = tseq.run_filter_batched(tparams, tcfg, batch)
  jxs, jPs = jseq.run_filter_batched(jparams, jcfg, jnp.asarray(batch))
  close(xs, jxs)
  close(Ps, jPs)


def test_filter_reduces_noise_toy():
  # a static scene (identical frames): the posterior variance falls below
  # the single-frame measurement's
  _, tcfg = configs(True)
  _, tparams = weights(7)
  img = frames(1, 5)[0]
  xs, Ps, _ = tseq.run_filter(tparams, tcfg, np.stack([img] * 6))
  _, V = tkfnet.measure(tparams, tcfg, torch.from_numpy(img))
  assert float(Ps[-1].mean()) < float(V.mean())
  assert float(Ps[3].mean()) <= float(Ps[1].mean()) + 1e-6


def _streams(T, seed):
  rng = np.random.default_rng(seed)
  u8 = rng.integers(0, 256, (T,) + tc.IMG, dtype=np.uint8)
  # the device-side ingest arithmetic (cast, then * 1/255)
  return u8, u8.astype(np.float32) * np.float32(1.0 / 255.0)


def test_run_filter_uint8_matches_f32():
  _, tcfg = configs(True)
  _, tparams = weights(0)
  u8, f32 = _streams(6, 0)
  xs_u, Ps_u, _ = tseq.run_filter(tparams, tcfg, u8)
  xs_f, Ps_f, _ = tseq.run_filter(tparams, tcfg, f32)
  np.testing.assert_allclose(xs_u.numpy(), xs_f.numpy(), rtol=1e-5,
                             atol=2e-5)
  np.testing.assert_allclose(Ps_u.numpy(), Ps_f.numpy(), rtol=1e-5,
                             atol=2e-5)


@pytest.mark.parametrize("fused", FUSED)
def test_chunked_stream_uint8_and_pipelining(fused):
  """uint8 host frames through the pipelined chunked streamer equal the
  float32 run; the chunks are 5, 4 and a ragged 2; and the JAX streamer
  gives the same."""
  jcfg, tcfg = configs(fused)
  jparams, tparams = weights(1)
  u8, f32 = _streams(11, 2)
  xs_ref, Ps_ref, _ = tseq.run_filter(tparams, tcfg, f32)
  outs = list(tseq.run_filter_chunked_arrays(tparams, tcfg, list(u8),
                                             chunk_size=4))
  assert [o[0].shape[0] for o in outs] == [5, 4, 2]
  xs = torch.cat([o[0] for o in outs])
  Ps = torch.cat([o[1] for o in outs])
  np.testing.assert_allclose(xs.numpy(), xs_ref.numpy(), rtol=1e-5,
                             atol=2e-5)
  np.testing.assert_allclose(Ps.numpy(), Ps_ref.numpy(), rtol=1e-5,
                             atol=2e-5)
  jouts = list(jseq.run_filter_chunked_arrays(jparams, jcfg, list(u8),
                                              chunk_size=4))
  close(xs, np.concatenate([np.asarray(o[0]) for o in jouts]))
  close(Ps, np.concatenate([np.asarray(o[1]) for o in jouts]))


def test_chunked_return_aux_rows_align_as_jax():
  """Aux rows: the first chunk's align with xs[1:] (frame 0 has no filter
  step), every later chunk's with xs one to one; equal to the JAX
  streamer's, and to the one-shot run's."""
  jcfg, tcfg = configs(True)
  jparams, tparams = weights(1)
  u8, _ = _streams(10, 6)
  outs = list(tseq.run_filter_chunked_arrays(tparams, tcfg, list(u8),
                                             chunk_size=4, return_aux=True))
  jouts = list(jseq.run_filter_chunked_arrays(jparams, jcfg, list(u8),
                                              chunk_size=4, return_aux=True))
  assert [o[0].shape[0] for o in outs] == [5, 4, 1]
  assert [o[2]["z"].shape[0] for o in outs] == [4, 4, 1]
  assert [o[2]["z"].shape[0] for o in outs] == [
      np.asarray(o[2]["z"]).shape[0] for o in jouts]
  _, _, _, aux = tseq.run_filter(tparams, tcfg, u8, return_aux=True)
  for k in aux:
    got = torch.cat([o[2][k] for o in outs])
    np.testing.assert_allclose(got.numpy().astype(np.float32),
                               aux[k].numpy().astype(np.float32), atol=1e-5)
    want = np.concatenate([np.asarray(o[2][k]) for o in jouts])
    if k == "consistent":
      np.testing.assert_array_equal(got.numpy(), want)
    else:
      close(got, want)


def test_chunked_stream_yields_completed_chunks_before_failure():
  """A later chunk's failed stack must not lose the chunks computed before
  it: they are yielded before the exception propagates."""
  _, tcfg = configs(True)
  _, tparams = weights(4)
  u8, _ = _streams(13, 5)
  bad = list(u8[:12]) + [u8[12, :10]]  # the 13th frame: wrong shape
  outs = []
  with pytest.raises(ValueError):
    for o in tseq.run_filter_chunked_arrays(tparams, tcfg, bad,
                                            chunk_size=4):
      outs.append(o)
  # chunks 0 (5 frames) and 1 (4 frames) completed before chunk 2's
  # stack hit the bad frame
  assert [o[0].shape[0] for o in outs] == [5, 4]


def test_short_sequence_is_one_chunk_and_tensor_frames_work():
  _, tcfg = configs(True)
  _, tparams = weights(4)
  u8, _ = _streams(3, 7)
  xs, _, _ = tseq.run_filter(tparams, tcfg, u8)
  outs = list(tseq.run_filter_chunked_arrays(
      tparams, tcfg, [torch.from_numpy(f) for f in u8], chunk_size=8))
  assert len(outs) == 1 and torch.equal(outs[0][0], xs)


def test_device_follows_params_and_graph_needs_cuda():
  _, tcfg = configs(True)
  _, tparams = weights(4)
  imgs = frames(3, 8)
  xs, _, _ = tseq.run_filter(tparams, tcfg, imgs)
  assert xs.device.type == "cpu"
  xs2, _, _ = tseq.run_filter(tparams, tcfg, imgs, device="cpu",
                              graph=False)
  assert torch.equal(xs, xs2)
  with pytest.raises(ValueError, match="CUDA"):
    tseq.run_filter(tparams, tcfg, imgs, graph=True)
  with pytest.raises(ValueError, match="CUDA"):
    next(tseq.run_filter_chunked_arrays(tparams, tcfg, list(imgs),
                                        graph=True))
