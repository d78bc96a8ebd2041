"""The pose solve after its draws: the CUDA kernels ``csrc/ransac.cu`` and
their plain PyTorch versions.

They replace no Pallas kernel: the JAX package's PnP-RANSAC
(``kfnet_tpu/pose/ransac.py``) is plain JAX, fused by XLA. The port's plain
composition of the same steps is about 2150 one-op kernels a solve; the
kernels do its work in three launches, stage by stage:

  * ``hypothesize``: each draw's minimal solve, the 6-point DLT
    (``pose.pnp.dlt_pnp``, one candidate) or Grunert's P3P
    (``pose.p3p.p3p_grunert``, four);
  * ``score``: each candidate's weighted inlier sum over its pool;
  * ``pick_and_refine``: each frame's first best candidate, its LM polish
    on the winner's pool (``pose.pnp.refine_pnp_lm``), the final inliers and
    the outputs of ``pose.ransac.solve_with_indices``.

Pools. T frames solve at once, each with M hypotheses. A hypothesis reads
one pool of k points: uv (E, k, 2) pixels, or one (k, 2) grid for every
pool; X (E, k, 3) world points; w (E, k) weights. Without ``map_of``
hypothesis (t, m) reads pool t (E == T); with ``map_of`` ((T, M) int64) it
reads pool ``map_of[t, m]`` of a stack of E. Draws are (T, M, s) int64
indices into the pool; candidates (T, M c, 12) float32, each R (row-major)
then t, world to camera.

The kernels take CUDA tensors only (float32, int64 indices, contiguous,
shapes as above) and raise on anything else; ``pose.ransac`` takes the
``*_reference`` versions on the CPU. Each wrapper has a ``launches`` count
(``kernels.launches``: under CUDA graph capture a launch counts once per
replay). The kernels draw nothing, allocate nothing themselves and never
synchronise, so a solve can be captured in a CUDA graph.
"""

from __future__ import annotations

import ctypes

import torch

from kfnet_tpu_torch.core import geometry as geo
from kfnet_tpu_torch.kernels import launches as launch_count
from kfnet_tpu_torch.pose import p3p, pnp

LIBRARY = "kfnet_ransac"
SOURCES = ("ransac.cu",)
CANDIDATES = {"dlt": 1, "p3p": 4}  # candidates a draw
_SOLVER_CODE = {"dlt": 0, "p3p": 1}
DRAW_SIZES = {"dlt": range(6, 17), "p3p": range(3, 4)}  # the kernels' s
DAMPING = 1e-3  # refine_pnp_lm's default

_LIB = None


def _lib():
  global _LIB
  if _LIB is None:
    from kfnet_tpu_torch.kernels import _build
    lib = _build.load_library(LIBRARY, SOURCES)
    # pointers and the stream as c_void_p: a plain int would be cut to 32 bits
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    lib.kfnet_ransac_hypothesize.argtypes = (
        [ptr] * 6 + [i32] * 8 + [ptr])
    lib.kfnet_ransac_score.argtypes = (
        [ptr] * 7 + [i32] * 6 + [f32, i32, ptr])
    lib.kfnet_ransac_refine.argtypes = (
        [ptr] * 11 + [i32] * 6 + [f32, i32, f32, f32, i32, ptr])
    for fn in (lib.kfnet_ransac_hypothesize, lib.kfnet_ransac_score,
               lib.kfnet_ransac_refine):
      fn.restype = ctypes.c_int
    lib.kfnet_ransac_error_string.restype = ctypes.c_char_p
    lib.kfnet_ransac_error_string.argtypes = [ctypes.c_int]
    _LIB = lib
  return _LIB


def build() -> None:
  """Build (or load the cached) kernel library without launching it."""
  _lib()


# ---------------------------------------------------------------------------
# The plain versions: the solve's composition of PyTorch operations, stage
# by stage (the CPU's solve, and the card's yardstick).


def take(a, idx):
  """Rows of ``a`` ([T,] N, C) at ``idx`` ([T,] *S): ([T,] *S, C)."""
  sel = idx.reshape(a.shape[:-2] + (-1, 1))
  return torch.take_along_dim(a, sel, dim=-2).reshape(idx.shape
                                                      + a.shape[-1:])


def _pick(a, best):
  """``a``'s row ``best`` along the hypothesis axis, by a gather: a CUDA
  index read as a Python int would be copied to the host."""
  n = best.dim()
  sel = best.reshape(best.shape + (1,) * (a.dim() - n))
  return torch.take_along_dim(a, sel, dim=n).squeeze(n)


def per_hypothesis(uv, X, w, map_of=None):
  """The pool each hypothesis reads, ([T,] M or 1, k, ...): its frame's, as
  views, or with ``map_of`` its map's rows."""
  if map_of is None:
    return uv[..., None, :, :], X[..., None, :, :], w[..., None, :]
  return (uv if uv.dim() == 2 else uv[map_of]), X[map_of], w[map_of]


def hypothesize_reference(uvh, Xh, K, idx, solver: str):
  """Each draw's candidates from its pool (``per_hypothesis``): R ([T,] M,
  c, 3, 3) and t ([T,] M, c, 3), c = ``CANDIDATES[solver]``."""
  if solver == "p3p":
    return p3p.p3p_grunert(take(uvh, idx), take(Xh, idx), K)
  Rs, ts = pnp.dlt_pnp(take(uvh, idx), take(Xh, idx), K)
  return Rs[..., None, :, :], ts[..., None, :]


def score_reference(uvh, Xh, wh, K, Rs, ts, threshold: float):
  """Each candidate's inlier weights over its pool, ([T,] M c, k): (error
  < threshold) w. A candidate's score is their sum."""
  pool = lambda a: a[..., None, :, :]  # against a draw's candidates
  errs = pnp.reprojection_errors(pool(uvh), pool(Xh), K, Rs, ts)
  inl = (errs < threshold).to(torch.float32) * wh[..., None, :]
  return inl.flatten(-3, -2)


def refine_reference(uv, X, w, K, Rs, ts, inl, iters: int,
                     threshold: float, map_of=None):
  """The first best of each frame's candidates (the largest inlier sum),
  its LM polish on its inliers of its pool, and the final inliers under
  ``threshold``: ``pose.ransac.solve_with_indices``'s outputs."""
  c = Rs.shape[-3]
  Rs, ts = Rs.flatten(-4, -3), ts.flatten(-3, -2)
  best = torch.argmax(torch.sum(inl, dim=-1), dim=-1)
  R0, t0, inl0 = _pick(Rs, best), _pick(ts, best), _pick(inl, best)
  if map_of is not None:  # on the winner's map
    mb = _pick(map_of, torch.div(best, c, rounding_mode="floor"))
    X, w = X[mb], w[mb]
    uv = uv.expand(X.shape[:-1] + (2,)) if uv.dim() == 2 else uv[mb]
  R, t = pnp.refine_pnp_lm(uv, X, K, R0, t0, inl0, iters=iters)
  err_f = pnp.reprojection_errors(uv, X, K, R, t)
  inl_f = (err_f < threshold).to(torch.float32) * w
  n_in = torch.sum(inl_f, dim=-1)
  return {
      "T_wc": geo.invert_pose(geo.make_pose(R, t)),
      "num_inliers": n_in,
      "inlier_ratio": n_in / torch.clamp_min(torch.sum(w, dim=-1), 1.0),
      "mean_inlier_error_px":
          torch.sum(err_f * inl_f, dim=-1) / torch.clamp_min(n_in, 1.0),
  }


def candidates(Rs, ts):
  """(T, M, c, 3, 3) R and (T, M, c, 3) t packed as the kernels'
  candidates, (T, M c, 12)."""
  T = Rs.shape[0]
  return torch.cat([Rs.reshape(T, -1, 9), ts.reshape(T, -1, 3)],
                   dim=-1).contiguous()


# ---------------------------------------------------------------------------
# The kernels


def _check(name, t, dtype, shape, device):
  if t.device != device:
    raise ValueError(f"{name} is on {t.device}, expected {device}")
  if t.dtype != dtype:
    raise TypeError(f"{name} must be {dtype}, got {t.dtype}")
  if tuple(t.shape) != tuple(shape):
    raise ValueError(f"{name} has shape {tuple(t.shape)}, expected "
                     f"{tuple(shape)}")
  if not t.is_contiguous():
    raise ValueError(f"{name} must be contiguous")


def _pools(uv, X, w, K, map_of, T: int, M: int):
  """Check the pools, K and ``map_of`` on X's CUDA device; returns (their
  pointers, k, maps, uv_shared, device)."""
  dev = X.device
  if dev.type != "cuda":
    raise ValueError(f"the RANSAC kernels run on cuda tensors, got X on "
                     f"{dev}")
  if X.dim() != 3:
    raise ValueError(f"X must be (E, k, 3), got {tuple(X.shape)}")
  E, k = X.shape[:2]
  _check("X", X, torch.float32, (E, k, 3), dev)
  uv_shared = uv.dim() == 2
  _check("uv", uv, torch.float32, (k, 2) if uv_shared else (E, k, 2), dev)
  if w is not None:
    _check("w", w, torch.float32, (E, k), dev)
  _check("K", K, torch.float32, (3, 3), dev)
  if map_of is None:
    if E != T:
      raise ValueError(f"without map_of there is a pool a frame: {E} pools "
                       f"for {T} frames")
  else:
    _check("map_of", map_of, torch.int64, (T, M), dev)
  ptrs = (uv.data_ptr(), X.data_ptr(), None if w is None else w.data_ptr(),
          None if map_of is None else map_of.data_ptr(), K.data_ptr())
  return ptrs, k, E, int(uv_shared), dev


def _stream(dev):
  return dev.index, torch.cuda.current_stream(dev).cuda_stream


def _raise_on(lib, err, name):
  if err != 0:
    msg = lib.kfnet_ransac_error_string(err).decode()
    raise RuntimeError(f"{name} launch failed: {msg} ({err})")


def hypothesize(uv, X, K, idx, solver: str, map_of=None):
  """The candidates of T frames' M draws each: one launch, one thread a
  draw. ``idx`` (T, M, s) int64, s = 6..16 for the DLT, 3 for P3P.

  Returns (T, M c, 12) float32 candidates, c = ``CANDIDATES[solver]``."""
  if solver not in CANDIDATES:
    raise ValueError(f"solver={solver!r}: expected one of "
                     f"{tuple(CANDIDATES)}")
  if idx.dim() != 3:
    raise ValueError(f"idx must be (T, M, s), got {tuple(idx.shape)}")
  T, M, s = idx.shape
  if s not in DRAW_SIZES[solver]:
    raise ValueError(f"a {solver} draw of {s} points: the kernel takes "
                     f"{DRAW_SIZES[solver].start}-"
                     f"{DRAW_SIZES[solver].stop - 1}")
  (uvp, Xp, _, mp, Kp), k, E, shared, dev = _pools(uv, X, None, K, map_of,
                                                   T, M)
  _check("idx", idx, torch.int64, (T, M, s), dev)
  c = CANDIDATES[solver]
  cands = torch.empty((T, M * c, 12), dtype=torch.float32, device=dev)
  lib = _lib()
  err = lib.kfnet_ransac_hypothesize(
      uvp, Xp, mp, Kp, idx.data_ptr(), cands.data_ptr(), T, M, s, k, E,
      shared, _SOLVER_CODE[solver], *_stream(dev))
  _raise_on(lib, err, "ransac hypothesize")
  launch_count.count(hypothesize)
  return cands


def _draws(cands, T: int, per_draw: int, map_of):
  """M, the draws a frame of (T, M c, 12) candidates, c = ``per_draw``."""
  if per_draw not in (1, 4):
    raise ValueError(f"per_draw must be 1 (DLT) or 4 (P3P), got {per_draw}")
  if cands.dim() != 3 or cands.shape[0] != T or cands.shape[1] % per_draw:
    raise ValueError(f"cands must be (T={T}, M {per_draw}, 12), got "
                     f"{tuple(cands.shape)}")
  M = cands.shape[1] // per_draw
  if M == 0 or (map_of is not None and map_of.shape[-1] != M):
    raise ValueError(f"cands has {cands.shape[1]} candidates a frame, not "
                     f"{per_draw} for each of the draws")
  return M


def score(uv, X, w, K, cands, per_draw: int, threshold: float,
          map_of=None):
  """Each candidate's inlier weight over its draw's pool, the sum of
  (reprojection error < ``threshold``) w: one launch, one block a draw;
  ``per_draw`` (c) candidates a draw, as ``hypothesize`` made them.

  Returns (T, M c) float32."""
  T = X.shape[0] if map_of is None else map_of.shape[0]
  M = _draws(cands, T, per_draw, map_of)
  (uvp, Xp, wp, mp, Kp), k, E, shared, dev = _pools(uv, X, w, K, map_of,
                                                    T, M)
  _check("cands", cands, torch.float32, (T, M * per_draw, 12), dev)
  out = torch.empty((T, M * per_draw), dtype=torch.float32, device=dev)
  lib = _lib()
  err = lib.kfnet_ransac_score(
      uvp, Xp, wp, mp, Kp, cands.data_ptr(), out.data_ptr(), T, M, per_draw,
      k, E, shared, float(threshold), *_stream(dev))
  _raise_on(lib, err, "ransac score")
  launch_count.count(score)
  return out


def pick_and_refine(uv, X, w, K, cands, scores, per_draw: int,
                    inlier_threshold: float, iters: int,
                    refine_threshold: float, map_of=None):
  """Each frame's pose from its candidates and their ``scores``: the first
  best, ``iters`` LM iterations on its pool weighted by its inliers under
  ``inlier_threshold``, the final inliers under ``refine_threshold``. One
  launch, one block a frame.

  Returns {"T_wc" (T, 4, 4) camera to world, "num_inliers",
  "inlier_ratio", "mean_inlier_error_px" (T,) each}."""
  T = X.shape[0] if map_of is None else map_of.shape[0]
  M = _draws(cands, T, per_draw, map_of)
  (uvp, Xp, wp, mp, Kp), k, E, shared, dev = _pools(uv, X, w, K, map_of,
                                                    T, M)
  _check("cands", cands, torch.float32, (T, M * per_draw, 12), dev)
  _check("scores", scores, torch.float32, (T, M * per_draw), dev)
  if iters < 0:
    raise ValueError(f"iters must be >= 0, got {iters}")
  out = {"T_wc": torch.empty((T, 4, 4), dtype=torch.float32, device=dev)}
  for name in ("num_inliers", "inlier_ratio", "mean_inlier_error_px"):
    out[name] = torch.empty((T,), dtype=torch.float32, device=dev)
  lib = _lib()
  err = lib.kfnet_ransac_refine(
      uvp, Xp, wp, mp, Kp, cands.data_ptr(), scores.data_ptr(),
      *(t.data_ptr() for t in out.values()), T, M, per_draw, k, E, shared,
      float(inlier_threshold), int(iters), float(refine_threshold), DAMPING,
      *_stream(dev))
  _raise_on(lib, err, "ransac pick_and_refine")
  launch_count.count(pick_and_refine)
  return out


hypothesize.launches = 0
score.launches = 0
pick_and_refine.launches = 0
