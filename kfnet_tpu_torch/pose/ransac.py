"""Fixed-budget batched PnP-RANSAC (port of ``kfnet_tpu/pose/ransac.py``).

Confidence preselection is a top-k, hypotheses are a batched 6-point DLT
over an (M, 6) index tensor (or, with ``solver="p3p"``, Grunert's P3P over
an (M, 3) one, 4 candidates a draw: 4M scored), scoring is one (M, N) reprojection-error
matrix, and the winner gets a fixed-iteration LM polish on its inliers.
Every step takes a leading frame dim T, where the JAX package vmaps the
solve over frames: T frames solve in one pass of launches.
Sampling is split from solving (``solve_with_indices``) so a test can
feed the JAX package and the port the same index set.

Several maps a frame (ESAC's experts, ``models/esac.py``): with
``map_of`` ((T, M) long) the solve takes a stack of E maps, and hypothesis
m of frame t draws its set from map ``map_of[t, m]``, is scored against
that map and, where it wins, refined on it. Without a variance there is no
top-k: every valid cell of the map takes part. With ``map_of[t] = t`` and
the variances the solve is the one-map solve, bit for bit. Nothing here reads
a value back to the host. A solve is the span ``pose.solve``
(``utils/tracing.py``) over its four stages: ``pose.draw`` (top-k and
draws), ``pose.hypothesize``, ``pose.score`` (errors, inliers) and
``pose.refine`` (the pick, LM, final errors and outputs).

After the draws, the device decides the path: on the CPU the plain
PyTorch composition (``kernels/ransac.py``, the ``*_reference`` stages), on
CUDA the hand-written kernels, one launch a stage (``kernels/ransac.py``:
``hypothesize``, ``score``, ``pick_and_refine``), each solve counting one
``pose.kernel_solves``. The kernels draw nothing: the top-k and the keys
are the same on both.

A serving surface replays its solve as one CUDA graph (``GraphedSolve``,
passed to ``solve_pnp_from_maps`` as ``graphed``); without one the solve
runs eagerly, as every other caller runs it.
"""

from __future__ import annotations

import dataclasses

import torch

from kfnet_tpu_torch.core import geometry as geo
from kfnet_tpu_torch.kernels import ransac as kransac
from kfnet_tpu_torch.utils import graphs, tracing

SOLVERS = ("dlt", "p3p")


@dataclasses.dataclass(frozen=True)
class RansacConfig:
  num_hypotheses: int = 256
  solver: str = "dlt"            # "dlt" (6 points) | "p3p" (3 points, up to
                                 # 4 candidates a draw)
  sample_size: int = 6           # the DLT's minimal set (P3P draws 3)
  inlier_threshold_px: float = 10.0
  top_k: int = 2048
  refine_iters: int = 10
  refine_threshold_px: float = 10.0

  def __post_init__(self):
    if self.solver not in SOLVERS:
      raise ValueError(f"solver={self.solver!r}: expected one of {SOLVERS}")

  @property
  def draw_size(self) -> int:
    """Points a hypothesis is drawn from."""
    return 3 if self.solver == "p3p" else self.sample_size


def select_confident(pixels, coords, variance, valid, k):
  """Top-k lowest-variance valid correspondences of each frame.

  Args:
    pixels: ([T,] N, 2), shared by the frames when 2-dim; coords: ([T,] N,
      3); variance: ([T,] N); valid: ([T,] N) bool.

  Returns (pixels_k, coords_k, weight_k), ([T,] k, ...); weight is 0 for
  slots that were invalid (when fewer than k valid points exist)."""
  score = torch.where(valid, -variance,
                      torch.full_like(variance, float("-inf")))
  idx = torch.topk(score, k).indices
  pixels = pixels.expand(idx.shape[:-1] + pixels.shape[-2:])
  return (kransac.take(pixels, idx), kransac.take(coords, idx),
          torch.take_along_dim(valid, idx, dim=-1).to(torch.float32))


def sample_hypotheses(w, num_hypotheses: int, sample_size: int,
                      generator: torch.Generator | None = None,
                      map_of: torch.Tensor | None = None):
  """([T,] M, s) index sets drawn without replacement, for each frame
  uniformly over its slots with weight > 0 (over all its slots when none
  has). With ``map_of`` ((T, M) long into the E rows of ``w`` (E, k)),
  hypothesis m of frame t draws over the slots of map ``map_of[t, m]``.

  This is ``torch.multinomial(p, s, replacement=False)``'s own algorithm
  (keys p / Exp(1), the s largest win) without its input check, which
  reads a value back to the host. The frames' draws come from one
  generator, frame after frame."""
  p = (w > 0).to(torch.float32)
  p = torch.where(torch.any(w > 0, dim=-1, keepdim=True), p,
                  torch.ones_like(p))
  lead = w.shape[:-1] if map_of is None else map_of.shape[:-1]
  q = torch.empty(lead + (num_hypotheses, w.shape[-1]),
                  dtype=torch.float32,
                  device=w.device).exponential_(generator=generator)
  p = p[..., None, :] if map_of is None else p[map_of]
  return torch.topk(p / q, sample_size, dim=-1).indices


def solve_with_indices(uv, X, w, K, idx, config: RansacConfig = RansacConfig(),
                       map_of: torch.Tensor | None = None):
  """Hypothesize from ([T,] M, ``config.draw_size``) index sets into each
  frame's (k,) pool, score, refine; a leading T solves T frames at once.

  Args:
    uv: ([T,] k, 2) pixels; X: ([T,] k, 3) world points; w: ([T,] k)
      weights; K: (3, 3).
    map_of: (T, M) long, or None. Given, uv (E, k, 2) or one (k, 2) for
      every map, X (E, k, 3) and w (E, k) are a stack of E maps, and
      hypothesis m of frame t indexes, is scored on and is refined on map
      ``map_of[t, m]``.

  Returns:
    dict with T_wc ([T,] 4, 4 camera-to-world), num_inliers, inlier_ratio,
    mean_inlier_error_px (([T,]) each).
  """
  if X.device.type == "cuda":
    return _solve_on_card(uv, X, w, K, idx, config, map_of)
  if X.device.type != "cpu":
    raise ValueError(f"the pose solve runs on cuda or cpu tensors, got "
                     f"{X.device}")
  cfg = config
  uvh, Xh, wh = kransac.per_hypothesis(uv, X, w, map_of)
  with tracing.span("pose.hypothesize"):  # ([T,] M, c, 3, 3): c a draw
    Rs, ts = kransac.hypothesize_reference(uvh, Xh, K, idx, cfg.solver)
  with tracing.span("pose.score"):
    inl = kransac.score_reference(uvh, Xh, wh, K, Rs, ts,
                                  cfg.inlier_threshold_px)
  with tracing.span("pose.refine"):
    return kransac.refine_reference(uv, X, w, K, Rs, ts, inl,
                                    cfg.refine_iters,
                                    cfg.refine_threshold_px, map_of)


def _solve_on_card(uv, X, w, K, idx, cfg, map_of):
  """``solve_with_indices`` as the three kernels' launches."""
  one = map_of is None and X.dim() == 2  # a frame without the T axis
  if one:
    X, w, idx = X[None], w[None], idx[None]
  uv, X, w, K, idx = (t.contiguous() for t in (uv, X, w, K, idx))
  if map_of is not None:
    map_of = map_of.contiguous()
  c = kransac.CANDIDATES[cfg.solver]
  with tracing.span("pose.hypothesize"):
    cands = kransac.hypothesize(uv, X, K, idx, cfg.solver, map_of)
  with tracing.span("pose.score"):
    scores = kransac.score(uv, X, w, K, cands, c, cfg.inlier_threshold_px,
                           map_of)
  with tracing.span("pose.refine"):
    out = kransac.pick_and_refine(uv, X, w, K, cands, scores, c,
                                  cfg.inlier_threshold_px, cfg.refine_iters,
                                  cfg.refine_threshold_px, map_of)
  if not torch.cuda.is_current_stream_capturing():
    tracing.count("pose.kernel_solves")  # a replay counts in GraphedSolve
  return {name: v[0] for name, v in out.items()} if one else out


def solve_pnp_ransac(pixels, coords, variance, valid, K,
                     generator: torch.Generator | None = None,
                     config: RansacConfig = RansacConfig(),
                     map_of: torch.Tensor | None = None):
  """Robust pose from ([T,] N, 2) pixels (one (N, 2) grid serves every
  frame), ([T,] N, 3) world coordinates, ([T,] N) variances (confidence
  1/σ²) and ([T,] N) validity, for one frame or T at once. With
  ``map_of`` ((T, M)), coords, variance and valid are a stack of E maps
  (E, N, ...) that the hypotheses index, and ``variance`` may be None:
  then every valid cell takes part, in grid order. See
  solve_with_indices."""
  with tracing.span("pose.draw"):
    if variance is None:
      uv, X, w = pixels, coords, valid.to(torch.float32)
    else:
      k = min(config.top_k, coords.shape[-2])
      uv, X, w = select_confident(pixels, coords, variance, valid, k)
    idx = sample_hypotheses(w, config.num_hypotheses, config.draw_size,
                            generator, map_of)
  return solve_with_indices(uv, X, w, K, idx, config, map_of)


def _solve_maps(coords_map, variance_map, valid_map, K, generator, stride,
                config, map_of=None):
  h, w = coords_map.shape[-3:-1]
  lead = tuple(coords_map.shape[:-3])
  grid = geo.cell_center_grid(h, w, stride,
                              device=coords_map.device).reshape(-1, 2)
  return solve_pnp_ransac(
      grid, coords_map.reshape(lead + (-1, 3)),
      None if variance_map is None else variance_map.reshape(lead + (-1,)),
      valid_map.reshape(lead + (-1,)), K, generator, config, map_of)


class GraphedSolve:
  """A serving surface's pose solve (``graphed=`` of every
  ``solve_pnp_from_maps`` call) as one CUDA graph (``utils/graphs.py``)
  over the x, P and valid maps, K and ``map_of`` (None: none). It keeps
  one capture, keyed by their shapes, dtypes and devices, the RANSAC
  config, the stride and the generator, which is registered: solve i draws
  its i-th block, as the eager solve does. A replay's outputs are the
  graph's buffers. A capture is the span ``pose.capture``, counted in
  ``pose.captures``; a replay counts one ``pose.replays`` and, where the
  capture launched the solve's kernels, one ``pose.kernel_solves``."""

  def __init__(self):
    self._key = None
    self._held = {}  # None: the kept capture, whose graph, inputs and out

  graph = property(lambda self: self._held[None].graph)
  inputs = property(lambda self: self._held[None].inputs)
  out = property(lambda self: self._held[None].out)

  def solve(self, coords_map, variance_map, valid_map, K, generator, stride,
            config, map_of=None):
    """This call's solve of the maps: a replay where the kept capture has
    its key, else the warm-up's result of a new capture."""
    maps = (coords_map, variance_map, valid_map, K, map_of)
    key = (tuple(None if t is None else (tuple(t.shape), t.dtype, t.device)
                 for t in maps), generator, stride, config)

    def capture():
      with tracing.span("pose.capture"):
        tracing.count("pose.captures")
        return graphs.Graph(lambda x, P, v, K, m: _solve_maps(
            x, P, v, K, generator, stride, config, m), maps, generator)

    held, built = graphs.kept(self._held, None, lambda _: key == self._key,
                              capture)
    self._key = key
    if built:
      return held.first
    out = held.replay(*maps)
    tracing.count("pose.replays")
    if held.record:  # the capture's solve ran the kernels
      tracing.count("pose.kernel_solves")
    return out


def solve_pnp_from_maps(coords_map, variance_map, valid_map, K,
                        generator: torch.Generator | None = None,
                        stride: int = 8,
                        config: RansacConfig = RansacConfig(),
                        graphed: GraphedSolve | None = None,
                        map_of: torch.Tensor | None = None):
  """([T,] h, w, 3) / ([T,] h, w, 1) maps -> pose (per map); pixels are the
  stride-cell centres used in label generation. With ``map_of`` ((T, M)
  long) the maps are a stack (E, h, w, ...) and hypothesis m of frame t
  reads map ``map_of[t, m]`` (``variance_map`` None: no top-k); one pose a
  frame. With ``graphed`` (a serving surface's ``GraphedSolve``) the solve
  is that graph's replay, or on a new key its capture: the outputs may
  then be the graph's buffers, which its next replay overwrites."""
  with tracing.span("pose.solve"):
    if graphed is not None:
      return graphed.solve(coords_map, variance_map, valid_map, K, generator,
                           stride, config, map_of)
    return _solve_maps(coords_map, variance_map, valid_map, K, generator,
                       stride, config, map_of)


def solve_pnp_from_maps_batched(coords_maps, variance_maps, valid_maps, K,
                                generator: torch.Generator | None = None,
                                stride: int = 8,
                                config: RansacConfig = RansacConfig()):
  """T frames' (T, h, w, 3) / (T, h, w, 1) maps -> T poses in one solve (the
  JAX package's ``vmap`` of ``solve_pnp_from_maps`` over frames): dict of
  (T, ...) tensors on the maps' device. Reads nothing back to the host;
  the T frames' hypotheses come from ``generator`` in one draw."""
  if coords_maps.dim() != 4:
    raise ValueError(f"expected (T, h, w, 3) maps, got "
                     f"{tuple(coords_maps.shape)}")
  return solve_pnp_from_maps(coords_maps, variance_maps, valid_maps, K,
                             generator, stride, config)
