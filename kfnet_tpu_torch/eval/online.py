"""Online (streaming) relocalization: the serving surface (port of
``kfnet_tpu/eval/online.py``): ``OnlineRelocalizer`` for one camera,
``FleetRelocalizer`` for B cameras in lockstep; and ``EsacRelocalizer``,
ESAC's gating and experts for B cameras (``models/esac.py``).

    reloc = OnlineRelocalizer(params, config, K)      # on cuda
    for frame in camera:                              # (H, W, 3) uint8
        pose, info = reloc.process(frame)

One frame is one filter step plus one PnP-RANSAC solve, all enqueued on
the device, and ONE device->host copy of 19 packed floats:
[consistent_frac, T_wc (16), num_inliers, inlier_ratio].

On ``cuda`` the filter step and consistent_frac run as one CUDA graph
(``filter.sequence.GraphedStep``, which the sequence runners replay too),
the port's counterpart of the JAX package's jitted ``_step``: frame 0 runs
``first_step`` eagerly; the first filter-step frame runs the step eagerly
on a side stream (the warm-up, which is that frame's result) and then
captures it; every later frame copies itself into the graph's input
buffer and replays it. The graph outlives ``reset()``: the frame after a
restart copies the new carry into the graph's carry buffers and replays.
A new frame shape or an in-place weight update captures again; a capture
synchronises the device once (``torch.cuda.graph``). The pose solve is a second CUDA graph
(``pose.ransac.GraphedSolve``): the first solve runs eagerly and then
captures, every later one copies the maps in and replays, its draws the
same blocks of the surface's generator as the eager solve's. A new map
shape captures again; a reset does not. ``graph=False`` runs every step
and solve eagerly, as on the CPU.

A tick is the span ``online.tick`` (``utils/tracing.py``) of the frame or
tick number, and the host's one wait for a frame or tick ``online.wait``,
which counts one ``host.syncs``.
"""

from __future__ import annotations

import numpy as np
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch.filter import sequence
from kfnet_tpu_torch.models import esac, kfnet
from kfnet_tpu_torch.nn import layers as L
from kfnet_tpu_torch.parallel.mesh import Sharded
from kfnet_tpu_torch.pose import ransac, smoothing
from kfnet_tpu_torch.utils import graphs, tracing


def _consistent_frac(aux) -> torch.Tensor:
  return torch.mean(aux["consistent"].to(torch.float32)).reshape(1)


def _slot_fracs(aux) -> torch.Tensor:
  """(B, 1) consistent_frac of each slot; 0 on a slot that reset."""
  frac = aux["consistent"].flatten(1).to(torch.float32).mean(1)
  return torch.where(aux["reset"], torch.zeros_like(frac), frac)[:, None]


def _packed_parts(out):
  """The pose solve's output as the packed columns [T_wc (16),
  num_inliers, inlier_ratio] over its leading dims."""
  lead = tuple(out["num_inliers"].shape)
  return [out["T_wc"].reshape(lead + (16,)).to(torch.float32),
          out["num_inliers"].reshape(lead + (1,)).to(torch.float32),
          out["inlier_ratio"].reshape(lead + (1,)).to(torch.float32)]


class _Relocalizer:
  """What both serving surfaces hold: the weights, intrinsics and RANSAC
  settings on the device, the (x, P, features) carry, the captured filter
  step and the graphed pose solve."""

  def __init__(self, params, config: kfnet.KFNetConfig, K,
               ransac_config: ransac.RansacConfig | None, stride: int,
               solve_pose: bool, seed: int, device, graph: bool | None):
    self.device = kfnet_tpu_torch.resolve_device(device)
    self._graph = graphs.use_graph(self.device, graph)
    self._params = L.tree_map(lambda p: p.to(self.device), params)
    self._config = config
    self._K = torch.as_tensor(np.asarray(K, np.float32), device=self.device)
    self._rcfg = ransac_config or ransac.RansacConfig()
    self._stride = stride
    self._solve = solve_pose
    self._gen = torch.Generator(device=self.device).manual_seed(seed)
    self._carry = None
    self._graphs = {}  # "step": the captured filter step (graph on)
    # a later frame's (or tick's) filter step; a function, not a bound
    # method, whose cycle would leave the graphs to a GC inside a capture
    self._filter = (_Relocalizer._replayed if self._graph
                    else _Relocalizer._eager)
    self._solver = (ransac.GraphedSolve() if self._graph and solve_pose
                    else None)

  def _replayed(self, frames, outputs, mask=None):
    step, out = sequence.kept_step(self._graphs, "step", self._params,
                                   self._config, self._carry, frames,
                                   outputs, mask)
    self._carry = step.carry
    return out

  def _eager(self, frames, outputs, mask=None):
    self._carry, aux = sequence.filter_step(self._params, self._config,
                                            self._carry, frames, mask)
    return outputs(aux)

  def _first(self, frames):
    """The carry of a first frame (or tick): its measurement; frac 0."""
    image = kfnet.preprocess_images(
        self._config, frames.to(self.device, non_blocking=True))
    self._carry = kfnet.first_step(self._params, self._config, image)
    return torch.zeros(frames.shape[:-3] + (1,), dtype=torch.float32,
                       device=self.device)

  @property
  def state(self):
    """Current (x, P, features) carry (batched over slots in a fleet;
    device tensors, not copied). With the graph on, these are its buffers,
    which the next tick overwrites: clone them to keep them."""
    return self._carry

  def _solve_packed(self, x, P):
    """The pose solve of the (x, P) maps, as the packed columns (copied out
    of the graph's output buffers by the caller's ``torch.cat``)."""
    return _packed_parts(ransac.solve_pnp_from_maps(
        x, P, torch.ones_like(P, dtype=torch.bool), self._K, self._gen,
        stride=self._stride, config=self._rcfg, graphed=self._solver))


class OnlineRelocalizer(_Relocalizer):
  """Carries (x, P, features) across frames on the device."""

  def __init__(self, params, config: kfnet.KFNetConfig, K,
               ransac_config: ransac.RansacConfig | None = None,
               stride: int = 8, solve_pose: bool = True, seed: int = 0,
               device=None, graph: bool | None = None,
               smoother: smoothing.SmootherConfig | None = None):
    """``graph``: replay the filter step and the pose solve as CUDA graphs
    (the default on ``cuda``; ``False`` runs them eagerly; the CPU has no
    graphs).
    ``smoother``: gate and blend the solved poses on the host
    (``pose/smoothing.py``); it resets with the filter."""
    super().__init__(params, config, K, ransac_config, stride, solve_pose,
                     seed, device, graph)
    self._frames = 0
    self._smoother = (smoothing.PoseSmoother(smoother)
                      if smoother is not None else None)

  def reset(self):
    """Drop the temporal state (scene change / tracking restart) and the
    smoother's history. The captured step is kept: the next filter-step
    frame replays it from the new carry."""
    self._carry = None
    if self._smoother is not None:
      self._smoother.reset()

  def tick(self, image) -> torch.Tensor:
    """Enqueue one frame's work; returns the packed (19,) (or (1,) without
    pose solving) float32 result on the device. Reads nothing back and
    never waits on the device, except on a frame that captures a graph:
    the pose solve's (the first frame, and the first of a new frame shape)
    or the filter step's (its first filter-step frame, and the first after
    a new frame shape or a weight update), where each capture synchronises
    once."""
    with tracing.span("online.tick", id=self._frames):
      frame = sequence.host_frames(image, self.device)
      frac = (self._first(frame) if self._carry is None
              else self._filter(self, frame, _consistent_frac))
      self._frames += 1
      parts = [frac]
      if self._solve:
        parts += self._solve_packed(*self._carry[:2])
      return torch.cat(parts)

  def process(self, image):
    """Feed one (H, W, 3) frame (uint8 0..255, or float in [0, 1]);
    returns (T_wc 4x4 numpy or None, info dict).

    info: frame, consistent_frac (filter health; ~0 after a cut), and
    num_inliers / inlier_ratio when pose solving is on."""
    info: dict = {"frame": self._frames}
    packed = self.tick(image)
    with tracing.span("online.wait", id=info["frame"]):
      tracing.count("host.syncs")
      packed = packed.cpu().numpy()  # the frame's one host sync
    info["consistent_frac"] = float(packed[0])
    if not self._solve:
      return None, info
    info["num_inliers"] = float(packed[17])
    info["inlier_ratio"] = float(packed[18])
    pose = packed[1:17].reshape(4, 4)
    if self._smoother is not None:
      pose = self._smoother.update(pose)
    return pose, info


class FleetRelocalizer(_Relocalizer):
  """B camera streams filtered in lockstep: the multi-stream serving
  surface.

      fleet = FleetRelocalizer(params, config, K, batch_size=4)  # on cuda
      poses, info = fleet.process(frames)                # (B, H, W, 3)
      poses, info = fleet.process(frames, reset=[False, False, False, True])

  A tick is one filter step for all B slots and one pose solve with B as
  its leading dim, enqueued on the device, and ONE device->host copy of a
  (B, 19) float32 block: [consistent_frac, T_wc (16), num_inliers,
  inlier_ratio] per slot. On ``cuda`` the filter step is one CUDA graph
  replay for the B slots (``filter.sequence.GraphedStep``: one fused
  update launch over the B maps; kernel convs a frame at a time), the
  per-slot reset a mask the replay copies in, so a reset never captures
  again; the B slots' pose solve is one ``GraphedSolve`` replay. A slot
  that resets starts a new session at that frame, its posterior the
  frame's measurement (``kfnet.first_step``'s). On the first tick every
  slot starts fresh and the mask is ignored. Streams never
  interact, but in the default bf16 config a slot is not bit-equal to a
  lone stream: cuDNN's convolutions pick their algorithm by the batch
  (``PERF.md``); the conv-kernel config, whose nets run frame by frame, is.

  ``pipeline_depth=d`` returns tick t−d's results from tick t's
  ``process``: the result's copy into pinned host memory is enqueued behind
  an event and waited for only when tick t−d is finalized, so the host's
  read overlaps the device's next ticks. The first d calls return ``(None,
  {"pending": True, ...})``; ``flush()`` drains the tail.

  Each slot may have its own pose smoother (``smoother``), reset when the
  tick that reset its slot is finalized.

  With a ``mesh`` (``parallel.mesh.Mesh``), the slots are split into
  contiguous groups, one per mesh entry, as the JAX package shards them
  over its mesh: each entry filters its group on its device with its own
  graphed step and its share of the reset mask. The maps of all B slots
  are then gathered on the first entry's device and solved there at once
  (one graphed solve on ``cuda``), from the one generator, as the
  one-device fleet solves them: the draws, and so the poses, do not depend
  on the split. ``state`` is (x, P, feat) as ``Sharded`` values along the
  slots; ``tick`` returns the (B, 19) block on the first entry's device.
  """

  def __init__(self, params, config: kfnet.KFNetConfig, K, batch_size: int,
               ransac_config: ransac.RansacConfig | None = None,
               stride: int = 8, solve_pose: bool = True, seed: int = 0,
               mesh=None, axis_name: str = "data",
               smoother: smoothing.SmootherConfig | None = None,
               pipeline_depth: int = 0, device=None,
               graph: bool | None = None):
    if pipeline_depth < 0:
      raise ValueError(f"pipeline_depth must be >= 0, got {pipeline_depth}")
    self._entries = None
    if mesh is not None:
      mesh.check_axis(axis_name)
      if batch_size % mesh.size:
        raise ValueError(f"batch_size {batch_size} must be divisible by "
                         f"mesh size {mesh.size}")
      if device is not None:
        raise ValueError("give a mesh or a device, not both")
      device = mesh.devices[0]
      on = {}  # the params placed once per device
      for dev in mesh.devices:
        if dev not in on:
          on[dev] = L.tree_map(lambda p, d=dev: p.to(d), params)
      params = on[device]
      # each entry: its slots' carry and graphed step on its device
      self._entries = [
          FleetRelocalizer(on[dev], config, K, batch_size // mesh.size,
                           solve_pose=False, device=dev, graph=graph)
          for dev in mesh.devices]
      self._mesh = mesh
    super().__init__(params, config, K, ransac_config, stride, solve_pose,
                     seed, device, graph)
    self._B = batch_size
    self._depth = pipeline_depth
    self._smoothers = (None if smoother is None else
                       [smoothing.PoseSmoother(smoother)
                        for _ in range(batch_size)])
    self._zero_mask = torch.zeros(batch_size, dtype=torch.bool,
                                  device=self.device)
    self._ticks = 0
    self._pending: list = []  # [(tick, (host block, event), reset mask)]

  def reset(self):
    """Drop ALL slots' temporal state and smoothers (one slot restarts
    through ``process(..., reset=mask)``). Results in flight are dropped:
    ``flush()`` first to keep them. The captured step is kept."""
    self._carry = None
    self._pending.clear()
    for sm in self._smoothers or ():
      sm.reset()
    for e in self._entries or ():
      e.reset()

  def _mask(self, reset) -> torch.Tensor:
    if reset is None:
      return self._zero_mask
    mask = np.asarray(reset, bool)
    if mask.shape != (self._B,):
      raise ValueError(f"reset mask of shape {mask.shape}, expected "
                       f"({self._B},)")
    return sequence.frames_to_device(mask, self.device)

  def tick(self, images, reset=None) -> torch.Tensor:
    """Enqueue one (B, H, W, 3) tick (uint8 0..255, or float in [0, 1]);
    returns the packed (B, 19) (or (B, 1) without pose solving) float32
    block on the device. Reads nothing back and never waits on the device,
    except on a tick that captures the pose solve's graph or the filter
    step's."""
    with tracing.span("online.tick", id=self._ticks):
      frames = sequence.host_frames(images, self.device)
      if frames.shape[0] != self._B:
        raise ValueError(f"expected batch {self._B}, got {frames.shape[0]}")
      if self._entries is not None:
        return self._tick_split(frames, reset)
      # on a first tick every slot is fresh; the mask means nothing
      frac = (self._first(frames) if self._carry is None
              else self._filter(self, frames, _slot_fracs,
                                self._mask(reset)))
      self._ticks += 1
      parts = [frac]
      if self._solve:
        parts += self._solve_packed(*self._carry[:2])
      return torch.cat(parts, dim=1)

  def _tick_split(self, frames, reset):
    """tick() over the mesh: each entry's filter step on its slots, then
    one pose solve of the maps gathered on the first entry's device."""
    if reset is not None:
      reset = np.asarray(reset, bool)
      if reset.shape != (self._B,):
        raise ValueError(f"reset mask of shape {reset.shape}, expected "
                         f"({self._B},)")
    b = self._B // len(self._entries)
    fracs = Sharded([e.tick(frames[i * b:(i + 1) * b],
                            None if reset is None else reset[i * b:(i + 1) * b])
                     for i, e in enumerate(self._entries)], 0,
                    self._mesh.devices)
    self._carry = tuple(Sharded([e._carry[k] for e in self._entries], 0,
                                self._mesh.devices) for k in range(3))
    self._ticks += 1
    parts = [fracs.full()]
    if self._solve:
      parts += self._solve_packed(self._carry[0].full(), self._carry[1].full())
    return torch.cat(parts, dim=1)

  def _to_host(self, packed):
    """The block's copy to the host, enqueued: (host tensor, the event
    after the copy on ``cuda``, else None)."""
    if self.device.type != "cuda":
      return packed, None
    host = torch.empty(packed.shape, dtype=packed.dtype, pin_memory=True)
    host.copy_(packed, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return host, done

  def process(self, images, reset=None):
    """Feed one (B, H, W, 3) tick; returns (poses (B, 4, 4) or None, info).

    Args:
      reset: optional (B,) bool mask: True slots start a new session at
        this frame. Ignored on the first tick (and after ``reset()``),
        where every slot starts fresh.

    info: tick, and per-slot arrays: consistent_frac (B,), and num_inliers
    / inlier_ratio (B,) when pose solving is on. With ``pipeline_depth=d``
    the results are tick t−d's (``info["tick"]``).
    """
    tick = self._ticks
    mask = (None if reset is None or self._carry is None
            else np.asarray(reset, bool))
    packed = self.tick(images, reset)
    self._pending.append((tick, self._to_host(packed), mask))
    if len(self._pending) <= self._depth:
      return None, {"tick": tick, "pending": True, "lag": self._depth}
    return self._finalize(*self._pending.pop(0))

  def flush(self):
    """Drain the ticks in flight: a list of (poses, info), oldest first."""
    out = [self._finalize(*entry) for entry in self._pending]
    self._pending.clear()
    return out

  def _finalize(self, tick, host, mask):
    block, done = host
    with tracing.span("online.wait", id=tick):
      tracing.count("host.syncs")
      if done is not None:
        done.synchronize()  # the tick's one host sync
    packed = block.numpy().copy()
    info: dict = {"tick": tick}
    # a slot's smoother restarts at the tick whose frame reset it: here,
    # so that pipelined results stay in order
    if mask is not None and self._smoothers is not None:
      for b in np.flatnonzero(mask):
        self._smoothers[b].reset()
    info["consistent_frac"] = packed[:, 0].copy()
    if not self._solve:
      return None, info
    poses = packed[:, 1:17].reshape(self._B, 4, 4)
    info["num_inliers"] = packed[:, 17].copy()
    info["inlier_ratio"] = packed[:, 18].copy()
    if self._smoothers is not None:
      poses = np.stack([self._smoothers[b].update(poses[b])
                        for b in range(self._B)])
    return poses, info


# ---- ESAC -------------------------------------------------------------------


# the most (slot, expert) pairs one grouped expert pass runs: a tick that
# drew more runs them in passes of this many and one of the rest
PASS_PAIRS = 16


def pair_passes(pairs: int):
  """The sizes of the expert passes that run ``pairs`` pairs."""
  return [min(PASS_PAIRS, pairs - i) for i in range(0, pairs, PASS_PAIRS)]


def _captured(fn, inputs, **kw):
  """(the warm-up's result, a replay) of ``fn`` captured now."""
  tracing.count("esac.captures")
  graph = graphs.Graph(fn, inputs, **kw)
  def replay(*inputs):
    tracing.count("esac.replays")
    return graph.replay(*inputs)
  return graph.first, replay


class EsacRelocalizer:
  """ESAC (``models/esac.py``) serving B cameras in lockstep (B = 1: one
  camera). Every frame is relocalised on its own: there is no state
  between ticks.

      reloc = EsacRelocalizer(params, config, K, batch_size=4)  # on cuda
      poses, info = reloc.process(frames)                # (B, H, W, 3)

  A tick (``tick``) enqueues:

    1. the gating net on the B frames (span ``esac.gate``, with CUDA
       events): (B, M) probabilities;
    2. each slot's ``num_hypotheses`` experts, drawn from its
       probabilities with the surface's generator, and the hypotheses per
       (slot, expert) (span ``esac.route``, which also holds the tick's
       one read-back of that (B, M) count, one ``host.syncs``);
    3. exactly the drawn (slot, expert) pairs, as one grouped pass over
       weights gathered on the device from the stacked experts (span
       ``esac.experts``, with CUDA events; ``esac.expert_runs`` counts the
       pairs, ``esac.experts_drawn`` the distinct experts of the tick),
       each map written to its (slot, expert) row of a (B·M, h, w, 3)
       stack; past ``PASS_PAIRS`` pairs, in passes of that many and one
       of the rest (``pair_passes``);
    4. the multi-map pose solve (``pose.ransac``, ``map_of``: hypothesis m
       of slot b reads row b·M + its expert), as ``pose.solve``.

  On ``cuda`` the gating, the draw and the solve are CUDA graphs
  (``utils/graphs.Graph``; the solve a ``pose.ransac.GraphedSolve``, one
  key whatever the pairs), and the expert pass one graph for each number
  of pairs from 1 to ``PASS_PAIRS`` (at most B·M), all captured on the
  first tick, in one memory pool (counted as ``esac.captures`` and
  ``esac.replays``). ``graph=False``, and the CPU, run everything eagerly,
  in the same passes. The surface's generator gives, tick after
  tick, the draw's (B, ``num_hypotheses``) uniforms and the solve's keys,
  in the same order graphed or eager.

  ``process`` waits for the tick's (B, 18) block [T_wc (16), num_inliers,
  inlier_ratio] (``online.wait``, one more ``host.syncs``)."""

  def __init__(self, params, config: esac.EsacConfig, K, batch_size: int = 1,
               ransac_config: ransac.RansacConfig | None = None,
               stride: int = esac.OUTPUT_STRIDE, seed: int = 0, device=None,
               graph: bool | None = None):
    self.device = kfnet_tpu_torch.resolve_device(device)
    self._graph = graphs.use_graph(self.device, graph)
    self._config = config
    self._B, self._M = batch_size, config.num_experts
    on = lambda t: t.to(self.device)
    self._gating = L.tree_map(on, params["gating"])
    self._experts = esac.served_experts(L.tree_map(on, params["experts"]),
                                        config)
    self._K = torch.as_tensor(np.asarray(K, np.float32), device=self.device)
    self._rcfg = ransac_config or ransac.RansacConfig(solver="p3p")
    self._stride = stride
    self._gen = torch.Generator(device=self.device).manual_seed(seed)
    self._ticks = 0
    self._maps = self._valid = None    # the (B·M, h, w, ...) stacks
    # with graphs, a later tick's "gate", "route" and pass of each size (a
    # part of no entry runs eagerly; no bound method kept: no cycle)
    self._parts = {}
    self._solver = ransac.GraphedSolve() if self._graph else None
    self.last = None  # the last tick's (probs, map_of, pairs) on the device

  # the tick's four parts, each a function of tensors (a graph's body)

  def _gate_fn(self, frames):
    image = esac.preprocess(self._config, frames)
    return image, esac.gate(self._gating, self._config, image)

  def _route_fn(self, probs):
    u = torch.rand((self._B, self._rcfg.num_hypotheses), generator=self._gen,
                   device=self.device)
    e = esac.draw_experts(probs, u)
    map_of = e + self._M * torch.arange(self._B, device=self.device)[:, None]
    return map_of, esac.expert_counts(e, self._M)

  def _experts_fn(self, image, pairs):
    maps = esac.experts_at(self._experts, self._config, image,
                           torch.div(pairs, self._M, rounding_mode="floor"),
                           pairs % self._M)
    self._maps.index_copy_(0, pairs, maps)

  def _first_tick(self, frames):
    """Allocate the stacks; returns the first tick's parts. With graphs,
    captures the later ticks': this one takes gating and draw warm-ups."""
    h, w = esac.map_shape(tuple(frames.shape[1:]))
    n = self._B * self._M
    self._maps = torch.zeros((n, h, w, 3), device=self.device)
    self._valid = torch.ones((n, h, w), dtype=torch.bool, device=self.device)
    if not self._graph:
      return self._parts
    gated, self._parts["gate"] = _captured(self._gate_fn, (frames,))
    routed, self._parts["route"] = _captured(self._route_fn, (gated[1],),
                                             generator=self._gen)
    pool = torch.cuda.graph_pool_handle()
    for size in range(1, min(PASS_PAIRS, n) + 1):
      pairs = torch.arange(size, device=self.device)
      _, self._parts[size] = _captured(self._experts_fn, (gated[0], pairs),
                                       pool=pool)
    return {"gate": lambda _: gated, "route": lambda _: routed}

  @property
  def maps(self) -> torch.Tensor:
    """The (B·M, h, w, 3) stack of expert maps: row b·M + e is expert e's
    map of slot b's frame, where the last tick ran that pair (the graph's
    buffer on ``cuda``: clone what is kept)."""
    return self._maps

  def _gated(self, frames, parts):
    """The gating of a tick's frames: (luma (B, 1, H, W), probs (B, M))."""
    with tracing.span("esac.gate", device=self.device):
      return parts.get("gate", self._gate_fn)(frames)

  def _run_pairs(self, image, pairs: np.ndarray, parts):
    """The grouped expert passes of the (P,) flat pairs b·M + e (sorted);
    returns the pairs on the device."""
    with tracing.span("esac.experts", device=self.device):
      index = sequence.frames_to_device(pairs.astype(np.int64), self.device)
      at = 0
      for size in pair_passes(len(pairs)):
        part = index[at:at + size]
        at += size
        parts.get(size, self._experts_fn)(image, part)
      return index

  def tick(self, images) -> torch.Tensor:
    """Enqueue one (B, H, W, 3) tick (uint8 0..255, or float in [0, 1]);
    returns the packed (B, 18) float32 block on the device. Waits once on
    the device, for the drawn pairs (and on the first tick for each
    capture)."""
    with tracing.span("online.tick", id=self._ticks):
      frames = sequence.frames_to_device(images, self.device)
      if frames.shape[0] != self._B:
        raise ValueError(f"expected batch {self._B}, got {frames.shape[0]}")
      parts = (self._first_tick(frames) if self._maps is None
               else self._parts)
      image, probs = self._gated(frames, parts)
      with tracing.span("esac.route"):
        map_of, counts = parts.get("route", self._route_fn)(probs)
        tracing.count("host.syncs")
        drawn = counts.cpu().numpy() > 0  # the tick's read-back
      pairs = np.flatnonzero(drawn)
      tracing.count("esac.expert_runs", len(pairs))
      tracing.count("esac.experts_drawn", int(drawn.any(0).sum()))
      index = self._run_pairs(image, pairs, parts)
      self.last = (probs, map_of, index)
      self._ticks += 1
      out = ransac.solve_pnp_from_maps(
          self._maps, None, self._valid, self._K, self._gen,
          stride=self._stride, config=self._rcfg, graphed=self._solver,
          map_of=map_of)
      return torch.cat(_packed_parts(out), dim=-1)

  def process(self, images):
    """Feed one (B, H, W, 3) tick; returns (poses (B, 4, 4), info): tick,
    num_inliers and inlier_ratio (B,), and pairs, the (slot, expert) pairs
    the tick ran."""
    tick = self._ticks
    packed = self.tick(images)
    with tracing.span("online.wait", id=tick):
      tracing.count("host.syncs")
      packed = packed.cpu().numpy()  # the tick's answer
    info = {"tick": tick, "num_inliers": packed[:, 16].copy(),
            "inlier_ratio": packed[:, 17].copy(),
            "pairs": len(self.last[2])}
    return packed[:, :16].reshape(self._B, 4, 4), info
