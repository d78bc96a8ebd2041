"""Online (streaming) relocalization: the serving surface (port of
``kfnet_tpu/eval/online.py``): ``OnlineRelocalizer`` for one camera,
``FleetRelocalizer`` for B cameras in lockstep.

    reloc = OnlineRelocalizer(params, config, K)      # on cuda
    for frame in camera:                              # (H, W, 3) uint8
        pose, info = reloc.process(frame)

One frame is one filter step plus one PnP-RANSAC solve, all enqueued on
the device, and ONE device->host copy of 19 packed floats:
[consistent_frac, T_wc (16), num_inliers, inlier_ratio].

On ``cuda`` the filter step and consistent_frac run as one CUDA graph
(``filter.sequence.GraphedStep``, which the sequence runners replay too),
the port's counterpart of the JAX package's jitted ``_step`` (minus the
pose solve, which runs eagerly after it): frame 0 runs ``first_step`` eagerly;
the first filter-step frame runs the step eagerly on a side stream (the
warm-up, which is that frame's result) and then captures it; every later
frame copies itself into the graph's input buffer and replays it. The
graph outlives ``reset()``: the frame after a restart copies the new
carry into the graph's carry buffers and replays. A new frame shape or an
in-place weight update captures again; a capture synchronises the device
once (``torch.cuda.graph``). ``graph=False`` runs every step eagerly, as
on the CPU.

A tick is the span ``online.tick`` (``utils/tracing.py``) of the frame or
tick number, and the host's one wait for a frame or tick ``online.wait``,
which counts one ``host.syncs``.
"""

from __future__ import annotations

import numpy as np
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch.filter import sequence
from kfnet_tpu_torch.filter.sequence import GraphedStep
from kfnet_tpu_torch.models import kfnet
from kfnet_tpu_torch.nn import layers as L
from kfnet_tpu_torch.parallel.mesh import Sharded
from kfnet_tpu_torch.pose import ransac, smoothing
from kfnet_tpu_torch.utils import tracing


def _consistent_frac(aux) -> torch.Tensor:
  return torch.mean(aux["consistent"].to(torch.float32)).reshape(1)


def _slot_fracs(aux) -> torch.Tensor:
  """(B, 1) consistent_frac of each slot; 0 on a slot that reset."""
  frac = aux["consistent"].flatten(1).to(torch.float32).mean(1)
  return torch.where(aux["reset"], torch.zeros_like(frac), frac)[:, None]


def _host_frames(images, device: torch.device) -> torch.Tensor:
  """Frames as a tensor; on the host, in pinned memory when they go to the
  card, so that their copy there is asynchronous (no stream sync)."""
  if isinstance(images, np.ndarray):
    # torch does not wrap read-only arrays (e.g. views of device buffers)
    images = torch.from_numpy(images if images.flags.writeable
                              else images.copy())
  images = torch.as_tensor(images)
  if device.type == "cuda" and images.device.type == "cpu":
    images = images.pin_memory()
  return images


def _packed_parts(out):
  """The pose solve's output as the packed columns [T_wc (16),
  num_inliers, inlier_ratio] over its leading dims."""
  lead = tuple(out["num_inliers"].shape)
  return [out["T_wc"].reshape(lead + (16,)).to(torch.float32),
          out["num_inliers"].reshape(lead + (1,)).to(torch.float32),
          out["inlier_ratio"].reshape(lead + (1,)).to(torch.float32)]


class _Relocalizer:
  """What both serving surfaces hold: the weights, intrinsics and RANSAC
  settings on the device, the (x, P, features) carry and the captured
  filter step."""

  def __init__(self, params, config: kfnet.KFNetConfig, K,
               ransac_config: ransac.RansacConfig | None, stride: int,
               solve_pose: bool, seed: int, device, graph: bool | None):
    self.device = kfnet_tpu_torch.resolve_device(device)
    self._graph = sequence._use_graph(self.device, graph)
    self._params = L.tree_map(lambda p: p.to(self.device), params)
    self._config = config
    self._K = torch.as_tensor(np.asarray(K, np.float32), device=self.device)
    self._rcfg = ransac_config or ransac.RansacConfig()
    self._stride = stride
    self._solve = solve_pose
    self._gen = torch.Generator(device=self.device).manual_seed(seed)
    self._carry = None
    self._step = None  # the captured filter step (cuda, graph on)

  def _replayed(self, frames, fracs, *mask) -> torch.Tensor:
    """The filter step of the carry and ``frames`` as a graph replay (or,
    on the first call after a capture, its warm-up); returns ``fracs`` of
    its aux."""
    step = self._step
    if step is not None and step.fits(self._params, frames, self._carry,
                                      *mask):
      frac = step.replay(frames, self._carry, *mask)
    else:
      self._step = None  # free the old graph's memory first
      step = self._step = GraphedStep(
          self._params, self._config, self._carry,
          frames.to(self.device, non_blocking=True), fracs, *mask)
      frac = step.first
    self._carry = step.carry
    return frac

  def _first(self, frames):
    """The carry of a first frame (or tick): its measurement."""
    image = kfnet.preprocess_images(
        self._config, frames.to(self.device, non_blocking=True))
    self._carry = kfnet.first_step(self._params, self._config, image)

  @property
  def state(self):
    """Current (x, P, features) carry (batched over slots in a fleet;
    device tensors, not copied). With the graph on, these are its buffers,
    which the next tick overwrites: clone them to keep them."""
    return self._carry

  def _solve_packed(self):
    """The pose solve of the carry's maps, as the packed columns."""
    x, P = self._carry[0], self._carry[1]
    return _packed_parts(ransac.solve_pnp_from_maps(
        x, P, torch.ones_like(P, dtype=torch.bool), self._K, self._gen,
        stride=self._stride, config=self._rcfg))


class OnlineRelocalizer(_Relocalizer):
  """Carries (x, P, features) across frames on the device."""

  def __init__(self, params, config: kfnet.KFNetConfig, K,
               ransac_config: ransac.RansacConfig | None = None,
               stride: int = 8, solve_pose: bool = True, seed: int = 0,
               device=None, graph: bool | None = None,
               smoother: smoothing.SmootherConfig | None = None):
    """``graph``: replay the filter step as a CUDA graph (the default on
    ``cuda``; ``False`` runs it eagerly; the CPU has no graphs).
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
    never waits on the device, except on a frame that captures the filter
    step's graph (its first filter-step frame, and the first after a new
    frame shape or a weight update), where the capture synchronises once."""
    with tracing.span("online.tick", id=self._frames):
      frame = _host_frames(image, self.device)
      if self._carry is None:
        self._first(frame)
        frac = torch.zeros((1,), dtype=torch.float32, device=self.device)
      elif self._graph:
        frac = self._replayed(frame, _consistent_frac)
      else:
        image = kfnet.preprocess_images(
            self._config, frame.to(self.device, non_blocking=True))
        x, P, feat = self._carry
        x1, P1, feat1, aux = kfnet.filter_step(self._params, self._config,
                                               x, P, feat, image)
        frac = _consistent_frac(aux)
        self._carry = (x1, P1, feat1)
      self._frames += 1
      parts = [frac]
      if self._solve:
        parts += self._solve_packed()
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
  again. A slot that resets starts a new session at that frame, its
  posterior the frame's measurement (``kfnet.first_step``'s). On the first
  tick every slot starts fresh and the mask is ignored. Streams never
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
  are then gathered on the first entry's device and solved there at once,
  from the one generator, as the one-device fleet solves them: the draws,
  and so the poses, do not depend on the split. ``state`` is (x, P, feat)
  as ``Sharded`` values along the slots; ``tick`` returns the (B, 19)
  block on the first entry's device.
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
    mask = torch.as_tensor(np.asarray(reset, bool))
    if tuple(mask.shape) != (self._B,):
      raise ValueError(f"reset mask of shape {tuple(mask.shape)}, expected "
                       f"({self._B},)")
    if self.device.type == "cuda":
      mask = mask.pin_memory()
    return mask.to(self.device, non_blocking=True)

  def _filter(self, frames, mask) -> torch.Tensor:
    """The filter step of a later tick; returns the (B, 1) fractions."""
    if not self._graph:
      image = kfnet.preprocess_images(
          self._config, frames.to(self.device, non_blocking=True))
      x1, P1, feat1, aux = kfnet.filter_step(self._params, self._config,
                                             *self._carry, image)
      x1, P1 = sequence.restart_slots(mask, x1, P1, aux)
      self._carry = (x1, P1, feat1)
      return _slot_fracs(dict(aux, reset=mask))
    return self._replayed(frames, _slot_fracs, mask)

  def tick(self, images, reset=None) -> torch.Tensor:
    """Enqueue one (B, H, W, 3) tick (uint8 0..255, or float in [0, 1]);
    returns the packed (B, 19) (or (B, 1) without pose solving) float32
    block on the device. Reads nothing back and never waits on the device,
    except on the tick that captures the filter step's graph."""
    with tracing.span("online.tick", id=self._ticks):
      frames = _host_frames(images, self.device)
      if frames.shape[0] != self._B:
        raise ValueError(f"expected batch {self._B}, got {frames.shape[0]}")
      if self._entries is not None:
        return self._tick_split(frames, reset)
      if self._carry is None:  # every slot fresh; the mask means nothing
        self._first(frames)
        frac = torch.zeros((self._B, 1), dtype=torch.float32,
                           device=self.device)
      else:
        frac = self._filter(frames, self._mask(reset))
      self._ticks += 1
      parts = [frac]
      if self._solve:
        parts += self._solve_packed()
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
      x, P = self._carry[0].full(), self._carry[1].full()
      parts += _packed_parts(ransac.solve_pnp_from_maps(
          x, P, torch.ones_like(P, dtype=torch.bool), self._K, self._gen,
          stride=self._stride, config=self._rcfg))
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
