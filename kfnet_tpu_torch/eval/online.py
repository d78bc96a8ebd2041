"""Online (streaming) relocalization: the serving surface (port of
``kfnet_tpu/eval/online.py``'s ``OnlineRelocalizer``).

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
"""

from __future__ import annotations

import numpy as np
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch.filter.sequence import GraphedStep
from kfnet_tpu_torch.models import kfnet
from kfnet_tpu_torch.nn import layers as L
from kfnet_tpu_torch.pose import ransac


def _consistent_frac(aux) -> torch.Tensor:
  return torch.mean(aux["consistent"].to(torch.float32)).reshape(1)


class OnlineRelocalizer:
  """Carries (x, P, features) across frames on the device."""

  def __init__(self, params, config: kfnet.KFNetConfig, K,
               ransac_config: ransac.RansacConfig | None = None,
               stride: int = 8, solve_pose: bool = True, seed: int = 0,
               device=None, graph: bool | None = None):
    """``graph``: replay the filter step as a CUDA graph (the default on
    ``cuda``; ``False`` runs it eagerly; the CPU has no graphs)."""
    self.device = kfnet_tpu_torch.resolve_device(device)
    self._graph = self.device.type == "cuda" if graph is None else graph
    if self._graph and self.device.type != "cuda":
      raise ValueError(f"graph=True needs a CUDA device, got {self.device}")
    self._params = L.tree_map(lambda p: p.to(self.device), params)
    self._config = config
    self._K = torch.as_tensor(np.asarray(K, np.float32), device=self.device)
    self._rcfg = ransac_config or ransac.RansacConfig()
    self._stride = stride
    self._solve = solve_pose
    self._carry = None
    self._step = None  # the captured filter step (cuda, graph on)
    self._gen = torch.Generator(device=self.device).manual_seed(seed)
    self._frames = 0

  def reset(self):
    """Drop the temporal state (scene change / tracking restart). The
    captured step is kept: the next filter-step frame replays it from the
    new carry."""
    self._carry = None

  def _host(self, image) -> torch.Tensor:
    """The frame as a tensor; on the host, in pinned memory when it goes to
    the card, so that its copy there is asynchronous (no stream sync)."""
    if isinstance(image, np.ndarray):
      # torch does not wrap read-only arrays (e.g. views of device buffers)
      image = torch.from_numpy(image if image.flags.writeable
                               else image.copy())
    image = torch.as_tensor(image)
    if self.device.type == "cuda" and image.device.type == "cpu":
      image = image.pin_memory()
    return image

  def _solve_packed(self, x, P):
    out = ransac.solve_pnp_from_maps(
        x, P, torch.ones_like(P, dtype=torch.bool), self._K, self._gen,
        stride=self._stride, config=self._rcfg)
    return [out["T_wc"].reshape(16).to(torch.float32),
            out["num_inliers"].reshape(1).to(torch.float32),
            out["inlier_ratio"].reshape(1).to(torch.float32)]

  def _graphed_step(self, frame) -> torch.Tensor:
    """consistent_frac of this frame's filter step, replayed (or, on the
    first frame after a capture, from the warm-up)."""
    step = self._step
    if step is not None and step.fits(self._params, frame, self._carry):
      frac = step.replay(frame, self._carry)
    else:
      self._step = None  # free the old graph's memory first
      step = self._step = GraphedStep(
          self._params, self._config, self._carry,
          frame.to(self.device, non_blocking=True), _consistent_frac)
      frac = step.first
    self._carry = step.carry
    return frac

  def tick(self, image) -> torch.Tensor:
    """Enqueue one frame's work; returns the packed (19,) (or (1,) without
    pose solving) float32 result on the device. Reads nothing back and
    never waits on the device, except on a frame that captures the filter
    step's graph (its first filter-step frame, and the first after a new
    frame shape or a weight update), where the capture synchronises once."""
    frame = self._host(image)
    if self._carry is None:
      image = kfnet.preprocess_images(
          self._config, frame.to(self.device, non_blocking=True))
      self._carry = kfnet.first_step(self._params, self._config, image)
      frac = torch.zeros((1,), dtype=torch.float32, device=self.device)
    elif self._graph:
      frac = self._graphed_step(frame)
    else:
      image = kfnet.preprocess_images(
          self._config, frame.to(self.device, non_blocking=True))
      x, P, feat = self._carry
      x1, P1, feat1, aux = kfnet.filter_step(self._params, self._config, x,
                                             P, feat, image)
      frac = _consistent_frac(aux)
      self._carry = (x1, P1, feat1)
    self._frames += 1
    parts = [frac]
    if self._solve:
      parts += self._solve_packed(self._carry[0], self._carry[1])
    return torch.cat(parts)

  def process(self, image):
    """Feed one (H, W, 3) frame (uint8 0..255, or float in [0, 1]);
    returns (T_wc 4x4 numpy or None, info dict).

    info: frame, consistent_frac (filter health; ~0 after a cut), and
    num_inliers / inlier_ratio when pose solving is on."""
    info: dict = {"frame": self._frames}
    packed = self.tick(image).cpu().numpy()  # the frame's one host sync
    info["consistent_frac"] = float(packed[0])
    if not self._solve:
      return None, info
    info["num_inliers"] = float(packed[17])
    info["inlier_ratio"] = float(packed[18])
    return packed[1:17].reshape(4, 4), info

  @property
  def state(self):
    """Current (x, P, features) carry (device tensors; not copied). With
    the graph on, these are its buffers, which the next tick overwrites:
    clone them to keep them."""
    return self._carry
