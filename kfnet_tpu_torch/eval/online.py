"""Online (streaming) relocalization: the serving surface (port of
``kfnet_tpu/eval/online.py``'s ``OnlineRelocalizer``).

    reloc = OnlineRelocalizer(params, config, K)      # on cuda
    for frame in camera:                              # (H, W, 3) uint8
        pose, info = reloc.process(frame)

One frame is one filter step plus one PnP-RANSAC solve, all enqueued on
the device, and ONE device->host copy of 19 packed floats:
[consistent_frac, T_wc (16), num_inliers, inlier_ratio].
"""

from __future__ import annotations

import numpy as np
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch.models import kfnet
from kfnet_tpu_torch.nn import layers as L
from kfnet_tpu_torch.pose import ransac


class OnlineRelocalizer:
  """Carries (x, P, features) across frames on the device."""

  def __init__(self, params, config: kfnet.KFNetConfig, K,
               ransac_config: ransac.RansacConfig | None = None,
               stride: int = 8, solve_pose: bool = True, seed: int = 0,
               device=None):
    self.device = kfnet_tpu_torch.resolve_device(device)
    self._params = L.tree_map(lambda p: p.to(self.device), params)
    self._config = config
    self._K = torch.as_tensor(np.asarray(K, np.float32), device=self.device)
    self._rcfg = ransac_config or ransac.RansacConfig()
    self._stride = stride
    self._solve = solve_pose
    self._carry = None
    self._gen = torch.Generator(device=self.device).manual_seed(seed)
    self._frames = 0

  def reset(self):
    """Drop the temporal state (scene change / tracking restart)."""
    self._carry = None

  def _upload(self, image) -> torch.Tensor:
    if isinstance(image, np.ndarray):
      # torch does not wrap read-only arrays (e.g. views of device buffers)
      image = torch.from_numpy(image if image.flags.writeable
                               else image.copy())
    image = torch.as_tensor(image)
    if image.device != self.device:
      if self.device.type == "cuda":
        # from pinned memory the copy is asynchronous: no stream sync
        image = image.pin_memory().to(self.device, non_blocking=True)
      else:
        image = image.to(self.device)
    return image

  def _solve_packed(self, x, P):
    out = ransac.solve_pnp_from_maps(
        x, P, torch.ones_like(P, dtype=torch.bool), self._K, self._gen,
        stride=self._stride, config=self._rcfg)
    return [out["T_wc"].reshape(16).to(torch.float32),
            out["num_inliers"].reshape(1).to(torch.float32),
            out["inlier_ratio"].reshape(1).to(torch.float32)]

  def tick(self, image) -> torch.Tensor:
    """Enqueue one frame's work; returns the packed (19,) (or (1,) without
    pose solving) float32 result on the device. Reads nothing back."""
    image = kfnet.preprocess_images(self._config, self._upload(image))
    if self._carry is None:
      self._carry = kfnet.first_step(self._params, self._config, image)
      frac = torch.zeros((1,), dtype=torch.float32, device=self.device)
    else:
      x, P, feat = self._carry
      x1, P1, feat1, aux = kfnet.filter_step(self._params, self._config, x,
                                             P, feat, image)
      frac = torch.mean(aux["consistent"].to(torch.float32)).reshape(1)
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
    """Current (x, P, features) carry (device tensors; not copied)."""
    return self._carry
