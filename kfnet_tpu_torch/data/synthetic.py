"""Procedural synthetic scenes (port of ``kfnet_tpu/data/synthetic.py``):
a field of textured spheres before a back wall, raycast from any camera
pose into pixel-exact (RGB, depth, pose) frames, so that the whole path
from frames to poses runs without dataset files.

The scene and the trajectory come from numpy's seeded generator, as in the
JAX package, and are the same arrays. The raycast runs on the device in
torch, a chunk of frames at a time.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch.core import geometry as geo

# bytes that the raycast's (frames, H, W, spheres) float32 intermediates
# may take at once; at 640x480 one frame's is ~59 MB, five of which live
RENDER_BYTES = 1 << 30
LIVE_INTERMEDIATES = 5


@dataclasses.dataclass
class SyntheticScene:
  centers: np.ndarray    # (S, 3)
  radii: np.ndarray      # (S,)
  tex_freq: np.ndarray   # (3, 3) texture frequency matrix
  tex_phase: np.ndarray  # (3,)
  wall_z: float = 3.0    # back wall (world plane z = wall_z)


def make_scene(seed: int = 0, num_spheres: int = 48,
               scale: float = 1.0) -> SyntheticScene:
  """``scale`` stretches the world's geometry (an outdoor depth range at
  ~20) with the texture frequencies divided by it, so that the images look
  the same when the trajectory is scaled with it."""
  rng = np.random.default_rng(seed)
  centers = np.stack([
      rng.uniform(-2.0, 2.0, num_spheres),
      rng.uniform(-1.5, 1.5, num_spheres),
      rng.uniform(1.2, 2.8, num_spheres),
  ], -1).astype(np.float32) * scale
  radii = rng.uniform(0.15, 0.45, num_spheres).astype(np.float32) * scale
  tex_freq = rng.uniform(3.0, 9.0, (3, 3)).astype(np.float32) / scale
  tex_phase = rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
  return SyntheticScene(centers, radii, tex_freq, tex_phase,
                        wall_z=3.0 * scale)


def _on(a, device) -> torch.Tensor:
  return torch.as_tensor(np.asarray(a, np.float32), device=device)


def _texture(scene: SyntheticScene, pw: torch.Tensor) -> torch.Tensor:
  """Procedural RGB texture of the world position (locally
  discriminative)."""
  phase = (pw @ _on(scene.tex_freq, pw.device).T
           + _on(scene.tex_phase, pw.device))
  base = 0.5 + 0.35 * torch.sin(phase) + 0.15 * torch.sin(3.1 * phase + 1.7)
  return torch.clamp(base, 0.0, 1.0)


def render(scene: SyntheticScene, T_wc: torch.Tensor, K: torch.Tensor,
           height: int, width: int):
  """Raycast one frame ((4, 4) ``T_wc``) or F frames ((F, 4, 4)) on
  ``T_wc``'s device.

  Returns:
    rgb ([F,] H, W, 3) in [0, 1]; depth ([F,] H, W) camera z-depth (the
    wall where no sphere is hit: always valid).
  """
  dev = T_wc.device
  grid = geo.pixel_grid(height, width, device=dev)
  dx = (grid[..., 0] - K[0, 2]) / K[0, 0]
  dy = (grid[..., 1] - K[1, 2]) / K[1, 1]
  dirs_c = torch.stack([dx, dy, torch.ones_like(dx)], -1)  # (H, W, 3)
  R = T_wc[..., :3, :3]
  o = T_wc[..., :3, 3]
  lead = tuple(o.shape[:-1])
  # world-frame ray directions, unnormalised, so t is the camera z-depth
  dirs_w = torch.einsum("hwk,...jk->...hwj", dirs_c, R)
  centers = _on(scene.centers, dev)
  pix = (slice(None),) * len(lead) + (None, None)  # a frame's, per pixel

  # spheres: |o + t d - c|² = r² for each sphere
  oc = o[..., None, :] - centers                               # (.., S, 3)
  d2 = torch.sum(dirs_w * dirs_w, -1)[..., None]               # (.., H, W, 1)
  b = torch.einsum("...hwk,...sk->...hws", dirs_w, oc)         # (.., H, W, S)
  c = torch.sum(oc * oc, -1) - _on(scene.radii, dev) ** 2      # (.., S)
  disc = b * b - d2 * c[pix]
  t_hit = (-b - torch.sqrt(torch.clamp_min(disc, 0.0))) / d2
  del b
  inf = torch.full((), float("inf"), device=dev)
  t_hit = torch.where((disc > 0) & (t_hit > 1e-3), t_hit, inf)
  del disc
  t_sphere = torch.amin(t_hit, dim=-1)
  del t_hit

  # the back wall: the world plane z = wall_z
  denom = dirs_w[..., 2]
  t_wall = (scene.wall_z - o[..., 2])[pix] / torch.where(
      torch.abs(denom) < 1e-6, torch.full_like(denom, 1e-6), denom)
  t_wall = torch.where(t_wall > 1e-3, t_wall, inf)

  t = torch.minimum(t_sphere, t_wall)
  t = torch.where(torch.isfinite(t), t, torch.full_like(t, 10.0))
  pw = o[pix] + t[..., None] * dirs_w
  return _texture(scene, pw), t


def orbit_trajectory(num_frames: int, seed: int = 1, radius: float = 1.2,
                     scale: float = 1.0, duration: float = 1.0) -> np.ndarray:
  """A smooth (T, 4, 4) float32 ``T_wc`` trajectory: a slow orbit before
  the scene, looking at its centre, with small smooth jitter (numpy, as in
  the JAX package). ``scale`` must be make_scene's. ``duration`` stretches
  time at constant motion a frame: 480 frames over 10 move as 48 over 1."""
  rng = np.random.default_rng(seed)
  ts = np.linspace(0, duration, num_frames)
  look_at = np.array([0.0, 0.0, 2.0], np.float32) * scale
  jitter = rng.normal(size=(3, 3)).astype(np.float32) * 0.05 * scale
  poses = []
  for s in ts:
    ang = 0.6 * np.sin(2 * np.pi * s)
    pos = np.array([radius * np.sin(ang),
                    0.3 * np.sin(4 * np.pi * s),
                    -1.0 + 0.2 * np.cos(2 * np.pi * s)], np.float32) * scale
    pos = pos + (jitter @ np.array([np.sin(7 * s), np.cos(11 * s),
                                    np.sin(13 * s)], np.float32))
    fwd = look_at - pos
    fwd = fwd / np.linalg.norm(fwd)
    up = np.array([0.0, -1.0, 0.0], np.float32)
    right = np.cross(up, fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    # camera axes: x = right, y = down (image v), z = forward
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.stack([right, down, fwd], -1).astype(np.float32)
    T[:3, 3] = pos
    poses.append(T)
  return np.stack(poses)


def render_chunk(height: int, width: int, num_spheres: int = 48) -> int:
  """Frames a render call takes at once: as many as keep the raycast's
  (frames, H, W, spheres) intermediates within ``RENDER_BYTES``."""
  per_frame = LIVE_INTERMEDIATES * height * width * num_spheres * 4
  return max(1, RENDER_BYTES // per_frame)


def make_sequence(num_frames: int, height: int = 48, width: int = 64,
                  seed: int = 0, fov_scale: float = 1.0, scale: float = 1.0,
                  traj_seed: int | None = None, duration: float = 1.0,
                  K=None, device=None):
  """Render a sequence on ``device`` (``cuda`` unless given): dict(images
  (T, H, W, 3), depths (T, H, W), poses (T, 4, 4), K (3, 3)), float32
  tensors. ``K`` defaults to the 7-Scenes intrinsics scaled to the frame
  size; the trajectory's seed to ``seed + 1``."""
  device = kfnet_tpu_torch.resolve_device(device)
  scene = make_scene(seed, scale=scale)
  if K is None:
    sx, sy = width / 640.0, height / 480.0
    K = [[585.0 * sx * fov_scale, 0.0, width / 2.0 - 0.5],
         [0.0, 585.0 * sy * fov_scale, height / 2.0 - 0.5],
         [0.0, 0.0, 1.0]]
  K = _on(K, device)
  poses = _on(orbit_trajectory(
      num_frames, seed=(seed + 1 if traj_seed is None else traj_seed),
      scale=scale, duration=duration), device)
  chunk = render_chunk(height, width, len(scene.radii))
  rgbs, depths = [], []
  for i in range(0, num_frames, chunk):
    rgb, depth = render(scene, poses[i:i + chunk], K, height, width)
    rgbs.append(rgb)
    depths.append(depth)
  return {"images": torch.cat(rgbs), "depths": torch.cat(depths),
          "poses": poses, "K": K}
