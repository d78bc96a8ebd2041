"""A frozen copy of the program's procedural scene (``data/synthetic.py``):
textured spheres before a back wall, raycast on the device, and a smooth
orbit of camera poses. Kept here so that the traffic cannot change when
the program's renderer does.
"""

from __future__ import annotations

import numpy as np
import torch

# the raycast's (frames, H, W, spheres) float32 intermediates that may
# live at once
RENDER_BYTES = 1 << 30
LIVE_INTERMEDIATES = 5


def make_scene(seed: int, num_spheres: int = 48):
  rng = np.random.default_rng(seed)
  centers = np.stack([rng.uniform(-2.0, 2.0, num_spheres),
                      rng.uniform(-1.5, 1.5, num_spheres),
                      rng.uniform(1.2, 2.8, num_spheres)],
                     -1).astype(np.float32)
  radii = rng.uniform(0.15, 0.45, num_spheres).astype(np.float32)
  tex_freq = rng.uniform(3.0, 9.0, (3, 3)).astype(np.float32)
  tex_phase = rng.uniform(0, 2 * np.pi, 3).astype(np.float32)
  return {"centers": centers, "radii": radii, "tex_freq": tex_freq,
          "tex_phase": tex_phase, "wall_z": 3.0}


def orbit(num_frames: int, seed: int, radius: float = 1.2,
          frames_per_orbit: int = 48) -> np.ndarray:
  """(T, 4, 4) float32 camera-to-world poses: an orbit before the scene
  looking at its centre, one orbit per ``frames_per_orbit`` frames, with a
  small smooth jitter from ``seed``."""
  rng = np.random.default_rng(seed)
  ts = np.arange(num_frames) / frames_per_orbit
  look_at = np.array([0.0, 0.0, 2.0], np.float32)
  jitter = rng.normal(size=(3, 3)).astype(np.float32) * 0.05
  poses = []
  for s in ts:
    ang = 0.6 * np.sin(2 * np.pi * s)
    pos = np.array([radius * np.sin(ang), 0.3 * np.sin(4 * np.pi * s),
                    -1.0 + 0.2 * np.cos(2 * np.pi * s)], np.float32)
    pos = pos + jitter @ np.array([np.sin(7 * s), np.cos(11 * s),
                                   np.sin(13 * s)], np.float32)
    fwd = look_at - pos
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(np.array([0.0, -1.0, 0.0], np.float32), fwd)
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    T = np.eye(4, dtype=np.float32)
    T[:3, :3] = np.stack([right, down, fwd], -1)
    T[:3, 3] = pos
    poses.append(T)
  return np.stack(poses)


def render(scene, T_wc: torch.Tensor, K: torch.Tensor, height: int,
           width: int) -> torch.Tensor:
  """(F, H, W, 3) float32 RGB in [0, 1] of F (F, 4, 4) poses."""
  dev = T_wc.device
  on = lambda a: torch.as_tensor(a, dtype=torch.float32, device=dev)
  v, u = torch.meshgrid(torch.arange(height, device=dev, dtype=torch.float32),
                        torch.arange(width, device=dev, dtype=torch.float32),
                        indexing="ij")
  dirs_c = torch.stack([(u - K[0, 2]) / K[0, 0], (v - K[1, 2]) / K[1, 1],
                        torch.ones_like(u)], -1)
  R, o = T_wc[:, :3, :3], T_wc[:, :3, 3]
  dirs = torch.einsum("hwk,fjk->fhwj", dirs_c, R)
  oc = o[:, None, :] - on(scene["centers"])                   # (F, S, 3)
  d2 = torch.sum(dirs * dirs, -1)[..., None]
  b = torch.einsum("fhwk,fsk->fhws", dirs, oc)
  c = torch.sum(oc * oc, -1) - on(scene["radii"]) ** 2
  disc = b * b - d2 * c[:, None, None, :]
  t_hit = (-b - torch.sqrt(torch.clamp_min(disc, 0.0))) / d2
  del b
  inf = torch.full((), float("inf"), device=dev)
  t_hit = torch.where((disc > 0) & (t_hit > 1e-3), t_hit, inf)
  del disc
  t_sphere = torch.amin(t_hit, -1)
  del t_hit
  dz = dirs[..., 2]
  t_wall = (scene["wall_z"] - o[:, 2])[:, None, None] / torch.where(
      torch.abs(dz) < 1e-6, torch.full_like(dz, 1e-6), dz)
  t_wall = torch.where(t_wall > 1e-3, t_wall, inf)
  t = torch.minimum(t_sphere, t_wall)
  t = torch.where(torch.isfinite(t), t, torch.full_like(t, 10.0))
  pw = o[:, None, None, :] + t[..., None] * dirs
  phase = pw @ on(scene["tex_freq"]).T + on(scene["tex_phase"])
  rgb = 0.5 + 0.35 * torch.sin(phase) + 0.15 * torch.sin(3.1 * phase + 1.7)
  return torch.clamp(rgb, 0.0, 1.0)


def chunk_frames(height: int, width: int, num_spheres: int) -> int:
  return max(1, RENDER_BYTES // (LIVE_INTERMEDIATES * height * width
                                 * num_spheres * 4))
