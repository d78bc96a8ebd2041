"""The one generator of the benchmark's traffic. A mix is a data file
``perfbench/traffic/<name>.json`` of parameters:

  mode           "stream" (one camera), "fleet" (B cameras in lockstep),
                 both through the family's ``Server``, or "offline"
                 (recorded sequences through the family's ``sequences``)
  cameras        B, the streams served together
  pool_frames    frames rendered per camera; a camera's track restarts (a
                 reset) at the end of its pool, an offline sequence is the
                 whole pool, filtered again from its frame 0 when it ends
  stagger        ticks between the restarts of consecutive cameras
  scene_seed     the scene (0: the protocol's sceneA)
  frames_per_orbit  camera motion: one orbit of the scene per this many
  intrinsics     fx, fy, cx, cy at the configuration's frame size
  chunk_size     frames a chunk of an offline sequence
  ahead_chunks   offline: chunks launched ahead of the one waited for
                 (``ahead_chunks_traced`` in a run's traced part)
  pipeline_depth the fleet's result lag (0: each tick waited for)
  warmup         frames (ticks) served before the window
  checks         how many of the window's answers the family's check
                 compares: first frames (measurements), steps, poses

Every camera's trajectory is its own, drawn from the run's seed and the
camera's index; the scene, the sizes and the order of the work are the
same for every seed.
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from perfbench.traffic import render

HERE = os.path.dirname(os.path.abspath(__file__))


def load(name: str) -> dict:
  path = os.path.join(HERE, f"{name}.json")
  if not os.path.isfile(path):
    raise FileNotFoundError(f"no traffic mix {name!r} ({path})")
  with open(path) as f:
    return json.load(f)


def intrinsics(mix: dict, device) -> torch.Tensor:
  fx, fy, cx, cy = mix["intrinsics"]
  return torch.tensor([[fx, 0.0, cx], [0.0, fy, cy], [0.0, 0.0, 1.0]],
                      dtype=torch.float32, device=device)


def camera_seed(seed: int, camera: int) -> int:
  return int(np.random.SeedSequence([seed, camera]).generate_state(1)[0])


def resets(mix: dict, ticks: int, start: int = 0) -> np.ndarray:
  """(ticks, B) bool: the slots whose track restarts at each tick from
  ``start`` on (a camera's first frame of its pool)."""
  n, b = mix["pool_frames"], mix["cameras"]
  t = np.arange(start, start + ticks)[:, None] + mix["stagger"] * np.arange(b)
  return t % n == 0


def frames(mix: dict, seed: int, frame_shape, device) -> torch.Tensor:
  """The pool, tick-major: (pool_frames, B, H, W, 3) uint8 in pinned host
  memory (plain host memory off the card), row n holding each camera's
  frame of tick n, rendered on ``device``."""
  n, b = mix["pool_frames"], mix["cameras"]
  h, w = frame_shape[:2]
  scene = render.make_scene(mix["scene_seed"])
  K = intrinsics(mix, device)
  pool = torch.empty((n, b, h, w, 3), dtype=torch.uint8,
                     pin_memory=torch.device(device).type == "cuda")
  step = render.chunk_frames(h, w, len(scene["radii"]))
  for cam in range(b):
    poses = torch.as_tensor(render.orbit(n, camera_seed(seed, cam),
                                         frames_per_orbit=mix[
                                             "frames_per_orbit"]),
                            device=device)
    out = torch.empty((n, h, w, 3), dtype=torch.uint8, device=device)
    for i in range(0, n, step):
      rgb = render.render(scene, poses[i:i + step], K, h, w)
      out[i:i + step] = torch.round(rgb * 255.0).to(torch.uint8)
    # camera cam shows its frame j at tick (j - stagger·cam) mod n
    order = (torch.arange(n, device=device) + mix["stagger"] * cam) % n
    pool[:, cam].copy_(out[order])
    del out
  return pool
