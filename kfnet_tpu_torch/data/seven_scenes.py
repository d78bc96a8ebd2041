"""7-Scenes (and 12-Scenes) dataset loaders (port of
``kfnet_tpu/data/seven_scenes.py``).

Disk layout (the public MSR 7-Scenes release):

    <root>/<scene>/TrainSplit.txt            lines like "sequence1"
    <root>/<scene>/TestSplit.txt
    <root>/<scene>/seq-XX/frame-XXXXXX.color.png   (640x480 RGB)
    <root>/<scene>/seq-XX/frame-XXXXXX.depth.png   (16-bit mm; 65535=invalid)
    <root>/<scene>/seq-XX/frame-XXXXXX.pose.txt    (4x4 camera-to-world)

12-Scenes ships the same frame triplets under <root>/<building>/<room>/
<seq>/data/, with JPEG colour.

Files decode on the host through the port's PNG and JPEG codecs
(``image_io``, no PIL); everything returns numpy (the batches go to the
device in ``pipeline.py``).
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Iterator, Sequence

import numpy as np

from kfnet_tpu_torch.core import geometry as geo
from kfnet_tpu_torch.data import image_io, native_io

SEVEN_SCENES = ("chess", "fire", "heads", "office", "pumpkin",
                "redkitchen", "stairs")

DEPTH_INVALID = 65535


@dataclasses.dataclass(frozen=True)
class Frame:
  color_path: str
  depth_path: str | None
  pose_path: str
  seq: str
  index: int


@dataclasses.dataclass
class SceneSplit:
  scene: str
  frames: list[Frame]
  intrinsics: np.ndarray  # (3, 3)


def _read_split_file(path: str) -> list[str]:
  seqs = []
  with open(path) as f:
    for line in f:
      m = re.search(r"(\d+)", line)
      if m:
        seqs.append(f"seq-{int(m.group(1)):02d}")
  return seqs


def _frames_in_seq(seq_dir: str, seq: str) -> list[Frame]:
  frames = []
  idx = 0
  while True:
    base = os.path.join(seq_dir, f"frame-{idx:06d}")
    color = base + ".color.png"
    if not os.path.exists(color):
      color = base + ".color.jpg"  # 12-Scenes ships JPEG colour
      if not os.path.exists(color):
        break
    depth = base + ".depth.png"
    frames.append(Frame(
        color_path=color,
        depth_path=depth if os.path.exists(depth) else None,
        pose_path=base + ".pose.txt",
        seq=seq, index=idx))
    idx += 1
  return frames


def load_split(root: str, scene: str, split: str = "train",
               intrinsics: Sequence[float] = geo.SEVEN_SCENES_K
               ) -> SceneSplit:
  """Enumerate the frames of a scene split (no pixel data loaded yet)."""
  scene_dir = os.path.join(root, scene)
  split_file = os.path.join(
      scene_dir, "TrainSplit.txt" if split == "train" else "TestSplit.txt")
  seqs = _read_split_file(split_file)
  frames: list[Frame] = []
  for seq in seqs:
    seq_dir = os.path.join(scene_dir, seq)
    seq_frames = _frames_in_seq(seq_dir, seq)
    if not seq_frames:
      # 12-Scenes nests the frame triplets one level down (<seq>/data/);
      # looked at only when the top level holds none, so that a stray
      # data/ directory cannot shadow real frames
      nested = os.path.join(seq_dir, "data")
      if os.path.isdir(nested):
        seq_frames = _frames_in_seq(nested, seq)
    if not seq_frames:
      # a listed sequence without frames is a mount laid out wrongly, not
      # an empty dataset
      raise FileNotFoundError(
          f"{split_file} lists {seq!r} but no frame-XXXXXX.color.png/.jpg "
          f"found under {os.path.join(scene_dir, seq)} (or its data/ "
          f"subdirectory)")
    frames.extend(seq_frames)
  K = geo.make_intrinsics(*intrinsics).numpy()
  return SceneSplit(scene=scene, frames=frames, intrinsics=K)


def read_color(path: str) -> np.ndarray:
  """(H, W, 3) float32 in [0, 1]."""
  return image_io.read_color(path)


def read_depth(path: str, scale_to_m: float = 1e-3) -> np.ndarray:
  """(H, W) float32 meters; invalid (65535 / 0) -> 0."""
  d = native_io.read_depth_raw(path).astype(np.float32)
  return np.where((d >= DEPTH_INVALID) | (d <= 0), 0.0, d * scale_to_m)


def read_pose(path: str) -> np.ndarray:
  """4x4 camera-to-world matrix."""
  return np.loadtxt(path, dtype=np.float32).reshape(4, 4)


def load_frame(frame: Frame) -> dict:
  out = {
      "image": read_color(frame.color_path),
      "pose": read_pose(frame.pose_path),
      "seq": frame.seq,
      "index": frame.index,
  }
  if frame.depth_path:
    out["depth"] = read_depth(frame.depth_path)
  return out


def iter_sequences(split: SceneSplit) -> Iterator[list[Frame]]:
  """Group frames by sequence, in temporal order: the unit the recursive
  filter runs over."""
  by_seq: dict[str, list[Frame]] = {}
  for fr in split.frames:
    by_seq.setdefault(fr.seq, []).append(fr)
  for seq in sorted(by_seq):
    yield sorted(by_seq[seq], key=lambda f: f.index)
