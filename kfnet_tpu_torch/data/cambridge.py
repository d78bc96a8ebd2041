"""Cambridge Landmarks loader (port of ``kfnet_tpu/data/cambridge.py``).

Disk layout (the public PoseNet release):

    <root>/<scene>/dataset_train.txt   header lines then
                                       "seqN/frameNNNNN.png tx ty tz qw qx qy qz"
    <root>/<scene>/dataset_test.txt
    <root>/<scene>/seqN/frameNNNNN.png

A pose line gives the camera's position (its centre in the world frame)
and a world-to-camera quaternion (the file's header reads "ImageFile,
Camera Position [X Y Z W P Q R]", the NVM export), so T_wc = [R(q)ᵀ | t]
with the position as it stands. Cambridge has no sensor depth: labels come
from rendered depth maps (``<stem>.depth.png``, 16-bit mm) where they are;
a frame without one serves evaluation only. Frames are resized on load to
the working size, bilinear (PIL's, antialiased) for colour and nearest for
depth, by ``image_io``.
"""

from __future__ import annotations

import os

import numpy as np

from kfnet_tpu_torch.data import image_io
from kfnet_tpu_torch.data.seven_scenes import Frame, SceneSplit, read_depth

CAMBRIDGE_SCENES = ("KingsCollege", "OldHospital", "ShopFacade",
                    "StMarysChurch", "GreatCourt", "Street")

# 1920x1080 frames; the SfM focal length is about 1670 px at that size
CAMBRIDGE_K_FULLRES = (1670.0, 1670.0, 960.0, 540.0)
CAMBRIDGE_FULLRES = (1080, 1920)  # (h, w)

# working size (h, w): a quarter of 1920 wide, and 272 rows, not 270, so
# that the 8 px label grid (34 rows) matches the net's SAME-padded output;
# the intrinsics scale per axis (load_split)
CAMBRIDGE_IMAGE_SIZE = (272, 480)


def quat_to_matrix(q: np.ndarray) -> np.ndarray:
  """(w, x, y, z) unit quaternion -> 3x3 rotation."""
  w, x, y, z = q / np.linalg.norm(q)
  return np.asarray([
      [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
      [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
      [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
  ], np.float32)


def parse_dataset_file(path: str):
  """Yield (relative image path, T_wc 4x4) per entry."""
  with open(path) as f:
    lines = f.readlines()
  for line in lines:
    parts = line.strip().split()
    if len(parts) != 8 or not parts[0].lower().endswith((".png", ".jpg")):
      continue  # header / comments
    rel = parts[0]
    vals = np.asarray([float(v) for v in parts[1:]], np.float32)
    # (X Y Z): the camera centre in the world; (W P Q R): world-to-camera
    center, q = vals[:3], vals[3:]
    R_w2c = quat_to_matrix(q)
    T_wc = np.eye(4, dtype=np.float32)
    T_wc[:3, :3] = R_w2c.T
    T_wc[:3, 3] = center
    yield rel, T_wc


def load_split(root: str, scene: str, split: str = "train",
               image_size: tuple[int, int] = CAMBRIDGE_IMAGE_SIZE
               ) -> tuple[SceneSplit, dict]:
  """Returns (SceneSplit, poses dict rel_path -> T_wc).

  ``image_size`` is the working (h, w); the intrinsics scale per axis from
  the 1920x1080 originals.
  """
  scene_dir = os.path.join(root, scene)
  fname = "dataset_train.txt" if split == "train" else "dataset_test.txt"
  frames = []
  poses = {}
  for i, (rel, T_wc) in enumerate(
      parse_dataset_file(os.path.join(scene_dir, fname))):
    img = os.path.join(scene_dir, rel)
    stem = os.path.splitext(img)[0]
    depth = stem + ".depth.png"
    frames.append(Frame(
        color_path=img,
        depth_path=depth if os.path.exists(depth) else None,
        pose_path="",  # poses come from the dataset file
        seq=rel.split("/")[0], index=i))
    poses[img] = T_wc
  fx, fy, cx, cy = CAMBRIDGE_K_FULLRES
  th, tw = image_size
  sx = tw / CAMBRIDGE_FULLRES[1]
  sy = th / CAMBRIDGE_FULLRES[0]
  K = np.asarray([[fx * sx, 0, cx * sx], [0, fy * sy, cy * sy], [0, 0, 1]],
                 np.float32)
  return SceneSplit(scene=scene, frames=frames, intrinsics=K), poses


def load_frame(frame: Frame, poses: dict,
               image_size: tuple[int, int] = CAMBRIDGE_IMAGE_SIZE) -> dict:
  th, tw = image_size
  rgb = image_io.to_rgb(image_io.read_image(frame.color_path))
  if rgb.shape[:2] != (th, tw):
    rgb = image_io.resize_bilinear(rgb, (th, tw))
  out = {
      "image": rgb.astype(np.float32) / 255.0,
      "pose": poses[frame.color_path],
      "seq": frame.seq,
      "index": frame.index,
  }
  if frame.depth_path:
    d = read_depth(frame.depth_path)
    if d.shape != (th, tw):
      d = image_io.resize_nearest(d, (th, tw))
    out["depth"] = d
  return out
