"""Write procedural synthetic scenes to disk in the on-disk layouts of the
supported datasets (port of ``kfnet_tpu/data/fixture.py``), so that the
dataset path (split parsing, PNG decode in both routes, pose files, the
batch loader, the train scripts) runs end to end without a dataset.

7-Scenes (``data/seven_scenes.py``):

    <root>/<scene>/TrainSplit.txt                 "sequence1"
    <root>/<scene>/TestSplit.txt                  "sequence2"
    <root>/<scene>/seq-01/frame-000000.color.png  8-bit RGB
    <root>/<scene>/seq-01/frame-000000.depth.png  16-bit mm (65535 invalid)
    <root>/<scene>/seq-01/frame-000000.pose.txt   4x4 camera-to-world

Cambridge Landmarks (``data/cambridge.py``): dataset_{train,test}.txt with
"seqN/frameNNNNN.png tx ty tz qw qx qy qz" lines (camera centre and
world-to-camera quaternion), and rendered-depth ``<stem>.depth.png``
files for the train frames only (test frames exercise the depth-less
path).

12-Scenes (``data/twelve_scenes.py``): nested <building>/<room> scene
directories, the frame triplets one level down under <seq>/data/, colour
as baseline JPEG (quality 95, 4:4:4, as the JAX package's fixture writes
it with PIL).

Frames are rendered by the port's ``data/synthetic.py`` (on ``device``:
``cuda`` unless given) under each dataset's preset camera, and written by
the port's PNG and JPEG encoders (``image_io``).
"""

from __future__ import annotations

import os

import numpy as np

from kfnet_tpu_torch.core import geometry as geo
from kfnet_tpu_torch.data import image_io, synthetic

SEVEN_SCENES_HW = (480, 640)


def _host(data: dict) -> dict:
  return {k: v.cpu().numpy() for k, v in data.items()}


def _write_frame(color_path: str, rgb: np.ndarray, depth_path=None,
                 depth=None, invalid_corner: bool = False):
  """One frame's files: colour as 8-bit RGB, depth (where given) in mm as
  16-bit grey, its 2x2 corner stamped 65535 (invalid) if asked."""
  image_io.write_png(color_path,
                     np.clip(rgb * 255.0 + 0.5, 0, 255).astype(np.uint8))
  if depth_path:
    mm = np.clip(depth * 1000.0 + 0.5, 0, 65000).astype(np.uint16)
    if invalid_corner:
      mm[:2, :2] = 65535
    image_io.write_png(depth_path, mm)


def write_seven_scenes_fixture(root: str, scenes=("chess",),
                               train_frames: int = 8,
                               test_frames: int = 6,
                               height: int = SEVEN_SCENES_HW[0],
                               width: int = SEVEN_SCENES_HW[1],
                               seed: int = 0, device=None) -> dict:
  """Render and write one or more fixture scenes; returns the ground truth
  arrays per scene (numpy), to hold what the loaders read against.

  seq-01 is the train split, seq-02 the test split. Depth is written in
  millimetres as 16-bit PNG, with a few pixels stamped 65535 (invalid).
  """
  out = {}
  for si, scene in enumerate(scenes):
    scene_seed = seed + 37 * si
    sdir = os.path.join(root, scene)
    os.makedirs(sdir, exist_ok=True)
    with open(os.path.join(sdir, "TrainSplit.txt"), "w") as f:
      f.write("sequence1\n")
    with open(os.path.join(sdir, "TestSplit.txt"), "w") as f:
      f.write("sequence2\n")
    gt = {}
    for seq, n, traj_seed in (("seq-01", train_frames, scene_seed + 1),
                              ("seq-02", test_frames, scene_seed + 99)):
      # the preset camera, scaled to the fixture's frame size
      K = geo.make_intrinsics(*geo.SEVEN_SCENES_K).numpy()
      K = K * np.asarray([[width / 640.0], [height / 480.0], [1.0]],
                         np.float32)
      data = _host(synthetic.make_sequence(
          n, height=height, width=width, seed=scene_seed,
          traj_seed=traj_seed, K=K, device=device))
      seq_dir = os.path.join(sdir, seq)
      os.makedirs(seq_dir, exist_ok=True)
      for t in range(n):
        base = os.path.join(seq_dir, f"frame-{t:06d}")
        _write_frame(base + ".color.png", data["images"][t],
                     base + ".depth.png", data["depths"][t],
                     invalid_corner=True)
        np.savetxt(base + ".pose.txt", data["poses"][t], fmt="%.9f")
      gt[seq] = data
    out[scene] = gt
  return out


def write_twelve_scenes_fixture(root: str, scenes=("apt1/kitchen",),
                                train_frames: int = 8,
                                test_frames: int = 6,
                                height: int = SEVEN_SCENES_HW[0],
                                width: int = SEVEN_SCENES_HW[1],
                                seed: int = 0, device=None) -> dict:
  """12-Scenes layout: nested <building>/<room> scene directories, the
  frame triplets under <seq>/data/, JPEG colour (quality 95, 4:4:4: the
  returned ground-truth images are the frames before compression, so
  compare with a lossy tolerance), 16-bit mm depth PNGs,
  one pose file a frame. Renders under the 12-Scenes preset camera (572,
  572, 320, 240), scaled to the frame size."""
  from kfnet_tpu_torch.data import twelve_scenes as s12

  out = {}
  for si, scene in enumerate(scenes):
    scene_seed = seed + 37 * si
    sdir = os.path.join(root, scene)
    os.makedirs(sdir, exist_ok=True)
    with open(os.path.join(sdir, "TrainSplit.txt"), "w") as f:
      f.write("sequence1\n")
    with open(os.path.join(sdir, "TestSplit.txt"), "w") as f:
      f.write("sequence2\n")
    gt = {}
    for seq, n, traj_seed in (("seq-01", train_frames, scene_seed + 1),
                              ("seq-02", test_frames, scene_seed + 99)):
      K = geo.make_intrinsics(*s12.TWELVE_SCENES_K).numpy()
      K = K * np.asarray([[width / 640.0], [height / 480.0], [1.0]],
                         np.float32)
      data = _host(synthetic.make_sequence(
          n, height=height, width=width, seed=scene_seed,
          traj_seed=traj_seed, K=K, device=device))
      seq_dir = os.path.join(sdir, seq, "data")
      os.makedirs(seq_dir, exist_ok=True)
      for t in range(n):
        base = os.path.join(seq_dir, f"frame-{t:06d}")
        rgb = np.clip(data["images"][t] * 255.0 + 0.5, 0, 255).astype(
            np.uint8)
        image_io.write_jpeg(base + ".color.jpg", rgb)
        mm = np.clip(data["depths"][t] * 1000.0 + 0.5, 0,
                     65000).astype(np.uint16)
        image_io.write_png(base + ".depth.png", mm)
        np.savetxt(base + ".pose.txt", data["poses"][t], fmt="%.9f")
      gt[seq] = data
    out[scene] = gt
  return out


def _matrix_to_quat(R: np.ndarray) -> np.ndarray:
  """3x3 rotation -> (w, x, y, z) unit quaternion (Shepperd's method; the
  inverse of cambridge.quat_to_matrix)."""
  t = float(np.trace(R))
  if t > 0:
    s = np.sqrt(t + 1.0) * 2.0
    q = np.asarray([0.25 * s, (R[2, 1] - R[1, 2]) / s,
                    (R[0, 2] - R[2, 0]) / s, (R[1, 0] - R[0, 1]) / s])
  else:
    i = int(np.argmax(np.diag(R)))
    j, k = (i + 1) % 3, (i + 2) % 3
    s = np.sqrt(max(1.0 + R[i, i] - R[j, j] - R[k, k], 0.0)) * 2.0
    q = np.empty(4)
    q[0] = (R[k, j] - R[j, k]) / s
    q[1 + i] = 0.25 * s
    q[1 + j] = (R[j, i] + R[i, j]) / s
    q[1 + k] = (R[k, i] + R[i, k]) / s
  return (q / np.linalg.norm(q)).astype(np.float64)


def write_cambridge_fixture(root: str, scenes=("KingsCollege",),
                            train_frames: int = 8,
                            test_frames: int = 6,
                            world_scale: float = 12.0,
                            seed: int = 0, device=None) -> dict:
  """Cambridge Landmarks layout: dataset_{train,test}.txt with NVM-style
  pose lines, frames as PNGs under seq1/, depth files for the train
  frames only. Renders an outdoor-scale world (``world_scale``; depths
  stay under the 16-bit mm ceiling) at the loader's 272x480 working size
  under its scaled intrinsics, so that no resize happens on load."""
  from kfnet_tpu_torch.data import cambridge as cb

  height, width = cb.CAMBRIDGE_IMAGE_SIZE
  fx, fy, cx, cy = cb.CAMBRIDGE_K_FULLRES
  sx = width / cb.CAMBRIDGE_FULLRES[1]
  sy = height / cb.CAMBRIDGE_FULLRES[0]
  K = np.asarray([[fx * sx, 0, cx * sx], [0, fy * sy, cy * sy],
                  [0, 0, 1]], np.float32)

  out = {}
  for si, scene in enumerate(scenes):
    scene_seed = seed + 37 * si
    sdir = os.path.join(root, scene)
    os.makedirs(os.path.join(sdir, "seq1"), exist_ok=True)
    gt = {}
    for split, n, traj_seed in (("train", train_frames, scene_seed + 1),
                                ("test", test_frames, scene_seed + 99)):
      data = _host(synthetic.make_sequence(
          n, height=height, width=width, seed=scene_seed,
          traj_seed=traj_seed, K=K, scale=world_scale, device=device))
      poses = data["poses"]
      lines = ["Visual Landmark Dataset V1",
               "ImageFile, Camera Position [X Y Z W P Q R]", ""]
      for t in range(n):
        # train and test share seq1/: test frames continue the numbering
        idx = t + (train_frames if split == "test" else 0)
        rel = f"seq1/frame{idx + 1:05d}.png"
        path = os.path.join(sdir, rel)
        _write_frame(path, data["images"][t],
                     (os.path.splitext(path)[0] + ".depth.png"
                      if split == "train" else None), data["depths"][t])
        center = poses[t][:3, 3]
        q = _matrix_to_quat(poses[t][:3, :3].T)  # world-to-camera
        lines.append(rel + " " + " ".join(
            f"{v:.9f}" for v in (*center, *q)))
      with open(os.path.join(sdir, f"dataset_{split}.txt"), "w") as f:
        f.write("\n".join(lines) + "\n")
      data["K"] = K
      gt[split] = data
    out[scene] = gt
  return out
