"""12-Scenes dataset (port of ``kfnet_tpu/data/twelve_scenes.py``).

Layout: <root>/<building>/<room>/<seq>/data/frame-XXXXXX.{color.jpg,
depth.png,pose.txt} with TrainSplit.txt / TestSplit.txt beside the
sequences (the 7-Scenes frame triplets, JPEG colour, mm depth). The
loader is ``seven_scenes``'s with 12-Scenes intrinsics (fx = fy = 572,
640x480); scenes are named "building/room" (e.g. "apt1/kitchen").
Colour decodes through the port's JPEG decoder (``image_io.read_color``,
the C++ route).
"""

from __future__ import annotations

from kfnet_tpu_torch.data import seven_scenes as s7

TWELVE_SCENES = (
    "apt1/kitchen", "apt1/living", "apt2/bed", "apt2/kitchen",
    "apt2/living", "apt2/luke", "office1/gates362", "office1/gates381",
    "office1/lounge", "office1/manolis", "office2/5a", "office2/5b",
)

TWELVE_SCENES_K = (572.0, 572.0, 320.0, 240.0)


def load_split(root: str, scene: str, split: str = "train",
               intrinsics=TWELVE_SCENES_K):
  return s7.load_split(root, scene, split, intrinsics=intrinsics)


load_frame = s7.load_frame
iter_sequences = s7.iter_sequences
