"""Dataset dispatch (port of ``kfnet_tpu/data/registry.py``): one interface
over 7-Scenes, 12-Scenes and Cambridge, so that the train scripts take
``--dataset`` and work unchanged.

Each adapter gives SceneSplit objects and frame dicts with the keys
image, pose and, where there is depth, depth.
"""

from __future__ import annotations

from typing import Callable


class DatasetAdapter:
  def __init__(self, name: str, load_split: Callable,
               load_frame: Callable, iter_sequences: Callable):
    self.name = name
    self.load_split = load_split
    self.load_frame = load_frame
    self.iter_sequences = iter_sequences

  def load_frame_with_split(self, split_obj, frame):
    return self.load_frame(frame)


def _seven():
  from kfnet_tpu_torch.data import seven_scenes as s7
  return DatasetAdapter("7scenes", s7.load_split, s7.load_frame,
                        s7.iter_sequences)


def _twelve():
  from kfnet_tpu_torch.data import twelve_scenes as s12
  return DatasetAdapter("12scenes", s12.load_split, s12.load_frame,
                        s12.iter_sequences)


class _CambridgeAdapter(DatasetAdapter):
  """Cambridge's poses come from the split's dataset file, so a frame
  loads with its split (``load_frame_with_split``)."""

  def __init__(self):
    from kfnet_tpu_torch.data import seven_scenes as s7
    super().__init__("cambridge", self._load_split, self._load_frame,
                     s7.iter_sequences)

  @staticmethod
  def _load_split(root, scene, split="train", intrinsics=None):
    from kfnet_tpu_torch.data import cambridge as cb
    if intrinsics is not None:
      raise ValueError(
          "the cambridge loader derives its working-resolution "
          "intrinsics from the full-res camera (data/cambridge.py); an "
          "override would silently disagree with the resized images — "
          "callers must not pass intrinsics for this dataset")
    sp, poses = cb.load_split(root, scene, split)
    sp._cambridge_poses = poses  # kept for load_frame_with_split
    return sp

  @staticmethod
  def _load_frame(frame):
    raise RuntimeError(
        "cambridge frames need the split context; use "
        "adapter.load_frame_with_split(split, frame)")

  def load_frame_with_split(self, split_obj, frame):
    from kfnet_tpu_torch.data import cambridge as cb
    return cb.load_frame(frame, split_obj._cambridge_poses)


_REGISTRY = {"7scenes": _seven, "12scenes": _twelve,
             "cambridge": _CambridgeAdapter}


def get(name: str) -> DatasetAdapter:
  return _REGISTRY[name]()


def default_scenes(name: str) -> list[str]:
  """The dataset's canonical scene list: the default of a ``--scenes`` flag
  left unset."""
  if name == "7scenes":
    from kfnet_tpu_torch.data.seven_scenes import SEVEN_SCENES
    return list(SEVEN_SCENES)
  if name == "12scenes":
    from kfnet_tpu_torch.data.twelve_scenes import TWELVE_SCENES
    return list(TWELVE_SCENES)
  if name == "cambridge":
    from kfnet_tpu_torch.data.cambridge import CAMBRIDGE_SCENES
    return list(CAMBRIDGE_SCENES)
  raise KeyError(name)
