"""Per-dataset and per-scene experiment presets, and the model and solver
presets of the synthetic scenes (port of ``kfnet_tpu/configs/__init__.py``).

``get(dataset, scene)`` gives an ExperimentConfig with the reference's
flag defaults for the train scripts. The small, full and tiny widths of
both nets, ``NET_SCALES`` and ``synthetic_ransac`` serve the synthetic
demo and the smoke runs; the shipped synthetic weights (``pretrained``)
are the small ones.
"""

from __future__ import annotations

import dataclasses

from kfnet_tpu_torch.data.cambridge import CAMBRIDGE_SCENES
from kfnet_tpu_torch.data.seven_scenes import SEVEN_SCENES
from kfnet_tpu_torch.data.twelve_scenes import TWELVE_SCENES
from kfnet_tpu_torch.models import oflownet, scoordnet
from kfnet_tpu_torch.pose import ransac
from kfnet_tpu_torch.train.trainer import OptimizerConfig, TrainLoopConfig
from kfnet_tpu_torch.utils import config as config_lib


def seven_scenes(scene: str = "chess",
                 input_folder: str = "") -> config_lib.ExperimentConfig:
  assert scene in SEVEN_SCENES, scene
  return config_lib.ExperimentConfig(
      dataset=config_lib.SEVEN_SCENES, scene=scene,
      input_folder=input_folder, batch_size=8,
      optimizer=OptimizerConfig(learning_rate=1e-4, decay_steps=100_000),
      loop=TrainLoopConfig(max_steps=300_000))


def twelve_scenes(scene: str = "apt1/kitchen",
                  input_folder: str = "") -> config_lib.ExperimentConfig:
  assert scene in TWELVE_SCENES, scene
  return config_lib.ExperimentConfig(
      dataset=config_lib.TWELVE_SCENES, scene=scene,
      input_folder=input_folder, batch_size=8,
      optimizer=OptimizerConfig(learning_rate=1e-4, decay_steps=80_000),
      loop=TrainLoopConfig(max_steps=200_000))


def cambridge(scene: str = "KingsCollege",
              input_folder: str = "") -> config_lib.ExperimentConfig:
  assert scene in CAMBRIDGE_SCENES, scene
  return config_lib.ExperimentConfig(
      dataset=config_lib.CAMBRIDGE, scene=scene,
      input_folder=input_folder, batch_size=8,
      optimizer=OptimizerConfig(learning_rate=2e-4, decay_steps=100_000),
      loop=TrainLoopConfig(max_steps=300_000))


_FACTORIES = {
    "7scenes": seven_scenes,
    "12scenes": twelve_scenes,
    "cambridge": cambridge,
}


def get(dataset: str, scene: str,
        input_folder: str = "") -> config_lib.ExperimentConfig:
  return _FACTORIES[dataset](scene, input_folder)


def small_scoordnet(mean=(0.0, 0.0, 0.0), std=1.0):
  """Reduced-width float32 SCoordNet for quick synthetic runs."""
  return scoordnet.SCoordNetConfig(
      channels=(16, 16, 32, 32, 64, 64), strides=(1, 2, 1, 2, 1, 2),
      head_channels=64, compute_dtype="float32",
      coord_offset=tuple(float(x) for x in mean), coord_scale=float(std))


def full_scoordnet(mean=(0.0, 0.0, 0.0), std=1.0):
  """The flagship bf16 SCoordNet (the paper's widths)."""
  return dataclasses.replace(
      scoordnet.SCoordNetConfig(),
      coord_offset=tuple(float(x) for x in mean), coord_scale=float(std))


def small_oflownet():
  """Reduced-width float32 OFlowNet for quick synthetic runs."""
  return oflownet.OFlowNetConfig(
      encoder_channels=(16, 16, 32), encoder_strides=(2, 2, 2),
      search_radius=2, unet_channels=(16, 16, 32),
      compute_dtype="float32")


def tiny_scoordnet(mean=(0.0, 0.0, 0.0), std=1.0):
  """Minimal SCoordNet for smoke tests on the CPU."""
  return scoordnet.SCoordNetConfig(
      channels=(8, 8, 16, 16, 16, 16), strides=(1, 2, 1, 2, 1, 2),
      head_channels=16, compute_dtype="float32",
      coord_offset=tuple(float(x) for x in mean), coord_scale=float(std))


def tiny_oflownet():
  """Minimal OFlowNet (see tiny_scoordnet)."""
  return oflownet.OFlowNetConfig(
      encoder_channels=(8, 8, 16), encoder_strides=(2, 2, 2),
      search_radius=2, unet_channels=(8, 8, 16),
      compute_dtype="float32")


def full_oflownet():
  """The flagship OFlowNet (the paper's widths)."""
  return oflownet.OFlowNetConfig()


# name: (SCoordNet factory (mean, std), OFlowNet factory)
NET_SCALES = {
    "full": (full_scoordnet, full_oflownet),
    "small": (small_scoordnet, small_oflownet),
    "tiny": (tiny_scoordnet, tiny_oflownet),
}


def synthetic_ransac(full_size: bool) -> ransac.RansacConfig:
  """The RANSAC preset of the synthetic evaluation: P3P at full size."""
  if full_size:
    return ransac.RansacConfig(num_hypotheses=256, top_k=1024,
                               solver="p3p", inlier_threshold_px=8.0)
  return ransac.RansacConfig(num_hypotheses=256, top_k=512)
