"""Experiment configs and the per-dataset presets (port of
``kfnet_tpu/utils/config.py``).

The reference's flag surface (input_folder, model_folder, scene,
batch_size, lr, steps) as dataclasses with a thin argparse bridge, so the
train scripts' command lines read as the JAX package's. One flag is the
port's own: ``--device`` (``cuda`` unless given), where the JAX package
picks its platform from ``JAX_PLATFORMS``.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import tempfile

from kfnet_tpu_torch.core import geometry as geo
from kfnet_tpu_torch.models import oflownet, scoordnet
from kfnet_tpu_torch.train.trainer import OptimizerConfig, TrainLoopConfig


@dataclasses.dataclass(frozen=True)
class DatasetPreset:
  name: str
  intrinsics: tuple  # (fx, fy, cx, cy) at working resolution
  image_size: tuple  # (H, W)
  depth_scale: float = 1e-3
  min_depth: float = 0.05
  max_depth: float = 20.0
  stride: int = 8


SEVEN_SCENES = DatasetPreset(
    name="7scenes", intrinsics=geo.SEVEN_SCENES_K, image_size=(480, 640))
TWELVE_SCENES = DatasetPreset(
    name="12scenes", intrinsics=(572.0, 572.0, 320.0, 240.0),
    image_size=(480, 640))
# the 1670 px focal length of the 1920x1080 SfM calibration scaled per axis
# to the (272, 480) working size (fy and cy absorb the 270 -> 272
# stretch), with the arithmetic data/cambridge.load_split uses
CAMBRIDGE = DatasetPreset(
    name="cambridge",
    intrinsics=(1670.0 * 480.0 / 1920.0, 1670.0 * 272.0 / 1080.0,
                240.0, 136.0),
    image_size=(272, 480), max_depth=100.0)

PRESETS = {p.name: p for p in (SEVEN_SCENES, TWELVE_SCENES, CAMBRIDGE)}

# outputs go under the temporary directory of the process (TMPDIR) unless
# --model_folder names a place
DEFAULT_MODEL_FOLDER = os.path.join(tempfile.gettempdir(),
                                    "kfnet_tpu_torch_models")


@dataclasses.dataclass(frozen=True)
class ExperimentConfig:
  dataset: DatasetPreset = SEVEN_SCENES
  scene: str = "chess"
  input_folder: str = ""
  model_folder: str = DEFAULT_MODEL_FOLDER
  batch_size: int = 8
  optimizer: OptimizerConfig = OptimizerConfig()
  loop: TrainLoopConfig = TrainLoopConfig()
  scoordnet: scoordnet.SCoordNetConfig = scoordnet.SCoordNetConfig()
  oflownet: oflownet.OFlowNetConfig = oflownet.OFlowNetConfig()
  seed: int = 0
  device: str = "cuda"


def add_common_flags(parser: argparse.ArgumentParser):
  """The reference scripts' flag surface, and ``--device``."""
  parser.add_argument("--input_folder", required=True,
                      help="dataset root")
  parser.add_argument("--model_folder", default=DEFAULT_MODEL_FOLDER,
                      help="checkpoint/output dir")
  parser.add_argument("--dataset", default="7scenes",
                      choices=sorted(PRESETS))
  parser.add_argument("--scene", default="chess")
  parser.add_argument("--batch_size", type=int, default=8)
  parser.add_argument("--learning_rate", type=float, default=1e-4)
  parser.add_argument("--max_steps", type=int, default=300_000)
  parser.add_argument("--decay_steps", type=int, default=100_000)
  parser.add_argument("--decay_rate", type=float, default=0.5)
  parser.add_argument("--seed", type=int, default=0)
  parser.add_argument("--steps_per_dispatch", type=int, default=1,
                      help="optimizer steps per call of the train step "
                           "(K batches stacked)")
  parser.add_argument("--net_scale", default="full",
                      choices=("full", "small", "tiny"),
                      help="model width preset: full = the paper's widths; "
                           "small/tiny = reduced widths for rehearsals and "
                           "smoke runs of the dataset path")
  parser.add_argument("--device", default="cuda",
                      help="torch device the nets train on (cpu for "
                           "tests)")
  return parser


def from_args(args: argparse.Namespace) -> ExperimentConfig:
  kw = {}
  scale = getattr(args, "net_scale", "full")
  if scale != "full":
    from kfnet_tpu_torch import configs as presets
    sc_fn, of_fn = presets.NET_SCALES[scale]
    kw = {"scoordnet": sc_fn(), "oflownet": of_fn()}
  return ExperimentConfig(
      dataset=PRESETS[args.dataset],
      scene=args.scene,
      input_folder=args.input_folder,
      model_folder=args.model_folder,
      batch_size=args.batch_size,
      optimizer=OptimizerConfig(
          learning_rate=args.learning_rate,
          decay_steps=args.decay_steps,
          decay_rate=args.decay_rate),
      loop=TrainLoopConfig(max_steps=args.max_steps,
                           steps_per_dispatch=args.steps_per_dispatch),
      seed=args.seed,
      device=getattr(args, "device", "cuda"),
      **kw,
  )
