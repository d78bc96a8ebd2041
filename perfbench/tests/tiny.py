"""A cell's configuration and traffic cut to a size a CPU test can hold:
the nets at the port's tiny widths in float32, 48x64 frames, short pools.
"""

from __future__ import annotations

import json
import os

import torch

from perfbench import run
from perfbench.traffic import generator

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
# the tests run several to a machine: a few threads each
torch.set_num_threads(2)


def cell(name: str) -> dict:
  bench = run.load_benchmark(ROOT)
  return next(w for w in bench["workloads"] if w["name"] == name)


def config(cell_name: str) -> dict:
  bench = run.load_benchmark(ROOT)
  cfg = run.load_config(bench, cell(cell_name)["config"])
  cfg["frame"] = [48, 64, 3]
  cfg["scoordnet"].update(channels=[8, 8, 16, 16, 16, 16],
                          strides=[1, 2, 1, 2, 1, 2], head_channels=16,
                          compute_dtype="float32")
  cfg["oflownet"].update(encoder_channels=[8, 8, 16],
                         encoder_strides=[2, 2, 2], search_radius=2,
                         unet_channels=[8, 8, 16], compute_dtype="float32")
  return cfg


def mix(cell_name: str) -> dict:
  m = generator.load(cell(cell_name)["traffic"])
  m["intrinsics"] = [585.0 * 64 / 640, 585.0 * 48 / 480, 31.5, 23.5]
  if m["mode"] == "offline":
    m.update(pool_frames=80, chunk_size=8, warmup=20)
    m["checks"] = dict(m["checks"], step=6)
  else:
    m.update(pool_frames=16, stagger=4 if m["mode"] == "fleet" else 0)
  return m


def limits(cell_name: str) -> dict:
  with open(os.path.join(ROOT, "perfbench", "limits",
                         f"{cell_name}.json")) as f:
    return json.load(f)
