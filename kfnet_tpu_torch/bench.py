"""Headline benchmark of the port: full-size KFNet recursive filtering
throughput (frames per second on one GPU) at the reference's working
resolution (640x480 frames, 60x80 filtered coordinate maps), the
counterpart of the repository's root ``bench.py``.

    python -m kfnet_tpu_torch.bench                # on the card
    python -m kfnet_tpu_torch.bench --device cpu   # tiny config, 48x64

Prints ONE JSON line with the root bench's keys that apply (``metric``,
``value``, ``unit``, ``vs_baseline``, ``frames``, ``gflops_per_frame``,
``mfu``, ``flop_source``, ``peak_tflops_assumed``, ``baseline_note``) and
the frames per second of three configurations over the same weights and
frames: the fused update kernel (``fps_kernels``, the headline), the
PyTorch composition of the update (``fps_composition``, the root bench's
``fps_xla``) and the conv-kernel configuration (``fps_conv_kernels``:
SCoordNet ``pallas_fused``, OFlowNet ``pallas_3x3``), each by
``eval.benchmark.filter_fps``; the serving fleet's rows of four streams
(``fleet_tick_ms_b4``, ``fleet_pipelined_tick_ms_b4``,
``fleet_pipelined_host_uint8_tick_ms_b4``, ``eval.benchmark.fleet_ticks``)
in the headline configuration; plus the card's name and power limit from
``nvidia-smi``. MFU is the analytic FLOP count over the card's own dense
bf16 peak (``eval.flops.peak_flops``), null for a card it does not know.

vs_baseline keeps the root bench's assumption: the TF1 reference's
throughput was not measurable, so an estimated 15 fps for its recursive
filter on a 2019-class GPU stands in; the assumption-free figures are the
absolute fps and the MFU.

Without a CUDA device, and without ``--device cpu``, it raises.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import subprocess

import numpy as np
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch import configs
from kfnet_tpu_torch.eval import flops as flops_lib
from kfnet_tpu_torch.eval.benchmark import filter_fps, fleet_ticks
from kfnet_tpu_torch.models import kfnet

ASSUMED_TF1_FPS = 15.0
FRAMES = 32
H, W = 480, 640
TINY = (48, 64)


def tiny_config() -> kfnet.KFNetConfig:
  """The CPU run's config: the widths of the test suite's tiny config."""
  return kfnet.KFNetConfig(scoordnet=configs.tiny_scoordnet(),
                           oflownet=configs.tiny_oflownet())


def conv_kernel_config(cfg: kfnet.KFNetConfig) -> kfnet.KFNetConfig:
  """``cfg`` with SCoordNet's fused conv chain and OFlowNet's 3x3 kernel."""
  return dataclasses.replace(
      cfg,
      scoordnet=dataclasses.replace(cfg.scoordnet, conv_impl="pallas_fused"),
      oflownet=dataclasses.replace(cfg.oflownet, conv_impl="pallas_3x3"))


def gpu_name_and_power_limit() -> tuple[str, str]:
  """(name, power limit) as ``nvidia-smi --query-gpu=name,power.limit``
  gives them for the first card; raises when it fails."""
  out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                        "--format=csv,noheader"], capture_output=True,
                       text=True, timeout=20, check=True).stdout
  name, limit = out.strip().splitlines()[0].rsplit(",", 1)
  return name.strip(), limit.strip()


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--device", default=None,
                 help="cuda (the default; raises without one) or cpu (the "
                      "tiny config at 48x64)")
  args = p.parse_args(argv)
  device = kfnet_tpu_torch.resolve_device(args.device)
  on_card = device.type == "cuda"
  cfg = kfnet.KFNetConfig() if on_card else tiny_config()
  h, w = (H, W) if on_card else TINY
  params = kfnet.init(0, cfg, (h, w, 3), device=device)
  rng = np.random.default_rng(0)
  images = torch.from_numpy(
      rng.uniform(0, 1, (FRAMES, h, w, 3)).astype(np.float32)).to(device)

  fps = filter_fps(cfg, params, images)
  fps_composition = filter_fps(
      dataclasses.replace(cfg, use_fused_kernel=False), params, images)
  fps_conv = filter_fps(conv_kernel_config(cfg), params, images)
  K = np.asarray([[585.0 * w / W, 0.0, w / 2.0 - 0.5],
                  [0.0, 585.0 * h / H, h / 2.0 - 0.5],
                  [0.0, 0.0, 1.0]], np.float32)
  fleet = fleet_ticks(cfg, params, K, images[0], device=device)

  flops_per_frame = flops_lib.filter_step_flops(cfg, h, w)
  peak = flops_lib.peak_flops(device)
  gpu, power_limit = gpu_name_and_power_limit() if on_card else (None, None)
  # the tiny CPU run must not pass for the 640x480 headline, nor claim a
  # ratio against the full-size TF1 anchor
  metric = ("kfnet_filtered_frames_per_sec_640x480" if on_card else
            "kfnet_filtered_frames_per_sec_48x64_tiny_cpu")
  print(json.dumps({
      "metric": metric,
      "value": fps,
      "unit": "frames/sec/gpu" if on_card else "frames/sec",
      "vs_baseline": fps / ASSUMED_TF1_FPS if on_card else None,
      "device": str(device),
      "frames": FRAMES,
      "fps_kernels": fps,
      "fps_composition": fps_composition,
      "fps_conv_kernels": fps_conv,
      "kernel_speedup": fps / fps_composition,
      **fleet,
      "gflops_per_frame": flops_per_frame / 1e9,
      "mfu": flops_per_frame * fps / peak if peak else None,
      "flop_source": "analytic_conv_count",
      "peak_tflops_assumed": peak / 1e12 if peak else None,
      "gpu": gpu,
      "power_limit": power_limit,
      "baseline_note": "assumed TF1 reference 15 fps (not measurable; "
                       "north-star target vs_baseline >= 10)",
  }))


if __name__ == "__main__":
  main()
