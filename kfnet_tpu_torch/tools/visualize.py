"""Visualization of eval dumps: coordinate maps, uncertainty, and error
heatmaps as PNGs (port of ``kfnet_tpu/tools/visualize.py``).

    python -m kfnet_tpu_torch.tools.visualize --dump_dir dump/seq-01 \
        --out_dir viz [--gt_labels labels/seq-01]

The PNGs are written by the port's own encoder (``data/image_io.py``),
each map upsampled ×``scale`` by nearest neighbour in numpy: the pixels of
the JAX tool's PIL output. Host only: it touches no device.
"""

from __future__ import annotations

import argparse
import glob
import os

import numpy as np

from kfnet_tpu_torch.data import image_io


def _colorize(x: np.ndarray, lo=None, hi=None) -> np.ndarray:
  """Scalar map -> uint8 heat map (blue→red), nan-safe."""
  x = np.asarray(x, np.float32)
  lo = np.nanpercentile(x, 2) if lo is None else lo
  hi = np.nanpercentile(x, 98) if hi is None else hi
  t = np.clip((x - lo) / max(hi - lo, 1e-9), 0, 1)
  r = np.clip(1.5 - np.abs(4 * t - 3), 0, 1)
  g = np.clip(1.5 - np.abs(4 * t - 2), 0, 1)
  b = np.clip(1.5 - np.abs(4 * t - 1), 0, 1)
  return (np.stack([r, g, b], -1) * 255).astype(np.uint8)


def coords_to_rgb(coords: np.ndarray) -> np.ndarray:
  """World-coordinate map -> RGB by per-channel min/max normalization."""
  c = np.asarray(coords, np.float32)
  lo = c.reshape(-1, 3).min(0)
  hi = c.reshape(-1, 3).max(0)
  return ((c - lo) / np.maximum(hi - lo, 1e-9) * 255).astype(np.uint8)


def render_frame(npz_path: str, out_dir: str, gt: np.ndarray | None = None,
                 scale: int = 8):
  d = np.load(npz_path)
  stem = os.path.splitext(os.path.basename(npz_path))[0]
  os.makedirs(out_dir, exist_ok=True)

  def save(arr, suffix):  # nearest-neighbour ×scale, as PIL's NEAREST
    image_io.write_png(os.path.join(out_dir, f"{stem}.{suffix}.png"),
                       np.repeat(np.repeat(arr, scale, 0), scale, 1))

  save(coords_to_rgb(d["coords"]), "coords")
  save(_colorize(np.log10(np.maximum(d["covariance"][..., 0], 1e-12))),
       "log_cov")
  if gt is not None:
    err = np.linalg.norm(d["coords"] - gt, axis=-1)
    save(_colorize(err, lo=0.0, hi=0.5), "err")


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--dump_dir", required=True,
                 help="directory of frame-XXXXXX.npz eval dumps")
  p.add_argument("--out_dir", required=True)
  p.add_argument("--gt_labels", default="",
                 help="optional dir of matching label .npz (coords key)")
  args = p.parse_args(argv)
  for path in sorted(glob.glob(os.path.join(args.dump_dir, "*.npz"))):
    gt = None
    if args.gt_labels:
      lp = os.path.join(args.gt_labels, os.path.basename(path))
      if os.path.exists(lp):
        with np.load(lp) as f:
          gt = f["coords"]
    render_frame(path, args.out_dir, gt)
  print("wrote visualizations to", args.out_dir)


if __name__ == "__main__":
  main()
