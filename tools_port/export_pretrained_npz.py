"""Export shipped weights (orbax, under ``artifacts/``) to the ``.npz`` +
``meta.json`` stages that ``kfnet_tpu_torch.pretrained`` reads:

    JAX_PLATFORMS=cpu python tools_port/export_pretrained_npz.py
    JAX_PLATFORMS=cpu python tools_port/export_pretrained_npz.py \
        --src artifacts/pretrained_full --dst /exports \
        --stages stage3_sceneA --compressed

The first writes the synthetic set (the defaults): the ``.npz`` path's
fixture. The port reads the full-size stages from ``artifacts/``
itself; the second form writes one as ``.npz`` (bf16 leaves as their
uint16 bits, deflated: about 42 MB) where that is wanted.

Runs on the CPU with JAX. Each stage is read with
``kfnet_tpu.utils.checkpoint.load_params_values`` and ``load_meta`` and
written with ``kfnet_tpu_torch.utils.checkpoint.save_params`` in the JAX
package's layouts (NHWC / HWIO) and saved dtypes, so that
``kfnet_tpu_torch.convert.params_from_jax`` stays the one place where a
layout changes. This script lives outside both packages: it is the one
place that imports both.
"""

from __future__ import annotations

import argparse
import os
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

SRC = os.path.join(ROOT, "artifacts", "pretrained_synthetic")
DST = os.path.join(ROOT, "kfnet_tpu_torch", "assets", "pretrained_synthetic")
STAGES = ("stage3_sceneA", "stage1_sceneA", "stage2_indoor")


def export(src: str = SRC, dst: str = DST, stages=STAGES,
           compressed: bool = False) -> list[str]:
  """Write every stage of ``src`` to ``dst``; returns the written dirs."""
  import jax
  import numpy as np

  from kfnet_tpu.utils import checkpoint as jax_ckpt
  from kfnet_tpu_torch.utils import checkpoint as npz_ckpt

  written = []
  for stage in stages:
    params = jax_ckpt.load_params_values(os.path.join(src, stage))
    params = jax.tree_util.tree_map(np.asarray, params)
    meta = jax_ckpt.load_meta(os.path.join(src, stage))
    out = os.path.join(dst, stage)
    npz_ckpt.save_params(out, params, meta, compressed=compressed)
    written.append(out)
  return written


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--src", default=SRC)
  p.add_argument("--dst", default=DST)
  p.add_argument("--stages", default=",".join(STAGES),
                 help="comma-separated stage directories under --src")
  p.add_argument("--compressed", action="store_true",
                 help="deflate the arrays (np.savez_compressed)")
  args = p.parse_args(argv)
  import jax
  jax.config.update("jax_platforms", "cpu")
  stages = [s for s in args.stages.split(",") if s]
  for out in export(args.src, args.dst, stages, args.compressed):
    print(out)


if __name__ == "__main__":
  main()
