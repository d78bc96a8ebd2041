"""Export a trained stage as a compact release (port of
``kfnet_tpu/tools/export_release.py``): the full-size stages are ~95 MB in
float32 each, so the shipped form is bfloat16, half the bytes; the nets
compute in bf16 anyway, so serving changes by one rounding of the stored
weights at most.

    python -m kfnet_tpu_torch.tools.export_release \\
        --src /ckpts --stage stage3_sceneA \\
        --out /releases/stage3_sceneA

Reads the stage's export (``<src>/<stage>/params.npz`` or the JAX
package's orbax ``params/``, and ``meta.json``: ``utils/checkpoint.py``),
casts each leaf to torch's
bfloat16 (round to nearest even) and writes the release through
``utils/checkpoint.save_params`` in the same (the JAX package's) layouts,
bf16 stored as its bit pattern. The meta is the stage's, plus ``params_dtype`` and
``release_source_stage`` (and a calibrated serving point where given), so
that ``pretrained.load`` reads the release as it reads the shipped
flagship (``artifacts/pretrained_full``), cast back to the config's dtypes. Host only: nothing runs on a
device.
"""

from __future__ import annotations

import argparse
import os

import numpy as np
import torch

from kfnet_tpu_torch.nn import layers as L
from kfnet_tpu_torch.utils import checkpoint as ckpt_lib


def main(argv=None):
  p = argparse.ArgumentParser()
  p.add_argument("--src", required=True, help="directory of stage exports")
  p.add_argument("--stage", required=True, help="e.g. stage3_sceneA")
  p.add_argument("--out", required=True)
  p.add_argument("--dtype", default="bfloat16",
                 choices=("bfloat16", "float32"))
  p.add_argument("--serving_w_scale", type=float, default=None,
                 help="calibrated serving w_scale for these weights when "
                      "it differs from the KFNetConfig default (e.g. 2.0 "
                      "for norm='none' trunks); pretrained.load applies "
                      "it")
  p.add_argument("--serving_chi2_threshold", type=float, default=None,
                 help="calibrated serving chi2 gate, same contract")
  args = p.parse_args(argv)

  src = os.path.join(args.src, args.stage)
  meta = ckpt_lib.load_meta(src)
  if not meta:
    raise FileNotFoundError(f"{src}: no meta.json (not a stage export)")
  params = ckpt_lib.load_params_values(src)  # the saved values, on the host
  dtype = torch.bfloat16 if args.dtype == "bfloat16" else torch.float32
  # torch's cast rounds to nearest even; save_params stores bf16 as bits
  params = L.tree_map(lambda x: torch.from_numpy(
      np.ascontiguousarray(x, np.float32)).to(dtype), params)
  n_bytes = sum(x.numel() * x.element_size() for x in L.tree_leaves(params))
  meta = {**meta, "params_dtype": args.dtype,
          "release_source_stage": args.stage}
  if args.serving_w_scale is not None:
    meta["serving_w_scale"] = args.serving_w_scale
  if args.serving_chi2_threshold is not None:
    meta["serving_chi2_threshold"] = args.serving_chi2_threshold
  ckpt_lib.save_params(os.path.abspath(args.out), params, meta=meta)
  print(f"exported {args.stage} -> {args.out} "
        f"({args.dtype}, {n_bytes/1e6:.1f} MB of params)")


if __name__ == "__main__":
  main()
