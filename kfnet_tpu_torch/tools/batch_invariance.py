"""Where a batch stops giving a lone frame's bits: ``kfnet.first_step`` on
one 640x480 frame and on B copies of it (the default configuration, bf16,
weights from a seed), compared op by op. Every ATen op's output is caught
through a ``TorchDispatchMode`` (of the batch, slot 0's), the two runs'
op sequences are matched by name, and each matched op's outputs compared
(slot 0 of the batch against the frame). It names the first op whose
output differs, by how much, and counts the differing ops by name; then
the same with cuDNN held to deterministic algorithms, and in float32.

    python -m kfnet_tpu_torch.tools.batch_invariance [--batch 4]

Prints one JSON object and writes it to ``chiprun_out/batch_invariance.json``.
On the card unless ``--device cpu``.
"""

from __future__ import annotations

import argparse
import collections
import contextlib
import dataclasses
import difflib
import json
import os

import numpy as np
import torch
from torch.utils._python_dispatch import TorchDispatchMode

import kfnet_tpu_torch
from kfnet_tpu_torch.models import kfnet


def _tensors(out):
  if isinstance(out, torch.Tensor):
    return [out]
  if isinstance(out, (list, tuple)):
    return [t for o in out for t in _tensors(o)]
  return []


class _Ops(TorchDispatchMode):
  """Each op's name and float outputs, in call order; of a batch of
  ``batch`` frames, slot 0 of each output whose leading dim is the batch."""

  def __init__(self, batch: int = 1):
    super().__init__()
    self.batch = batch
    self.ops: list = []

  def __torch_dispatch__(self, func, types, args=(), kwargs=None):
    out = func(*args, **(kwargs or {}))
    self.ops.append((func._schema.name, [
        self._slot0(t.detach()) for t in _tensors(out)
        if t.is_floating_point()]))
    return out

  def _slot0(self, t):
    if self.batch > 1 and t.dim() and t.shape[0] == self.batch:
      return t[0].clone()
    return t.clone()


def _deviation(got, want):
  """(max |difference|, max |value| of ``want``) over the outputs of two
  ops, or None where their outputs do not line up."""
  if len(got) != len(want):
    return None
  worst = (0.0, 0.0)
  for g, w in zip(got, want):
    if g.numel() != w.numel():
      return None
    if w.numel():
      d = (g.reshape(-1).float() - w.reshape(-1).float()).abs().max().item()
      worst = max(worst, (d, w.float().abs().max().item()))
  return worst


def compare(params, config, frame: torch.Tensor, batch: int) -> dict:
  """first_step on ``frame`` and on ``batch`` copies of it, op by op: the
  two runs' op sequences are matched by name (a batch may run some ops
  once a frame), and each matched pair's outputs compared."""
  image = kfnet.preprocess_images(config, frame)
  images = image.expand((batch,) + tuple(image.shape)).contiguous()
  with torch.no_grad():
    # warm-up: what a first call makes once (and caches) is no op of ours
    kfnet.first_step(params, config, image)
    kfnet.first_step(params, config, images)
    with _Ops() as lone:
      alone = kfnet.first_step(params, config, image)
    with _Ops(batch) as batched:
      out = kfnet.first_step(params, config, images)
  names = [n for n, _ in lone.ops], [n for n, _ in batched.ops]
  pairs = [(a + k, b + k) for a, b, size in difflib.SequenceMatcher(
      None, *names, autojunk=False).get_matching_blocks()
           for k in range(size)]
  compared = [(b, _deviation(batched.ops[b][1], lone.ops[a][1]))
              for a, b in pairs]
  compared = [(b, r) for b, r in compared if r is not None]
  differing = [(b, batched.ops[b][0], r) for b, r in compared if r[0] > 0]
  first = differing[0] if differing else None
  return {
      "ops": len(batched.ops), "ops_lone": len(lone.ops),
      "ops_compared": len(compared),
      "first_differing_op": None if first is None else {
          "index": first[0], "op": first[1], "max_abs_diff": first[2][0],
          "max_abs_value": first[2][1],
          "shape_slot0": [list(t.shape) for t in batched.ops[first[0]][1]],
          "ops_before": collections.Counter(
              n for n, _ in batched.ops[:first[0]]).most_common(8)},
      "differing_ops_by_name": dict(collections.Counter(
          n for _, n, _ in differing)),
      "slots_equal_each_other": all(
          torch.equal(t[0], t[b]) for t in out for b in range(1, batch)),
      "z_max_abs_diff": (out[0][0] - alone[0]).abs().max().item(),
      "z_max_abs": alone[0].abs().max().item(),
      "V_max_rel_diff": ((out[1][0] - alone[1]).abs()
                         / alone[1].abs()).max().item(),
  }


@contextlib.contextmanager
def _cudnn_deterministic():
  saved = (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark)
  torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = (
      True, False)
  try:
    yield
  finally:
    torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark = saved


def run(batch: int = 4, device=None, height: int = 480, width: int = 640,
        config: kfnet.KFNetConfig | None = None, seed: int = 0) -> dict:
  device = kfnet_tpu_torch.resolve_device(device)
  cfg = config or kfnet.KFNetConfig()
  params = kfnet.init(seed, cfg, (height, width, 3), device=device)
  frame = torch.from_numpy(np.random.default_rng(seed).integers(
      0, 256, (height, width, 3), dtype=np.uint8)).to(device)
  cfg32 = dataclasses.replace(
      cfg, scoordnet=dataclasses.replace(cfg.scoordnet,
                                         compute_dtype="float32"),
      oflownet=dataclasses.replace(cfg.oflownet, compute_dtype="float32"))
  out = {"device": str(device), "batch": batch, "frame": [height, width],
         "gpu": (torch.cuda.get_device_name(device)
                 if device.type == "cuda" else None),
         "bf16": compare(params, cfg, frame, batch)}
  with _cudnn_deterministic():
    out["bf16_cudnn_deterministic"] = compare(params, cfg, frame, batch)
  out["float32"] = compare(params, cfg32, frame, batch)
  return out


def main(argv=None):
  p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
  p.add_argument("--batch", type=int, default=4)
  p.add_argument("--device", default=None)
  p.add_argument("--out", default=os.path.join("chiprun_out",
                                               "batch_invariance.json"))
  args = p.parse_args(argv)
  res = run(args.batch, args.device)
  os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
  with open(args.out, "w") as f:
    json.dump(res, f, indent=1)
  print(json.dumps(res))


if __name__ == "__main__":
  main()
