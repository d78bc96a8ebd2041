"""How ``correct`` is decided: a family's ``compare`` reads the numbers of
a run's record once the window has closed (``families/<family>.py``), and
``judge`` holds them to the cell's limits in ``limits/<cell>.json``. What
several families' comparisons share is here: relative and log errors,
the seeded choice of the answers compared, and the pose solve's draws and
its agreement test.
"""

from __future__ import annotations

import json
import math
import os

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))


def load_limits(cell: str) -> dict:
  path = os.path.join(HERE, "limits", f"{cell}.json")
  with open(path) as f:
    return json.load(f)


def rel(a, r) -> float:
  return float(torch.linalg.norm(a - r) / torch.clamp_min(
      torch.linalg.norm(r), 1e-30))


def log_rms(a, r) -> float:
  d = torch.log(torch.clamp_min(a, 1e-30)) - torch.log(torch.clamp_min(r,
                                                                       1e-30))
  return float(torch.sqrt(torch.mean(d * d)))


def pick(rng, items, n):
  """``n`` of ``items`` drawn by ``rng``, in their order (all if fewer)."""
  if len(items) <= n:
    return list(items)
  return [items[i] for i in sorted(rng.choice(len(items), n, replace=False))]


def draws(seed: int, shape, n: int, device, wanted):
  """The Exp(1) keys of solves ``wanted`` (indices) of a generator seeded
  with ``seed`` that draws one (shape) block per solve, ``n`` solves."""
  gen = torch.Generator(device=device).manual_seed(seed)
  out = {}
  last = max(wanted) if wanted else -1
  for i in range(min(n, last + 1)):
    q = torch.empty(shape, dtype=torch.float32,
                    device=device).exponential_(generator=gen)
    if i in wanted:
      out[i] = q
  return out


def pose_disagrees(Tp, Tr, n_p, n_r) -> bool:
  """Whether a served pose differs from the reference's: rotation over 0.5
  degrees, camera centre over 0.5% of its distance to the origin (at
  least 1 unit), inliers by more than 2, or not finite."""
  Rp, Rr = Tp[:3, :3], Tr[:3, :3]
  cos = np.clip((np.trace(Rp.T @ Rr) - 1.0) / 2.0, -1.0, 1.0)
  angle = math.degrees(math.acos(cos))
  cp, cr = Tp[:3, 3], Tr[:3, 3]
  dist = np.linalg.norm(cp - cr) / max(1.0, np.linalg.norm(cr))
  ok = (np.isfinite(Tp).all() and angle <= 0.5 and dist <= 5e-3
        and abs(float(n_p) - float(n_r)) <= 2)
  return not ok


def judge(numbers: dict, limits: dict, names) -> tuple[bool, dict]:
  """(correct, {name: {"value", "limit"}}) of every number the limits
  name: the family's ``names`` first, in their order, then the rest. Each
  is read, finite and within its limit; a limited name that the family
  does not define reads None and makes the run not correct."""
  order = [n for n in names if n in limits]
  order += [n for n in limits if n not in names]
  shown, ok = {}, True
  for name in order:
    v = numbers.get(name) if name in names else None
    lim = limits[name]["limit"]
    shown[name] = {"value": v, "limit": lim}
    if v is None or not math.isfinite(v) or v > lim:
      ok = False
  return ok, shown
