"""The device mesh and sharded values (port of
``kfnet_tpu/parallel/mesh.py``).

The JAX package is single-controller: one process lays its devices out on
one logical axis, ``data``, shards batches over it and replicates the
params, and GSPMD inserts the collectives. The port keeps that model. A
``Mesh`` is an ordered list of ``torch.device``s and an axis name, in one
process; one Python thread drives every entry. A mesh may name a device
more than once (four entries on ``cuda:0``, say), the counterpart of
XLA's forced host device count: every split, halo and reduction then runs
through the same code as on distinct GPUs, on one card.

``batch_sharding`` and ``replicated`` (JAX ``NamedSharding``s) have no
meaning without GSPMD and are not ported: a ``Sharded`` value names its
split axis and the device of each shard itself, ``replicate_tree`` gives
one copy per entry, and ``replica_tree`` joins per-entry copies into one
tree of ``Replicated`` leaves.
"""

from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Mesh:
  """An ordered list of devices on one named axis. Entries may repeat a
  device."""
  devices: tuple
  axis_name: str = "data"

  def __init__(self, devices: Sequence, axis_name: str = "data"):
    devs = tuple(torch.device(d) for d in devices)
    if not devs:
      raise ValueError("a mesh needs at least one device")
    object.__setattr__(self, "devices", devs)
    object.__setattr__(self, "axis_name", axis_name)

  @property
  def size(self) -> int:
    return len(self.devices)

  def check_axis(self, axis_name: str) -> None:
    """Raise unless ``axis_name`` names this mesh's axis (as a JAX
    PartitionSpec on an unknown axis does)."""
    if axis_name != self.axis_name:
      raise ValueError(f"axis {axis_name!r} is not the mesh's axis "
                       f"{self.axis_name!r}")


def _visible(device) -> list:
  device = torch.device(device)
  if device.type == "cuda":
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
  return [device]


def make_mesh(num_devices: int | None = None, axis_name: str = "data",
              device="cuda") -> Mesh:
  """A mesh over the first ``num_devices`` visible devices of ``device``'s
  type (all of them when None). Raises for 0, a negative count or more
  than are visible; never shrinks a mesh silently."""
  devices = _visible(device)
  n = len(devices) if num_devices is None else num_devices
  if not 1 <= n <= len(devices):
    raise ValueError(
        f"make_mesh(num_devices={num_devices}): need 1..{len(devices)} "
        f"(visible devices: {len(devices)})")
  return Mesh(devices[:n], axis_name)


def default_mesh(batch_size: int, device="cuda") -> Mesh | None:
  """A data mesh over as many visible GPUs as divide the batch; None where
  only one device would take part: the CPU, a device given with its index
  (``cuda:0``), or one visible GPU."""
  device = torch.device(device)
  if device.type != "cuda" or device.index is not None:
    return None
  n = torch.cuda.device_count()
  while n > 1 and batch_size % n:
    n -= 1
  return make_mesh(n) if n > 1 else None


def even_bounds(size: int, n: int) -> list:
  """The n + 1 offsets that split ``size`` into n contiguous parts, equal
  where n divides it (a map's shards are a function of its width alone, so
  two maps of one width are split alike)."""
  return [size * i // n for i in range(n + 1)]


class Sharded:
  """A value split along ``axis`` into one shard per mesh entry, shard i
  on ``devices[i]``. The axis is kept counted from the end, so that a map
  of the shards that drops leading axes (a frame of a sequence) keeps it."""

  def __init__(self, shards: Sequence[torch.Tensor], axis: int, devices):
    self.shards = list(shards)
    self.devices = [torch.device(d) for d in devices]
    ndim = self.shards[0].dim()
    self.axis = axis % ndim - ndim
    if len(self.shards) != len(self.devices):
      raise ValueError(f"{len(self.shards)} shards for "
                       f"{len(self.devices)} devices")

  @property
  def shape(self) -> tuple:
    """The whole value's shape."""
    s = list(self.shards[0].shape)
    s[self.axis] = sum(t.shape[self.axis] for t in self.shards)
    return tuple(s)

  @property
  def bounds(self) -> list:
    """Offsets of the shards along the axis."""
    out = [0]
    for t in self.shards:
      out.append(out[-1] + t.shape[self.axis])
    return out

  def map(self, fn, axis: int | None = None) -> "Sharded":
    """``fn`` of each shard (a tensor), split along ``axis`` (this one's,
    from the end, by default)."""
    return Sharded([fn(t) for t in self.shards],
                   self.axis if axis is None else axis, self.devices)

  def full(self, device=None) -> torch.Tensor:
    """The whole value, gathered onto ``device`` (the first entry's by
    default)."""
    device = self.devices[0] if device is None else torch.device(device)
    return torch.cat([t.to(device) for t in self.shards], dim=self.axis)

  def take(self, i: int, lo: int, hi: int) -> torch.Tensor:
    """Indices [lo, hi) along the axis onto shard i's device, from
    whichever shards hold them, zeros outside [0, size): a halo from as
    many neighbours as it spans."""
    dev, size = self.devices[i], self.shape[self.axis]
    bounds, parts = self.bounds, []
    ref = self.shards[i]

    def zeros(n):
      shape = list(ref.shape)
      shape[self.axis] = n
      return torch.zeros(shape, dtype=ref.dtype, device=dev)

    if lo < 0:
      parts.append(zeros(min(hi, 0) - lo))
    for j, t in enumerate(self.shards):
      a, b = max(lo, bounds[j]), min(hi, bounds[j + 1])
      if a < b:
        parts.append(t.narrow(self.axis, a - bounds[j], b - a).to(dev))
    if hi > size:
      parts.append(zeros(hi - max(lo, size)))
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=self.axis)


def split(mesh: Mesh, x, axis: int = 0) -> Sharded:
  """``x`` (a tensor or a numpy array) split evenly along ``axis``, one
  shard per mesh entry, each on its device (host arrays bound for the card
  go up from pinned memory). Raises unless the mesh size divides it."""
  if isinstance(x, np.ndarray) and not x.flags.writeable:
    x = x.copy()  # torch does not wrap read-only arrays
  x = torch.as_tensor(x)
  n, size = mesh.size, x.shape[axis]
  if size % n:
    raise ValueError(f"axis {axis} of size {size} must be divisible by the "
                     f"mesh size {n}")
  b = even_bounds(size, n)
  shards = []
  for i, dev in enumerate(mesh.devices):
    part = x.narrow(axis, b[i], b[i + 1] - b[i])
    if dev.type == "cuda" and part.device.type == "cpu":
      part = part.contiguous().pin_memory()
    shards.append(part.to(dev, non_blocking=True))
  return Sharded(shards, axis, mesh.devices)


def _tree_map(fn, tree):
  if isinstance(tree, dict):
    return {k: _tree_map(fn, v) for k, v in tree.items()}
  if isinstance(tree, (list, tuple)):
    return [_tree_map(fn, v) for v in tree]
  return fn(tree)


def shard_batch(mesh: Mesh, batch, axis_name: str = "data", axis: int = 0):
  """A batch tree with every array split along ``axis`` (the batch axis)
  over the mesh: a tree of ``Sharded``. Raises "divisible" unless the mesh
  size divides it."""
  mesh.check_axis(axis_name)
  return _tree_map(lambda x: split(mesh, x, axis), batch)


def entry_batch(batch, i: int):
  """Entry i's part of a tree of ``Sharded`` (as ``shard_batch`` gives)."""
  return _tree_map(lambda s: s.shards[i], batch)


class Replicated:
  """A params leaf with one copy per mesh entry, copy i on ``devices[i]``
  (entries on one device share a copy): what a layer applied to a
  ``Sharded`` map takes each shard's weights from (``entry_params``)."""

  def __init__(self, copies: Sequence[torch.Tensor], devices):
    self.copies = list(copies)
    self.devices = [torch.device(d) for d in devices]


def replica_tree(trees: Sequence, devices) -> object:
  """One tree of ``Replicated`` leaves from per-entry trees of one
  structure, ``trees[i]`` on ``devices[i]``."""
  first = trees[0]
  if isinstance(first, dict):
    return {k: replica_tree([t[k] for t in trees], devices) for k in first}
  if isinstance(first, (list, tuple)):
    return [replica_tree([t[j] for t in trees], devices)
            for j in range(len(first))]
  return Replicated(trees, devices)


def entry_params(tree, i: int, device) -> object:
  """Entry i's params: each ``Replicated`` leaf's copy i. Any other tensor
  must already be on ``device``, where entry i computes: a copy a frame
  would move the weights again on every call, so it raises instead."""
  device = torch.device(device)

  def pick(t):
    if isinstance(t, Replicated):
      return t.copies[i]
    if t.device != device:
      raise ValueError(
          f"a weight on {t.device} for a shard on {device}: place the params "
          "once per device (parallel.mesh.replica_tree)")
    return t

  return _tree_map(pick, tree)


def replicate_tree(mesh: Mesh, tree) -> list:
  """One copy of ``tree``'s tensors per mesh entry, each on its device."""
  return [_tree_map(lambda t: torch.as_tensor(t).detach().to(dev, copy=True),
                    tree) for dev in mesh.devices]
