"""The root entry points (the port's counterpart of the root
``__graft_entry__.py``).

``entry()`` gives one flagship filter step at 480x640: OFlowNet flow, the
warp, SCoordNet's measurement and the Kalman update, from frame 0's
posterior. On ``cuda`` the update is the fused CUDA kernel (one launch a
call); on the CPU it is the plain composition, as the JAX package's
``use_pallas`` is on only on the TPU. The step keeps static shapes and
never waits on the device, so it can be captured as one CUDA graph (the
port's counterpart of ``jax.jit``).

``dryrun_multichip(n)`` runs the three multi-device paths of the JAX
package's dry run on a ``parallel.mesh.Mesh`` of n entries, all on one
device (the device named n times: the counterpart of XLA's forced host
device count), at its tiny float32 config: one data-parallel joint
KFNet train step, the width-sharded filter and the fleet.

    python -c "from kfnet_tpu_torch import graft_entry as g; \\
               g.dryrun_multichip(8, device='cpu')"

Both run on ``cuda`` unless given ``device="cpu"``; with no CUDA and no
device given they raise.
"""

from __future__ import annotations

import numpy as np
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch.filter import sequence
from kfnet_tpu_torch.models import kfnet, oflownet, scoordnet
from kfnet_tpu_torch.parallel import mesh as mesh_lib
from kfnet_tpu_torch.parallel import spatial
from kfnet_tpu_torch.train import objectives, trainer

IMAGE = (480, 640, 3)      # entry()'s frames: the reference working size
DRYRUN_IMAGE = (48, 64, 3)  # the dry run's frames


class Step:
  """``step(params, img_prev, img_cur) -> (x1, P1, flow)``: ``first_step``
  on the previous frame, then one ``filter_step`` to the current one, under
  ``torch.no_grad()``, on (H, W, 3) NHWC frames; ``config`` is the
  ``KFNetConfig`` it runs."""

  def __init__(self, config: kfnet.KFNetConfig):
    self.config = config

  def __call__(self, params, img_prev, img_cur):
    cfg = self.config
    with torch.no_grad():
      x0, P0, feat0 = kfnet.first_step(params, cfg, img_prev)
      x1, P1, _, aux = kfnet.filter_step(params, cfg, x0, P0, feat0,
                                         img_cur)
    return x1, P1, aux["flow"]


def entry(device=None):
  """(fn, example_args): the flagship filter step and its arguments
  (seed-0 params, two frames drawn from ``default_rng(0)`` in the JAX
  package's order, so they equal its example args bit for bit)."""
  device = kfnet_tpu_torch.resolve_device(device)
  cfg = kfnet.KFNetConfig(use_fused_kernel=device.type == "cuda")
  params = kfnet.init(0, cfg, IMAGE, device)
  rng = np.random.default_rng(0)
  img_prev, img_cur = (
      torch.from_numpy(rng.uniform(0, 1, IMAGE).astype(np.float32)).to(device)
      for _ in range(2))
  return Step(cfg), (params, img_prev, img_cur)


def dryrun_config() -> kfnet.KFNetConfig:
  """The JAX package's dry-run config: tiny float32 nets, the composition
  (the joint objective needs the warped prior)."""
  return kfnet.KFNetConfig(
      scoordnet=scoordnet.SCoordNetConfig(
          channels=(8, 8, 16, 16, 16, 16), strides=(1, 2, 1, 2, 1, 2),
          head_channels=16, compute_dtype="float32"),
      oflownet=oflownet.OFlowNetConfig(
          encoder_channels=(8, 8, 16), encoder_strides=(2, 2, 2),
          search_radius=2, unet_channels=(8, 8, 16),
          compute_dtype="float32"),
      use_fused_kernel=False)


def dryrun_mesh(n_devices: int, device=None) -> mesh_lib.Mesh:
  """``device`` (``cuda`` unless given) named ``n_devices`` times. Raises
  ``ValueError`` for fewer than 1 entry and ``RuntimeError`` for a CUDA
  device that is not visible."""
  if n_devices < 1:
    raise ValueError(f"dryrun_multichip needs n_devices >= 1, not "
                     f"{n_devices}")
  device = kfnet_tpu_torch.resolve_device(device)
  if device.type == "cuda":
    visible = torch.cuda.device_count()
    index = 0 if device.index is None else device.index
    if index >= visible:
      raise RuntimeError(f"{device} is not visible: {visible} CUDA "
                         "device(s)")
    device = torch.device("cuda", index)
  return mesh_lib.Mesh([device] * n_devices)


def dryrun_parts(mesh: mesh_lib.Mesh, train_params, spatial_params,
                 fleet_params):
  """The dry run's three parts over ``mesh``, each on its own params tree
  (none changed), on data drawn from ``default_rng(0)`` in the JAX
  package's order. Returns (loss, steps, xs, Ps, fxs, fPs): the joint
  step's loss and step count, the width-sharded filter's maps on
  (2, 48, 16 n, 3) frames and the fleet's on (2, n, 48, 64, 3) frames,
  each a ``Sharded``."""
  cfg, n, img = dryrun_config(), mesh.size, DRYRUN_IMAGE
  rng = np.random.default_rng(0)
  B = max(n, 2)
  batch = {
      "image_prev": rng.uniform(0, 1, (B,) + img).astype(np.float32),
      "image": rng.uniform(0, 1, (B,) + img).astype(np.float32),
      "coords": rng.normal(size=(B, 6, 8, 3)).astype(np.float32),
      "valid": np.ones((B, 6, 8), bool),
  }
  # one data-parallel joint step: a params replica per entry (copies, so
  # the caller's tree is not trained), the batch split over the entries
  loss_fn = objectives.kfnet_objective(cfg)
  optimizer = trainer.make_optimizer(trainer.OptimizerConfig())
  replicas = mesh_lib.replicate_tree(mesh, train_params)
  state = trainer.create_state(replicas[0], optimizer)
  step_fn = trainer.make_dp_train_step(loss_fn, optimizer, mesh, replicas)
  sharded = mesh_lib.shard_batch(mesh, batch)
  state, metrics = step_fn(state, [mesh_lib.entry_batch(sharded, i)
                                   for i in range(n)])
  loss = float(metrics["loss"])

  # the filter with the image WIDTH sharded over the mesh: 1/8-res width
  # 2n, so 2 columns a shard
  wimg = (img[0], 16 * n, 3)
  seq = rng.uniform(0, 1, (2,) + wimg).astype(np.float32)
  xs, Ps = spatial.run_filter_spatial(spatial_params, cfg, seq, mesh)

  # the fleet: n independent streams split over the entries
  fleet = rng.uniform(0, 1, (2, n) + img).astype(np.float32)
  fxs, fPs = sequence.run_filter_fleet(fleet_params, cfg, fleet, mesh)
  return loss, state.step, xs, Ps, fxs, fPs


def dryrun_multichip(n_devices: int, device=None) -> None:
  """One sharded training step, the width-sharded filter and the fleet
  over an ``n_devices``-entry mesh of ``device`` (tiny shapes, three
  fresh seeds as in the JAX package); raises on a failed check."""
  mesh = dryrun_mesh(n_devices, device)
  dev, cfg = mesh.devices[0], dryrun_config()
  wimg = (DRYRUN_IMAGE[0], 16 * n_devices, 3)
  loss, steps, xs, Ps, fxs, fPs = dryrun_parts(
      mesh, kfnet.init(0, cfg, DRYRUN_IMAGE, dev),
      kfnet.init(1, cfg, wimg, dev), kfnet.init(2, cfg, DRYRUN_IMAGE, dev))
  if not np.isfinite(loss):
    raise AssertionError(f"non-finite loss {loss}")
  if steps != 1:
    raise AssertionError(f"{steps} train steps, expected 1")
  for name, (x, P) in (("spatial", (xs, Ps)), ("fleet", (fxs, fPs))):
    if len(x.shards) != n_devices:
      raise AssertionError(f"{name}: {len(x.shards)} shards for "
                           f"{n_devices} entries")
    if not torch.isfinite(x.full()).all():
      raise AssertionError(f"{name}: non-finite coordinates")
    if not (P.full() > 0).all():
      raise AssertionError(f"{name}: a covariance <= 0")
