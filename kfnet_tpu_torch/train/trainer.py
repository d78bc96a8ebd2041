"""The trainer (port of ``kfnet_tpu/train/trainer.py``): Adam with a
staircase exponential learning-rate decay and a global-norm clip, the
training step, its K-steps-a-call form, checkpoint resume and the loop.

The optimizer is optax's ``chain(clip_by_global_norm(c), adam(schedule))``
term for term, written over the params tree with ``torch._foreach_*``:

  * clip: where the global norm g of the grads is at least c, each grad is
    (g_i / g) · c; below c the grads pass unchanged (``clip_grad_norm_``
    adds 1e-6 to the norm, so it is not this function);
  * Adam (b1, b2, eps 1e-8 outside the square root): mu = (1-b1)·g +
    b1·mu, nu = (1-b2)·g² + b2·nu, u = mu/(1-b1^k) / (sqrt(nu/(1-b2^k)) +
    eps) at the k-th update (k from 1);
  * the update with 0-based index k scales u by -lr0 · rate^floor(k /
    decay_steps) (staircase) or rate^(k / decay_steps).

Params are updated in place. ``fit`` and ``device_fit.fit_on_device``
clone the caller's params first and train the clone, so the caller's
tensors never change; a CUDA graph or a prepared weight layout that holds
the trained tensors sees their version move and is made again. The step
counter and the optimizer's count are host integers: a step reads nothing
back from the device; ``fit`` does at log and checkpoint cadence only.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Iterator

import numpy as np
import torch

import kfnet_tpu_torch
from kfnet_tpu_torch.filter import sequence
from kfnet_tpu_torch.nn import layers as L
from kfnet_tpu_torch.parallel import mesh as mesh_lib
from kfnet_tpu_torch.utils import checkpoint as ckpt_lib
from kfnet_tpu_torch.utils import logging as log_lib


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
  """Adam + exponential decay, the reference recipe."""
  learning_rate: float = 1e-4
  decay_rate: float = 0.5
  decay_steps: int = 100_000
  staircase: bool = True
  beta1: float = 0.9
  beta2: float = 0.999
  grad_clip_norm: float | None = 5.0


@dataclasses.dataclass
class AdamState:
  """optax's adam state: the updates made so far and the two moments (trees
  shaped as the params)."""
  count: int
  mu: object
  nu: object


@dataclasses.dataclass
class TrainState:
  step: int
  params: object
  opt_state: AdamState


class Adam:
  """optax's ``chain(clip_by_global_norm, adam(exponential_decay))`` on the
  port's params trees, in place. ``init(params)`` gives the state;
  ``update(grads, state, params)`` clips ``grads`` (a list in
  ``layers.tree_leaves`` order) in place, advances ``state`` and moves
  ``params``."""

  EPS = 1e-8

  def __init__(self, cfg: OptimizerConfig):
    self.cfg = cfg

  def init(self, params) -> AdamState:
    zeros = lambda: L.tree_map(torch.zeros_like, params)
    return AdamState(count=0, mu=zeros(), nu=zeros())

  def learning_rate(self, count: int) -> float:
    """optax's exponential_decay at ``count`` updates made, in float32."""
    c = self.cfg
    p = np.float32(count) / np.float32(c.decay_steps)
    if c.staircase:
      p = np.floor(p)
    return float(np.float32(c.learning_rate)
                 * np.power(np.float32(c.decay_rate), p, dtype=np.float32))

  def update(self, grads: list, state: AdamState, params) -> None:
    c = self.cfg
    leaves = L.tree_leaves(params)
    mu, nu = L.tree_leaves(state.mu), L.tree_leaves(state.nu)
    if c.grad_clip_norm:
      clip_by_global_norm(grads, c.grad_clip_norm)
    lr = self.learning_rate(state.count)
    k = np.float32(state.count + 1)
    # bias corrections in float32, as optax computes decay**count
    bc1 = float(np.float32(1) - np.float32(c.beta1) ** k)
    bc2 = float(np.float32(1) - np.float32(c.beta2) ** k)
    with torch.no_grad():
      torch._foreach_mul_(mu, c.beta1)
      torch._foreach_add_(mu, grads, alpha=1.0 - c.beta1)
      torch._foreach_mul_(nu, c.beta2)
      torch._foreach_addcmul_(nu, grads, grads, value=1.0 - c.beta2)
      denom = torch._foreach_div(nu, bc2)
      torch._foreach_sqrt_(denom)
      torch._foreach_add_(denom, self.EPS)
      step = torch._foreach_div(mu, bc1)
      torch._foreach_div_(step, denom)
      torch._foreach_mul_(step, -lr)
      torch._foreach_add_(leaves, step)
    state.count += 1


def make_optimizer(cfg: OptimizerConfig) -> Adam:
  return Adam(cfg)


def global_norm(tensors: list) -> torch.Tensor:
  """sqrt(Σ‖t‖²) over the list, a 0-d tensor on the tensors' device."""
  return torch.linalg.vector_norm(torch.stack(torch._foreach_norm(tensors)))


def clip_by_global_norm(grads: list, max_norm: float) -> None:
  """optax's clip_by_global_norm, in place and without a host sync: each
  grad becomes (g / norm) · max_norm where norm >= max_norm."""
  g_norm = global_norm(grads)
  trigger = g_norm < max_norm
  one = torch.ones((), dtype=g_norm.dtype, device=g_norm.device)
  with torch.no_grad():
    torch._foreach_div_(grads, torch.where(trigger, one, g_norm))
    torch._foreach_mul_(grads, torch.where(trigger, one, one * max_norm))


def create_state(params, optimizer: Adam) -> TrainState:
  return TrainState(step=0, params=params, opt_state=optimizer.init(params))


def _grads(live) -> list:
  """The grads of a tree of leaves that require grad, in leaf order
  (zeros for a leaf the loss does not reach)."""
  return [torch.zeros_like(p) if p.grad is None else p.grad
          for p in L.tree_leaves(live)]


def value_and_grad(loss_fn: Callable, params, batch):
  """(loss, metrics, grads) of ``loss_fn(params, batch)``: the loss and
  metrics detached, the grads a list in ``layers.tree_leaves(params)``
  order (zeros for a leaf the loss does not reach). ``params`` are not
  changed: the loss sees detached leaves that require grad."""
  live = L.tree_map(lambda p: p.detach().requires_grad_(True), params)
  with torch.enable_grad():
    loss, metrics = loss_fn(live, batch)
    loss.backward()
  grads = _grads(live)
  return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
          grads)


def to_device(batch, device):
  """A batch's arrays as tensors on ``device`` (host arrays bound for the
  card go up from pinned memory)."""
  device = torch.device(device)
  return {k: sequence.frames_to_device(v, device) for k, v in batch.items()}


def _one_step(loss_fn: Callable, optimizer: Adam):
  """THE gradient-step body, shared by the single-step and K-step forms and
  by ``device_fit``, so a change to the update cannot apply to one path and
  not the other."""

  def one_step(state: TrainState, batch):
    _, metrics, grads = value_and_grad(loss_fn, state.params, batch)
    metrics["grad_norm"] = global_norm(grads)
    optimizer.update(grads, state.opt_state, state.params)
    state.step += 1
    return state, metrics

  return one_step


def make_dp_train_step(loss_fn: Callable, optimizer: Adam, mesh,
                       replicas: list) -> Callable:
  """The data-parallel step over ``mesh`` (the JAX package's jitted step on
  a sharded batch, whose gradient psum GSPMD inserts): (state, entry
  batches) -> (state, metrics), where entry i's batch is its shard of the
  global batch, on its device, and ``replicas[i]`` its copy of the params
  (``replicas[0]`` is ``state.params``).

  ``loss_fn`` is one of ``train.objectives``' (``objectives._pooled``):
  each entry runs its forward on its shard, the loss is taken of the
  outputs gathered on the first entry's device (the whole batch's, however
  it pools it: one masked mean in stages 1 and 2, a mean of per-row means
  in stage 3), and one backward runs through every entry's graph; each
  replica's gradient is its shard's share. The grads are added on the
  first entry's device in entry order (the answer does not depend on
  which device finishes first), one Adam update runs there, and the other
  replicas copy the new params. The metrics are the batch's; ``grad_norm``
  is that of the reduced gradient. GroupNorm's moments are each sample's
  own, so nothing else is synced."""
  if not (hasattr(loss_fn, "forward") and hasattr(loss_fn, "loss_of")):
    raise ValueError(
        "a data-parallel step needs a loss with its forward and loss_of "
        "(train.objectives' losses have them): a wrapped loss hides how "
        "it pools the batch")
  dev = mesh.devices[0]

  def dp_step(state: TrainState, batches: list):
    lives = [L.tree_map(lambda p: p.detach().requires_grad_(True), rep)
             for rep in replicas]
    with torch.enable_grad():
      outs = [loss_fn.forward(live, b) for live, b in zip(lives, batches)]
      gathered = tuple(torch.cat([o[k].to(dev) for o in outs])
                       for k in range(len(outs[0])))
      whole = {k: torch.cat([b[k].to(dev) for b in batches])
               for k in batches[0]}
      loss, metrics = loss_fn.loss_of(gathered, whole)
      loss.backward()
    parts = [_grads(live) for live in lives]
    grads = [t.to(dev, non_blocking=True) for t in parts[0]]
    for g in parts[1:]:
      torch._foreach_add_(grads, [t.to(dev, non_blocking=True) for t in g])
    metrics = {k: v.detach() for k, v in metrics.items()}
    metrics["grad_norm"] = global_norm(grads)
    optimizer.update(grads, state.opt_state, state.params)
    master = L.tree_leaves(state.params)
    with torch.no_grad():
      for rep in replicas[1:]:
        leaves = L.tree_leaves(rep)
        torch._foreach_copy_(leaves, [t.to(leaves[0].device) for t in
                                      master])
    state.step += 1
    return state, metrics

  return dp_step


def make_train_step(loss_fn: Callable, optimizer: Adam) -> Callable:
  """(state, batch) -> (state, metrics); the state is updated in place."""
  return _one_step(loss_fn, optimizer)


def make_multi_train_step(loss_fn: Callable, optimizer: Adam,
                          unroll: int = 1) -> Callable:
  """K training steps a call: (state, batches) -> (state, metrics of the
  last step), where ``batches`` holds arrays stacked along a leading (K,)
  axis. ``unroll`` is the JAX package's scan unroll: the steps here run
  one after another in an eager loop, which has nothing to unroll, so any
  positive value gives the same steps; it must be positive, as there."""
  if unroll < 1:
    raise ValueError(f"unroll must be a positive integer, not {unroll!r}")
  return _k_steps(_one_step(loss_fn, optimizer))


def _k_steps(one_step: Callable) -> Callable:
  """``one_step`` over each row of arrays stacked along a leading (K,)
  axis; the metrics of the last step."""

  def multi_step(state: TrainState, batches):
    k = next(iter(batches.values())).shape[0]
    metrics = {}
    for i in range(k):
      state, metrics = one_step(state, {n: v[i] for n, v in batches.items()})
    return state, metrics

  return multi_step


@dataclasses.dataclass(frozen=True)
class TrainLoopConfig:
  max_steps: int = 300_000
  log_every: int = 100
  checkpoint_every: int = 5000
  checkpoint_dir: str | None = None
  keep_checkpoints: int = 3
  # >1: stack K batches and run K optimizer steps a call (the JAX
  # package's one dispatch per K steps); log / checkpoint cadence then
  # quantizes to multiples of K
  steps_per_dispatch: int = 1


# the JAX package's data mesh, over the visible GPUs that divide a batch
default_mesh = mesh_lib.default_mesh


def clone_params(params, device):
  """A copy of ``params`` on ``device`` that nothing else holds."""
  return L.tree_map(lambda p: p.detach().to(device, copy=True), params)


def _stack(group):
  """K batches stacked where their data lives: tensors on their device,
  host arrays with numpy."""
  return {k: (torch.stack([b[k] for b in group])
              if isinstance(group[0][k], torch.Tensor)
              else np.stack([b[k] for b in group])) for k in group[0]}


def _grouped(batches, K):
  it = iter(batches)
  while True:
    group = []
    for batch in it:
      group.append(batch)
      if len(group) == K:
        break
    if not group:
      return
    # a short tail group (stream exhausted) is still trained
    yield _stack(group)
    if len(group) < K:
      return


def fit(loss_fn: Callable,
        init_params,
        batches: Iterator,
        optimizer_cfg: OptimizerConfig = OptimizerConfig(),
        loop_cfg: TrainLoopConfig = TrainLoopConfig(),
        mesh=None,
        logger: log_lib.MetricLogger | None = None,
        device=None) -> TrainState:
  """Run the training loop on ``device`` (``cuda`` unless given); resumes
  from the latest checkpoint if ``loop_cfg.checkpoint_dir`` holds one.
  Batches (dicts of numpy arrays or tensors) are moved to the device.
  Returns the final TrainState; ``init_params`` are left as they were.

  With a ``mesh`` (``parallel.mesh.default_mesh``) each step's batch is
  split over its entries along the batch axis (the stacked (K, B, ...)
  batches of ``steps_per_dispatch`` > 1 a step at a time, so along B) and
  the step is the data-parallel one (``make_dp_train_step``): one params
  replica per entry, the state on the first entry's device, where the
  checkpoints are taken from; a resumed run replicates again."""
  if mesh is not None:
    device = mesh.devices[0]
  device = kfnet_tpu_torch.resolve_device(device)
  optimizer = make_optimizer(optimizer_cfg)
  state = create_state(clone_params(init_params, device), optimizer)
  logger = logger or log_lib.MetricLogger()

  ckpt = None
  if loop_cfg.checkpoint_dir:
    ckpt = ckpt_lib.Checkpointer(loop_cfg.checkpoint_dir,
                                 max_to_keep=loop_cfg.keep_checkpoints)
    restored = ckpt.restore_latest(state)
    if restored is not None:
      state = restored
      logger.log_text(f"resumed at step {state.step}")

  K = max(1, loop_cfg.steps_per_dispatch)
  if mesh is None:
    train_step = make_train_step(loss_fn, optimizer)
    place = to_device
  else:
    replicas = [state.params] + (mesh_lib.replicate_tree(
        mesh_lib.Mesh(mesh.devices[1:]), state.params) if mesh.size > 1
                                 else [])
    dp_step = make_dp_train_step(loss_fn, optimizer, mesh, replicas)

    def train_step(state, batch):
      sharded = mesh_lib.shard_batch(mesh, batch, mesh.axis_name)
      return dp_step(state, [mesh_lib.entry_batch(sharded, i)
                             for i in range(mesh.size)])

    place = lambda batch, device: batch  # the split places each part
  if K > 1:
    batches = _grouped(batches, K)
    train_step = _k_steps(train_step)
  t0 = time.time()
  start_step = step = state.step
  for batch in batches:
    remaining = loop_cfg.max_steps - step
    if remaining <= 0:
      break
    k_batch = 1
    if K > 1:
      k_batch = next(iter(batch.values())).shape[0]
      if k_batch > remaining:  # trim so max_steps is exact
        batch = {k: v[:remaining] for k, v in batch.items()}
        k_batch = remaining
    prev_step = step
    state, metrics = train_step(state, place(batch, device))
    step += k_batch
    # window-crossing tests (not `step % every < K`, which can double-fire
    # around a boundary when a short tail group makes k_batch < K)
    if step // loop_cfg.log_every != prev_step // loop_cfg.log_every:
      metrics = {k: float(v) for k, v in metrics.items()}
      sps = (step - start_step) / max(time.time() - t0, 1e-9)
      logger.log_metrics(step, {**metrics, "steps_per_sec": sps})
    if ckpt and (step // loop_cfg.checkpoint_every
                 != prev_step // loop_cfg.checkpoint_every):
      ckpt.save(step, state)
  if ckpt:
    ckpt.save(step, state, force=True)
    ckpt.wait()
  return state
