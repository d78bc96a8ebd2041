"""Per-stage training objectives (port of ``kfnet_tpu/train/objectives.py``;
paper §4 / §5):

  stage 1  SCoordNet, per scene:   measurement NLL.
  stage 2  OFlowNet, per dataset:  NLL of flow-warped GT coords of t-1
                                   against GT coords of t, under the
                                   predicted process noise.
  stage 3  KFNet joint fine-tune:  posterior NLL on T-frame windows
                                   (BPTT) or 2-frame pairs (+ weighted
                                   component NLLs), gradients through
                                   both subnets.

Each objective is a function (params, batch) -> (loss, metrics dict) on
the port's params tree and NHWC batches of tensors. Where the JAX package
takes a mean per sequence or per pair under ``vmap`` (the stage-3
objectives), the port takes one per row of the batch too, and then their
mean; stages 1 and 2 pool the whole batch into one masked mean, as there.
Every loss function also carries its two parts (``_pooled``): the forward
(the nets' outputs in stages 1 and 2, the per-row losses in stage 3) and
the loss of its outputs, so that data parallelism can run the forward on
each device's shard and take the loss of the whole batch's outputs, as
the JAX package's GSPMD does.

The window objective runs with the fused update kernel when the config
takes it (the port's default): the kernel does the forward of every filter
step and its ``FusedFilterStep`` backward, autograd through the plain
version, carries the gradient, as the JAX package's custom VJP does. The
conv kernels have no backward (nor have the Pallas convs a VJP), so a
config whose nets take them cannot be trained.
"""

from __future__ import annotations

import dataclasses

import torch
from torch.utils import checkpoint as torch_checkpoint

from kfnet_tpu_torch.core import kalman, warp as warp_lib
from kfnet_tpu_torch.losses import nll
from kfnet_tpu_torch.models import kfnet, oflownet, scoordnet


def _differentiable(*net_configs):
  """Raise for a net whose convs are kernels: they have no backward."""
  for c in net_configs:
    if c.conv_impl != "xla":
      raise ValueError(
          f"conv_impl={c.conv_impl!r} runs the conv kernels, which have no "
          "backward (as in the JAX package, they are for inference): "
          "train with conv_impl='xla'")


def _pooled(forward, loss_of):
  """``loss_fn(params, batch) = loss_of(forward(params, batch), batch)``,
  with ``forward`` (a tuple of (B, ...) outputs, row i of each from row i
  of the batch alone) and ``loss_of`` kept on it, so that a batch split
  over devices takes each part's forward and the loss of the outputs
  gathered (``train.trainer.make_dp_train_step``)."""

  def loss_fn(params, batch):
    return loss_of(forward(params, batch), batch)

  loss_fn.forward, loss_fn.loss_of = forward, loss_of
  return loss_fn


def _training_dynamics(config: kfnet.KFNetConfig) -> kfnet.KFNetConfig:
  """Joint fine-tuning ALWAYS trains the raw paper filter dynamics (χ²
  p=0.05 gate, no W temperature, no adaptation): the calibrated serving
  defaults in KFNetConfig are an eval-side reweighting of models trained
  exactly this way. The fused kernel path stays as the config has it."""
  return dataclasses.replace(
      config, chi2_threshold=kalman.CHI2_3DOF_P05, w_scale=1.0,
      adaptive_alpha_max=0.0)


def _per_row(fn, *maps):
  """``fn`` of each row of (B, ...) maps, as a (B,) tensor: the JAX
  package's per-example reduction under ``vmap``."""
  return torch.stack([fn(*row) for row in zip(*maps)])


def scoordnet_objective(config: scoordnet.SCoordNetConfig):
  """batch: image (B,H,W,3), coords (B,h,w,3), valid (B,h,w)."""
  _differentiable(config)

  def forward(params, batch):
    return scoordnet.apply(params, config, batch["image"])

  def loss_of(outputs, batch):
    coords, var = outputs
    valid = batch["valid"]
    loss = nll.gaussian_nll(coords, batch["coords"], var, valid)
    metrics = {
        "loss": loss,
        "coord_err_m": nll.l2_coord_error(coords, batch["coords"], valid),
        "mean_var": nll.masked_mean(var, valid[..., None]),
    }
    return loss, metrics

  return _pooled(forward, loss_of)


def oflownet_objective(config: oflownet.OFlowNetConfig,
                       flow_reg_weight: float = 0.0):
  """batch: image_prev/image (B,H,W,3), coords_prev/coords (B,h,w,3),
  valid_prev/valid (B,h,w).

  The warped-prev-GT-vs-cur-GT NLL supervises flow and process noise
  jointly without any flow ground truth (paper §4.2): only where the flow
  transports a valid previous label onto a valid current pixel.
  """
  _differentiable(config)

  def forward(params, batch):
    return oflownet.apply(params, config, batch["image_prev"],
                          batch["image"])

  def loss_of(outputs, batch):
    flow, W = outputs
    joint = torch.cat([batch["coords_prev"],
                       batch["valid_prev"][..., None].to(torch.float32)], -1)
    warped, in_bounds = warp_lib.warp_by_flow(joint, flow)  # map by map
    # a warped label is trustworthy only if the entire bilinear footprint
    # was valid (warped validity == 1 exactly)
    ok_prev = in_bounds[..., 0] & (warped[..., 3] > 0.999)
    warped = warped[..., :3]
    mask = ok_prev & batch["valid"]
    loss = nll.gaussian_nll(warped, batch["coords"], W, mask)
    if flow_reg_weight:
      # smoothness along the width and the height of the NHWC flow
      dx = torch.diff(flow, dim=-2)
      dy = torch.diff(flow, dim=-3)
      loss = loss + flow_reg_weight * (
          torch.mean(torch.abs(dx)) + torch.mean(torch.abs(dy)))
    metrics = {
        "loss": loss,
        "warp_err_m": nll.l2_coord_error(warped, batch["coords"], mask),
        "mean_W": nll.masked_mean(W, mask[..., None]),
        "supervised_frac": torch.mean(mask.to(torch.float32)),
    }
    return loss, metrics

  return _pooled(forward, loss_of)


@dataclasses.dataclass(frozen=True)
class JointLossWeights:
  posterior: float = 1.0
  measurement: float = 0.5
  prior: float = 0.5


def kfnet_window_objective(config: kfnet.KFNetConfig,
                           weights: JointLossWeights = JointLossWeights(),
                           remat: bool = False):
  """Sequence-unrolled joint fine-tune: the filter runs over a T-frame
  window with gradients through time (BPTT), the posterior NLL of frames
  1..T-1 averaged per sequence. The B sequences of a batch step in
  lockstep (one fused launch a step for the B maps); each sequence's NLLs
  are its own masked means, averaged over the batch afterwards.

  remat: each filter step runs under ``torch.utils.checkpoint``
  (non-reentrant): only its inputs (the (x, P, feat) carry and the frame)
  are kept, and its activations are recomputed in the backward, so
  activation memory is O(1) in T. The recompute runs the step's forward
  again, the fused kernel included.

  batch: images (B, T, H, W, 3), coords (B, T, h, w, 3), valid (B, T, h, w).
  """
  _differentiable(config.scoordnet, config.oflownet)
  config = _training_dynamics(config)

  def forward(params, batch):
    images, coords_gt, valid = batch["images"], batch["coords"], batch["valid"]
    T = images.shape[1]

    def body(x, P, feat, img, gt, v):
      x1, P1, feat1, aux = kfnet.filter_step(params, config, x, P, feat, img)
      return (x1, P1, feat1,
              _per_row(nll.gaussian_nll, x1, gt, P1, v),
              _per_row(nll.gaussian_nll, aux["z"], gt, aux["V"], v),
              _per_row(nll.l2_coord_error, x1, gt, v))

    x, P, feat = kfnet.first_step(params, config, images[:, 0])
    l0 = _per_row(nll.gaussian_nll, x, coords_gt[:, 0], P, valid[:, 0])
    l_post, l_meas, err = [], [], []
    for t in range(1, T):
      inputs = (x, P, feat, images[:, t], coords_gt[:, t], valid[:, t])
      if remat:
        out = torch_checkpoint.checkpoint(body, *inputs, use_reentrant=False)
      else:
        out = body(*inputs)
      x, P, feat = out[:3]
      l_post.append(out[3])
      l_meas.append(out[4])
      err.append(out[5])
    # per sequence: means over the window; l0 / T divides by the window
    # length (the JAX package's images.shape[0] inside its vmap)
    return (torch.mean(torch.stack(l_post), dim=0),
            torch.mean(torch.stack(l_meas), dim=0) + l0 / T,
            torch.mean(torch.stack(err), dim=0))

  def loss_of(rows, batch):
    l_post, l_meas, err = map(torch.mean, rows)
    loss = weights.posterior * l_post + weights.measurement * l_meas
    return loss, {"loss": loss, "posterior_nll": l_post,
                  "measurement_nll": l_meas, "coord_err_m": err}

  return _pooled(forward, loss_of)


def kfnet_objective(config: kfnet.KFNetConfig,
                    weights: JointLossWeights = JointLossWeights()):
  """Joint fine-tune on 2-frame pairs: the t-1 posterior is initialized
  from the measurement system, one filter step runs to t, and the
  posterior NLL (+ component NLLs) trains both nets. The prior NLL needs
  the warped prior, which only the composition returns: the config must
  have ``use_fused_kernel=False`` (the JAX package asserts
  ``not use_pallas``).

  batch: image_prev/image (B,H,W,3), coords (B,h,w,3), valid (B,h,w).
  """
  if config.use_fused_kernel:
    raise ValueError(
        "kfnet_objective needs the warped prior, which the fused kernel "
        "does not return: pass a config with use_fused_kernel=False")
  _differentiable(config.scoordnet, config.oflownet)
  config = _training_dynamics(config)

  def forward(params, batch):
    coords_gt, valid = batch["coords"], batch["valid"]
    x0, P0, feat0 = kfnet.first_step(params, config, batch["image_prev"])
    x1, P1, _, aux = kfnet.filter_step(params, config, x0, P0, feat0,
                                       batch["image"])
    l_post = _per_row(nll.gaussian_nll, x1, coords_gt, P1, valid)
    l_meas = _per_row(nll.gaussian_nll, aux["z"], coords_gt, aux["V"], valid)
    # prior supervised only where the warp stayed in bounds
    prior_ok = valid & (aux["P_prior"][..., 0] < config.invalid_cov * 0.5)
    l_prior = _per_row(nll.gaussian_nll, aux["x_prior"], coords_gt,
                       aux["P_prior"], prior_ok)
    err = _per_row(nll.l2_coord_error, x1, coords_gt, valid)
    cons = torch.mean(aux["consistent"].to(torch.float32),
                      dim=tuple(range(1, aux["consistent"].dim())))
    return l_post, l_meas, l_prior, err, cons

  def loss_of(rows, batch):
    l_post, l_meas, l_prior, err, cons = map(torch.mean, rows)
    loss = (weights.posterior * l_post + weights.measurement * l_meas +
            weights.prior * l_prior)
    metrics = {
        "loss": loss,
        "posterior_nll": l_post,
        "measurement_nll": l_meas,
        "prior_nll": l_prior,
        "coord_err_m": err,
        "consistent_frac": cons,
    }
    return loss, metrics

  return _pooled(forward, loss_of)
