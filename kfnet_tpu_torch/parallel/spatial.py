"""Width-sharded filtering (port of ``kfnet_tpu/parallel/spatial.py``).

The JAX package shards the image width over its mesh: the cost volume
with an explicit ``shard_map`` halo exchange, and the whole recursive
filter under GSPMD, which partitions every op and inserts each halo
exchange itself. The port has no partitioner, so every exchange is
written here, per layer, as GSPMD would insert it: a map is a
``mesh.Sharded`` split along W (``even_bounds``: a function of its width
alone), and each op computes a shard's columns from the columns they
read, taken from as many neighbours as they span (``Sharded.take``; zeros
past the image's edges):

  * convs and transposed convs: ``nn.layers`` applies them to a sharded
    map (SAME padding in H, the halo in W, whatever the stride);
  * GroupNorm: ``nn.layers.group_norm`` sums each shard's moments across
    the shards, in shard order, before the group combine;
  * the cost volume: ``radius`` columns on each side;
  * the warp of (x, P) at the flow clipped to [-r, r]: r + 1 columns, with
    validity and the corners' clamp taken against the map's width
    (``core.warp``), so a shard's edge is not the image's;
  * the adaptive inflation's map-wide mean: its two sums reduced across
    the shards;
  * the heads' output steps and the Kalman update: pointwise.

As the JAX package drops ``use_pallas`` under the mesh, the fused update
kernel does not take a shard: ``run_filter_spatial`` runs the warp and the
update as their composition. The conv kernels stay, as GSPMD keeps the
Pallas kernels: a ``pallas_3x3`` conv runs the ``conv3x3_same`` kernel on
each shard's halo'd block (a pure stencil: the block's columns give the
shard's); a ``pallas_fused`` trunk runs its ``conv3x3_gn_chain`` kernels
on the whole map gathered on the first entry's device and splits their
output again, as GSPMD replicates a custom call it cannot partition (the
kernel's per-channel sums are the map's, which a halo'd block's would not
be).

The params are placed once per device (``_spatial_params``) and every
layer takes its shard's entry's copy (``mesh.Replicated``).
"""

from __future__ import annotations

import dataclasses

import torch

from kfnet_tpu_torch.core import kalman
from kfnet_tpu_torch.core import warp as warp_lib
from kfnet_tpu_torch.filter import sequence
from kfnet_tpu_torch.kernels.cost_volume import correlate
from kfnet_tpu_torch.models import kfnet, oflownet, scoordnet
from kfnet_tpu_torch.nn import layers as L
from kfnet_tpu_torch.parallel import mesh as mesh_lib
from kfnet_tpu_torch.parallel.mesh import Sharded, even_bounds, split


def _halo_exchange_w(x: Sharded, halo: int) -> Sharded:
  """Each shard of an (..., H, W_local, C) map extended by ``halo``
  columns from its mesh neighbours on each side, zeros at the image's
  edges (the unsharded op's zero padding). ``halo`` >= 1; callers with a
  0-wide stencil need no exchange."""
  if halo < 1:
    raise ValueError("halo exchange with an empty halo: skip the call")
  b = x.bounds
  return Sharded([x.take(i, b[i] - halo, b[i + 1] + halo)
                  for i in range(len(x.shards))], x.axis, x.devices)


def _cost_volume_w(fp: Sharded, fc: Sharded, radius: int) -> Sharded:
  """The cost volume of W-sharded (h, w, C) maps, sharded as ``fc``."""
  ext = _halo_exchange_w(fp, radius) if radius > 0 else fp
  return Sharded([correlate(p, c, radius)
                  for p, c in zip(ext.shards, fc.shards)], fc.axis,
                 fc.devices)


def cost_volume_spatial(feat_prev: torch.Tensor, feat_cur: torch.Tensor,
                        radius: int, mesh,
                        axis_name: str = "data") -> Sharded:
  """W-sharded local correlation volume, equal to
  ``kernels.cost_volume.cost_volume``.

  Args:
    feat_prev/feat_cur: (H, W, C), W divisible by the mesh size.

  Returns:
    (H, W, (2r+1)²), a ``Sharded`` along W.
  """
  mesh.check_axis(axis_name)
  n = mesh.size
  r = radius
  shard_w = feat_prev.shape[-2] // n
  if r > shard_w:
    raise ValueError(
        f"cost_volume_spatial needs radius <= W/n_shards: a single-neighbor "
        f"halo of {r} columns cannot be served by {shard_w}-column shards "
        f"(W={feat_prev.shape[-2]}, shards={n}). Use fewer shards or the "
        "whole filter (run_filter_spatial), which has no such limit.")
  return _cost_volume_w(split(mesh, feat_prev, -2),
                        split(mesh, feat_cur, -2), r)


def _to_nchw(x: Sharded) -> Sharded:
  """W-sharded (H, w, C) maps -> (1, C, H, w) views."""
  return x.map(lambda t: scoordnet.to_nchw(t)[0], axis=-1)


def _from_nchw(x: Sharded) -> Sharded:
  return x.map(lambda t: scoordnet.from_nchw(t, ()), axis=-2)


def _crop_to(x: Sharded, h: int, w: int) -> Sharded:
  """A (1, C, H, W) map cropped to its first h rows and w columns, split
  as a map of width w is."""
  if x.shape[-1] != w:
    b = even_bounds(w, len(x.shards))
    x = Sharded([x.take(i, b[i], b[i + 1]) for i in range(len(x.shards))],
                -1, x.devices)
  return x.map(lambda t: t[..., :h, :])


def _cat_channels(a: Sharded, b: Sharded) -> Sharded:
  return Sharded([torch.cat([p, q], dim=1) for p, q in zip(a.shards,
                                                          b.shards)],
                 -1, a.devices)


def _ingest(config, image: Sharded) -> Sharded:
  """The stem (space-to-depth, local: a shard's width is a multiple of the
  factor) and the uint8 cast, shard by shard."""
  return image.map(lambda t: scoordnet.ingest(
      scoordnet.maybe_space_to_depth(config, t)))


def _fused_trunk_w(params, config, x: Sharded) -> Sharded:
  """``scoordnet._apply_fused_trunk`` on a W-sharded (1, C, H', W') frame
  after the stem: the prefix on the shards, the fused suffix (the chain
  kernels) on the map gathered on the first entry's device, split again."""
  k = scoordnet._fused_suffix_start(config)
  layers_list = scoordnet._layer_list(config, single_frame=True)
  for i in range(k):
    x = layers_list[i].apply(params[i], x)
  dev = x.devices[0]
  out = scoordnet._fused_suffix(mesh_lib.entry_params(params, 0, dev),
                                config, L.frame_hwc(x.full()))
  return split(mesh_lib.Mesh(x.devices), out, -1)


def _scoord_raw(params, config, image: Sharded) -> Sharded:
  """``scoordnet.apply_raw`` of one W-sharded frame."""
  x = _to_nchw(_ingest(config, image))
  if config.conv_impl == "pallas_fused":
    out = _fused_trunk_w(params, config, x)
  else:
    out = scoordnet.build(config, single_frame=True).apply(params, x)
  return _from_nchw(out).map(lambda t: t.to(torch.float32))


def _encode(params, config, image: Sharded) -> Sharded:
  """``oflownet.encode`` of one W-sharded frame."""
  x = _to_nchw(_ingest(config, image))
  enc = oflownet._encoder(config, single_frame=True)
  return _from_nchw(enc.apply(params["encoder"], x))


def _decode_raw(params, config, cv: Sharded) -> Sharded:
  """``oflownet.decode_raw`` of a W-sharded cost volume."""
  dec = oflownet._decoder_layers(config, single_frame=True)
  x = _to_nchw(cv)
  e0 = dec["enc0"].apply(params["enc0"], x)
  d1 = dec["down1"].apply(params["down1"], e0)
  d2 = dec["down2"].apply(params["down2"], d1)
  u1 = _crop_to(dec["up1"].apply(params["up1"], d2), *d1.shape[-2:])
  f1 = dec["fuse1"].apply(params["fuse1"], _cat_channels(u1, d1))
  u0 = _crop_to(dec["up0"].apply(params["up0"], f1), *e0.shape[-2:])
  f0 = dec["fuse0"].apply(params["fuse0"], _cat_channels(u0, e0))
  return _from_nchw(dec["head"].apply(params["head"], f0)).map(
      lambda t: t.to(torch.float32))


def _measure(params, config, image: Sharded):
  sc = config.scoordnet
  raw = _scoord_raw(params["scoordnet"], sc, image)
  zV = [scoordnet.output_step(t, sc.coord_scale, sc.coord_offset)
        for t in raw.shards]
  return [z for z, _ in zV], [v for _, v in zV]


def _update(config, x_prev: Sharded, P_prev: Sharded, flow, W, z, V):
  """``kfnet._composed_update`` on W-sharded maps (lists of per-shard
  flow, W, z, V): the warp reads r + 1 columns of each neighbour, its
  validity the map's; the adaptive mean's sums are reduced across the
  shards. Returns per-shard (x_post, P_post) lists."""
  r = config.oflownet.search_radius
  halo = r + 1
  joint = _halo_exchange_w(
      Sharded([torch.cat([x, P], dim=-1) for x, P in zip(x_prev.shards,
                                                         P_prev.shards)],
              x_prev.axis, x_prev.devices), halo)
  b, width = x_prev.bounds, x_prev.shape[-2]
  priors = []
  for i, blk in enumerate(joint.shards):
    priors.append(warp_lib.warp_state_cov(
        blk[..., :3], blk[..., 3:4], torch.clamp(flow[i], -float(r),
                                                 float(r)),
        W[i], invalid_cov=config.invalid_cov, first=b[i], col0=b[i] - halo,
        width=width))
  if config.adaptive_alpha_max > 1.0:
    nums, dens = [], []
    for (x_pr, P_pr, valid), zi, Vi in zip(priors, z, V):
      maha = kalman.mahalanobis_sq(zi - x_pr, P_pr, Vi)
      v = valid.to(torch.float32)
      nums.append(torch.sum(torch.clamp_max(maha, 25.0) * v))
      dens.append(torch.sum(v))
    dev = x_prev.devices[0]
    m_bar = (L.sum_in_order(nums, dev)
             / torch.clamp_min(L.sum_in_order(dens, dev), 1.0))
    alpha = torch.clamp(m_bar / 3.0, 1.0, config.adaptive_alpha_max)
    priors = [(x_pr, alpha.to(P_pr.device) * P_pr, valid)
              for x_pr, P_pr, valid in priors]
  xs, Ps = [], []
  for (x_pr, P_pr, _), zi, Vi in zip(priors, z, V):
    x1, P1, _ = kalman.kalman_update(x_pr, P_pr, zi, Vi,
                                     threshold=config.chi2_threshold)
    xs.append(x1)
    Ps.append(P1)
  return xs, Ps


def _first_step(params, config, image: Sharded):
  z, V = _measure(params, config, image)
  feat = _encode(params["oflownet"], config.oflownet, image)
  return Sharded(z, -2, image.devices), Sharded(V, -2, image.devices), feat


def _filter_step(params, config, x: Sharded, P: Sharded, feat: Sharded,
                 image: Sharded):
  of = config.oflownet
  feat_cur = _encode(params["oflownet"], of, image)
  cv = _cost_volume_w(feat, feat_cur, of.search_radius)
  fw = [oflownet.output_step(t, of.search_radius)
        for t in _decode_raw(params["oflownet"], of, cv).shards]
  flow = [f for f, _ in fw]
  W = [w * config.w_scale if config.w_scale != 1.0 else w for _, w in fw]
  z, V = _measure(params, config, image)
  xs, Ps = _update(config, x, P, flow, W, z, V)
  return (Sharded(xs, -2, x.devices), Sharded(Ps, -2, x.devices), feat_cur)


# The spatial filter's params, placed once across calls.
_spatial_params = sequence.Placements()


def run_filter_spatial(params, config: kfnet.KFNetConfig, images, mesh,
                       axis_name: str = "data"):
  """The recursive filter with the image WIDTH sharded over the mesh: the
  params placed once per device (``_spatial_params``, kept across calls;
  each shard computes with its device's copy), each frame split into
  W-shards, each op of each step on its shards with the halos its stencil
  reads (module docstring).
  ``use_fused_kernel`` is replaced by the composition.

  Args:
    images: (T, H, W, 3) frames (uint8 or float in [0, 1]); W divisible by
      8 × the mesh size (the stride-8 maps shard evenly, and the stem's
      space-to-depth stays within a shard).

  Returns:
    (xs (T, h, w, 3), Ps (T, h, w, 1)) as ``filter.sequence.run_filter``
    gives them, each a ``Sharded`` along w.
  """
  mesh.check_axis(axis_name)
  config = dataclasses.replace(config, use_fused_kernel=False)
  n = mesh.size
  width = images.shape[-2]
  if width % (8 * n):
    raise ValueError(f"image width {width} must be divisible by 8 x the "
                     f"mesh size ({8 * n})")
  placed = {d: _spatial_params.get(params, d)
            for d in dict.fromkeys(mesh.devices)}
  params = mesh_lib.replica_tree([placed[d] for d in mesh.devices],
                                 mesh.devices)
  frames = split(mesh, images, axis=-2)
  x, P, feat = _first_step(params, config, frames.map(lambda t: t[0]))
  xs, Ps = [x], [P]
  for t in range(1, images.shape[0]):
    x, P, feat = _filter_step(params, config, x, P, feat,
                              frames.map(lambda f: f[t]))
    xs.append(x)
    Ps.append(P)

  def stacked(maps):
    return Sharded([torch.stack([m.shards[i] for m in maps])
                    for i in range(n)], -2, mesh.devices)

  return stacked(xs), stacked(Ps)
