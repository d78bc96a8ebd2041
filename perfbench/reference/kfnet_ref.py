"""Plain PyTorch reference of one KFNet filter step and of the PnP-RANSAC
pose solve, written from the paper (arXiv:2003.10629, sections 3-4) and the
configuration files in ``perfbench/configs``. It imports nothing of the
program under test: it reads the configuration dict, the raw uint8 frames
and the weights the benchmark made, and works out every map itself.

Weights are taken in the program's parameter tree (``perfbench/weights.py``
lays it out): plain nested lists and dicts of float32 tensors.

Precision: ``Precision()`` is the reference, float32 everywhere with TF32
off. The control is the same code one step lower: ``conv="fp8"`` rounds
each convolution's input and weight to float8 e4m3 (one scale per tensor,
its absolute maximum at 448) and its output to bfloat16, and ``tf32=True``
lets the float32 convolutions and matrix products run in TF32.

Layouts: frames (..., H, W, 3) uint8; maps (..., h, w, C).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math

import torch
import torch.nn.functional as F

FP8_MAX = 448.0


@dataclasses.dataclass(frozen=True)
class Precision:
  conv: str = "float32"  # "float32" | "fp8"
  tf32: bool = False


REFERENCE = Precision()
CONTROL = Precision(conv="fp8", tf32=True)


@contextlib.contextmanager
def tf32_mode(on: bool):
  """TF32 for float32 convolutions and matrix products while the block
  runs (the reference keeps it off)."""
  saved = (torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32)
  torch.backends.cuda.matmul.allow_tf32 = on
  torch.backends.cudnn.allow_tf32 = on
  try:
    yield
  finally:
    (torch.backends.cuda.matmul.allow_tf32,
     torch.backends.cudnn.allow_tf32) = saved


# ---- layers (NCHW float32) ------------------------------------------------


def same_pads(size: int, kernel: int, stride: int):
  """SAME padding (lo, hi) of one axis: the output has ceil(size/stride)
  samples and the extra pad goes on the high side."""
  out = -(-size // stride)
  total = max((out - 1) * stride + kernel - size, 0)
  return total // 2, total - total // 2


def _fp8(t: torch.Tensor) -> torch.Tensor:
  scale = FP8_MAX / torch.clamp_min(t.abs().amax(), 1e-30)
  q = (t * scale).to(torch.float8_e4m3fn).to(torch.float32)
  return q / scale


def conv(x, p, stride: int, prec: Precision, low: bool):
  """A SAME conv with bias ``p.get("b")``; ``low``: a convolution the
  configuration runs in its low precision (the trunks), which the control
  takes to fp8; the float32 heads take TF32 there."""
  w = p["w"]
  k = w.shape[-1]
  t, b = same_pads(x.shape[-2], k, stride)
  l, r = same_pads(x.shape[-1], k, stride)
  fp8 = low and prec.conv == "fp8"
  if fp8:
    x, w = _fp8(x), _fp8(w)
  # fp8 operands multiply exactly in TF32; accumulation is float32 either way
  with tf32_mode(fp8 or (prec.tf32 and not low)):
    y = F.conv2d(F.pad(x, (l, r, t, b)), w, stride=stride)
  if "b" in p:
    y = y + p["b"][:, None, None]
  if low and prec.conv == "fp8":
    y = y.to(torch.bfloat16).to(torch.float32)
  return y


def conv_transpose(x, p, prec: Precision):
  """The 4x4 stride-2 SAME transposed conv: the stride-dilated input
  correlated with the stored (in, out, 4, 4) kernel (kept flipped), so the
  output is exactly twice the input's size."""
  w = p["w"]
  if prec.conv == "fp8":
    x, w = _fp8(x), _fp8(w)
  with tf32_mode(prec.conv == "fp8"):
    y = F.conv_transpose2d(x, w, stride=2, padding=1)
  y = y + p["b"][:, None, None]
  if prec.conv == "fp8":
    y = y.to(torch.bfloat16).to(torch.float32)
  return y


def groups_of(c: int, groups: int = 32) -> int:
  g = min(groups, c)
  while c % g:
    g -= 1
  return g


def block(x, p, stride: int, norm: str, prec: Precision):
  """conv, GroupNorm (32 groups, eps 1e-5) where ``norm`` is "group",
  ReLU. ``p`` is the block's [conv, (norm,) relu] params."""
  x = conv(x, p[0], stride, prec, low=True)
  if norm == "group":
    gn = p[1]
    x = F.group_norm(x, groups_of(x.shape[1]), gn["scale"], gn["bias"],
                     eps=1e-5)
  return torch.relu(x)


def adjusted_strides(strides, stem_s2d: int):
  """The trailing stride-2 layers that the space-to-depth stem replaces
  become stride 1."""
  strides = list(strides)
  drop = {1: 0, 2: 1, 4: 2, 8: 3}[stem_s2d]
  for i in range(len(strides) - 1, -1, -1):
    if drop == 0:
      break
    if strides[i] == 2:
      strides[i] = 1
      drop -= 1
  return strides


def stem(frames: torch.Tensor, f: int) -> torch.Tensor:
  """(B, H, W, 3) uint8 -> (B, 3 f², H/f, W/f) float32 in [0, 1];
  channel (fy·f + fx)·3 + c."""
  x = frames.to(torch.float32) * (1.0 / 255.0)
  b, h, w, c = x.shape
  x = x.reshape(b, h // f, f, w // f, f, c).permute(0, 1, 3, 2, 4, 5)
  x = x.reshape(b, h // f, w // f, f * f * c)
  return x.permute(0, 3, 1, 2)


def _batched(frames):
  return frames if frames.dim() == 4 else frames[None]


def to_maps(y: torch.Tensor, lead) -> torch.Tensor:
  """(B, C, h, w) -> (..., h, w, C)."""
  y = y.permute(0, 2, 3, 1)
  return y.reshape(tuple(lead) + tuple(y.shape[1:]))


# ---- the nets ---------------------------------------------------------------


def scoordnet_raw(params, sc: dict, frames, prec: Precision = REFERENCE):
  """SCoordNet's raw float32 head (..., h, w, 4) of (..., H, W, 3) uint8
  frames: the stem, the trunk, a conv block and the 1x1 head."""
  lead = frames.shape[:-3]
  x = stem(_batched(frames), sc["stem_s2d"])
  n = len(sc["channels"])
  for i, s in enumerate(adjusted_strides(sc["strides"], sc["stem_s2d"])):
    x = block(x, params[i], s, sc["norm"], prec)
  x = block(x, params[n], 1, sc["norm"], prec)
  x = conv(x, params[n + 1], 1, prec, low=False)
  return to_maps(x, lead)


def encode(params, of: dict, frames, prec: Precision = REFERENCE):
  """OFlowNet's shared encoder: (..., h, w, C) features."""
  lead = frames.shape[:-3]
  x = stem(_batched(frames), of["stem_s2d"])
  strides = adjusted_strides(of["encoder_strides"], of["stem_s2d"])
  for i, s in enumerate(strides):
    x = block(x, params["encoder"][i], s, of["norm"], prec)
  return to_maps(x, lead)


def cost_volume(feat_prev, feat_cur, r: int):
  """(..., h, w, (2r+1)²): channel (dy+r)(2r+1) + (dx+r) is the mean over
  channels of feat_cur(p) · feat_prev(p + (dx, dy)), zero off the map."""
  h, w = feat_cur.shape[-3:-1]
  pad = F.pad(feat_prev, (0, 0, r, r, r, r))
  out = []
  for dy in range(-r, r + 1):
    for dx in range(-r, r + 1):
      shifted = pad[..., r + dy:r + dy + h, r + dx:r + dx + w, :]
      out.append(torch.mean(feat_cur * shifted, dim=-1))
  return torch.stack(out, dim=-1)


def decode_raw(params, of: dict, cv, prec: Precision = REFERENCE):
  """The U-Net over the cost volume: the raw float32 head (..., h, w, 3)."""
  lead = cv.shape[:-3]
  x = cv.reshape((-1,) + tuple(cv.shape[-3:])).permute(0, 3, 1, 2)
  nm = of["norm"]

  def pair(p, x, s):
    return block(block(x, p[0], s, nm, prec), p[1], 1, nm, prec)

  e0 = pair(params["enc0"], x, 1)
  d1 = pair(params["down1"], e0, 2)
  d2 = pair(params["down2"], d1, 2)
  u1 = conv_transpose(d2, params["up1"], prec)[..., :d1.shape[-2],
                                                :d1.shape[-1]]
  f1 = block(torch.cat([u1, d1], 1), params["fuse1"], 1, nm, prec)
  u0 = conv_transpose(f1, params["up0"], prec)[..., :e0.shape[-2],
                                                :e0.shape[-1]]
  f0 = block(torch.cat([u0, e0], 1), params["fuse0"], 1, nm, prec)
  y = conv(f0, params["head"], 1, prec, low=False)
  return to_maps(y, lead)


LOG_VAR_CLIP = 12.0


def coord_head(raw, sc: dict):
  """(coords (..., 3), variance (..., 1)) of SCoordNet's raw head."""
  off = torch.tensor(sc["coord_offset"], dtype=torch.float32,
                     device=raw.device)
  s = float(sc["coord_scale"])
  return (raw[..., :3] * s + off,
          torch.exp(torch.clamp(raw[..., 3:4], -LOG_VAR_CLIP,
                                LOG_VAR_CLIP)) * s * s)


def flow_head(raw, r: int, w_scale: float):
  """(backward flow r·tanh (..., 2), process variance (..., 1))."""
  return (r * torch.tanh(raw[..., :2]),
          torch.exp(torch.clamp(raw[..., 2:3], -LOG_VAR_CLIP, LOG_VAR_CLIP))
          * w_scale)


def measure(params, cfg: dict, frames, prec: Precision = REFERENCE):
  """(z, V) of (..., H, W, 3) frames: what a first frame's posterior is."""
  return coord_head(scoordnet_raw(params["scoordnet"], cfg["scoordnet"],
                                  frames, prec), cfg["scoordnet"])


# ---- warp and update ------------------------------------------------------


def bilinear(img, pos):
  """Sample (B, h, w, C) maps at (B, h, w, 2) (u, v) positions: valid
  inside [0, w-1] x [0, h-1]; zero where invalid."""
  b, h, w, c = img.shape
  u, v = pos[..., 0], pos[..., 1]
  valid = (u >= 0) & (u <= w - 1) & (v >= 0) & (v <= h - 1)
  u0, v0 = torch.floor(u), torch.floor(v)
  du, dv = u - u0, v - v0
  x0 = torch.clamp(u0.long(), 0, w - 1)
  y0 = torch.clamp(v0.long(), 0, h - 1)
  x1 = torch.clamp(x0 + 1, 0, w - 1)
  y1 = torch.clamp(y0 + 1, 0, h - 1)
  bi = torch.arange(b, device=img.device)[:, None, None]

  def at(yy, xx):
    return img[bi, yy, xx]

  out = (((1 - du) * (1 - dv))[..., None] * at(y0, x0)
         + (du * (1 - dv))[..., None] * at(y0, x1)
         + ((1 - du) * dv)[..., None] * at(y1, x0)
         + (du * dv)[..., None] * at(y1, x1))
  return torch.where(valid[..., None], out, torch.zeros_like(out)), valid


def update(x_prev, P_prev, flow, W, z, V, r: int, threshold: float,
           invalid_cov: float):
  """Warp the previous posterior by the flow (clipped to ±r), add the
  process noise, then the per-pixel Kalman update with the χ² (3 dof)
  consistency test: an inconsistent pixel restarts from (z, V). Maps may
  carry a leading batch dim. Returns (x, P, consistent)."""
  lead = x_prev.shape[:-3]
  one = lambda t: t.reshape((-1,) + tuple(t.shape[-3:]))
  h, w = flow.shape[-3:-1]
  vv, uu = torch.meshgrid(torch.arange(h, device=flow.device,
                                       dtype=torch.float32),
                          torch.arange(w, device=flow.device,
                                       dtype=torch.float32), indexing="ij")
  pos = torch.stack([uu, vv], -1) + torch.clamp(one(flow), -r, r)
  warped, valid = bilinear(torch.cat([one(x_prev), one(P_prev)], -1), pos)
  valid = valid[..., None]
  x_pr = warped[..., :3]
  P_pr = torch.where(valid, warped[..., 3:] + one(W),
                     torch.full_like(warped[..., 3:], invalid_cov))
  zz, VV = one(z), one(V)
  innov = zz - x_pr
  S = P_pr + VV
  consistent = torch.sum(innov * innov, -1, keepdim=True) / S <= threshold
  x = torch.where(consistent, x_pr + (P_pr / S) * innov, zz)
  P = torch.where(consistent, P_pr * VV / S, VV)
  back = lambda t: t.reshape(tuple(lead) + tuple(t.shape[1:]))
  return back(x), back(P), back(consistent)


def filter_step(params, cfg: dict, x_prev, P_prev, frame_prev, frame_cur,
                prec: Precision = REFERENCE):
  """One filter step from the posterior of ``frame_prev`` to that of
  ``frame_cur`` (uint8 (..., H, W, 3)): OFlowNet's flow and process noise
  between the two frames, SCoordNet's measurement of the second, the
  update. Returns dict(x, P, z, V, flow, W, consistent)."""
  of, flt = cfg["oflownet"], cfg["filter"]
  r = of["search_radius"]
  feats = encode(params["oflownet"], of, torch.stack([frame_prev,
                                                      frame_cur]), prec)
  cv = cost_volume(feats[0], feats[1], r)
  flow, W = flow_head(decode_raw(params["oflownet"], of, cv, prec), r,
                      flt["w_scale"])
  z, V = measure(params, cfg, frame_cur, prec)
  with tf32_mode(prec.tf32):
    x, P, consistent = update(x_prev, P_prev, flow, W, z, V, r,
                              flt["chi2_threshold"], flt["invalid_cov"])
  return {"x": x, "P": P, "z": z, "V": V, "flow": flow, "W": W,
          "consistent": consistent}


# ---- pose: confidence top-k, 6-point DLT hypotheses, scoring, LM --------


def _take(a, idx):
  sel = idx.reshape(a.shape[:-2] + (-1, 1))
  return torch.take_along_dim(a, sel, dim=-2).reshape(idx.shape
                                                      + a.shape[-1:])


def cell_centers(h: int, w: int, stride: int, device):
  off = (stride - 1) // 2
  vs = torch.arange(h, device=device) * stride + off
  us = torch.arange(w, device=device) * stride + off
  v, u = torch.meshgrid(vs.float(), us.float(), indexing="ij")
  return torch.stack([u, v], -1).reshape(-1, 2)


def inv3(M):
  a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
  d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
  g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
  A, B, C = e * i - f * h, f * g - d * i, d * h - e * g
  det = a * A + b * B + c * C
  det = torch.where(torch.abs(det) < 1e-20, torch.sign(det) * 1e-20 + 1e-30,
                    det)
  adj = torch.stack([
      torch.stack([A, c * h - b * i, b * f - c * e], -1),
      torch.stack([B, a * i - c * g, c * d - a * f], -1),
      torch.stack([C, b * g - a * h, a * e - b * d], -1)], -2)
  return adj / det[..., None, None]


def det3(M):
  a, b, c = M[..., 0, 0], M[..., 0, 1], M[..., 0, 2]
  d, e, f = M[..., 1, 0], M[..., 1, 1], M[..., 1, 2]
  g, h, i = M[..., 2, 0], M[..., 2, 1], M[..., 2, 2]
  return a * (e * i - f * h) + b * (f * g - d * i) + c * (d * h - e * g)


def nearest_rotation(M, iters: int = 8):
  """The proper rotation nearest a 3x3 matrix: the last column flipped
  where det < 0, then the polar factor by scaled Newton iteration."""
  flip = torch.where(det3(M) < 0, -1.0, 1.0).to(M.dtype)
  X = M * torch.stack([torch.ones_like(flip), torch.ones_like(flip), flip],
                      -1)[..., None, :]
  for _ in range(iters):
    g = torch.abs(det3(X)) ** (-1.0 / 3.0)
    g = torch.clamp(torch.where(torch.isfinite(g), g, torch.ones_like(g)),
                    1e-4, 1e4)
    Xs = X * g[..., None, None]
    X = 0.5 * (Xs + inv3(Xs).transpose(-1, -2))
  return X


def _normalize(pts, w, target: float):
  """Hartley normalisation: weighted centroid to 0, mean distance to
  ``target``; returns (points, (d+1, d+1) transform)."""
  d = pts.shape[-1]
  ws = torch.clamp_min(w.sum(-1), 1e-8)
  mean = (pts * w[..., None]).sum(-2) / ws[..., None]
  dist = torch.sqrt(((pts - mean[..., None, :]) ** 2).sum(-1))
  s = target / torch.clamp_min((dist * w).sum(-1) / ws, 1e-8)
  T = torch.zeros(pts.shape[:-2] + (d + 1, d + 1), dtype=pts.dtype,
                  device=pts.device)
  for i in range(d):
    T[..., i, i] = s
    T[..., i, d] = -mean[..., i] * s
  T[..., d, d] = 1.0
  return (pts - mean[..., None, :]) * s[..., None, None], T


def dlt(uv, X, K):
  """World->camera (R, t) of each (..., n, 2) / (..., n, 3) sample by the
  normalised DLT: the null vector of AᵀA (shifted inverse iteration, 8
  steps), sign so that the points lie in front, R the nearest rotation."""
  w = torch.ones(uv.shape[:-1], dtype=uv.dtype, device=uv.device)
  ones = w[..., None]
  xn = (torch.cat([uv, ones], -1) @ inv3(K).T)[..., :2]
  xn, T2 = _normalize(xn, w, math.sqrt(2.0))
  Xn, T3 = _normalize(X, w, math.sqrt(3.0))
  Xh = torch.cat([Xn, ones], -1)
  zeros = torch.zeros_like(Xh)
  A = torch.cat([torch.cat([Xh, zeros, -xn[..., 0:1] * Xh], -1),
                 torch.cat([zeros, Xh, -xn[..., 1:2] * Xh], -1)], -2)
  M = A.transpose(-1, -2) @ A
  eps = 1e-7 * torch.diagonal(M, dim1=-2, dim2=-1).sum(-1) / 12.0 + 1e-30
  L, _ = torch.linalg.cholesky_ex(
      M + eps[..., None, None] * torch.eye(12, device=M.device))
  v = torch.full(M.shape[:-1] + (1,), 12 ** -0.5, dtype=M.dtype,
                 device=M.device)
  for _ in range(8):
    y = torch.linalg.solve_triangular(L, v, upper=False)
    v = torch.linalg.solve_triangular(L.transpose(-1, -2), y, upper=True)
    v = v / torch.clamp_min(torch.linalg.norm(v, dim=-2, keepdim=True),
                            1e-30)
  P = v[..., 0].reshape(v.shape[:-2] + (3, 4))
  P = inv3(T2) @ P @ T3
  P = P / torch.clamp_min(torch.linalg.norm(P[..., 2, :3], dim=-1),
                          1e-12)[..., None, None]
  depth = X @ P[..., 2, :3, None] + P[..., 2, 3, None, None]
  sign = torch.where(torch.sign(depth[..., 0]).sum(-1) >= 0, 1.0, -1.0)
  P = P * sign[..., None, None]
  return nearest_rotation(P[..., :3]), P[..., 3]


def project(X, K, R, t):
  pc = X @ R.transpose(-1, -2) + t[..., None, :]
  z = pc[..., 2]
  zs = torch.where(torch.abs(z) < 1e-8, torch.full_like(z, 1e-8), z)
  return torch.stack([K[0, 0] * pc[..., 0] / zs + K[0, 2],
                      K[1, 1] * pc[..., 1] / zs + K[1, 2]], -1), z


def reprojection_errors(uv, X, K, R, t, max_err: float = 1e6):
  proj, z = project(X, K, R, t)
  err = torch.linalg.norm(proj - uv, dim=-1)
  return torch.clamp_max(torch.where(z > 1e-6, err,
                                     torch.full_like(err, max_err)), max_err)


def hat(w):
  wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
  z = torch.zeros_like(wx)
  return torch.stack([torch.stack([z, -wz, wy], -1),
                      torch.stack([wz, z, -wx], -1),
                      torch.stack([-wy, wx, z], -1)], -2)


def rodrigues(w):
  th2 = (w * w).sum(-1)
  th = torch.sqrt(th2 + 1e-24)
  small = th2 < 1e-12
  a = torch.where(small, 1.0 - th2 / 6.0, torch.sin(th) / th)
  b = torch.where(small, 0.5 - th2 / 24.0, (1.0 - torch.cos(th)) / th2)
  Wm = hat(w)
  eye = torch.eye(3, dtype=w.dtype, device=w.device).expand(Wm.shape)
  return eye + a[..., None, None] * Wm + b[..., None, None] * (Wm @ Wm)


def refine(uv, X, K, R, t, wts, iters: int = 10, damping: float = 1e-3):
  """Levenberg-Marquardt on the weighted reprojection error, a fixed
  number of steps, a step kept only where it lowers the cost; (T, ...)."""
  fx, fy = K[0, 0], K[1, 1]

  def resid(R, t):
    pc = X @ R.transpose(-1, -2) + t[..., None, :]
    z = torch.clamp_min(pc[..., 2], 1e-6)
    r = torch.stack([fx * pc[..., 0] / z + K[0, 2] - uv[..., 0],
                     fy * pc[..., 1] / z + K[1, 2] - uv[..., 1]], -1)
    return r, pc, z

  def cost(r):
    return (wts * (r * r).sum(-1)).sum(-1)

  eye6 = torch.eye(6, dtype=uv.dtype, device=uv.device)
  lam = torch.full(wts.shape[:-1], damping, dtype=uv.dtype, device=uv.device)
  c = cost(resid(R, t)[0])
  for _ in range(iters):
    r, pc, z = resid(R, t)
    zi = 1.0 / z
    zero = torch.zeros_like(z)
    Jp = torch.stack([torch.stack([fx * zi, zero, -fx * pc[..., 0] * zi * zi],
                                  -1),
                      torch.stack([zero, fy * zi, -fy * pc[..., 1] * zi * zi],
                                  -1)], -2)
    J = torch.cat([-Jp @ hat(pc), Jp], -1)                   # (.., n, 2, 6)
    lead = J.shape[:-3]
    Jf = J.reshape(lead + (-1, 6))
    wJr = (wts[..., None, None] * torch.cat([J, r[..., None]], -1)
           ).reshape(lead + (-1, 7))
    G = Jf.transpose(-1, -2) @ wJr
    JTJ, JTr = G[..., :6], G[..., 6]
    tr = torch.diagonal(JTJ, dim1=-2, dim2=-1).sum(-1)
    H = JTJ + (lam * torch.clamp_min(tr / 6.0, 1e-8))[..., None, None] * eye6
    d = -torch.linalg.solve_ex(H, JTr[..., None])[0][..., 0]
    dR = rodrigues(d[..., :3])
    R1 = dR @ R
    t1 = (dR @ t[..., None])[..., 0] + d[..., 3:]
    c1 = cost(resid(R1, t1)[0])
    ok = c1 < c
    R = torch.where(ok[..., None, None], R1, R)
    t = torch.where(ok[..., None], t1, t)
    c = torch.where(ok, c1, c)
    lam = torch.where(ok, lam * 0.5, lam * 4.0)
  return R, t


def solve(x, P, K, draws, rc: dict, stride: int, prec: Precision = REFERENCE):
  """The pose of each (T, h, w, 3) posterior map with (T, h, w, 1)
  variances: the ``top_k`` most confident cells (lowest variance), one
  hypothesis per row of ``draws`` ((T, M, k) Exp(1) keys; a hypothesis
  takes the ``sample_size`` cells with the largest 1/key), scored by
  inliers under ``inlier_threshold_px``, the best polished by LM on its
  inliers. Returns (T_wc (T, 4, 4), inliers (T,))."""
  with tf32_mode(prec.tf32):
    T, h, w = x.shape[:3]
    n = h * w
    k = min(rc["top_k"], n)
    X = x.reshape(T, n, 3)
    score = -P.reshape(T, n)
    idx = torch.topk(score, k).indices
    grid = cell_centers(h, w, stride, x.device).expand(T, n, 2)
    uv, Xk = _take(grid, idx), _take(X, idx)
    wts = torch.ones((T, k), dtype=torch.float32, device=x.device)
    sample = torch.topk(1.0 / draws, rc["sample_size"], dim=-1).indices
    R, t = dlt(_take(uv, sample), _take(Xk, sample), K)
    errs = reprojection_errors(uv[:, None], Xk[:, None], K, R, t)
    inl = (errs < rc["inlier_threshold_px"]).float()
    best = torch.argmax(inl.sum(-1), dim=-1)
    pick = lambda a: a[torch.arange(T, device=a.device), best]
    R, t = refine(uv, Xk, K, pick(R), pick(t), pick(inl),
                  iters=rc["refine_iters"])
    err = reprojection_errors(uv, Xk, K, R, t)
    n_in = (err < rc["refine_threshold_px"]).float().sum(-1)
    Rt = R.transpose(-1, -2)
    T_wc = torch.zeros((T, 4, 4), dtype=torch.float32, device=x.device)
    T_wc[:, :3, :3] = Rt
    T_wc[:, :3, 3] = -(Rt @ t[..., None])[..., 0]
    T_wc[:, 3, 3] = 1.0
  return T_wc, n_in
