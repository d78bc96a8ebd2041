"""Plain PyTorch reference of ESAC (Brachmann & Rother, ICCV 2019,
arXiv:1908.02484) as the benchmark's configuration ``esac-*`` states it:
the gating net, any expert on any frame, each hypothesis's expert drawn
from the gating, and the multi-map P3P-RANSAC pose with an LM polish. It
imports nothing of the program under test: it reads the configuration
dict, the raw uint8 frames and the weights the benchmark made
(``families/esac.py``: {"gating": {layer: {"w", "b"}, "fc"}, "experts":
{layer: {"w" (M, ...), "b" (M, ...)}, "centre" (M, 3)}}, float32).

Written from the paper and DSAC*'s network (arXiv:2002.12324, its
``network.py``), with these departures, each also in the configuration's
``assumed``:

* the expert's layers are DSAC*'s (ESAC's own expert file is not public);
* the gating net is the expert's stem and res1 at a quarter of its widths,
  a global average pool and one linear layer (ESAC's gating widths are
  not public); its last layer is not trained: it is the benchmark's
  seeded stand-in for a trained classifier of scene parts, its
  temperature in its weights;
* input luma is 0.299 R + 0.587 G + 0.114 B in float32, not rounded to
  uint8 as an image library's grayscale conversion would;
* a hypothesis is scored by its hard inlier count (ESAC: a soft, sigmoid
  count), and the winner is polished by a fixed number of
  Levenberg-Marquardt steps on its inliers (ESAC: iterative re-fitting);
* every cell of the expert's map takes part in the draws (no confidence).

The P3P solver is Grunert's in Haralick et al.'s form (1994): the quartic
by Durand-Kerner in complex64, 40 iterations from the powers of 0.4+0.9i,
a root invalid when its imaginary part exceeds 1e-3 or a distance is not
positive, an invalid root's pose that of unit distances (finite, and
scored like any other), the pose from the matched triads of the three
points. Scoring, the pick and the LM polish are ``kfnet_ref``'s.

Precision: ``Precision()`` is float32 everywhere with TF32 off. The
control is the same code one step lower: ``conv="fp8"`` rounds each expert
convolution's input and weight to float8 e4m3 and its output to bfloat16,
and ``tf32=True`` lets the gating's convolutions and every matrix product
(the gating's linear layer, the pose) run in TF32.

Layouts: frames (..., H, W, 3) uint8; maps (..., h, w, 3).
"""

from __future__ import annotations

import cmath
import dataclasses

import torch
import torch.nn.functional as F

from perfbench.reference import kfnet_ref as base

LUMA = (0.299, 0.587, 0.114)


@dataclasses.dataclass(frozen=True)
class Precision:
  conv: str = "float32"  # "float32" | "fp8" (the experts' convolutions)
  tf32: bool = False


REFERENCE = Precision()
CONTROL = Precision(conv="fp8", tf32=True)
tf32_mode = base.tf32_mode


# ---- the nets (NCHW float32) -----------------------------------------------


def luma(cfg: dict, frames: torch.Tensor) -> torch.Tensor:
  """(N, H, W, 3) uint8 -> (N, 1, H, W) normalised luma."""
  x = frames.to(torch.float32) / 255.0
  y = x[..., 0] * LUMA[0] + x[..., 1] * LUMA[1] + x[..., 2] * LUMA[2]
  return ((y - cfg["image_mean"]) / cfg["image_std"])[:, None]


def conv(x, p, stride: int, fp8: bool, tf32: bool):
  """A conv padded by (k - 1) / 2 on every side, as the published convs."""
  w = p["w"]
  if fp8:
    x, w = base._fp8(x), base._fp8(w)
  with tf32_mode(fp8 or tf32):
    y = F.conv2d(x, w, p["b"], stride=stride, padding=(w.shape[-1] - 1) // 2)
  if fp8:
    y = y.to(torch.bfloat16).to(torch.float32)
  return y


STEM = (("conv1", 1), ("conv2", 2), ("conv3", 2), ("conv4", 2))


def _stem_res1(p, x, fp8, tf32):
  for name, s in STEM:
    x = torch.relu(conv(x, p[name], s, fp8, tf32))
  res = x
  for name in ("res1_conv1", "res1_conv2", "res1_conv3"):
    x = torch.relu(conv(x, p[name], 1, fp8, tf32))
  return res + x


def gating_features(params, cfg: dict, frames, prec: Precision = REFERENCE):
  """(N, H, W, 3) uint8 -> (N, C): the gating's pooled res1 features."""
  return _stem_res1(params["gating"], luma(cfg, frames), False,
                    prec.tf32).mean((-2, -1))


def gate(params, cfg: dict, frames, prec: Precision = REFERENCE):
  """(N, H, W, 3) uint8 -> (N, M) gating probabilities: softmax of the
  linear layer of the pooled res1 features."""
  g = params["gating"]
  feat = gating_features(params, cfg, frames, prec)
  with tf32_mode(prec.tf32):
    logits = feat @ g["fc"]["w"].T + g["fc"]["b"]
  return torch.softmax(logits, dim=-1)


def expert(params, cfg: dict, m: int, frames, prec: Precision = REFERENCE):
  """Expert ``m`` on (N, H, W, 3) uint8 frames -> (N, h, w, 3), a frame at a
  time (memory)."""
  e = {k: {"w": v["w"][m], "b": v["b"][m]}
       for k, v in params["experts"].items() if k != "centre"}
  fp8 = prec.conv == "fp8"
  out = []
  for f in frames:
    x = luma(cfg, f[None])
    res = _stem_res1(e, x, fp8, prec.tf32)
    x = res
    for name in ("res2_conv1", "res2_conv2", "res2_conv3"):
      x = torch.relu(conv(x, e[name], 1, fp8, prec.tf32))
    res = conv(res, e["res2_skip"], 1, fp8, prec.tf32) + x
    x = res
    for name in ("res3_conv1", "res3_conv2", "res3_conv3"):
      x = torch.relu(conv(x, e[name], 1, fp8, prec.tf32))
    x = res + x
    x = torch.relu(conv(x, e["fc1"], 1, fp8, prec.tf32))
    x = torch.relu(conv(x, e["fc2"], 1, fp8, prec.tf32))
    x = conv(x, e["fc3"], 1, fp8, prec.tf32)
    out.append(x[0].permute(1, 2, 0) + params["experts"]["centre"][m])
  return torch.stack(out)


def draw_experts(probs, uniforms):
  """(N, M) probabilities, (N, H) uniforms -> (N, H): the number of
  cumulative probabilities at or below the uniform (the inverse CDF), the
  last expert past rounding."""
  cdf = torch.cumsum(probs, dim=-1)
  e = (cdf[:, None, :] <= uniforms[..., None]).sum(-1)
  return torch.clamp_max(e, probs.shape[-1] - 1)


# ---- P3P (Grunert, Haralick et al.'s form) --------------------------------


def quartic_roots(c, iters: int = 40):
  """Roots of (..., 5) real quartics [A4..A0] by Durand-Kerner, complex64."""
  a4 = c[..., :1]
  a4 = torch.where(a4.abs() < 1e-12, torch.full_like(a4, 1e-12), a4)
  c = (c / a4).to(torch.complex64)
  r, th = cmath.polar(0.4 + 0.9j)
  k = torch.arange(1, 5, dtype=torch.float32, device=c.device)
  z = torch.polar(r ** k, th * k).expand(c.shape[:-1] + (4,))
  eye = torch.eye(4, dtype=torch.complex64, device=c.device)
  for _ in range(iters):
    d = z[..., :, None] - z[..., None, :] + eye
    p = (((z + c[..., 1:2]) * z + c[..., 2:3]) * z + c[..., 3:4]) * z \
        + c[..., 4:5]
    z = z - p / d.prod(-1)
  return z


def _unit(a):
  return a / torch.clamp_min(a.norm(dim=-1, keepdim=True), 1e-12)


def _frame_of(P):
  """Orthonormal triad (columns) of (..., 3, 3) points."""
  a = P[..., 1, :] - P[..., 0, :]
  b = P[..., 2, :] - P[..., 0, :]
  u1, u3 = _unit(a), _unit(torch.linalg.cross(a, b, dim=-1))
  return torch.stack([u1, torch.linalg.cross(u3, u1, dim=-1), u3], -1)


def p3p(uv, X, K):
  """(..., 3, 2) pixels and (..., 3, 3) points -> 4 world->camera (R, t)
  candidates, (..., 4, 3, 3) and (..., 4, 3)."""
  rays = torch.cat([uv, torch.ones_like(uv[..., :1])], -1) @ base.inv3(K).T
  f = rays / rays.norm(dim=-1, keepdim=True)
  dot = lambda a, b: (a * b).sum(-1)
  X0, X1, X2 = X[..., 0, :], X[..., 1, :], X[..., 2, :]
  a2, b2, c2 = dot(X1 - X2, X1 - X2), dot(X0 - X2, X0 - X2), dot(X0 - X1,
                                                                 X0 - X1)
  ca = dot(f[..., 1, :], f[..., 2, :])
  cb = dot(f[..., 0, :], f[..., 2, :])
  cg = dot(f[..., 0, :], f[..., 1, :])
  b2s = torch.where(b2.abs() < 1e-12, torch.full_like(b2, 1e-12), b2)
  q1, q2 = (a2 - c2) / b2s, (a2 + c2) / b2s
  coeffs = torch.stack([
      (q1 - 1) ** 2 - 4 * (c2 / b2s) * ca ** 2,
      4 * (q1 * (1 - q1) * cb - (1 - q2) * ca * cg
           + 2 * (c2 / b2s) * ca ** 2 * cb),
      2 * (q1 ** 2 - 1 + 2 * q1 ** 2 * cb ** 2
           + 2 * ((b2 - c2) / b2s) * ca ** 2 - 4 * q2 * ca * cb * cg
           + 2 * ((b2 - a2) / b2s) * cg ** 2),
      4 * (-q1 * (1 + q1) * cb + 2 * (a2 / b2s) * cg ** 2 * cb
           - (1 - q2) * ca * cg),
      (1 + q1) ** 2 - 4 * (a2 / b2s) * cg ** 2], -1)
  roots = quartic_roots(coeffs)
  v = roots.real
  ca, cb, cg, q1, b2 = (t[..., None] for t in (ca, cb, cg, q1, b2))
  du = 2 * (cg - v * ca)
  du = torch.where(du.abs() < 1e-9, torch.full_like(du, 1e-9), du)
  u = ((q1 - 1) * v ** 2 - 2 * q1 * cb * v + 1 + q1) / du
  s1 = torch.sqrt(torch.clamp_min(
      b2 / torch.clamp_min(1 + v ** 2 - 2 * v * cb, 1e-9), 1e-12))
  bad = (roots.imag.abs() > 1e-3) | (v <= 1e-6) | (u * s1 <= 1e-6) | (
      v * s1 <= 1e-6)
  s = torch.where(bad[..., None], torch.ones_like(s1)[..., None],
                  torch.stack([s1, u * s1, v * s1], -1))
  Pc = f[..., None, :, :] * s[..., None]                  # (..., 4, 3, 3)
  Xw = X[..., None, :, :]
  R = _frame_of(Pc) @ _frame_of(Xw).transpose(-1, -2)
  t = Pc.mean(-2) - (R @ Xw.mean(-2)[..., None])[..., 0]
  return R, t


# ---- the multi-map solve ----------------------------------------------------


def solve(maps, map_of, K, draws, rc: dict, stride: int,
          prec: Precision = REFERENCE):
  """The pose of each of T frames from a stack of E (E, h, w, 3) maps:
  hypothesis m of frame t takes the 3 cells of map ``map_of[t, m]`` with
  the largest 1 / key of ``draws`` (T, M, h·w) (Exp(1) keys), P3P's 4
  candidates are scored by their inliers on that map under
  ``inlier_threshold_px``, the best is polished by LM on its inliers on its
  map. Returns (T_wc (T, 4, 4), inliers (T,))."""
  with tf32_mode(prec.tf32):
    E, h, w = maps.shape[:3]
    T = map_of.shape[0]
    X = maps.reshape(E, h * w, 3)
    grid = base.cell_centers(h, w, stride, maps.device)
    sample = torch.topk(1.0 / draws, 3, dim=-1).indices     # (T, M, 3)
    Xh = X[map_of]                                          # (T, M, N, 3)
    X3 = torch.take_along_dim(Xh, sample[..., None], dim=-2)
    R, t = p3p(grid[sample], X3, K)                         # (T, M, 4, ...)
    errs = base.reprojection_errors(grid, Xh[:, :, None], K, R, t)
    inl = (errs < rc["inlier_threshold_px"]).float().flatten(1, 2)
    best = torch.argmax(inl.sum(-1), dim=-1)                # (T,) in 4M
    ar = torch.arange(T, device=maps.device)
    mb = map_of[ar, best // 4]
    R0, t0 = R.flatten(1, 2)[ar, best], t.flatten(1, 2)[ar, best]
    uv = grid.expand(T, -1, -1)
    R, t = base.refine(uv, X[mb], K, R0, t0, inl[ar, best],
                       iters=rc["refine_iters"])
    err = base.reprojection_errors(uv, X[mb], K, R, t)
    n_in = (err < rc["refine_threshold_px"]).float().sum(-1)
    Rt = R.transpose(-1, -2)
    T_wc = torch.zeros((T, 4, 4), dtype=torch.float32, device=maps.device)
    T_wc[:, :3, :3] = Rt
    T_wc[:, :3, 3] = -(Rt @ t[..., None])[..., 0]
    T_wc[:, 3, 3] = 1.0
  return T_wc, n_in
