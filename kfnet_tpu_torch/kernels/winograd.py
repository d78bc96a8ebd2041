"""Winograd F(2x2, 3x3) convolution as a 16-way batched matmul (port of
``kfnet_tpu/kernels/winograd.py``).

    Y = A^T [ (G g G^T) ⊙ (B^T d B) ] A        per 4x4 input tile,

with B and A entries in {0, ±1} (adds only) and G in {0, ±1/2}. The
channel contraction in the transform domain is one batched matmul,
(16, tiles, Cin) @ (16, Cin, Cout). It is plain PyTorch (the JAX module is
plain jnp, not a Pallas kernel) and differentiable through autograd.

Layouts are the port's: x (..., Cin, H, W) with H and W even, weights
(Cout, Cin, 3, 3); the output is (..., Cout, H, W) in channels-last
memory, as the convs the models call give.

Numerics, as in the JAX module: the weight transform runs in float32 on
the float32 params and rounds to the compute dtype once; the input and
output transforms are adds in the compute dtype and in float32; the
contraction accumulates in float32: on ``cuda`` ``torch.bmm(...,
out_dtype=torch.float32)`` on bf16 operands, on the CPU (and where a
gradient is needed: ``aten::bmm.dtype`` has no derivative) the operands
upcast to float32, as the JAX module does off the TPU. The bias is added
in float32 before the one rounding to the compute dtype.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

# G: weight transform (4x3)
_G = ((1.0, 0.0, 0.0),
      (0.5, 0.5, 0.5),
      (0.5, -0.5, 0.5),
      (0.0, 0.0, 1.0))
_G_ON: dict = {}  # G by device: made once, outside any CUDA graph capture


def _g(device) -> torch.Tensor:
  g = _G_ON.get(device)
  if g is None:
    g = _G_ON[device] = torch.tensor(_G, dtype=torch.float32, device=device)
  return g


def transform_weights(w: torch.Tensor, compute_dtype=torch.bfloat16):
  """(Cout, Cin, 3, 3) kernel -> (4, 4, Cin, Cout) Winograd domain, in
  float32 then rounded to ``compute_dtype`` once."""
  g = _g(w.device)
  wt = torch.einsum("ka,lb,dcab->klcd", g, g, w.to(torch.float32))
  return wt.to(compute_dtype)


def _bt(d):
  """B^T along a length-4 list: [d0-d2, d1+d2, d2-d1, d1-d3]."""
  return [d[0] - d[2], d[1] + d[2], d[2] - d[1], d[1] - d[3]]


def _at(m):
  """A^T along a length-4 list: [m0+m1+m2, m1-m2-m3]."""
  return [m[0] + m[1] + m[2], m[1] - m[2] - m[3]]


def _contract(u: torch.Tensor, wt: torch.Tensor) -> torch.Tensor:
  """(16, T, Cin) @ (16, Cin, Cout) with float32 accumulation."""
  if u.dtype == torch.float32:
    return torch.bmm(u, wt.to(torch.float32))
  needs_grad = torch.is_grad_enabled() and (u.requires_grad
                                            or wt.requires_grad)
  if u.is_cuda and not needs_grad:
    return torch.bmm(u, wt, out_dtype=torch.float32)
  return torch.bmm(u.to(torch.float32), wt.to(torch.float32))


def conv3x3_winograd(x: torch.Tensor, w: torch.Tensor,
                     bias: torch.Tensor | None = None,
                     compute_dtype=torch.bfloat16) -> torch.Tensor:
  """SAME stride-1 3x3 conv of x (..., Cin, H, W), H and W even, with
  w (Cout, Cin, 3, 3); returns (..., Cout, H, W) in ``compute_dtype``."""
  lead = tuple(x.shape[:-3])
  cin, h, wd = x.shape[-3:]
  if h % 2 or wd % 2:
    raise ValueError(f"conv3x3_winograd needs an even H and W, got "
                     f"{(h, wd)}")
  th, tw = h // 2, wd // 2
  xb = x.reshape((-1, cin, h, wd)).to(compute_dtype)
  b = xb.shape[0]
  wt = transform_weights(w, compute_dtype)  # (4, 4, Cin, Cout)
  cout = wt.shape[-1]
  xp = F.pad(xb, (1, 1, 1, 1))
  # tile (i, j) reads xp[2i + a, 2j + c] for a, c in 0..3
  tiles = [[xp[:, :, a:a + 2 * th:2, c:c + 2 * tw:2] for c in range(4)]
           for a in range(4)]
  # B^T d B: over the tile's rows, then its columns, as the JAX module
  cols = [_bt([tiles[a][c] for a in range(4)]) for c in range(4)]
  u = [_bt([cols[c][k] for c in range(4)]) for k in range(4)]
  u = torch.stack([t for r in u for t in r])    # (16, B, Cin, th, tw)
  u = u.permute(0, 1, 3, 4, 2).reshape(16, b * th * tw, cin)
  m = _contract(u, wt.reshape(16, cin, cout))   # (16, T, Cout) float32
  m = m.reshape(4, 4, b, th, tw, cout)
  # A^T m A: over rows (k), then columns (l)
  rows = _at([m[k] for k in range(4)])          # 2 x (4 l, B, th, tw, Co)
  y = torch.stack([torch.stack(_at([r[l] for l in range(4)]))
                   for r in rows])              # (2 i, 2 j, B, th, tw, Co)
  if bias is not None:
    y = y + bias.to(torch.float32)
  y = y.to(compute_dtype)
  y = y.permute(2, 3, 0, 4, 1, 5).reshape(b, h, wd, cout)
  return y.permute(0, 3, 1, 2).reshape(lead + (cout, h, wd))
