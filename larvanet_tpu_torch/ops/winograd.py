"""Winograd F(2x2, 3x3) convolution and the EDSR forward on it, in plain
PyTorch: the port of larvanet_tpu/ops/winograd.py.

F(2x2, 3x3) computes a 2x2 output tile with 16 point products of the
channels (a (M, C) x (C, K) product each) instead of 4 x 9 = 36, at the
cost of add-only transforms: V = B^T d B of each 4x4 input tile, U = G g
G^T of each kernel (`transform_weights`), Y = A^T (U . V) A. The JAX
package computes these in XLA, outside any Pallas kernel, so here the
transforms are torch ops and the point products `torch.matmul`; the
serving routes reach the fused Winograd ResBlock kernel instead
(ops/wino_resblock.py, `--wino_trunk`). This module is kept for parity
with the JAX package: no CLI routes to it.

Numerics as in JAX: the transforms in float32, the point products of
operands rounded to `dtype` summed in float32, the result stored in
`dtype`; not bit-equal to a direct conv (the sums are taken in another
order). Borders are those of a SAME conv: the input is zero-padded before
the transform.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# F(2x2, 3x3) transform (Winograd / Toom-Cook with points {0, 1, -1, inf});
# B^T and A^T are 0 / +-1, so those transforms are additions
_G = ((1.0, 0.0, 0.0), (0.5, 0.5, 0.5), (0.5, -0.5, 0.5), (0.0, 0.0, 1.0))


def transform_weights(k_hwio: torch.Tensor) -> torch.Tensor:
    """(3, 3, C, K) -> (16, C, K): U = G g G^T per channel pair, float32."""
    g = torch.tensor(_G, dtype=torch.float32, device=k_hwio.device)
    k = k_hwio.float()
    u = torch.einsum("ai,ijck,bj->abck", g, k, g)
    return u.reshape(16, k.shape[2], k.shape[3])


def _bt4(d0, d1, d2, d3):
    """B^T along one axis (additions)."""
    return d0 - d2, d1 + d2, d2 - d1, d1 - d3


def _at4(m0, m1, m2, m3):
    """A^T along one axis (additions)."""
    return m0 + m1 + m2, m1 - m2 - m3


def wino_conv3x3(x: torch.Tensor, u16: torch.Tensor, bias: Optional[torch.Tensor],
                 dtype: torch.dtype) -> torch.Tensor:
    """SAME 3x3 conv of NHWC `x` by the transformed weights `u16`
    (`transform_weights`) in F(2x2, 3x3) tiles; returns (N, H, W, K) in
    `dtype`."""
    n, h, w, c = x.shape
    k = u16.shape[-1]
    th, tw = -(-h // 2), -(-w // 2)
    # rows and columns -1 .. 2t inclusive: a padded length of 2t + 2
    p = F.pad(x.float(), (0, 0, 1, 2 * tw + 1 - w, 1, 2 * th + 1 - h))
    # the 16 strided views d[i][j][tile] = p[2 t_h + i, 2 t_w + j]
    d = [[p[:, i:i + 2 * th:2, j:j + 2 * tw:2, :] for j in range(4)] for i in range(4)]
    t = [_bt4(d[0][j], d[1][j], d[2][j], d[3][j]) for j in range(4)]
    v = [_bt4(t[0][a], t[1][a], t[2][a], t[3][a]) for a in range(4)]
    # (16, M, C) rounded to the product dtype, summed in f32
    vv = torch.stack([v[a][b].reshape(n * th * tw, c) for a in range(4)
                      for b in range(4)]).to(dtype).float()
    m = torch.matmul(vv, u16.to(dtype).float()).reshape(4, 4, n, th, tw, k)
    ta = [_at4(m[0, b], m[1, b], m[2, b], m[3, b]) for b in range(4)]
    y = [_at4(ta[0][u], ta[1][u], ta[2][u], ta[3][u]) for u in range(2)]
    # y[u][v]: (N, th, tw, K) -> interleaved (N, 2 th, 2 tw, K)
    out = torch.stack([torch.stack(y[u], dim=3) for u in range(2)], dim=2)
    out = out.reshape(n, 2 * th, 2 * tw, k)[:, :h, :w, :]
    if bias is not None:
        out = out + bias.float()
    return out.to(dtype)


def _conv(layer, h: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """A Conv3x3 layer's conv in Winograd tiles, its weights transformed
    from the live parameters on every call (as JAX does)."""
    u = transform_weights(layer.weight.permute(2, 3, 1, 0))
    return wino_conv3x3(h, u, layer.bias, dtype)


def make_winograd_edsr_forward(model, dtype: torch.dtype = torch.float32):
    """EDSR's forward with a Winograd F(2x2, 3x3) trunk and the collapsed
    tail (JAX's make_winograd_edsr_forward, ops/winograd.py:103-144): the
    mean shift and first_conv direct (C_in = 3), every trunk 3x3 (the two
    of each ResBlock and after_res_conv) in Winograd tiles, the global
    skip, then the baked collapsed tail (ops/collapsed_tail.py; the
    module's own tail where the mean shifts are not the intended ones).
    Returns forward(x) for an NHWC batch on the model's device."""
    from larvanet_tpu_torch.ops.collapsed_tail import collapsed_edsr_tail

    module = model.module

    @torch.no_grad()
    def forward(x: torch.Tensor) -> torch.Tensor:
        h = module.first_conv(module.mean_shift(x.to(dtype)))
        res = h
        for block in module.res_blocks:
            t = torch.relu(_conv(block.body[0], res, dtype))
            t = _conv(block.body[2], t, dtype)
            rw = block.res_weight
            res = res + (t * torch.tensor(rw, dtype=dtype, device=t.device) if rw != 1.0
                         else t)
        fused = h + _conv(module.after_res_conv, res, dtype)
        tail = collapsed_edsr_tail(model)
        if tail is None:
            return module.mean_inverse_shift(module.final_conv(module.upsample(fused)))
        return tail(fused)

    return forward
