"""PixelShuffle (depth-to-space) on NHWC with PyTorch's channel order, and
its inverse.

Copy of larvanet_tpu/ops/pixel_shuffle.py:22-41: torch's NCHW shuffle
reads the channel axis as (C, r, r),

    out[n, h*r + i, w*r + j, c] = x[n, h, w, c*r*r + i*r + j],

so reference `.pth` upsample kernels line up without a permutation.
"""

from __future__ import annotations

import torch
from torch import nn


def pixel_shuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """[N, H, W, C*r*r] -> [N, H*r, W*r, C], contiguous."""
    n, h, w, crr = x.shape
    if crr % (r * r) != 0:
        raise ValueError("channels %d not divisible by r^2=%d" % (crr, r * r))
    c = crr // (r * r)
    x = x.reshape(n, h, w, c, r, r).permute(0, 1, 4, 2, 5, 3)  # n, h, i, w, j, c
    return x.reshape(n, h * r, w * r, c)


def pixel_unshuffle(x: torch.Tensor, r: int) -> torch.Tensor:
    """Inverse of `pixel_shuffle`: [N, H*r, W*r, C] -> [N, H, W, C*r*r],
    contiguous (the LR-domain training targets and the collapsed base)."""
    n, hr, wr, c = x.shape
    if hr % r or wr % r:
        raise ValueError("spatial dims (%d,%d) not divisible by r=%d" % (hr, wr, r))
    h, w = hr // r, wr // r
    x = x.reshape(n, h, r, w, r, c).permute(0, 1, 3, 5, 2, 4)  # n, h, w, c, i, j
    return x.reshape(n, h, w, c * r * r)


class PixelShuffle(nn.Module):
    """NHWC `pixel_shuffle` as a module (owns no parameters)."""

    def __init__(self, r: int):
        super().__init__()
        self.r = r

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return pixel_shuffle(x, self.r)
