"""Ensembles at inference (larvanet_tpu/eval/ensemble.py).

* `EnsembleForward`: K checkpoints of one module over the same NHWC
  batch. JAX vmaps the forward over stacked parameter trees in one jit;
  here the members run in turn through the one module
  (`torch.func.functional_call`, each member's tensors swapped in), and
  the mean is taken on the device.
* `self_ensemble_forward`: x8 dihedral test-time augmentation. Each of the
  eight orientations of the batch (a rotation by k quarter turns, with or
  without a flip of the width axis) goes through the forward, is turned
  back, and the eight outputs are averaged on the device. `torch.rot90`
  and `flip` return views that are not contiguous, and the conv kernel
  takes only contiguous NHWC input, so each orientation is made
  contiguous before the forward.
"""

from __future__ import annotations

from typing import Callable, Dict, Sequence

import torch
from torch import nn


class EnsembleForward:
    """K checkpoints (state_dicts of `module`'s keys) of one topology."""

    def __init__(self, module: nn.Module, state_dicts: Sequence[Dict[str, torch.Tensor]]):
        device = next(module.parameters()).device
        self.module = module
        self.members = [{k: v.to(device) for k, v in sd.items()} for sd in state_dicts]
        self.k = len(self.members)

    @torch.no_grad()
    def all(self, x: torch.Tensor) -> torch.Tensor:
        """(K, N, H*s, W*s, C): each member's output."""
        return torch.stack([torch.func.functional_call(self.module, member, (x,))
                            for member in self.members])

    def mean(self, x: torch.Tensor) -> torch.Tensor:
        """(N, H*s, W*s, C): the members' mean, taken on the device."""
        return self.all(x).mean(0)


def _orient(x: torch.Tensor, k: int, flip: bool) -> torch.Tensor:
    if flip:
        x = x.flip(2)
    return torch.rot90(x, k, dims=(1, 2))


def _unorient(y: torch.Tensor, k: int, flip: bool) -> torch.Tensor:
    y = torch.rot90(y, -k, dims=(1, 2))
    if flip:
        y = y.flip(2)
    return y


def self_ensemble_forward(forward: Callable[[torch.Tensor], torch.Tensor]):
    """`forward` (NHWC batch -> NHWC output) averaged over the 8 dihedral
    orientations of its input."""

    @torch.no_grad()
    def fn(x: torch.Tensor) -> torch.Tensor:
        outs = []
        for flip in (False, True):
            for k in range(4):
                y = forward(_orient(x, k, flip).contiguous())
                outs.append(_unorient(y, k, flip))
        return torch.stack(outs).mean(0)

    return fn
