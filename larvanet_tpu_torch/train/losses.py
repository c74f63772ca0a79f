"""Loss functions for the SR zoo (larvanet_tpu/train/losses.py), on NHWC
tensors.

  * l1_loss          - torch nn.L1Loss (every stepwise trainer,
                       reference models/edsr.py:55).
  * robust_sqrt_loss - mean((|o-t|+eps)^0.5), reference models/edsr_loss.py:35-37.
  * multi_exit_l1    - mean of per-exit L1s, the LarvaNet family's
                       objective (reference models/LarvaNet.py:101-109).
"""

from __future__ import annotations

from typing import Sequence

import torch


def l1_loss(pred: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    """Mean absolute error (torch nn.L1Loss parity)."""
    return torch.mean(torch.abs(pred - target))


def robust_sqrt_loss(pred: torch.Tensor, target: torch.Tensor,
                     eps: float = 1e-5) -> torch.Tensor:
    """mean((|pred-target| + eps)^0.5), reference models/edsr_loss.py:35-37."""
    return torch.mean(torch.sqrt(torch.abs(pred - target) + eps))


def multi_exit_l1(outputs: Sequence[torch.Tensor], target: torch.Tensor) -> torch.Tensor:
    """Average L1 over early-exit outputs (LarvaNet/TreeNet objective)."""
    losses = [l1_loss(o, target) for o in outputs]
    return sum(losses) / len(losses)
