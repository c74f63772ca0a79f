"""TreeNet (larvanet_tpu/models/treenet.py; reference models/TreeNet.py): a
shared trunk and independent branches, NHWC.

  common parts:  conv 3 -> 48 with LeakyReLU(0.1) fused in its epilogue,
                 then --num_common_blocks ResBlocks
  branch b:      --num_branch_blocks ResBlocks -> PixelShuffle(scale) ->
                 + the interpolated base (computed once); the 48 channels
                 shuffle to RGB at x4 only, as in JAX and the reference

Parameters carry the reference's state_dict names, the ones
larvanet_tpu/utils/torch_convert.py:528-538 exports: `common_parts.0`,
`common_parts.2.<i>.body.{0,2}` and `branch_<b>.<i>.body.{0,2}`.
`TreeNetModule.walk(x, pair, branches, lr_domain)` is the family's one
topology (ops/packed/branchy.py:18-70): its ResBlock pairs go to
`pair(idx, h, conv1, conv2, kind="res", res_weight=...)`, the common
blocks first, then the selected branch's (the int8 forward runs branch 0,
the reference's inference branch); `branches` is an int or "all" (a list,
one output per branch); `lr_domain` (training) returns every branch before
its shuffle with the base unshuffled once. Serving and the CLIs run
branch 0; `validate_tree` scores every branch (`upscale_branch_device`).

Training (treenet.py:139-218): AdamW on the mean of every branch's L1
loss at a StepLR's learning rate stepped after every batch, in the
volume-driven loop of the train_larva CLI (models/volume.StepVolumeMixin);
while --packed_trunk is not 0 (unset is JAX's 1) through `training_pair`
(--qat 1, --remat 1) with the loss before the shuffle under
--lr_domain_loss 1. Every restore is partial (strict=False), as the
reference's (TreeNet.py:105).
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional, Union

import torch
from torch import nn

from larvanet_tpu_torch.core.config import parse_known
from larvanet_tpu_torch.core.registry import register_model
from larvanet_tpu_torch.models.base import (SRModel, add_training_flags, qat_requested,
                                            remat_requested)
from larvanet_tpu_torch.models.layers import Conv3x3, ResBlock, exact_pair, interpolated_base
from larvanet_tpu_torch.models.volume import StepVolumeMixin
from larvanet_tpu_torch.ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle
from larvanet_tpu_torch.train.losses import multi_exit_l1

FEATURES = 48
INIT_SCALE = 0.1  # kaiming_normal_ x 0.1, zero bias (reference TreeNet.py)

Branches = Union[str, int]


class TreeNetModule(nn.Module):
    """The shared trunk and the branches (reference TreeNet.py:226-264)."""

    def __init__(self, num_common_blocks: int = 8, num_branches: int = 1,
                 num_branch_blocks: int = 8, interpolate: str = "bicubic",
                 res_weight: float = 1.0, scale: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.num_branches, self.interpolate, self.scale = num_branches, interpolate, scale
        block = lambda: ResBlock(FEATURES, res_weight, g, init_scale=INIT_SCALE)  # noqa: E731
        # the reference's Sequential(conv, LeakyReLU, Sequential(ResBlocks))
        self.common_parts = nn.ModuleList([
            Conv3x3(3, FEATURES, act="leaky_relu", generator=g, init_scale=INIT_SCALE),
            nn.Identity(),
            nn.ModuleList([block() for _ in range(num_common_blocks)])])
        for b in range(num_branches):
            setattr(self, "branch_%d" % b,
                    nn.ModuleList([block() for _ in range(num_branch_blocks)]))

    def branch(self, b: int) -> nn.ModuleList:
        return getattr(self, "branch_%d" % b)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.walk(x)

    def walk(self, x: torch.Tensor, pair: Callable = exact_pair, branches: Branches = 0,
             lr_domain: bool = False):
        common = self.common_parts[2]
        fea = self.common_parts[0](x)
        for i, blk in enumerate(common):
            fea = pair(i, fea, blk.body[0], blk.body[2], kind="res", res_weight=blk.res_weight)
        s = self.scale
        base = interpolated_base(x, s, self.interpolate)
        if lr_domain:
            base = pixel_unshuffle(base, s)

        def run_branch(b: int) -> torch.Tensor:
            h = fea
            for i, blk in enumerate(self.branch(b)):
                h = pair(len(common) + i, h, blk.body[0], blk.body[2], kind="res",
                         res_weight=blk.res_weight)
            return (h if lr_domain else pixel_shuffle(h, s)) + base

        if branches == "all":
            return [run_branch(b) for b in range(self.num_branches)]
        return run_branch(int(branches))

    def pairs(self):
        """Branch 0's conv pairs in the walk's order (the int8 forward's)."""
        blocks = list(self.common_parts[2]) + list(self.branch(0))
        return [(blk.body[0], blk.body[2]) for blk in blocks]


class TreeNet(StepVolumeMixin, SRModel):
    """The wrapper (larvanet_tpu/models/treenet.py:76-262)."""

    def parse_args(self, args):
        parser = argparse.ArgumentParser()
        parser.add_argument("--num_common_blocks", type=int, default=8,
                            help="The number of residual blocks.")
        parser.add_argument("--num_branches", type=int, default=1,
                            help="The number of branches.")
        parser.add_argument("--num_branch_blocks", type=int, default=8,
                            help="The number of residual blocks per branch.")
        parser.add_argument("--interpolate", type=str, default="bicubic",
                            help="Interpolation method.")
        parser.add_argument("--res_weight", type=float, default=1.0,
                            help="The scaling factor.")
        parser.add_argument("--lr", type=float, default=4e-4,
                            help="Initial learning rate.")
        parser.add_argument("--lr_decay", type=float, default=0.5,
                            help="Learning rate decay factor.")
        parser.add_argument("--lr_step", type=int, default=200000,
                            help="Learning rate decay step.")
        parser.add_argument("--val_volume", type=float, default=30e9,
                            help="How much volume need for validation.")
        parser.add_argument("--threshold", type=float, default=0.001,
                            help="Threshold for reduceLRonPlateau.")
        parser.add_argument("--min_lr", type=float, default=1e-8,
                            help="Minimum learning rate.")
        parser.add_argument("--patience", type=int, default=1,
                            help="patience for lr scheduler")
        add_training_flags(parser)
        self.args, remaining = parse_known(parser, args)
        return self.args, remaining

    def build_module(self, generator: torch.Generator) -> nn.Module:
        a = self.args
        return TreeNetModule(num_common_blocks=a.num_common_blocks,
                             num_branches=a.num_branches,
                             num_branch_blocks=a.num_branch_blocks,
                             interpolate=a.interpolate, res_weight=a.res_weight,
                             scale=self.scale, generator=generator)

    def _compute_loss(self, inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """The mean of every branch's L1 loss (treenet.py:164-178): while
        --packed_trunk is not 0, the walk through `training_pair` with the
        loss before the shuffle under --lr_domain_loss 1; else the module
        graph on the HR image."""
        from larvanet_tpu_torch.ops.pairs import training_pair

        if getattr(self.args, "packed_trunk", None) == 0:
            return multi_exit_l1(self.module.walk(inputs, branches="all"), targets)
        lr_domain = bool(getattr(self.args, "lr_domain_loss", 0))
        if lr_domain:
            targets = pixel_unshuffle(targets, self.scale)  # no backward
        pair = training_pair(qat_requested(self), remat_requested(self))
        return multi_exit_l1(self.module.walk(inputs, pair, "all", lr_domain), targets)

    def restore(self, ckpt_path: str, strict: bool = False) -> None:
        """Always partial, as the reference's (TreeNet.py:105, JAX :180-182)."""
        super().restore(ckpt_path, strict=False)

    def upscale_branch_device(self, input_list, scale, branch: int,
                              uint8: bool = False) -> torch.Tensor:
        """Launch branch `branch`'s forward and return the NHWC batch on the
        device without waiting for it (treenet.py:220-242), quantized to
        uint8 there with `upscale_device`'s rounding when `uint8`, so
        validate_tree's --pipeline_depth overlaps the pulls."""
        x = self._input_to_device(input_list).to(self.compute_dtype).contiguous()
        with torch.no_grad():
            out = self.serving_module.walk(x, branches=branch).float()
        if uint8:
            out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
        return out

    def upscale_branch(self, input_list, scale, branch: int):
        """Branch `branch`'s SR of CHW host frames -> (N, 3, sH, sW) float32
        numpy (treenet.py:244-249)."""
        out = self.upscale_branch_device(input_list, scale, branch)
        return out.cpu().numpy().transpose(0, 3, 1, 2)


@register_model("TreeNet")
def create_treenet():
    return TreeNet()
