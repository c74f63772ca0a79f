"""EDSR-baseline (larvanet_tpu/models/edsr.py; reference models/edsr.py).

mean-shift -> conv 3->F -> N x ResBlock(res_weight) -> conv + global
skip -> UpsampleBlock (PixelShuffle) -> conv F->3 -> inverse mean-shift.
The module's state_dict keys are the reference's (`mean_shift`,
`first_conv`, `res_blocks.{i}.body.{0,2}`, `after_res_conv`,
`upsample.body.{0,2}`, `final_conv`, `mean_inverse_shift`), the keys
larvanet_tpu/utils/torch_convert.py:470-479 exports.

`edsr_loss` is the same network (its robust loss matters only to
training, which is not ported yet).
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch
from torch import nn

from larvanet_tpu_torch.core.config import parse_known
from larvanet_tpu_torch.core.registry import register_model
from larvanet_tpu_torch.models.base import SRModel
from larvanet_tpu_torch.models.layers import (Conv3x3, MeanShift, ResBlock,
                                              UpsampleBlock)


class EDSRModule(nn.Module):
    def __init__(self, features: int = 64, num_blocks: int = 16,
                 res_weight: float = 1.0, scale: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.features = features
        self.mean_shift = MeanShift(sign=1.0)
        self.first_conv = Conv3x3(3, features, generator=g)
        self.res_blocks = nn.ModuleList(
            [ResBlock(features, res_weight=res_weight, generator=g)
             for _ in range(num_blocks)])
        self.after_res_conv = Conv3x3(features, features, generator=g)
        self.upsample = UpsampleBlock(features, scale, generator=g)
        self.final_conv = Conv3x3(features, 3, generator=g)
        self.mean_inverse_shift = MeanShift(sign=-1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.first_conv(self.mean_shift(x))
        res = x
        for block in self.res_blocks:
            res = block(res)
        x = x + self.after_res_conv(res)
        x = self.final_conv(self.upsample(x))
        return self.mean_inverse_shift(x)


class EDSR(SRModel):
    def parse_args(self, args):
        parser = argparse.ArgumentParser()
        parser.add_argument("--edsr_conv_features", type=int, default=64,
                            help="The number of convolutional features.")
        parser.add_argument("--edsr_res_blocks", type=int, default=16,
                            help="The number of residual blocks.")
        parser.add_argument("--edsr_res_weight", type=float, default=1.0,
                            help="The scaling factor.")
        self.args, remaining = parse_known(parser, args)
        return self.args, remaining

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return EDSRModule(features=self.args.edsr_conv_features,
                          num_blocks=self.args.edsr_res_blocks,
                          res_weight=self.args.edsr_res_weight,
                          scale=self.scale, generator=generator)


@register_model("edsr")
def create_edsr():
    return EDSR()


@register_model("edsr_loss")
def create_edsr_loss():
    return EDSR()
