"""IMDN, the AIM 2019 information multi-distillation network
(larvanet_tpu/models/imdn.py; reference models/imdn_aim2019.py).

mean-shift -> conv 3->F -> N x IMDBlock -> conv + global skip -> conv
F -> 3 s^2 -> PixelShuffle(s) -> inverse mean-shift (imdn.py:47-67). An
IMDBlock is a four-stage progressive channel split at distill rate 0.25 (d =
F / 4 distilled, r = F - d passed on; 16 and 48 at F = 64): conv1 F -> F,
conv2 and conv3 r -> F, conv4 r -> d, each with LeakyReLU(0.05) fused in
the conv3x3 kernel's epilogue; the four distilled slices are concatenated
and fused by a 1x1 conv (`Conv1x1`, `torch.matmul`, as JAX leaves it to
XLA), then the residual add (imdn.py:25-44). The state_dict keys are the
reference's (`res_blocks.{i}.conv{1..4}.0`, `res_blocks.{i}.conv5`,
`upsample.body.0`; larvanet_tpu/utils/torch_convert.py:514-526).

The conv kernel takes a contiguous NHWC input, and the remaining channels
of a stage are a strided slice, so each block copies rem1, rem2 and rem3
(`.contiguous()`): three copies a block, counted in `SLICE_COPIES`.

Every route runs this module graph: JAX's --packed_trunk (default 0 for the
model, 1 in its inference CLIs) is a width-packed reparametrisation of the
same function (ops/packed/light.py:147-241), which the port does not run;
the flag is accepted. IMDN has no int8 path in JAX: --int8_trunk prints
JAX's "...; ignoring" line and keeps the exact route. Training: Adam and L1
at --learning_rate (1e-4) halved every 200k steps, the module's forward.
"""

from __future__ import annotations

import argparse
from typing import Optional

import torch
from torch import nn

from larvanet_tpu_torch.core.config import parse_known
from larvanet_tpu_torch.core.registry import register_model
from larvanet_tpu_torch.models.base import SRModel, StepDecayMixin, TrainedMeanShiftMixin
from larvanet_tpu_torch.models.layers import Conv1x1, Conv3x3, ConvShuffle, MeanShift

DISTILL_RATE = 0.25
SLOPE = 0.05

# the rem1 / rem2 / rem3 copies made since the last reset
SLICE_COPIES = 0


def reset_slice_copies() -> None:
    global SLICE_COPIES
    SLICE_COPIES = 0


def _contiguous(t: torch.Tensor) -> torch.Tensor:
    global SLICE_COPIES
    SLICE_COPIES += 1
    return t.contiguous()


class IMDBlock(nn.Module):
    def __init__(self, features: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        d = int(features * DISTILL_RATE)
        r = features - d
        self.distilled = d

        def conv(c, f):
            # the reference's Sequential(conv, LeakyReLU): the act in the epilogue
            return nn.Sequential(Conv3x3(c, f, act="leaky_relu", slope=SLOPE,
                                         generator=generator), nn.Identity())

        self.conv1 = conv(features, features)
        self.conv2 = conv(r, features)
        self.conv3 = conv(r, features)
        self.conv4 = conv(r, d)
        self.conv5 = Conv1x1(4 * d, features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        d = self.distilled
        res1 = self.conv1(x)
        res2 = self.conv2(_contiguous(res1[..., d:]))
        res3 = self.conv3(_contiguous(res2[..., d:]))
        res4 = self.conv4(_contiguous(res3[..., d:]))
        res = torch.cat([res1[..., :d], res2[..., :d], res3[..., :d], res4], dim=-1)
        return x + self.conv5(res)


class IMDNModule(nn.Module):
    def __init__(self, features: int = 64, num_blocks: int = 8, scale: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.features = features
        self.mean_shift = MeanShift(sign=1.0)
        self.first_conv = Conv3x3(3, features, generator=g)
        self.res_blocks = nn.ModuleList([IMDBlock(features, g) for _ in range(num_blocks)])
        self.after_res_conv = Conv3x3(features, features, generator=g)
        self.upsample = ConvShuffle(Conv3x3(features, 3 * scale * scale, generator=g), scale)
        self.mean_inverse_shift = MeanShift(sign=-1.0)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x = self.first_conv(self.mean_shift(x))
        res = x
        for block in self.res_blocks:
            res = block(res)
        x = x + self.after_res_conv(res)
        return self.mean_inverse_shift(self.upsample.body(x))


class IMDN(TrainedMeanShiftMixin, StepDecayMixin, SRModel):
    lr_flag = "learning_rate"
    decay_flag = "learning_rate_decay"
    decay_steps_flag = "learning_rate_decay_steps"

    def parse_args(self, args):
        parser = argparse.ArgumentParser()
        parser.add_argument("--num_filters", type=int, default=64,
                            help="The number of filters.")
        parser.add_argument("--num_blocks", type=int, default=8,
                            help="The number of modules.")
        parser.add_argument("--learning_rate", type=float, default=1e-4,
                            help="Initial learning rate.")
        parser.add_argument("--learning_rate_decay", type=float, default=0.5,
                            help="Learning rate decay factor.")
        parser.add_argument("--learning_rate_decay_steps", type=int, default=200000,
                            help="The number of training steps to perform learning rate "
                                 "decay.")
        parser.add_argument("--packed_trunk", type=int, default=0,
                            help="The JAX package's width-packed trunk (an exact "
                                 "reparametrisation the port does not run); accepted.")
        self.args, remaining = parse_known(parser, args)
        return self.args, remaining

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return IMDNModule(features=self.args.num_filters, num_blocks=self.args.num_blocks,
                          scale=self.scale, generator=generator)


@register_model("imdn_aim2019")
def create_imdn():
    return IMDN()
