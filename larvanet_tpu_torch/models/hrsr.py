"""The HRSR family (larvanet_tpu/models/hrsr.py; reference models/hrsr.py,
hrsr_.py, hrsr_c3.py): ResBlocks in LR space, a PixelShuffle, then
optional ResBlocks in HR space, plus the interpolated base. NHWC.

  first_conv 3 -> 3 scale^2 (48 at x4) with LeakyReLU(0.1) fused
  --num_lr_blocks ResBlocks at 3 scale^2 channels, times --res_weight
  PixelShuffle(scale) to RGB
  with --num_hr_blocks > 0: middle_conv 3 -> --num_hr_filters with
      LeakyReLU(0.1) fused, then ResBlocks of --hr_filter_size (relu); for
      hrsr_c3 (c3_style) the ResBlocks on the 3-channel image, times
      --res_weight, and no middle conv
  but for hrsr_c3, when --num_hr_filters is not 3: LeakyReLU(0.1), then
      final_conv back to 3 channels
  + the interpolated base (--interpolate, bilinear)

Every conv is 0.1-scaled Kaiming with a zero bias (the reference's
initialize_weights). Parameters carry the reference's state_dict names, the
ones larvanet_tpu/utils/torch_convert.py:581-588 exports: `first_conv`,
`lr_res_blocks.N.body.{0,2}`, `middle_conv`, `hr_res_blocks.N.body.{0,2}`,
`final_conv`. The 3x3 convs run on the conv3x3 kernel, the 3-channel HR
ones on its CUDA cores; an --hr_filter_size K other than 3 runs on the
conv_kxk kernel with XLA's SAME pads (layers.ConvKxK).

`HRSRModule.walk(x, pair)` is the family's one topology (ops/packed/
branchy.py:104-147): the LR ResBlocks go to `pair(idx, h, conv1, conv2,
kind="res", res_weight=...)` (the int8 pairs, QAT, --remat come in there);
the HR part runs its modules, as JAX's packed walk runs it plain.

Training (hrsr.py:108-246), while --packed_trunk is not 0 (unset is JAX's
1) through `training_pair` (--qat 1, --remat 1), else the module graph,
the loss on the HR image either way:
  hrsr     AdamW at `lr_scheduler.lr`, a ReduceLROnPlateau (patience 1,
           mode max, --lr_decay, --threshold, --min_lr 1e-5, --cooldown)
           made by `prepare` for training; the train_schedule CLI steps it
           with the validation PSNR. Its state is in the training state
           file and comes back on restore, from a JAX `.ckpt` too.
  hrsr_    the same with --min_lr 0.
  hrsr_c3  32 LR blocks, 0 HR blocks, Adam at --learning_rate's step
           decay, no lr_scheduler.
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional

import torch
from torch import nn

from larvanet_tpu_torch.core.config import parse_known
from larvanet_tpu_torch.core.registry import register_model
from larvanet_tpu_torch.models.base import (SchedulerStateMixin, SRModel, StepDecayMixin,
                                            add_training_flags, qat_requested,
                                            remat_requested)
from larvanet_tpu_torch.models.layers import (Conv3x3, ResBlock, activation, exact_pair,
                                              interpolated_base)
from larvanet_tpu_torch.ops.pixel_shuffle import pixel_shuffle
from larvanet_tpu_torch.train.schedules import ReduceLROnPlateau

INIT_SCALE = 0.1  # kaiming_normal_ x 0.1, zero bias (reference initialize_weights)
SLOPE = 0.1  # the LeakyReLU of first_conv, middle_conv and before final_conv


class HRSRModule(nn.Module):
    """hrsr / hrsr_ and, with `c3_style`, hrsr_c3 (hrsr.py:38-74)."""

    def __init__(self, num_lr_blocks: int = 4, num_hr_blocks: int = 4,
                 num_hr_filters: int = 3, hr_filter_size: int = 3,
                 interpolate: str = "bilinear", res_weight: float = 1.0, scale: int = 4,
                 c3_style: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        g, s = generator, INIT_SCALE
        features = 3 * scale * scale
        self.scale, self.interpolate, self.c3_style = scale, interpolate, c3_style
        self.first_conv = Conv3x3(3, features, act="leaky_relu", generator=g, init_scale=s)
        self.lr_res_blocks = nn.ModuleList([ResBlock(features, res_weight, g, init_scale=s)
                                            for _ in range(num_lr_blocks)])
        hr_features = 3
        if num_hr_blocks > 0:
            if c3_style:
                blocks = [ResBlock(3, res_weight, g, init_scale=s) for _ in range(num_hr_blocks)]
            else:
                hr_features = num_hr_filters
                self.middle_conv = Conv3x3(3, hr_features, act="leaky_relu", generator=g,
                                           init_scale=s)
                blocks = [ResBlock(hr_features, 1.0, g, init_scale=s,
                                   kernel_size=hr_filter_size) for _ in range(num_hr_blocks)]
            self.hr_res_blocks = nn.ModuleList(blocks)
        if not c3_style and num_hr_filters != 3:
            self.final_conv = Conv3x3(hr_features, 3, generator=g, init_scale=s)

    def pairs(self):
        """The LR ResBlocks' conv pairs in the walk's order (the int8
        forward's)."""
        return [(b.body[0], b.body[2]) for b in self.lr_res_blocks]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.walk(x)

    def walk(self, x: torch.Tensor, pair: Callable = exact_pair) -> torch.Tensor:
        h = self.first_conv(x)
        for i, blk in enumerate(self.lr_res_blocks):
            h = pair(i, h, blk.body[0], blk.body[2], kind="res", res_weight=blk.res_weight)
        out = pixel_shuffle(h, self.scale)
        if hasattr(self, "middle_conv"):
            out = self.middle_conv(out)
        for blk in getattr(self, "hr_res_blocks", ()):
            out = blk(out)
        if hasattr(self, "final_conv"):
            out = self.final_conv(activation("leaky_relu", SLOPE)(out))
        return out + interpolated_base(x, self.scale, self.interpolate)


class _HRSRFamily(SRModel):
    """The training graph (`_HRSRPackedMixin._compute_loss`, hrsr.py:
    77-105)."""

    def _compute_loss(self, inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        from larvanet_tpu_torch.ops.pairs import training_pair

        if getattr(self.args, "packed_trunk", None) == 0:
            return self.loss(self.module(inputs), targets)
        pair = training_pair(qat_requested(self), remat_requested(self))
        return self.loss(self.module.walk(inputs, pair), targets)


class HRSR(SchedulerStateMixin, _HRSRFamily):
    """AdamW and the plateau scheduler that train_schedule steps, its state
    saved and restored (hrsr.py:108-181)."""

    optimizer_kind = "adamw"
    scheduler_attr = "lr_scheduler"
    default_min_lr = 1e-5

    def __init__(self):
        super().__init__()
        self.lr_scheduler: Optional[ReduceLROnPlateau] = None

    def parse_args(self, args):
        parser = argparse.ArgumentParser()
        parser.add_argument("--num_lr_blocks", type=int, default=4,
                            help="The number of residual blocks at LR domain.")
        parser.add_argument("--num_hr_blocks", type=int, default=4,
                            help="The number of residual blocks at HR domain.")
        parser.add_argument("--num_hr_filters", type=int, default=3,
                            help="The number of filters at HR domain.")
        parser.add_argument("--hr_filter_size", type=int, default=3,
                            help="The size of filters at HR domain.")
        parser.add_argument("--interpolate", type=str, default="bilinear",
                            help="Interpolation method.")
        parser.add_argument("--lr", type=float, default=1e-3,
                            help="Initial learning rate.")
        parser.add_argument("--lr_decay", type=float, default=0.5,
                            help="Learning rate decay factor.")
        parser.add_argument("--threshold", type=float, default=0.005,
                            help="Threshold for the plateau scheduler.")
        parser.add_argument("--min_lr", type=float, default=self.default_min_lr,
                            help="Minimum learning rate.")
        parser.add_argument("--cooldown", type=float, default=0,
                            help="cooldown for reduce lr")
        parser.add_argument("--learning_rate_decay_steps", type=int, default=200000,
                            help="The number of training steps to perform learning rate "
                                 "decay.")
        add_training_flags(parser, lr_domain=False)
        self.args, remaining = parse_known(parser, args)
        return self.args, remaining

    def build_module(self, generator: torch.Generator) -> nn.Module:
        a = self.args
        return HRSRModule(num_lr_blocks=a.num_lr_blocks, num_hr_blocks=a.num_hr_blocks,
                          num_hr_filters=a.num_hr_filters, hr_filter_size=a.hr_filter_size,
                          interpolate=a.interpolate, scale=self.scale, generator=generator)

    def prepare(self, scales, device="cuda", seed: int = 0, is_training: bool = False,
                global_step: int = 0):
        super().prepare(scales, device=device, seed=seed, is_training=is_training,
                        global_step=global_step)
        self.lr_scheduler = None
        if is_training:
            a = self.args
            # patience 1 is the reference's (hrsr.py:91)
            self.lr_scheduler = ReduceLROnPlateau(
                lr=a.lr, factor=a.lr_decay, patience=1, cooldown=int(a.cooldown),
                threshold=a.threshold, min_lr=a.min_lr, mode="max")

    def get_learning_rate(self) -> float:
        return self.lr_scheduler.lr if self.lr_scheduler is not None else self.args.lr


class HRSRUnderscore(HRSR):
    """hrsr_: --min_lr 0 (reference models/hrsr_.py)."""

    default_min_lr = 0.0


class HRSRC3(StepDecayMixin, _HRSRFamily):
    """hrsr_c3: Adam at --learning_rate's step decay (hrsr.py:196-246)."""

    lr_flag = "learning_rate"
    decay_flag = "learning_rate_decay"
    decay_steps_flag = "learning_rate_decay_steps"

    def parse_args(self, args):
        parser = argparse.ArgumentParser()
        parser.add_argument("--num_lr_blocks", type=int, default=32,
                            help="The number of residual blocks at LR domain.")
        parser.add_argument("--num_hr_blocks", type=int, default=0,
                            help="The number of residual blocks at HR domain.")
        parser.add_argument("--interpolate", type=str, default="bilinear",
                            help="Interpolation method.")
        parser.add_argument("--res_weight", type=float, default=1.0,
                            help="The scaling factor.")
        parser.add_argument("--learning_rate", type=float, default=1e-4,
                            help="Initial learning rate.")
        parser.add_argument("--learning_rate_decay", type=float, default=0.5,
                            help="Learning rate decay factor.")
        parser.add_argument("--learning_rate_decay_steps", type=int, default=200000,
                            help="The number of training steps to perform learning rate "
                                 "decay.")
        add_training_flags(parser, lr_domain=False)
        self.args, remaining = parse_known(parser, args)
        return self.args, remaining

    def build_module(self, generator: torch.Generator) -> nn.Module:
        a = self.args
        return HRSRModule(num_lr_blocks=a.num_lr_blocks, num_hr_blocks=a.num_hr_blocks,
                          interpolate=a.interpolate, res_weight=a.res_weight,
                          scale=self.scale, c3_style=True, generator=generator)


@register_model("hrsr")
def create_hrsr():
    return HRSR()


@register_model("hrsr_")
def create_hrsr_():
    return HRSRUnderscore()


@register_model("hrsr_c3")
def create_hrsr_c3():
    return HRSRC3()
