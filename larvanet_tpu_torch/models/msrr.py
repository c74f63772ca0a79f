"""The MSRR family (larvanet_tpu/models/msrr.py; reference models/msrr.py,
msrr_reduced*.py, dwsr_reduced.py, msrr_test.py): full MSRR, the
ultra-light msrr_reduced and its six ablations, DWSR, and msrr_test.

Three modules, NHWC, with the reference's state_dict keys (the ones
larvanet_tpu/utils/torch_convert.py:505-511, 555-564, 640-656 exports):

  MSRRModule         first_conv (LeakyReLU(0.1)) -> N ResBlocks -> upsample
                     (a LeakyReLU after every x2 shuffle) -> HR_conv
                     (LeakyReLU) -> final_conv, + the bilinear base
                     (msrr.py:53-76). Its dead mean_shift /
                     mean_inverse_shift buffers are kept so that a
                     reference `.pth` loads strictly.
  MSRRReducedModule  3 scale^2 channels (48 at x4), 32 ResBlocks, one
                     PixelShuffle(scale) straight to RGB, + the base at the
                     configured scale (JAX's fix of the reference's
                     hardcoded x4), a MeanShift pair, or nothing; the
                     ablations switch the block activation (relu6,
                     leaky_relu at --slope, which drives the first
                     activation too), the first activation (none), the
                     init, and depthwise-separable blocks (dwsr_reduced)
                     (msrr.py:79-128).
  MSRRTestModule     conv_first -> N ResBlocks (recon_trunk.N.conv1/2) ->
                     two x2 upconv + shuffle stages -> HRconv -> conv_last,
                     + the bilinear x4 base (msrr.py:131-156); the `test`
                     CLI runs it in the [0, 1] range.

Every activation that follows a conv runs fused in that conv's kernel
epilogue (a LeakyReLU after a PixelShuffle too: it commutes with the
shuffle). Each module's `walk(x, pair, lr_domain)` is the family's one
topology (ops/packed/msrr.py:17-114): its ResBlock pairs go to
`pair(idx, h, conv1, conv2, kind="res", res_weight=...)` (the modules
themselves by default; the int8 calibration and replay, QAT, --remat come
in there), and `lr_domain` (training, MSRRReducedModule only) returns the
output before the shuffle with the base (or mean) unshuffled. The
depthwise blocks run on the hand-written depthwise kernel (ops/dwconv3x3)
and their pointwise convs as plain products; they take no pair: JAX has no
int8, QAT or --remat path for them, and refuses those with its messages.

Training: the stepwise presets (msrr, msrr_reduced_def_init / _NI /
_linear / _relu6 / _leaky / _meanshift, dwsr_reduced, msrr_test) with Adam
and the step decay of --learning_rate; msrr_reduced with AdamW on the
plateau schedule's learning rate and the volume-driven loop of the
train_larva CLI (models/volume.py, shared with the LarvaNet family). While
--packed_trunk is not 0 (unset is JAX's 1) the walk trains through
`training_pair` (--qat 1, --remat 1) and msrr_reduced's presets take the
loss before the shuffle (--lr_domain_loss 1); an explicit --packed_trunk 0,
or a depthwise config, trains the module graph, as JAX's does.
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional

import torch
from torch import nn

from larvanet_tpu_torch.core.config import parse_known
from larvanet_tpu_torch.core.registry import register_model
from larvanet_tpu_torch.models.base import (SRModel, StepDecayMixin, add_training_flags,
                                            qat_requested, remat_requested)
from larvanet_tpu_torch.models.layers import (Conv3x3, ConvPairResBlock,
                                              DepthwiseSeparableResBlock, MeanShift, ResBlock,
                                              UpsampleBlock, exact_pair, interpolated_base,
                                              inverse_shift_lr)
from larvanet_tpu_torch.models.volume import PlateauVolumeMixin
from larvanet_tpu_torch.ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle

INIT_SCALE = 0.1  # kaiming_normal_ x 0.1, zero bias (reference initialize_weights)
LEAKY = "leaky_relu"


class MSRRModule(nn.Module):
    """Full MSRR (reference models/msrr.py:214-248)."""

    def __init__(self, features: int = 64, num_blocks: int = 16, res_weight: float = 1.0,
                 scale: int = 4, generator: Optional[torch.Generator] = None):
        super().__init__()
        g, s = generator, INIT_SCALE
        self.scale = scale
        self.mean_shift = MeanShift(sign=1.0)
        self.mean_inverse_shift = MeanShift(sign=-1.0)
        self.first_conv = Conv3x3(3, features, act=LEAKY, generator=g, init_scale=s)
        self.res_blocks = nn.ModuleList(
            [ResBlock(features, res_weight, g, init_scale=s) for _ in range(num_blocks)])
        self.upsample = UpsampleBlock(features, scale, g, activation=LEAKY, init_scale=s)
        self.HR_conv = Conv3x3(features, features, act=LEAKY, generator=g, init_scale=s)
        self.final_conv = Conv3x3(features, 3, generator=g, init_scale=s)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.walk(x)

    def walk(self, x: torch.Tensor, pair: Callable = exact_pair,
             lr_domain: bool = False) -> torch.Tensor:
        if lr_domain:
            raise ValueError("lr_domain requires a trailing shuffle (MSRRReducedModule only)")
        h = self.first_conv(x)
        for i, block in enumerate(self.res_blocks):
            h = pair(i, h, block.body[0], block.body[2], kind="res",
                     res_weight=block.res_weight)
        h = self.final_conv(self.HR_conv(self.upsample(h)))
        return h + interpolated_base(x, self.scale, "bilinear")


class MSRRReducedModule(nn.Module):
    """msrr_reduced and its ablations (reference models/msrr_reduced*.py,
    dwsr_reduced.py). `base`: an interpolation method, "meanshift" or None."""

    def __init__(self, num_blocks: int = 32, res_weight: float = 1.0, scale: int = 4,
                 block_activation: str = "relu", slope: float = 0.1,
                 first_activation: Optional[str] = LEAKY, base: Optional[str] = "bicubic",
                 init_style: str = "kaiming0.1", depthwise: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        features = 3 * scale * scale
        self.scale, self.base, self.depthwise = scale, base, depthwise
        init = INIT_SCALE if init_style == "kaiming0.1" else None
        self.first_conv = Conv3x3(3, features, act=first_activation, generator=g,
                                  init_scale=init, slope=slope)
        if base == "meanshift":
            self.mean_shift = MeanShift(sign=1.0)
            self.mean_inverse_shift = MeanShift(sign=-1.0)
        self.res_blocks = nn.ModuleList(
            [DepthwiseSeparableResBlock(features, g) if depthwise else
             ResBlock(features, res_weight, g, init_scale=init, activation=block_activation,
                      slope=slope) for _ in range(num_blocks)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.walk(x)

    def walk(self, x: torch.Tensor, pair: Callable = exact_pair,
             lr_domain: bool = False) -> torch.Tensor:
        meanshift = self.base == "meanshift"
        h = self.first_conv(self.mean_shift(x) if meanshift else x)
        for i, block in enumerate(self.res_blocks):
            if self.depthwise:
                h = block(h)
            else:
                h = pair(i, h, block.body[0], block.body[2], kind="res",
                         res_weight=block.res_weight)
        s = self.scale
        if lr_domain:
            if meanshift:
                return inverse_shift_lr(self.mean_inverse_shift, h)
            if self.base is not None:
                return h + pixel_unshuffle(interpolated_base(x, s, self.base), s)
            return h
        out = pixel_shuffle(h, s)
        if meanshift:
            return self.mean_inverse_shift(out)
        if self.base is not None:
            return out + interpolated_base(x, s, self.base)
        return out


class MSRRTestModule(nn.Module):
    """msrr_test (reference models/msrr_test.py): two x2 stages, so x4 at any
    --scales."""

    def __init__(self, features: int = 64, num_blocks: int = 16, res_weight: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, s = generator, INIT_SCALE
        self.conv_first = Conv3x3(3, features, act=LEAKY, generator=g, init_scale=s)
        self.recon_trunk = nn.ModuleList(
            [ConvPairResBlock(features, res_weight, g, init_scale=s) for _ in range(num_blocks)])
        self.upconv1 = Conv3x3(features, 4 * features, act=LEAKY, generator=g, init_scale=s)
        self.upconv2 = Conv3x3(features, 4 * features, act=LEAKY, generator=g, init_scale=s)
        self.HRconv = Conv3x3(features, features, act=LEAKY, generator=g, init_scale=s)
        self.conv_last = Conv3x3(features, 3, generator=g, init_scale=s)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.walk(x)

    def walk(self, x: torch.Tensor, pair: Callable = exact_pair,
             lr_domain: bool = False) -> torch.Tensor:
        if lr_domain:
            raise ValueError("lr_domain requires a trailing shuffle (MSRRReducedModule only)")
        h = self.conv_first(x)
        for i, block in enumerate(self.recon_trunk):
            h = pair(i, h, block.conv1, block.conv2, kind="res", res_weight=block.res_weight)
        h = pixel_shuffle(self.upconv2(pixel_shuffle(self.upconv1(h), 2)), 2)
        h = self.conv_last(self.HRconv(h))
        return h + interpolated_base(x, 4, "bilinear")


def _add_step_decay_flags(parser) -> None:
    parser.add_argument("--learning_rate", type=float, default=1e-4,
                        help="Initial learning rate.")
    parser.add_argument("--learning_rate_decay", type=float, default=0.5,
                        help="Learning rate decay factor.")
    parser.add_argument("--learning_rate_decay_steps", type=int, default=200000,
                        help="The number of training steps to perform learning rate decay.")


class _MSRRFamily(StepDecayMixin, SRModel):
    """The family's training graph (_PackedTrunkMixin._compute_loss,
    msrr.py:203-232): while --packed_trunk is not 0, the walk through
    `training_pair` (--qat 1, --remat 1), msrr_reduced's modules with the
    loss before the shuffle under --lr_domain_loss 1; a depthwise config, or
    an explicit --packed_trunk 0, the module graph with the loss on the HR
    image. A depthwise config refuses --qat 1 and --remat 1, as JAX does.
    The learning rate: --learning_rate's step decay (msrr.py:188-192)."""

    lr_flag = "learning_rate"
    decay_flag = "learning_rate_decay"
    decay_steps_flag = "learning_rate_decay_steps"

    def _compute_loss(self, inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        from larvanet_tpu_torch.ops.pairs import training_pair

        m = self.module
        depthwise = getattr(m, "depthwise", False)
        packed = getattr(self.args, "packed_trunk", None) != 0
        qat, remat = qat_requested(self), remat_requested(self)
        if packed and depthwise and (qat or remat):
            raise ValueError("--qat/--remat are unsupported for depthwise configs (they run "
                             "the plain graph — no packed conv pairs to wrap)")
        if not packed or depthwise:
            return self.loss(m(inputs), targets)
        lr_domain = (bool(getattr(self.args, "lr_domain_loss", 0))
                     and isinstance(m, MSRRReducedModule))
        if lr_domain:
            # the targets unshuffled (no backward) instead of the output shuffled
            targets = pixel_unshuffle(targets, self.scale)
        return self.loss(m.walk(inputs, training_pair(qat, remat), lr_domain), targets)


class MSRR(_MSRRFamily):
    """Full MSRR: stepwise Adam (reference models/msrr.py:48-53)."""

    def parse_args(self, args):
        parser = argparse.ArgumentParser()
        parser.add_argument("--num_filters", type=int, default=64,
                            help="The number of convolutional features.")
        parser.add_argument("--num_blocks", type=int, default=16,
                            help="The number of residual blocks.")
        parser.add_argument("--res_weight", type=float, default=1.0,
                            help="The scaling factor.")
        _add_step_decay_flags(parser)
        add_training_flags(parser)
        self.args, remaining = parse_known(parser, args)
        return self.args, remaining

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return MSRRModule(features=self.args.num_filters, num_blocks=self.args.num_blocks,
                          res_weight=self.args.res_weight, scale=self.scale,
                          generator=generator)


@register_model("msrr")
def create_msrr():
    return MSRR()


class _ReducedStepwise(_MSRRFamily):
    """The stepwise-Adam msrr_reduced ablations (msrr.py:250-312)."""

    default_interpolate: Optional[str] = "bicubic"
    has_interpolate_flag = True
    has_slope_flag = False
    # the preset's module
    block_activation = "relu"
    first_activation: Optional[str] = LEAKY
    base_kind: Optional[str] = "interpolate"  # "interpolate", "meanshift" or None
    init_style = "kaiming0.1"
    depthwise = False

    def parse_args(self, args):
        parser = argparse.ArgumentParser()
        parser.add_argument("--num_blocks", type=int, default=32,
                            help="The number of residual blocks.")
        if self.has_interpolate_flag:
            parser.add_argument("--interpolate", type=str, default=self.default_interpolate,
                                help="Interpolation method.")
        parser.add_argument("--res_weight", type=float, default=1.0,
                            help="The scaling factor.")
        if self.has_slope_flag:
            parser.add_argument("--slope", type=float, default=0.1,
                                help="Slope of LeakyReLU function.")
        _add_step_decay_flags(parser)
        add_training_flags(parser)
        self.args, remaining = parse_known(parser, args)
        return self.args, remaining

    def build_module(self, generator: torch.Generator) -> nn.Module:
        if self.base_kind == "interpolate":
            base = getattr(self.args, "interpolate", self.default_interpolate)
        else:
            base = self.base_kind
        return MSRRReducedModule(
            num_blocks=self.args.num_blocks, res_weight=self.args.res_weight,
            scale=self.scale, block_activation=self.block_activation,
            slope=getattr(self.args, "slope", 0.1), first_activation=self.first_activation,
            base=base, init_style=self.init_style, depthwise=self.depthwise,
            generator=generator)


def _reduced_preset(name, **attrs):
    cls = type(name, (_ReducedStepwise,), attrs)

    @register_model(name)
    def factory(cls=cls):
        return cls()

    return cls


MSRRReducedDefInit = _reduced_preset("msrr_reduced_def_init", init_style="default")
MSRRReducedNI = _reduced_preset("msrr_reduced_NI", base_kind=None, has_interpolate_flag=False)
MSRRReducedLinear = _reduced_preset("msrr_reduced_linear", first_activation=None,
                                    default_interpolate="bilinear")
MSRRReducedReLU6 = _reduced_preset("msrr_reduced_relu6", block_activation="relu6",
                                   default_interpolate="bilinear")
MSRRReducedLeaky = _reduced_preset("msrr_reduced_leaky", block_activation=LEAKY,
                                   has_slope_flag=True, default_interpolate="bilinear")
MSRRReducedMeanShift = _reduced_preset("msrr_reduced_meanshift", base_kind="meanshift",
                                       default_interpolate="bilinear")
DWSRReduced = _reduced_preset("dwsr_reduced", depthwise=True, default_interpolate="bilinear")


class MSRRTest(_ReducedStepwise):
    """msrr_test: the [0, 1]-range MSRR of the test CLI (reference
    msrr_test.py)."""

    def parse_args(self, args):
        parser = argparse.ArgumentParser()
        parser.add_argument("--num_filters", type=int, default=64)
        parser.add_argument("--num_blocks", type=int, default=16)
        parser.add_argument("--res_weight", type=float, default=1.0)
        _add_step_decay_flags(parser)
        add_training_flags(parser)
        self.args, remaining = parse_known(parser, args)
        return self.args, remaining

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return MSRRTestModule(features=self.args.num_filters, num_blocks=self.args.num_blocks,
                              res_weight=self.args.res_weight, generator=generator)


@register_model("msrr_test")
def create_msrr_test():
    return MSRRTest()


class MSRRReduced(PlateauVolumeMixin, _ReducedStepwise):
    """msrr_reduced proper: AdamW on the plateau schedule and the
    volume-driven step of the train_larva CLI (reference
    msrr_reduced.py:94-101, 156-192)."""

    def parse_args(self, args):
        parser = argparse.ArgumentParser()
        parser.add_argument("--num_blocks", type=int, default=32,
                            help="The number of residual blocks.")
        parser.add_argument("--interpolate", type=str, default="bicubic",
                            help="Interpolation method.")
        parser.add_argument("--res_weight", type=float, default=1.0,
                            help="The scaling factor.")
        parser.add_argument("--lr", type=float, default=4e-4,
                            help="Initial learning rate.")
        parser.add_argument("--lr_decay", type=float, default=0.5,
                            help="Learning rate decay factor.")
        parser.add_argument("--lr_step", type=int, default=50000,
                            help="Learning rate decay step.")
        parser.add_argument("--val_volume", type=float, default=30e9,
                            help="How much volume need for validation.")
        parser.add_argument("--threshold", type=float, default=0.001,
                            help="Threshold for reduceLRonPlateau.")
        parser.add_argument("--min_lr", type=float, default=1e-8,
                            help="Minimum learning rate.")
        parser.add_argument("--patience", type=int, default=3,
                            help="patience for lr scheduler")
        parser.add_argument("--cooldown", type=int, default=6,
                            help="cooldown for lr scheduler")
        add_training_flags(parser)
        self.args, remaining = parse_known(parser, args)
        return self.args, remaining


@register_model("msrr_reduced")
def create_msrr_reduced():
    return MSRRReduced()
