"""REGO-Net and REGO-serial (larvanet_tpu/models/rego.py; reference
models/REGO-Net.py, REGO-serial.py), registered under the reference's
hyphenated names "REGO-Net" and "REGO-serial". NHWC:

  MeanShift(+1) (forward only) -> feature_extraction conv 3 -> F
  a triangular wavefront of RESBlocks RESB_{i}_{j} (i + j < --len_side):
      each block conv1 (LeakyReLU(0.1) fused in its epilogue) -> conv2,
      times its weight, returns (res, x + res); anti-diagonal i feeds block
      (i, 0) the previous diagonal's first error, block (0, i) its last
      feature and the blocks between fea_in[j-1] + err_in[j]
  the fuse: concat(err_0, err_k + fea_{k-1} ..., fea_last), (len_side + 1)
      F channels (384 at the defaults)
  REGO-serial: --num_regos triangles, a merge conv conv_<k> (384 -> F)
      between them, every block's weight and the init scaled by
      --weight_scale
  SRrecon conv (384 -> 3 scale^2) -> PixelShuffle -> + the bilinear base

Parameters carry the reference's state_dict names, the ones
larvanet_tpu/utils/torch_convert.py:591-607 exports: REGO-Net's blocks are
`RESB_<i>_<j>.body.{0,2}` (one triangle, no repeat index), REGO-serial's
`RESB_<k>_<i>_<j>.body.{0,2}`; `feature_extraction`, `conv_<k>`,
`SRrecon.body.0`, and the `mean_shift` buffers, which a reference
checkpoint may carry trained (non-identity): the module applies its own
buffers on every route, and a restore of such a checkpoint prints JAX's
two lines (models/base.py:808-839) and turns --packed_trunk off, so that
training runs the module graph as JAX's does; the int8 forward, which JAX
builds on the intended shift, refuses it.

`REGOModule.walk(x, pair, lr_domain)` is the family's one topology
(ops/packed/branchy.py:178-257): every RESBlock goes to `pair(idx, h,
conv1, conv2, kind="both", res_weight=...)` in the wavefront's order
(JAX's `pair_order`); `lr_domain` (training) returns the output before the
shuffle with the base unshuffled. The fuse and SRrecon convs run on the
conv3x3 kernel at C = 384.

Training: Adam at --learning_rate's step decay in the step-driven train
CLI; while --packed_trunk is not 0 (unset is JAX's 1) through
`training_pair` (--qat 1, --remat 1) with the loss before the shuffle
under --lr_domain_loss 1; else the module graph on the HR image.
"""

from __future__ import annotations

import argparse
from typing import Callable, List, Optional, Tuple

import torch
from torch import nn

from larvanet_tpu_torch.core.config import parse_known
from larvanet_tpu_torch.core.registry import register_model
from larvanet_tpu_torch.models.base import (SRModel, StepDecayMixin, TrainedMeanShiftMixin,
                                            add_training_flags, qat_requested,
                                            remat_requested)
from larvanet_tpu_torch.models.layers import (Conv3x3, ConvShuffle, MeanShift, ResBlock,
                                              exact_pair, interpolated_base)
from larvanet_tpu_torch.ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle

SLOPE = 0.1  # the RESBlock's LeakyReLU


def triangle_order(len_side: int) -> List[Tuple[int, int]]:
    """The wavefront's (i, j) blocks in the order it runs them
    (REGO-Net.py; JAX's `pair_order`, branchy.py:197-206)."""
    order = [(0, 0)]
    for i in range(1, len_side):
        order += [(i, 0)] + [(i - j, j) for j in range(1, i)] + [(0, i)]
    return order


class REGOModule(nn.Module):
    """The triangle(s), the fuse and the reconstruction (larvanet_tpu/models/
    rego.py:88-128). `serial_keys`: REGO-serial's RESB_<k>_<i>_<j> names."""

    def __init__(self, features: int = 64, len_side: int = 5, res_weight: float = 1.0,
                 interpolate: str = "bilinear", scale: int = 4, num_regos: int = 1,
                 init_scale: Optional[float] = None, serial_keys: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.len_side, self.num_regos, self.serial_keys = len_side, num_regos, serial_keys
        self.interpolate, self.scale = interpolate, scale
        fused = (len_side + 1) * features
        self.mean_shift = MeanShift(sign=1.0)
        self.feature_extraction = Conv3x3(3, features, generator=g, init_scale=init_scale)
        for k in range(num_regos):
            for i, j in triangle_order(len_side):
                setattr(self, self.block_name(k, i, j),
                        ResBlock(features, res_weight, g, init_scale=init_scale,
                                 activation="leaky_relu", slope=SLOPE))
            if k != num_regos - 1:
                setattr(self, "conv_%d" % k, Conv3x3(fused, features, generator=g))
        self.SRrecon = ConvShuffle(Conv3x3(fused, 3 * scale * scale, generator=g,
                                      init_scale=init_scale or None), scale)

    def block_name(self, k: int, i: int, j: int) -> str:
        return "RESB_%d_%d_%d" % (k, i, j) if self.serial_keys else "RESB_%d_%d" % (i, j)

    def blocks(self) -> List[ResBlock]:
        """Every RESBlock in the walk's order (its pair indices)."""
        return [getattr(self, self.block_name(k, i, j)) for k in range(self.num_regos)
                for i, j in triangle_order(self.len_side)]

    def pairs(self):
        return [(blk.body[0], blk.body[2]) for blk in self.blocks()]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.walk(x)

    def walk(self, x: torch.Tensor, pair: Callable = exact_pair,
             lr_domain: bool = False) -> torch.Tensor:
        fea = self.feature_extraction(self.mean_shift(x))
        blocks = iter(enumerate(self.blocks()))

        def resb(h):
            idx, blk = next(blocks)
            return pair(idx, h, blk.body[0], blk.body[2], kind="both",
                        res_weight=blk.res_weight)

        for k in range(self.num_regos):
            err, fea = resb(fea)
            err_in, fea_in = [err], [fea]
            for i in range(1, self.len_side):
                # blocks (i, 0), (i - j, j) for 0 < j < i, (0, i): triangle_order's
                outs = ([resb(err_in[0])]
                        + [resb(fea_in[j - 1] + err_in[j]) for j in range(1, i)]
                        + [resb(fea_in[i - 1])])
                err_in, fea_in = [o[0] for o in outs], [o[1] for o in outs]
            mids = [e + f for e, f in zip(err_in[1:], fea_in[:-1])]
            fused = torch.cat([err_in[0], *mids, fea_in[-1]], dim=-1)
            if k != self.num_regos - 1:
                fea = getattr(self, "conv_%d" % k)(fused)
        sr = self.SRrecon.body[0](fused)
        s = self.scale
        base = interpolated_base(x, s, self.interpolate)
        if lr_domain:
            return sr + pixel_unshuffle(base, s)
        return pixel_shuffle(sr, s) + base


class REGONet(TrainedMeanShiftMixin, StepDecayMixin, SRModel):
    """REGO-Net (larvanet_tpu/models/rego.py:167-210): Adam at the step decay
    of --learning_rate."""

    lr_flag = "learning_rate"
    decay_flag = "learning_rate_decay"
    decay_steps_flag = "learning_rate_decay_steps"

    def parse_args(self, args):
        parser = argparse.ArgumentParser()
        parser.add_argument("--num_filters", type=int, default=64,
                            help="The number of convolutional features.")
        parser.add_argument("--len_side", type=int, default=5,
                            help="The number of residual blocks.")
        self._add_variant_flags(parser)
        parser.add_argument("--interpolate", type=str, default="bilinear",
                            help="Interpolation method.")
        parser.add_argument("--learning_rate", type=float, default=1e-4,
                            help="Initial learning rate.")
        parser.add_argument("--learning_rate_decay", type=float, default=0.5,
                            help="Learning rate decay factor.")
        parser.add_argument("--learning_rate_decay_steps", type=int, default=200000,
                            help="The number of training steps to perform learning rate decay.")
        add_training_flags(parser)
        self.args, remaining = parse_known(parser, args)
        return self.args, remaining

    def _add_variant_flags(self, parser) -> None:
        parser.add_argument("--res_weight", type=float, default=1.0,
                            help="The scaling factor.")

    def build_module(self, generator: torch.Generator) -> nn.Module:
        a = self.args
        return REGOModule(features=a.num_filters, len_side=a.len_side,
                          res_weight=a.res_weight, interpolate=a.interpolate,
                          scale=self.scale, generator=generator)

    def _compute_loss(self, inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """_REGOPackedMixin._compute_loss (rego.py:152-164): while
        --packed_trunk is not 0, the walk through `training_pair`, the loss
        before the shuffle under --lr_domain_loss 1; else the module graph."""
        from larvanet_tpu_torch.ops.pairs import training_pair

        if getattr(self.args, "packed_trunk", None) == 0:
            return self.loss(self.module(inputs), targets)
        lr_domain = bool(getattr(self.args, "lr_domain_loss", 0))
        if lr_domain:
            targets = pixel_unshuffle(targets, self.scale)  # no backward
        pair = training_pair(qat_requested(self), remat_requested(self))
        return self.loss(self.module.walk(inputs, pair, lr_domain), targets)


@register_model("REGO-Net")
def create_rego():
    return REGONet()


class REGOSerial(REGONet):
    """REGO-serial (rego.py:217-254): --num_regos triangles, --weight_scale
    the blocks' weight and the init's scale."""

    def _add_variant_flags(self, parser) -> None:
        parser.add_argument("--num_regos", type=int, default=1,
                            help="num of serial repeat of REGO-module")
        parser.add_argument("--weight_scale", type=float, default=0.1,
                            help="The scaling factor.")

    def build_module(self, generator: torch.Generator) -> nn.Module:
        a = self.args
        return REGOModule(features=a.num_filters, len_side=a.len_side,
                          res_weight=a.weight_scale, interpolate=a.interpolate,
                          scale=self.scale, num_regos=a.num_regos,
                          init_scale=a.weight_scale, serial_keys=True, generator=generator)


@register_model("REGO-serial")
def create_rego_serial():
    return REGOSerial()
