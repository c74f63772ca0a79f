"""EDSR-baseline (larvanet_tpu/models/edsr.py; reference models/edsr.py).

mean-shift -> conv 3->F -> N x ResBlock(res_weight) -> conv + global
skip -> UpsampleBlock (PixelShuffle) -> conv F->3 -> inverse mean-shift.
The module's state_dict keys are the reference's (`mean_shift`,
`first_conv`, `res_blocks.{i}.body.{0,2}`, `after_res_conv`,
`upsample.body.{0,2}`, `final_conv`, `mean_inverse_shift`), the keys
larvanet_tpu/utils/torch_convert.py:470-479 exports.

Serving routes share the module's walk (`EDSRModule.forward`): its `pair`
hook runs the ResBlocks (the fused Winograd, int8 and QAT pairs come in
there) and its `tail` hook the tail (the baked collapsed tail of
ops/collapsed_tail.py under the inference CLIs' default --collapsed_tail 1,
and on the int8 and Winograd routes).

Training (models/edsr.py:63-165 in the JAX package): Adam and L1, the
learning rate --edsr_learning_rate (1e-4) halved (--edsr_learning_rate_decay)
every --edsr_learning_rate_decay_steps (200k) steps. `edsr_loss` is the
same network trained with the robust sqrt loss mean((|o-t|+1e-5)^0.5)
(reference models/edsr_loss.py:35-37). JAX's default training graph
(--packed_trunk 1 --collapsed_tail_train 1 --lr_domain_loss 1, :115-145)
runs the tail collapsed and live (ops/collapsed_tail.live_collapsed_tail_hook:
the 5x5 kernel composed in the graph from the current tail weights, the
border recomputed on strips) and takes the loss before the shuffle, against
the pixel-unshuffled targets; the port does the same, with JAX's rule that
both apply only while --packed_trunk is not 0 (the width-packed layout
itself is not ported: an exact reparametrisation), and --lr_domain_loss only
with the collapsed tail. --collapsed_tail_train 0 trains the plain tail;
a module whose MeanShift affines are not the intended ones (a restored
reference checkpoint) trains the plain tail too, as JAX's restore turns
--packed_trunk off for it. --qat 1 trains every ResBlock pair through
ops/pairs.qat_pair (the int8 serving scheme in fake-quant); --remat 1
recomputes each ResBlock pair's activations in the backward
(ops/pairs.remat_pair; refused with an explicit --packed_trunk 0, as in
JAX). Both compose with the collapsed tail.

--train_dtype bf16 (models/edsr.py:99-113, :114-145) is JAX's mixed-precision
step: the batch is cast to bf16 and the whole forward runs in bf16 (the
MeanShifts, every conv on the kernels' bf16 entries, the residual adds, the
shuffles), each conv's f32 master weight and bias cast to bf16 as it is used
(layers.Conv3x3), so the weight gradients come back as bf16 (the bf16 wgrad
entry's f32 sums rounded to bf16, as JAX's conv gradient is bf16) and then
f32; the loss reduction (bf16 output against f32 targets), the master
parameters, the gradients and Adam stay f32. With an explicit --packed_trunk
0 JAX trains in f32 whatever --train_dtype says, and so does the port. The
collapsed tail's kernel is composed in f32 and cast to bf16, its bias tile
and border strips run in bf16, as in JAX.
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional

import torch
from torch import nn

from larvanet_tpu_torch.core.config import parse_known
from larvanet_tpu_torch.core.registry import register_model
from larvanet_tpu_torch.models.base import (SRModel, StepDecayMixin, add_qat_flag,
                                            qat_requested, remat_requested)
from larvanet_tpu_torch.train.losses import robust_sqrt_loss
from larvanet_tpu_torch.models.layers import (Conv3x3, MeanShift, ResBlock,
                                              UpsampleBlock, exact_pair, mean_shifts_intended)


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

    def forward(self, x: torch.Tensor, pair: Callable = exact_pair,
                tail: Optional[Callable] = None) -> torch.Tensor:
        """The forward, with ResBlock i's convs run by `pair(i, res, body[0],
        body[2], kind="res", res_weight=...)` (layers.exact_pair: the
        blocks themselves) and the tail, from the trunk's output after the
        global skip, by `tail(h)` (None: the module's own upsample,
        final_conv and inverse mean shift; ops/collapsed_tail.py: the
        collapsed tail); the head and after_res_conv run their own
        layers."""
        x = self.first_conv(self.mean_shift(x))
        res = x
        for i, block in enumerate(self.res_blocks):
            res = pair(i, res, block.body[0], block.body[2], kind="res",
                       res_weight=block.res_weight)
        x = x + self.after_res_conv(res)
        if tail is not None:
            return tail(x)
        x = self.final_conv(self.upsample(x))
        return self.mean_inverse_shift(x)


class EDSR(StepDecayMixin, SRModel):
    lr_flag = "edsr_learning_rate"
    decay_flag = "edsr_learning_rate_decay"
    decay_steps_flag = "edsr_learning_rate_decay_steps"
    has_collapsed_tail = True

    def parse_args(self, args):
        parser = argparse.ArgumentParser()
        parser.add_argument("--edsr_conv_features", type=int, default=64,
                            help="The number of convolutional features.")
        parser.add_argument("--edsr_res_blocks", type=int, default=16,
                            help="The number of residual blocks.")
        parser.add_argument("--edsr_res_weight", type=float, default=1.0,
                            help="The scaling factor.")
        parser.add_argument("--edsr_learning_rate", type=float, default=1e-4,
                            help="Initial learning rate.")
        parser.add_argument("--edsr_learning_rate_decay", type=float, default=0.5,
                            help="Learning rate decay factor.")
        parser.add_argument("--edsr_learning_rate_decay_steps", type=int, default=200000,
                            help="The number of training steps to perform learning rate "
                                 "decay.")
        parser.add_argument("--packed_trunk", type=int, default=None,
                            help="The JAX package's width-packed training trunk (an exact "
                                 "reparametrisation the port does not run). Unset is JAX's "
                                 "1; 0 trains the module graph as JAX does: the plain "
                                 "tail, f32.")
        parser.add_argument("--lr_domain_loss", type=int, default=1,
                            help="With --collapsed_tail_train: compute the training "
                                 "L1 loss PRE-SHUFFLE in the LR domain (targets are "
                                 "pixel-unshuffled instead; mean-L1 is permutation-"
                                 "invariant, so per-element grads are identical and "
                                 "the loss differs only in f32 summation order). "
                                 "0 = HR-domain loss.")
        parser.add_argument("--collapsed_tail_train", type=int, default=1,
                            help="Train through the LIVE collapsed tail (the upsample "
                                 "chain composed in the graph into one 5x5 conv; "
                                 "loss/grad-equivalent). Applies while --packed_trunk "
                                 "is not 0. 0 = plain live tail.")
        add_qat_flag(parser)
        parser.add_argument("--remat", type=int, default=0,
                            help="Recompute each ResBlock pair's activations in the "
                                 "backward (torch.utils.checkpoint): a step's peak "
                                 "memory holds one pair's, the same gradients.")
        parser.add_argument("--train_dtype", type=str, default="f32",
                            choices=["f32", "bf16"],
                            help="Compute dtype of the training graph. bf16 = mixed "
                                 "precision: convs/activations in bfloat16, loss "
                                 "reduction, master params, grads, and optimizer in "
                                 "f32.")
        self.args, remaining = parse_known(parser, args)
        return self.args, remaining

    def train_compute_dtype(self) -> torch.dtype:
        """bf16 under --train_dtype bf16, unless --packed_trunk 0 asks for
        the plain module graph, which JAX trains in f32 (_compute_loss,
        edsr.py:114-145)."""
        if (getattr(self.args, "train_dtype", "f32") == "bf16"
                and getattr(self.args, "packed_trunk", None) != 0):
            return torch.bfloat16
        return torch.float32

    def train_tail_route(self) -> Optional[str]:
        """The training tail (_compute_loss, edsr.py:115-145): "lr_domain"
        (the live collapsed tail, the loss before the shuffle), "collapsed"
        (the live collapsed tail, the loss on the HR image) or None (the
        plain tail). The collapsed tail needs --packed_trunk not 0 (unset
        is JAX's 1), --collapsed_tail_train 1 and the intended mean
        shifts; the LR-domain loss needs the collapsed tail and
        --lr_domain_loss 1."""
        a = self.args
        if (getattr(a, "packed_trunk", None) == 0 or not getattr(a, "collapsed_tail_train", 0)
                or not mean_shifts_intended(self.module)):
            return None
        return "lr_domain" if getattr(a, "lr_domain_loss", 0) else "collapsed"

    def _compute_loss(self, inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """The loss of the module's forward in the train dtype, through the
        tail of `train_tail_route`; under --qat 1 every ResBlock pair runs
        `qat_pair` (make_packed_edsr_train_forward (qat=True),
        ops/packed/edsr.py:145-185): the head, after_res_conv, the tail and
        the residual stream stay exact; under --remat 1 every ResBlock pair
        runs under `remat_pair`."""
        from larvanet_tpu_torch.ops.collapsed_tail import live_collapsed_tail_hook
        from larvanet_tpu_torch.ops.pairs import training_pair
        from larvanet_tpu_torch.ops.pixel_shuffle import pixel_unshuffle

        dtype = self.train_compute_dtype()
        pair = training_pair(qat_requested(self), remat_requested(self), dtype)
        route = self.train_tail_route()
        tail = None
        if route is not None:
            tail = live_collapsed_tail_hook(self.module, self.scale,
                                            lr_domain=route == "lr_domain")
        if route == "lr_domain":
            # the targets unshuffled (no backward) instead of the output
            # shuffled: mean-L1 is permutation-invariant
            targets = pixel_unshuffle(targets, self.scale)
        # a bf16 output against f32 targets: the loss is reduced in f32
        return self.loss(self.module(inputs.to(dtype), pair, tail), targets)

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return EDSRModule(features=self.args.edsr_conv_features,
                          num_blocks=self.args.edsr_res_blocks,
                          res_weight=self.args.edsr_res_weight,
                          scale=self.scale, generator=generator)


@register_model("edsr")
def create_edsr():
    return EDSR()


class EDSRLoss(EDSR):
    loss = staticmethod(robust_sqrt_loss)


@register_model("edsr_loss")
def create_edsr_loss():
    return EDSRLoss()
