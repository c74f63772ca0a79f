"""MAMNet (larvanet_tpu/models/mamnet.py; reference models/mamnet.py): EDSR's
trunk with a multi-path adaptive modulation after each block's convs.

mean-shift -> conv 3->F -> N x MAMBlock -> conv + global skip ->
UpsampleBlock (PixelShuffle) -> conv F->3 -> inverse mean-shift. A MAMBlock
is conv -> ReLU -> conv -> MAMLayer (models/layers.py: the sigmoid gate of
the channel variance CSI, its 1x1 squeeze-excite ICD and the depthwise CSD),
times res_weight, plus the identity (mamnet.py:49-63). The state_dict keys
are the reference's (`res_blocks.{i}.body.{0,2}`, the gate's
`res_blocks.{i}.body.3.conv_du.{0,2}` and `.depthwise_conv2d`, EDSR's names
for the rest; larvanet_tpu/utils/torch_convert.py:541-553).

The module has EDSR's attribute names and `forward(x, pair, tail)` hooks,
so EDSR's tail machinery serves it unchanged (ops/collapsed_tail.py: the
baked collapsed tail, the live training tail): block i runs its convs as
`pair(i, res, body[0], body[2], kind="none")` (no skip: the gate comes
between the convs and the add), then the gate, then res_weight, then the
add. Serving (`serves_collapsed_tail`) takes the collapsed tail by
default, as JAX's `make_packed_mamnet_forward` does, and the module graph
under --packed_trunk 0 or when the MeanShift affines are not the intended
ones (a restored reference checkpoint; JAX bakes the intended shifts there
regardless, ROADMAP.md queue 3). --int8_trunk runs the pairs on the s8
kernel (ops/int8_forward.make_int8_edsr_forward, whose walk MAMNet's module
shares).

Training (mamnet.py:87-196 in the JAX package): Adam and L1 at
--mamnet_learning_rate (1e-4) halved every 200k steps; the plain trunk with
the live collapsed tail (--collapsed_tail_train 1) and the loss before the
shuffle (--lr_domain_loss 1), JAX's `make_collapsed_mamnet_train_forward`.
--packed_trunk_train 1 names JAX's width-packed training graph, whose loss
is on the HR image through the collapsed tail: the port takes that route
(the layout itself is an exact reparametrisation it does not run), and at
an odd patch width prints JAX's warning once and falls back as JAX does.
--qat 1 is refused with JAX's message (no packed pairs to fake-quantize).
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional

import torch
from torch import nn

from larvanet_tpu_torch.core.config import parse_known
from larvanet_tpu_torch.core.registry import register_model
from larvanet_tpu_torch.models.base import SRModel, StepDecayMixin, TrainedMeanShiftMixin
from larvanet_tpu_torch.models.layers import (Conv3x3, MAMLayer, MeanShift, UpsampleBlock,
                                              exact_pair, mean_shifts_intended)

QAT_REFUSAL = ("--qat is unsupported for mamnet (plain-trunk training; no "
               "packed pairs to fake-quantize) — serve post-training int8 "
               "behind cli/validate.py --int8_report instead")


class MAMBlock(nn.Module):
    """conv -> ReLU (fused) -> conv -> MAMLayer, with the reference's keys
    body.0, body.2 and body.3 (index 1, the ReLU, runs in body.0's kernel);
    the walk (`MAMNetModule.forward`) applies res_weight and the skip."""

    def __init__(self, features: int, res_weight: float = 1.0,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.res_weight = res_weight
        self.body = nn.ModuleList([Conv3x3(features, features, act="relu", generator=generator),
                                   nn.Identity(),
                                   Conv3x3(features, features, generator=generator),
                                   MAMLayer(features, generator=generator)])


class MAMNetModule(nn.Module):
    def __init__(self, features: int = 64, num_blocks: int = 16, res_weight: float = 1.0,
                 scale: int = 4, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        self.features = features
        self.mean_shift = MeanShift(sign=1.0)
        self.first_conv = Conv3x3(3, features, generator=g)
        self.res_blocks = nn.ModuleList([MAMBlock(features, res_weight, g)
                                         for _ in range(num_blocks)])
        self.after_res_conv = Conv3x3(features, features, generator=g)
        self.upsample = UpsampleBlock(features, scale, generator=g)
        self.final_conv = Conv3x3(features, 3, generator=g)
        self.mean_inverse_shift = MeanShift(sign=-1.0)

    def forward(self, x: torch.Tensor, pair: Callable = exact_pair,
                tail: Optional[Callable] = None) -> torch.Tensor:
        """The forward, with block i's convs run by `pair(i, res, body[0],
        body[2], kind="none")`, then its gate, res_weight (rounded to the
        dtype first, as JAX's weak-typed scalar is) and the add; the tail,
        from the trunk's output after the global skip, by `tail(h)` (None:
        the module's own upsample, final_conv and inverse mean shift), as
        EDSRModule.forward."""
        x = self.first_conv(self.mean_shift(x))
        res = x
        for i, block in enumerate(self.res_blocks):
            t = block.body[3](pair(i, res, block.body[0], block.body[2], kind="none"))
            if block.res_weight != 1.0:
                t = t * torch.tensor(block.res_weight, dtype=t.dtype, device=t.device)
            res = res + t
        x = x + self.after_res_conv(res)
        if tail is not None:
            return tail(x)
        x = self.final_conv(self.upsample(x))
        return self.mean_inverse_shift(x)


class MAMNet(TrainedMeanShiftMixin, StepDecayMixin, SRModel):
    lr_flag = "mamnet_learning_rate"
    decay_flag = "mamnet_learning_rate_decay"
    decay_steps_flag = "mamnet_learning_rate_decay_steps"
    has_collapsed_tail = True
    serving_flags = ("packed_trunk",)

    def serves_collapsed_tail(self, args) -> bool:
        """Whatever --collapsed_tail says, as JAX's CLIs serve
        make_packed_mamnet_forward (cli/common.py:324-329); the module graph
        under --packed_trunk 0."""
        return str(getattr(args, "packed_trunk", None)) != "0"

    def parse_args(self, args):
        parser = argparse.ArgumentParser()
        parser.add_argument("--mamnet_conv_features", type=int, default=64,
                            help="The number of convolutional features.")
        parser.add_argument("--mamnet_res_blocks", type=int, default=16,
                            help="The number of residual blocks.")
        parser.add_argument("--mamnet_res_weight", type=float, default=1.0,
                            help="The scaling factor.")
        parser.add_argument("--mamnet_learning_rate", type=float, default=1e-4,
                            help="Initial learning rate.")
        parser.add_argument("--mamnet_learning_rate_decay", type=float, default=0.5,
                            help="Learning rate decay factor.")
        parser.add_argument("--mamnet_learning_rate_decay_steps", type=int, default=200000,
                            help="The number of training steps to perform learning rate "
                                 "decay.")
        parser.add_argument("--packed_trunk_train", type=int, default=0,
                            help="The JAX package's width-packed training graph: the loss "
                                 "on the HR image through the live collapsed tail. Even "
                                 "patch widths; an odd one falls back with a warning.")
        parser.add_argument("--collapsed_tail_train", type=int, default=1,
                            help="Train through the LIVE collapsed tail (plain trunk; "
                                 "loss/grad-equivalent). 0 = plain module graph.")
        parser.add_argument("--lr_domain_loss", type=int, default=1,
                            help="With --collapsed_tail_train: compute the training L1 "
                                 "loss PRE-SHUFFLE in the LR domain (targets pixel-"
                                 "unshuffled instead; identical per-element grads). 0 = "
                                 "HR-domain loss.")
        parser.add_argument("--qat", type=int, default=0,
                            help="UNSUPPORTED for mamnet (declared so the flag errors "
                                 "instead of vanishing as a leftover). Use post-training "
                                 "int8 with the --int8_report guardrail.")
        self.args, remaining = parse_known(parser, args)
        return self.args, remaining

    def prepare(self, scales, device="cuda", seed: int = 0, is_training: bool = False,
                global_step: int = 0):
        if is_training and getattr(self.args, "qat", 0):
            raise ValueError(QAT_REFUSAL)
        self._warned_odd_packed = False
        super().prepare(scales, device=device, seed=seed, is_training=is_training,
                        global_step=global_step)

    def train_tail_route(self, width: int) -> Optional[str]:
        """The training tail at patch width `width` (_compute_loss,
        mamnet.py:143-177): "collapsed" (the live collapsed tail, the loss on
        the HR image) under --packed_trunk_train 1 at an even width;
        otherwise, under --collapsed_tail_train 1, "lr_domain" (the loss
        before the shuffle) with --lr_domain_loss 1, else "collapsed"; None
        (the plain tail) under --collapsed_tail_train 0 or when the mean
        shifts are not the intended ones (JAX's graphs bake those). An odd
        width under --packed_trunk_train 1 prints JAX's warning once."""
        a = self.args
        packed = bool(getattr(a, "packed_trunk_train", 0))
        if packed and width % 2 and not self._warned_odd_packed:
            self._warned_odd_packed = True
            print("WARNING: --packed_trunk_train 1 but patch width %d is "
                  "odd — falling back to the %s graph for odd-width "
                  "batches (use an even --input_patch_size to stay packed)"
                  % (width, "collapsed-tail" if getattr(a, "collapsed_tail_train", 0)
                     else "plain module"))
        if not mean_shifts_intended(self.module):
            return None
        if packed and width % 2 == 0:
            return "collapsed"
        if not getattr(a, "collapsed_tail_train", 0):
            return None
        return "lr_domain" if getattr(a, "lr_domain_loss", 0) else "collapsed"

    def _compute_loss(self, inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """The L1 loss of the module's f32 forward through the tail of
        `train_tail_route` (the plain trunk in every route, as JAX's default
        make_collapsed_mamnet_train_forward)."""
        from larvanet_tpu_torch.ops.collapsed_tail import live_collapsed_tail_hook
        from larvanet_tpu_torch.ops.pixel_shuffle import pixel_unshuffle

        route = self.train_tail_route(inputs.shape[2])
        tail = None
        if route is not None:
            tail = live_collapsed_tail_hook(self.module, self.scale,
                                            lr_domain=route == "lr_domain")
        if route == "lr_domain":
            targets = pixel_unshuffle(targets, self.scale)
        return self.loss(self.module(inputs, tail=tail), targets)

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return MAMNetModule(features=self.args.mamnet_conv_features,
                            num_blocks=self.args.mamnet_res_blocks,
                            res_weight=self.args.mamnet_res_weight,
                            scale=self.scale, generator=generator)


@register_model("mamnet")
def create_mamnet():
    return MAMNet()
