"""The LarvaNet multi-exit family (larvanet_tpu/models/larvanet.py; reference
models/LarvaNet.py and its variant files).

One configurable module covers the nine reference variants and the two
w64 presets, NHWC:

  head:   conv 3 -> F (0.1-scaled Kaiming init)
  body_i: num_blocks[i] ResBlocks + the module skip; body style 'res'
          carries a second stream (fea + res', res')
  leg_i:  reconstruction -> PixelShuffle(4) -> + interpolated base; leg
          styles '2conv' (conv, ReLU, conv to 3 * 4^2 = 48 shuffle
          channels, so the w64 legs narrow 64 -> 48), 'none', 'resblock'
          and 'skip' (recon(x) + x)
  tail:   concat of every body's features -> merge conv -> 2conv recon ->
          PixelShuffle(4) -> + base (the V2 presets, whose inference exits
          through the tail)

Parameters carry the reference's state_dict names, the ones
larvanet_tpu/utils/torch_convert.py:482-503 exports: `head.feature_extraction`,
`body_{i}.res_blocks.{j}.body.{0,2}`, `body_{i}.leg.recon_block.{0,2}`
(`.recon_block.body.{0,2}` for the 'resblock' leg), `tail.merge_conv`,
`tail.recon_block.{0,2}`; there is no MeanShift. Every conv goes through
`ops.conv3x3`, the hand-written kernel on the card.

Training (larvanet.py:181-414): AdamW on the multi-exit loss, the mean of
the L1 losses of every exit (`walk(x, "all")`: every leg, then the V2
tail), with the learning rate of a ReduceLROnPlateau on the validation
PSNR; --qat 1 fake-quantizes every body and leg conv pair (ops/pairs.py).
`train_step` is one step at that rate (the step-driven train CLI, which
never validates); `train_step_larva` is the volume-driven step of
the train_larva CLIs: every `--val_volume` bytes of input pixels it
validates, steps the schedule, saves `model_step<N>_vol<G>G.pth` and
writes the summary. JAX's default training graph takes every exit's loss
before the shuffle (--lr_domain_loss 1, larvanet.py:242-248, :310-322;
ops/packed/larvanet.py:112-135): each leg (and the V2 tail) returns its 48
channels plus the base unshuffled once, against the pixel-unshuffled
targets; the port does the same, with JAX's rule that it applies only while
--packed_trunk is not 0 (the width-packed layout itself is not ported: an
exact reparametrisation). The V2 presets restore partially: a
LarvaNet checkpoint gives them its bodies and legs, the tail keeps its
init (`_V2Mixin`).
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional, Sequence, Union

import torch
from torch import nn

from larvanet_tpu_torch.core.config import parse_known
from larvanet_tpu_torch.core.registry import register_model
from larvanet_tpu_torch.models.base import (SRModel, add_qat_flag, qat_requested,
                                            remat_requested)
from larvanet_tpu_torch.models.layers import Conv3x3, ResBlock, exact_pair, interpolated_base
from larvanet_tpu_torch.models.volume import PlateauVolumeMixin
from larvanet_tpu_torch.ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle
from larvanet_tpu_torch.train.losses import multi_exit_l1

FEATURES = 48  # the reference's trunk width (reference models/LarvaNet.py:226)
SCALE = 4  # every exit is a PixelShuffle(4): 3 * SCALE^2 = 48 channels -> 3
SHUFFLE_CHANNELS = 3 * SCALE * SCALE
INIT_SCALE = 0.1  # kaiming_normal_ x 0.1, zero bias (models/LarvaNet.py:22-39)
LEG_STYLES = ("2conv", "none", "resblock", "skip")
BODY_STYLES = ("plain", "res")

Exits = Union[str, int]


class ReconBlock(nn.ModuleList):
    """conv F -> F, ReLU (fused in conv 0's kernel), conv F -> 48, at the
    reference's Sequential indices 0 and 2."""

    def __init__(self, in_features: int, generator: Optional[torch.Generator] = None):
        super().__init__([
            Conv3x3(in_features, in_features, act="relu", generator=generator,
                    init_scale=INIT_SCALE),
            nn.Identity(),
            Conv3x3(in_features, SHUFFLE_CHANNELS, generator=generator,
                    init_scale=INIT_SCALE),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self[2](self[0](x))


def shuffle_exit(fea: torch.Tensor, base: torch.Tensor,
                 lr_domain: bool = False) -> torch.Tensor:
    """PixelShuffle(4) of 48 channels plus the base, summed in the base's
    f32 (a bf16 residual is widened exactly first, as JAX promotes it).
    `lr_domain`: no shuffle; `base` is then the base pixel-unshuffled, and
    the exit is the output before the shuffle (a permutation of it)."""
    if lr_domain:
        return fea.to(base.dtype) + base
    return pixel_shuffle(fea, SCALE).to(base.dtype) + base


class Leg(nn.Module):
    """Early-exit head of one module (models/larvanet.py:60-87)."""

    def __init__(self, style: str, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if style not in LEG_STYLES:
            raise ValueError("unknown leg style %r" % (style,))
        self.style = style
        if style in ("2conv", "skip"):
            self.recon_block = ReconBlock(features, generator)
        elif style == "resblock":
            self.recon_block = ResBlock(features, generator=generator,
                                        init_scale=INIT_SCALE)

    def pair(self):
        """The leg's conv pair and its kind: (conv1, conv2, 'none') for
        '2conv', (conv1, conv2, 'res') for 'skip' and 'resblock' (the skip
        add); None for 'none'."""
        if self.style == "none":
            return None
        rb = self.recon_block
        if self.style == "resblock":
            return rb.body[0], rb.body[2], "res"
        return rb[0], rb[2], "none" if self.style == "2conv" else "res"

    def forward(self, fea: torch.Tensor, base: torch.Tensor, pair: Callable = exact_pair,
                idx: int = -1, lr_domain: bool = False) -> torch.Tensor:
        """The exit, with the leg's conv pair run by `pair(idx, fea, conv1,
        conv2, kind=...)`; `lr_domain` as in `shuffle_exit`."""
        convs = self.pair()
        if convs is not None:
            fea = pair(idx, fea, convs[0], convs[1], kind=convs[2])
        return shuffle_exit(fea, base, lr_domain)


class Body(nn.Module):
    """One module: its ResBlocks (0.1 init) and its leg. The module skip
    and the 'res' stream live in LarvaNetModule.walk."""

    def __init__(self, num_blocks: int, features: int, leg_style: str,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.res_blocks = nn.ModuleList(
            [ResBlock(features, generator=generator, init_scale=INIT_SCALE)
             for _ in range(num_blocks)])
        self.leg = Leg(leg_style, features, generator)


class Tail(nn.Module):
    """The V2 tail: merge conv over every body's features, then the 2conv
    reconstruction (LarvaNetV2.py LarvaTail)."""

    def __init__(self, num_modules: int, features: int,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.merge_conv = Conv3x3(num_modules * features, features, generator=generator,
                                  init_scale=INIT_SCALE)
        self.recon_block = ReconBlock(features, generator)

    def forward(self, features: Sequence[torch.Tensor], base: torch.Tensor,
                lr_domain: bool = False) -> torch.Tensor:
        return shuffle_exit(self.recon_block(self.merge_conv(torch.cat(features, -1))), base,
                            lr_domain)


class LarvaNetModule(nn.Module):
    """The family's network (models/larvanet.py:104-178). `exits` is the
    exit that forward() takes when called without one: 'last' (inference:
    the last leg, or the tail when there is one), 'all' (every leg, then
    the tail: the training list), or k for the early exit through leg k
    (k = 0: the pure base; an early exit never uses the tail)."""

    def __init__(self, num_blocks: Sequence[int] = (16, 16), interpolate: str = "bicubic",
                 leg_style: str = "2conv", body_style: str = "plain",
                 use_tail: bool = False, features: int = FEATURES, exits: Exits = "last",
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        if features != SHUFFLE_CHANNELS and leg_style != "2conv":
            # the other legs shuffle the trunk tensor itself, which only
            # works at the 48-channel reference width (models/larvanet.py:118-123)
            raise ValueError("leg_style %r requires the 48-channel trunk (features=%d)"
                             % (leg_style, features))
        if body_style not in BODY_STYLES:
            raise ValueError("unknown body style %r" % (body_style,))
        self.num_blocks = tuple(int(b) for b in num_blocks)
        self.interpolate = interpolate
        self.body_style = body_style
        self.features = features
        self.use_tail = use_tail
        self.exits = self.check_exits(exits)
        g = generator
        self.head = nn.ModuleDict({"feature_extraction": Conv3x3(
            3, features, generator=g, init_scale=INIT_SCALE)})
        for i, n in enumerate(self.num_blocks):
            self.add_module("body_%d" % i, Body(n, features, leg_style, g))
        if use_tail:
            self.tail = Tail(len(self.num_blocks), features, g)

    def check_exits(self, exits: Exits) -> Exits:
        if exits in ("last", "all"):
            return exits
        m = len(self.num_blocks)
        if type(exits) is int and 0 <= exits <= m:
            return exits
        raise ValueError("exit %r: the model has %d modules, so an early exit is a leg "
                         "0..%d (0 = the pure base), or 'last' or 'all'" % (exits, m, m))

    def bodies(self):
        return [getattr(self, "body_%d" % i) for i in range(len(self.num_blocks))]

    def forward(self, x: torch.Tensor, exits: Optional[Exits] = None):
        return self.walk(x, self.exits if exits is None else exits)

    def walk(self, x: torch.Tensor, exits: Exits, pair: Callable = exact_pair,
             lr_domain: bool = False):
        """The forward (the topology of ops/packed/larvanet.py:17-153), with
        every conv pair run by `pair(idx, h, conv1, conv2, kind=...)`
        (layers.exact_pair: the modules themselves). The indices are JAX's:
        the body ResBlocks in execution order, then the serving leg; the
        other legs, run only for exits 'all', get -1. The fused Winograd
        route, the int8 calibration and replay and QAT come in here.
        `lr_domain` (the LR-domain training loss, ops/packed/larvanet.py:
        112-135): every exit before the shuffle, 48 channels plus the base
        unshuffled once."""
        exits = self.check_exits(exits)
        base = interpolated_base(x, SCALE, self.interpolate)
        if exits == 0:
            return base
        if lr_domain:
            base = pixel_unshuffle(base, SCALE)
        fea = self.head["feature_extraction"](x)
        bodies = self.bodies()
        n_run = exits if isinstance(exits, int) else len(bodies)
        want_last_leg = exits == "all" or isinstance(exits, int) or not self.use_tail
        outputs, features = [], []
        res, idx = fea, 0
        for i in range(n_run):
            h = fea if self.body_style == "plain" else res
            for block in bodies[i].res_blocks:
                h = pair(idx, h, block.body[0], block.body[2], kind="res",
                         res_weight=block.res_weight)
                idx += 1
            if self.body_style == "plain":
                fea = fea + h
            else:
                fea, res = fea + h, h
            features.append(fea)
            if exits == "all" or (i == n_run - 1 and want_last_leg):
                outputs.append(bodies[i].leg(fea, base, pair, idx if i == n_run - 1 else -1,
                                             lr_domain))
        if self.use_tail and not isinstance(exits, int):
            outputs.append(self.tail(features, base, lr_domain))
        return outputs if exits == "all" else outputs[-1]


class LarvaNetBase(PlateauVolumeMixin, SRModel):
    """Shared wrapper of the presets (models/larvanet.py:181-414): AdamW
    with the plateau learning rate and the volume-driven step
    (models/volume.py, shared with msrr_reduced). Every flag of the JAX parser parses;
    --lr_domain_loss 1 (the default) takes the loss before the shuffle while
    --packed_trunk is not 0, --packed_trunk itself is accepted (an explicit
    --packed_trunk 0 with --qat 1 or --remat 1 is refused, as in JAX), --qat
    1 trains through the fake-quant pairs and --remat 1 recomputes each pair
    in the backward. The family's exits are
    PixelShuffle(4): --scales 2 or 3 are accepted and the output is x4 all
    the same, as in JAX."""

    supported_scales = (2, 3, 4)

    # preset knobs overridden by the variants
    leg_style = "2conv"
    body_style = "plain"
    use_tail = False
    has_early_exit = False
    trunk_features = FEATURES
    width_flag = False  # the w64 presets: --num_features
    default_lr = 4e-4
    default_val_volume = 30e9
    default_min_lr = 1e-8
    default_patience = 3
    default_cooldown: Optional[int] = 6  # None: no --cooldown flag

    def parse_args(self, args):
        parser = argparse.ArgumentParser()
        parser.add_argument("--num_modules", type=int, default=2,
                            help="The number of residual blocks at LR domain.")
        parser.add_argument("--num_blocks", type=str, default="16",
                            help="The number of residual blocks at HR domain.")
        if self.has_early_exit:
            parser.add_argument("--leg", type=int, default=4,
                                help="The early exit leg number, starts at 1.")
        if self.width_flag:
            parser.add_argument("--num_features", type=int, default=self.trunk_features,
                                help="Trunk width (64 runs the trunk on the fused "
                                     "Winograd kernel under --wino_trunk).")
        parser.add_argument("--interpolate", type=str, default="bicubic",
                            help="Interpolation method.")
        parser.add_argument("--val_volume", type=float, default=self.default_val_volume,
                            help="How much volume need for validation.")
        parser.add_argument("--lr", type=float, default=self.default_lr,
                            help="Initial learning rate.")
        parser.add_argument("--lr_decay", type=float, default=0.5,
                            help="Learning rate decay factor.")
        parser.add_argument("--lr_step", type=int, default=20000,
                            help="Learning rate decay step.")
        parser.add_argument("--threshold", type=float, default=0.001,
                            help="Threshold for measuring the new optimum.")
        parser.add_argument("--min_lr", type=float, default=self.default_min_lr,
                            help="Minimum learning rate.")
        parser.add_argument("--patience", type=int, default=self.default_patience,
                            help="patience for lr scheduler")
        if self.default_cooldown is not None:
            parser.add_argument("--cooldown", type=int, default=self.default_cooldown,
                                help="cooldown for lr scheduler")
        parser.add_argument("--packed_trunk", type=int, default=None,
                            help="The JAX package's width-packed trunk (an exact "
                                 "reparametrisation the port does not run). Unset is JAX's "
                                 "1; 0 takes the loss after the shuffle, as JAX does.")
        parser.add_argument("--lr_domain_loss", type=int, default=1,
                            help="With --packed_trunk (unset: on): compute every "
                                 "exit's training L1 loss PRE-SHUFFLE in the LR "
                                 "domain (targets pixel-unshuffled instead; mean-L1 is "
                                 "permutation-invariant, identical per-element grads, "
                                 "the loss equal up to f32 summation order). 0 = "
                                 "HR-domain loss.")
        add_qat_flag(parser)
        parser.add_argument("--remat", type=int, default=0,
                            help="Recompute each conv pair's activations in the "
                                 "backward (torch.utils.checkpoint): a step's peak "
                                 "memory holds one pair's, the same gradients.")
        self.args, remaining = parse_known(parser, args)
        return self.args, remaining

    def block_list(self):
        blocks = tuple(int(b) for b in str(self.args.num_blocks).split(","))
        if len(blocks) != self.args.num_modules:
            raise ValueError("Argument num_blocks should have the same number of "
                             "elements as num_modules.")
        return blocks

    def build_module(self, generator: torch.Generator) -> nn.Module:
        return LarvaNetModule(
            num_blocks=self.block_list(), interpolate=self.args.interpolate,
            leg_style=self.leg_style, body_style=self.body_style, use_tail=self.use_tail,
            features=getattr(self.args, "num_features", self.trunk_features),
            exits=int(self.args.leg) if self.has_early_exit else "last",
            generator=generator)

    def _compute_loss(self, inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """The mean of every exit's L1 loss (larvanet.py:314-323). The exits
        are asked for by name: LarvaLeg's module defaults to its --leg. Under
        --qat 1 every body and leg pair runs `qat_pair`, whatever its index,
        as JAX's all-exits walk does (ops/packed/larvanet.py:298-309); the
        head, the V2 tail and the residual stream stay exact. Under --remat
        1 every body and leg pair recomputes its activations in the
        backward (ops/pairs.remat_pair, as ops/packed/larvanet.py:179)."""
        from larvanet_tpu_torch.ops.pairs import training_pair

        pair = training_pair(qat_requested(self), remat_requested(self))
        lr_domain = self.lr_domain_loss()
        if lr_domain:
            # the targets unshuffled once, with no backward
            targets = pixel_unshuffle(targets, SCALE)
        return multi_exit_l1(self.module.walk(inputs, "all", pair, lr_domain), targets)

    def lr_domain_loss(self) -> bool:
        """JAX's rule (_lr_domain_loss, larvanet.py:310-312): --lr_domain_loss
        1 while --packed_trunk is not 0 (unset is JAX's 1)."""
        a = self.args
        return getattr(a, "packed_trunk", None) != 0 and bool(getattr(a, "lr_domain_loss", 0))


class _V2Mixin:
    """The V2 presets' partial restore (larvanet.py:405-414, reference
    models/LarvaNetV2.py:198-207): the keys both sides have load, the tail
    of a LarvaNet checkpoint keeps its init."""

    def restore(self, ckpt_path: str, strict: bool = False) -> None:
        super().restore(ckpt_path, strict=False)


def _preset(name, **attrs):
    cls = type(name, tuple(attrs.pop("__bases__", (LarvaNetBase,))), attrs)

    @register_model(name)
    def factory(cls=cls):
        return cls()

    return cls


_V2 = dict(default_lr=1e-4, default_val_volume=3e9, default_min_lr=1e-7,
           default_cooldown=None)
_VARIANT = dict(default_patience=1, default_cooldown=None)

LarvaNet = _preset("LarvaNet")
# the TPU-native w64 presets (no reference counterpart): a 64-channel trunk
# whose legs narrow 64 -> 48; LarvaLeg_w64 takes LarvaNet_w64's weights
LarvaNetW64 = _preset("LarvaNet_w64", trunk_features=64, width_flag=True)
LarvaNet0c = _preset("LarvaNet_0c", leg_style="none", **_VARIANT)
LarvaNet1c = _preset("LarvaNet_1c", leg_style="resblock", **_VARIANT)
LarvaNet4c = _preset("LarvaNet_4c", **_VARIANT)
LarvaNetSkip = _preset("LarvaNet_skip", leg_style="skip", **_VARIANT)
LarvaNetRes = _preset("LarvaNet_res", body_style="res", **_VARIANT)
LarvaNetV2 = _preset("LarvaNetV2", __bases__=(_V2Mixin, LarvaNetBase), use_tail=True, **_V2)
LarvaLeg = _preset("LarvaLeg", has_early_exit=True, **_V2)
LarvaLegW64 = _preset("LarvaLeg_w64", has_early_exit=True, trunk_features=64,
                      width_flag=True, **_V2)
LarvaLegV2 = _preset("LarvaLegV2", __bases__=(_V2Mixin, LarvaNetBase), has_early_exit=True,
                     use_tail=True, **_V2)
