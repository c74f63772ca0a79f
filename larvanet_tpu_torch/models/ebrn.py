"""The EBRN family (larvanet_tpu/models/ebrn.py; reference models/ebrn.py,
ebrn_rm.py, ebrn_rm_BLI.py): full EBRN, registered as "ebrn", and the
reduced-memory "ebrn_rm" and "ebrn_rm_BLI". NHWC.

  EBRNModule    MeanShift(+1) -> feature_extract: conv 3 -> 4F, PReLU,
                4F -> F, PReLU, F -> F, PReLU -> --num_brms BRMs; BRM i
                up-projects (ConvTranspose2d, k/s/p 8/4/2 at x4), runs its
                sr_flow (three conv + PReLU at the HR size), and but for the
                last projects back down (a strided conv), diff = x - down,
                diff + bp_flow(diff) feeding BRM i + 1 -> the reverse fusion
                cascade sr = fusion_i(sr + sr_list[-(i + 1)]) at the HR size
                -> recon conv over the concat of the num_brms outputs (10F ->
                3) -> MeanShift(-1) (ebrn.py:73-107)
  EBRNRMModule  [MeanShift(+1)] -> first_conv 3 -> F -> --num_brms 'both'
                pairs brms.i (conv1 with LeakyReLU(0.05) fused, conv2),
                whose residual t feeds the next BRM and whose h + t the
                fusion takes -> the fusion cascade in LR space -> upsample
                conv 10F -> 3 scale^2 -> PixelShuffle -> MeanShift(-1), or
                for ebrn_rm_BLI no mean shift and + the bilinear base
                (ebrn.py:110-152)

Parameters carry the reference's state_dict names, the ones
larvanet_tpu/utils/torch_convert.py:567-637 exports: `feature_extract.N`
(PReLUs at the odd indices, key `weight`), `brms.N.up_block` in
ConvTranspose2d's (in, out, k, k) layout, `brms.N.down_block`,
`brms.N.{sr,bp}_flow.M`, `fusion_layers.N`, `recon_layer`; ebrn_rm's
`first_conv`, `brms.N.body.{0,2}`, `fusion_layers.N`, `upsample.body.0`;
and the MeanShift buffers but for ebrn_rm_BLI. The reference builds the
last BRM's down_block and bp_flow though its forward never runs them
(ebrn.py:156-176), so EBRNModule owns them too and a reference `.pth`
loads strictly. A checkpoint whose MeanShifts are trained (not the intended
+/-mean) is run with its own affines; its restore prints JAX's lines and
turns --packed_trunk off (models/base.TrainedMeanShiftMixin), and the
int8 forward refuses it.

Every 3x3 conv runs on the conv3x3 kernel (fe0 3 -> 4F and recon 10F -> 3
on its CUDA cores); the up- and down-projections are library convs
(F.conv_transpose2d, F.conv2d) and the PReLUs plain torch.where, as all
three are XLA ops in JAX. Full EBRN's graph is its forward: it has no
conv pairs and no trailing shuffle, so JAX gives it no packed, int8, QAT or
LR-domain route. `EBRNRMModule.walk(x, pair, lr_domain)` is ebrn_rm's one
topology (ops/packed/branchy.py:294-370): every BRM goes to `pair(idx, h,
conv1, conv2, kind="both")`; `lr_domain` (training) returns the output
before the shuffle with the inverse mean shift on every sub-pixel's RGB (a
per-channel constant for the intended shift) or BLI's base unshuffled.

Training: Adam at --learning_rate's step decay in the step-driven train
CLI. ebrn_rm / BLI, while --packed_trunk is not 0 (unset is JAX's 1),
through `training_pair` (--qat 1, --remat 1) with the loss before the
shuffle under --lr_domain_loss 1 (the default); else the module graph on
the HR image. Full EBRN trains its module graph on the HR image whatever
--lr_domain_loss says and refuses --qat 1 with JAX's message; it serves
its f32 module whatever --serving_dtype says, as JAX does.
--packed_full_ebrn (a TPU layout of full EBRN's HR flows) is accepted and
ignored.
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional

import torch
from torch import nn

from larvanet_tpu_torch.core.config import parse_known
from larvanet_tpu_torch.core.registry import register_model
from larvanet_tpu_torch.models.base import (SRModel, StepDecayMixin, TrainedMeanShiftMixin,
                                            add_training_flags, qat_requested,
                                            remat_requested)
from larvanet_tpu_torch.models.layers import (Conv3x3, ConvShuffle, DownProjection, MeanShift,
                                              PReLU, ResBlock, UpProjection, exact_pair,
                                              interpolated_base, inverse_shift_lr)
from larvanet_tpu_torch.ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle

UP_GEOM = {2: (6, 2, 2), 3: (7, 3, 2), 4: (8, 4, 2)}  # k, s, p of the projections
SLOPE = 0.05  # ebrn_rm's LeakyReLU


def _conv_prelu_stack(features: int, g: Optional[torch.Generator]) -> nn.ModuleList:
    """The reference's Sequential(conv, PReLU, conv, PReLU, conv, PReLU)."""
    layers = []
    for _ in range(3):
        layers += [Conv3x3(features, features, generator=g), PReLU(features)]
    return nn.ModuleList(layers)


def _run_stack(stack: nn.ModuleList, h: torch.Tensor) -> torch.Tensor:
    for layer in stack:
        h = layer(h)
    return h


class BRM(nn.Module):
    """One back-projection unit (ebrn.py:52-70). Every BRM owns down_block
    and bp_flow, as the reference builds them; EBRNModule runs them on all
    but the last."""

    def __init__(self, features: int, scale: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        g = generator
        k, s, p = UP_GEOM[scale]
        self.up_block = UpProjection(features, features, k, s, p, g)
        self.sr_flow = _conv_prelu_stack(features, g)
        self.down_block = DownProjection(features, features, k, s, p, g)
        self.bp_flow = _conv_prelu_stack(features, g)

    def forward(self, x: torch.Tensor, back_project: bool = True):
        """(diff, sr), or sr alone without the back-projection."""
        up = self.up_block(x)
        sr = _run_stack(self.sr_flow, up)
        if not back_project:
            return sr
        diff = x - self.down_block(up)
        return diff + _run_stack(self.bp_flow, diff), sr


class EBRNModule(nn.Module):
    """Full EBRN (ebrn.py:73-107)."""

    def __init__(self, features: int = 64, num_brms: int = 10, scale: int = 4,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        g, f = generator, features
        self.mean_shift = MeanShift(sign=1.0)
        self.mean_inverse_shift = MeanShift(sign=-1.0)
        self.feature_extract = nn.ModuleList([
            Conv3x3(3, 4 * f, generator=g), PReLU(4 * f),
            Conv3x3(4 * f, f, generator=g), PReLU(f),
            Conv3x3(f, f, generator=g), PReLU(f)])
        self.brms = nn.ModuleList([BRM(f, scale, g) for _ in range(num_brms)])
        self.fusion_layers = nn.ModuleList([Conv3x3(f, f, generator=g)
                                            for _ in range(num_brms - 1)])
        self.recon_layer = Conv3x3(f * num_brms, 3, generator=g)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = _run_stack(self.feature_extract, self.mean_shift(x))
        sr_list = []
        for brm in self.brms[:-1]:
            h, sr = brm(h)
            sr_list.append(sr)
        sr = self.brms[-1](h, back_project=False)
        out_list = [sr]
        for i, fusion in enumerate(self.fusion_layers):
            sr = fusion(sr + sr_list[-(i + 1)])
            out_list.append(sr)
        return self.mean_inverse_shift(self.recon_layer(torch.cat(out_list, dim=-1)))


class EBRNRMModule(nn.Module):
    """ebrn_rm and, with `bilinear_base`, ebrn_rm_BLI (ebrn.py:110-152)."""

    def __init__(self, features: int = 64, num_brms: int = 10, scale: int = 4,
                 bilinear_base: bool = False, generator: Optional[torch.Generator] = None):
        super().__init__()
        g, f = generator, features
        self.scale, self.bilinear_base = scale, bilinear_base
        if not bilinear_base:
            self.mean_shift = MeanShift(sign=1.0)
            self.mean_inverse_shift = MeanShift(sign=-1.0)
        self.first_conv = Conv3x3(3, f, generator=g)
        self.brms = nn.ModuleList([ResBlock(f, 1.0, g, activation="leaky_relu", slope=SLOPE)
                                   for _ in range(num_brms)])
        self.fusion_layers = nn.ModuleList([Conv3x3(f, f, generator=g)
                                            for _ in range(num_brms - 1)])
        self.upsample = ConvShuffle(Conv3x3(f * num_brms, 3 * scale * scale, generator=g),
                                    scale)

    def pairs(self):
        """The BRMs' conv pairs in the walk's order (the int8 forward's)."""
        return [(b.body[0], b.body[2]) for b in self.brms]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.walk(x)

    def walk(self, x: torch.Tensor, pair: Callable = exact_pair,
             lr_domain: bool = False) -> torch.Tensor:
        h = self.first_conv(x if self.bilinear_base else self.mean_shift(x))
        outs = []
        for i, brm in enumerate(self.brms):
            # the residual stream feeds the next BRM (ebrn_rm.py forward)
            h, out = pair(i, h, brm.body[0], brm.body[2], kind="both")
            outs.append(out)
        out = outs[-1]
        primes = [out]
        for i, fusion in enumerate(self.fusion_layers):
            out = fusion(out + outs[-(i + 2)])
            primes.append(out)
        up = self.upsample.body[0](torch.cat(primes, dim=-1))
        s = self.scale
        if lr_domain:
            if self.bilinear_base:
                return up + pixel_unshuffle(interpolated_base(x, s, "bilinear"), s)
            return inverse_shift_lr(self.mean_inverse_shift, up)
        sr = pixel_shuffle(up, s)
        if self.bilinear_base:
            return sr + interpolated_base(x, s, "bilinear")
        return self.mean_inverse_shift(sr)


class _EBRNBase(TrainedMeanShiftMixin, StepDecayMixin, SRModel):
    """The family's flags and Adam at --learning_rate's step decay
    (ebrn.py:155-200)."""

    lr_flag = "learning_rate"
    decay_flag = "learning_rate_decay"
    decay_steps_flag = "learning_rate_decay_steps"

    def parse_args(self, args):
        parser = argparse.ArgumentParser()
        parser.add_argument("--num_filters", type=int, default=64,
                            help="The number of filters.")
        parser.add_argument("--num_brms", type=int, default=10,
                            help="The number of modules.")
        parser.add_argument("--learning_rate", type=float, default=1e-4,
                            help="Initial learning rate.")
        parser.add_argument("--learning_rate_decay", type=float, default=0.5,
                            help="Learning rate decay factor.")
        parser.add_argument("--learning_rate_decay_steps", type=int, default=200000,
                            help="The number of training steps to perform learning rate "
                                 "decay.")
        parser.add_argument("--packed_full_ebrn", type=int, default=0,
                            help="The JAX package's width-packed HR flows of full EBRN (a "
                                 "TPU layout); accepted and ignored.")
        add_training_flags(parser)
        self.args, remaining = parse_known(parser, args)
        return self.args, remaining


class EBRN(_EBRNBase):
    """Full EBRN (ebrn.py:246-293, `_EBRNPackedMixin`)."""

    def build_module(self, generator: torch.Generator) -> nn.Module:
        a = self.args
        return EBRNModule(features=a.num_filters, num_brms=a.num_brms, scale=self.scale,
                          generator=generator)

    def set_serving_dtype(self, name: str) -> None:
        """The f32 module whatever `name` says, as JAX serves full EBRN:
        --serving_dtype sets the dtype of the packed graphs (models/base.py:
        42-54), and full EBRN takes none (ebrn.py:262-266)."""
        if name != "f32":
            print("serving: full EBRN runs its f32 module; --serving_dtype %s applies to "
                  "the packed graphs, which it does not take (as in the JAX package)"
                  % (name,))
        super().set_serving_dtype("f32")

    def _compute_loss(self, inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """The module graph on the HR image; --qat 1 is refused as JAX
        refuses it (ebrn.py:269-276)."""
        if qat_requested(self):
            raise ValueError("--qat applies to the ebrn_rm variants (full EBRN has no int8 "
                             "serving path)")
        return self.loss(self.module(inputs), targets)


class EBRNRM(_EBRNBase):
    """ebrn_rm, and ebrn_rm_BLI with `bilinear_base` (`_EBRNRMPackedMixin`,
    ebrn.py:203-243)."""

    bilinear_base = False

    def build_module(self, generator: torch.Generator) -> nn.Module:
        a = self.args
        return EBRNRMModule(features=a.num_filters, num_brms=a.num_brms, scale=self.scale,
                            bilinear_base=self.bilinear_base, generator=generator)

    def _compute_loss(self, inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """While --packed_trunk is not 0, the walk through `training_pair`
        with the loss before the shuffle under --lr_domain_loss 1 (ebrn.py:
        231-242); else the module graph on the HR image."""
        from larvanet_tpu_torch.ops.pairs import training_pair

        if getattr(self.args, "packed_trunk", None) == 0:
            return self.loss(self.module(inputs), targets)
        lr_domain = bool(getattr(self.args, "lr_domain_loss", 0))
        if lr_domain:
            targets = pixel_unshuffle(targets, self.scale)  # no backward
        pair = training_pair(qat_requested(self), remat_requested(self))
        return self.loss(self.module.walk(inputs, pair, lr_domain), targets)


class EBRNRMBLI(EBRNRM):
    bilinear_base = True


@register_model("ebrn")
def create_ebrn():
    return EBRN()


@register_model("ebrn_rm")
def create_ebrn_rm():
    return EBRNRM()


@register_model("ebrn_rm_BLI")
def create_ebrn_rm_bli():
    return EBRNRMBLI()
