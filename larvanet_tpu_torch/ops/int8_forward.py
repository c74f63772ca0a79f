"""The W8A8 int8 forwards of EDSR, MAMNet, the LarvaNet family, the MSRR
family, TreeNet, the REGOs, ebrn_rm (and BLI) and the HRSR family.

Counterparts of `make_int8_edsr_forward` (larvanet_tpu/ops/packed/edsr.py:
114; MAMNet's too, for JAX's ops/packed/mamnet.py:129-143),
`make_int8_larvanet_forward` (ops/packed/larvanet.py:187),
`make_int8_msrr_forward` (ops/packed/msrr.py:137-147) and
`make_int8_treenet_forward` / `make_int8_rego_forward` /
`make_int8_hrsr_forward` / `make_int8_ebrn_rm_forward`
(ops/packed/branchy.py:87-101, :277-290, :165-175, :372-383). Each
runs its module's own walk (EDSRModule.forward, LarvaNetModule.walk, the
MSRR, TreeNet, REGO, EBRN-RM and HRSR modules' walk) with
every conv pair handed to a pair runner (ops/pairs.py), with JAX's pair
indices: the body blocks in execution order, then the serving leg. The int8
forward calibrates once over a batch with the exact pair in `dtype` and
replays the walk with the int8 pair on the conv3x3_s8 kernel; heads, EDSR's
after_res_conv and tail, the V2 tail and the residual stream stay exact, in
`dtype`, on the conv3x3 kernel. The CLIs build it in bf16 whatever
--serving_dtype says, as JAX's do. An odd-width input raises (the CLIs'
route sends it to the exact forward).

EDSR's and MAMNet's tail is the baked collapsed tail (ops/collapsed_tail.py
`collapsed_edsr_tail`: one 5x5 conv on the conv_kxk kernel, the border
operators, one shuffle), in `dtype`, as JAX's int8 forward bakes it
(ops/packed/edsr.py:114-142); a module whose mean shifts are not the
intended ones keeps its own tail.
"""

from __future__ import annotations

import copy

import torch

from larvanet_tpu_torch.models.larvanet import SCALE
from larvanet_tpu_torch.models.layers import interpolated_base, mean_shifts_intended
from larvanet_tpu_torch.ops.pairs import make_int8


class Int8Unsupported(ValueError):
    """A model family or configuration with no int8 path (JAX's makers raise
    ValueError for it, and the CLIs keep the exact route). Only this is
    caught by the CLIs: a failure while calibrating propagates."""


def _module_in(model, dtype: torch.dtype):
    """The model's module with its weights in `dtype` (a cast copy unless
    f32): the exact parts of the int8 walk run in `dtype`."""
    return model.module if dtype == torch.float32 else copy.deepcopy(model.module).to(dtype)


def make_int8_edsr_forward(model, calib_batch, dtype: torch.dtype = torch.bfloat16):
    """W8A8 EDSR inference (ops/packed/edsr.py:114-142): every ResBlock pair
    int8, calibrated on `calib_batch` (NHWC float, even width); the head,
    after_res_conv and the baked collapsed tail exact in `dtype`. Returns
    forward(x) for an NHWC batch on the model's device.

    The same function is MAMNet's (JAX's make_int8_mamnet_forward,
    ops/packed/mamnet.py:129-143): its module has EDSR's walk, whose blocks
    hand the pair `body[0]`, `body[2]` with kind 'none' (relu inside conv_a,
    no skip in conv_b) and apply the MAM gate (its variance, squeeze-excite
    and depthwise CSD), res_weight and the add exact in `dtype`."""
    from larvanet_tpu_torch.ops.collapsed_tail import collapsed_edsr_tail

    pairs = [(b.body[0], b.body[2]) for b in model.module.res_blocks]
    module = _module_in(model, dtype)
    return make_int8(model, calib_batch, dtype,
                     lambda x, pair: module(x, pair, collapsed_edsr_tail(model)), pairs)



def make_int8_larvanet_forward(model, calib_batch, dtype: torch.dtype = torch.bfloat16):
    """W8A8 LarvaNet-family inference (ops/packed/larvanet.py:187-235): the
    body pairs of the modules that run, then the serving leg's pair (none
    for leg style 'none', nor when a V2 model exits through its exact tail);
    `--leg 0` is the pure base. A 'res' body style raises ValueError, as in
    JAX (the CLIs then keep the exact route)."""
    m = model.module
    if m.body_style != "plain":
        raise Int8Unsupported("int8 path supports plain-body configs")
    exits = m.exits
    if exits == 0:
        return lambda x: interpolated_base(x.to(dtype), SCALE, m.interpolate)
    bodies = m.bodies()
    n_run = exits if isinstance(exits, int) else len(bodies)
    pairs = [(b.body[0], b.body[2]) for body in bodies[:n_run] for b in body.res_blocks]
    leg = bodies[n_run - 1].leg.pair()
    if leg is not None and not (m.use_tail and not isinstance(exits, int)):
        pairs.append(leg[:2])
    module = _module_in(model, dtype)
    return make_int8(model, calib_batch, dtype,
                     lambda x, pair: module.walk(x, exits, pair), pairs)


def make_int8_msrr_forward(model, calib_batch, dtype: torch.dtype = torch.bfloat16):
    """W8A8 MSRR-family inference (ops/packed/msrr.py:137-147): every
    ResBlock pair int8, its activation (relu, relu6, leaky_relu at --slope)
    conv1's, inside conv_a before the requantize, as pair_int8 applies it;
    the head, the upsample and HR convs, the shuffle, the base and the
    residual stream exact in `dtype`. A depthwise config (dwsr_reduced) has
    no int8 path: Int8Unsupported, with JAX's reason (packed/msrr.py:39-40)."""
    m = model.module
    if getattr(m, "depthwise", False):
        raise Int8Unsupported("depthwise blocks do not pack profitably")
    blocks = m.recon_trunk if hasattr(m, "recon_trunk") else m.res_blocks
    pairs = [(b.conv1, b.conv2) if hasattr(b, "conv1") else (b.body[0], b.body[2])
             for b in blocks]
    module = _module_in(model, dtype)
    return make_int8(model, calib_batch, dtype, lambda x, pair: module.walk(x, pair), pairs)


def _make_int8_walk(model, calib_batch, dtype: torch.dtype):
    """The int8 forward of a module whose `walk(x, pair)` is its serving
    graph and whose `pairs()` lists the walk's conv pairs in order."""
    module = _module_in(model, dtype)
    return make_int8(model, calib_batch, dtype, lambda x, pair: module.walk(x, pair),
                     model.module.pairs())


def make_int8_treenet_forward(model, calib_batch, dtype: torch.dtype = torch.bfloat16):
    """W8A8 TreeNet inference of branch 0, the reference's inference branch
    (branchy.py:87-101): the common blocks' pairs, then branch 0's, int8;
    the head (its LeakyReLU fused), the shuffle, the base and the residual
    stream exact in `dtype`."""
    return _make_int8_walk(model, calib_batch, dtype)


def make_int8_rego_forward(model, calib_batch, dtype: torch.dtype = torch.bfloat16):
    """W8A8 REGO-Net / REGO-serial inference (branchy.py:277-290): every
    RESBlock pair of the wavefront int8 in the walk's order, 'both'-kind
    (conv_b without the skip, then (t, hin + t)), its LeakyReLU(0.1) inside
    conv_a; the mean shift, the head, the fuse and SRrecon convs (C = 384),
    the shuffle and the base exact in `dtype`. A module whose mean shift is
    not the intended +mean (a trained reference checkpoint) has no int8
    path: JAX's forward bakes the intended shift (Int8Unsupported)."""
    if not model.module.mean_shift.intended():
        raise Int8Unsupported("the checkpoint carries a trained (non-identity) MeanShift "
                              "affine, which the int8 forward does not take")
    return _make_int8_walk(model, calib_batch, dtype)


def make_int8_ebrn_rm_forward(model, calib_batch, dtype: torch.dtype = torch.bfloat16):
    """W8A8 ebrn_rm / ebrn_rm_BLI inference (branchy.py:372-383): the
    num_brms BRM pairs int8, 'both'-kind, their LeakyReLU(0.05) inside
    conv_a; the mean shifts (or BLI's base), first_conv, the fusion cascade,
    the 10F-channel upsample conv and the shuffle exact in `dtype`. A module
    whose MeanShifts are not the intended ones has no int8 path, as REGO's
    (Int8Unsupported)."""
    m = model.module
    if not m.bilinear_base and not mean_shifts_intended(m):
        raise Int8Unsupported("the checkpoint carries trained (non-identity) MeanShift "
                              "affines, which the int8 forward does not take")
    return _make_int8_walk(model, calib_batch, dtype)


def make_int8_hrsr_forward(model, calib_batch, dtype: torch.dtype = torch.bfloat16):
    """W8A8 hrsr / hrsr_ / hrsr_c3 inference (branchy.py:165-175): the LR
    ResBlock pairs int8; the head (its LeakyReLU fused), the shuffle, the HR
    part and the base exact in `dtype`."""
    return _make_int8_walk(model, calib_batch, dtype)
