"""bf16 in the port's training and serving forwards against the JAX
package's, on the CPU, at a tiny width (EDSR 2 blocks x 8 features, LarvaNet
--num_blocks 2,2).

`--train_dtype bf16` (models/edsr.py) is JAX's mixed-precision step: the
forward and its backward in bf16, each conv's f32 master weight cast to
bf16 as it is used, the loss reduced in f32. Two differences from JAX bound
the bars. (1) Rounding: the port's conv rounds sum + bias to bf16 once,
XLA's rounds the conv, then adds the bf16 bias and rounds again, and both
sum in f32 in other orders; an output a half step from a bf16 value lands on
either side, and the step after it differs by a bf16 step (2^-8 of its
value). (2) The bias gradients: XLA's CPU gradient of a bf16 bias add is a
sum accumulated in bf16 (on 4,608 terms of +-1/13,824 it gives -0.00090
where the exact sum is -0.00058), while the port sums the same bf16 values
in f32 and rounds once. So JAX's bias gradients are no reference at bf16:
the port's are held to the float64 sums of its own bf16 cotangents, and the
loss and the weight gradients to JAX's.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.ops.fastpath import build_fast_forward
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.ops import conv3x3_wgrad
from larvanet_tpu_torch.utils.torch_convert import state_dict_from_jax_params

TINY = ["--edsr_conv_features", "8", "--edsr_res_blocks", "2"]
SCALE, PATCH = 4, 8
# both with --collapsed_tail_train 0 (the plain tail): the loss within 1e-4
# (measured 3.2e-5 here), each weight gradient within 2.5e-2 of its tensor's
# largest value (6.4 bf16 steps; measured 1.6e-2 on res_blocks.0.body.0,
# 3.8e-3 to 7.8e-3 on the others)
TIGHT = {"loss": 1e-4, "weight": 2.5e-2}
# both on the default route, the tail collapsed into one conv, composed in
# f32 and run in bf16 (first measured with the port on the plain tail: loss
# 1.24e-4, weights as above)
DEFAULT = {"loss": 5e-4, "weight": 2.5e-2}
# a bias gradient against the float64 sum of the bf16 cotangent it sums:
# one bf16 rounding of an f32 sum
BIAS_RTOL = 2.0 ** -8


def _to_numpy(tree):
    if hasattr(tree, "items"):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    lr = rng.uniform(0, 255, (2, PATCH, PATCH, 3)).astype(np.float32)
    hr = np.repeat(np.repeat(lr, SCALE, 1), SCALE, 2)
    return lr, np.clip(hr + rng.normal(0, 8, hr.shape), 0, 255).astype(np.float32)


def _pair(jflags=(), pflags=("--train_dtype", "bf16")):
    jm = jax_get_model("edsr")
    jm.parse_args(TINY + ["--train_dtype", "bf16"] + list(jflags))
    jm.prepare(is_training=True, scales=[SCALE])
    pm = get_model("edsr")
    pm.parse_args(TINY + list(pflags))
    pm.prepare([SCALE], device="cpu", is_training=True)
    pm.load_state_dict(state_dict_from_jax_params(_to_numpy(jm.params), "edsr"))
    return jm, pm


@functools.lru_cache(maxsize=None)
def _step(route):
    """One bf16 step's (port, JAX) loss and gradients by port name, and the
    port's bias gradients beside the float64 sums of its bf16 cotangents."""
    tight = route == "tight"
    # tight: both on the plain tail; default: both on the live collapsed tail
    jm, pm = _pair(*((("--collapsed_tail_train", "0"),
                      ("--train_dtype", "bf16", "--collapsed_tail_train", "0")) if tight else ()))
    lr, hr = _batch()
    jloss, jgrads = jax.value_and_grad(jm._compute_loss)(jm.params, jnp.asarray(lr),
                                                       jnp.asarray(hr))
    sums = []
    real = conv3x3_wgrad.conv3x3_wgrad

    def recording(x, g, path=None):
        # the plain tail's convs are the module's: all bf16 (the collapsed
        # tail composes its kernel in f32, as JAX does)
        assert x.dtype == g.dtype == torch.bfloat16 or not tight
        sums.append(g.double().sum((0, 1, 2)))
        return real(x, g, path)

    conv3x3_wgrad.conv3x3_wgrad = recording
    try:
        ploss = pm._loss_and_grads(torch.from_numpy(lr), torch.from_numpy(hr))
    finally:
        conv3x3_wgrad.conv3x3_wgrad = real
    grads = {k: p.grad for k, p in pm.module.named_parameters()}
    return float(ploss), float(jloss), grads, \
        state_dict_from_jax_params(_to_numpy(jgrads), "edsr"), sums


@pytest.mark.parametrize("route", ["tight", "default"])
def test_bf16_step_matches_jax(route):
    bars = TIGHT if route == "tight" else DEFAULT
    ploss, jloss, grads, jgrads, _ = _step(route)
    assert abs(ploss - jloss) <= bars["loss"] * abs(jloss), (ploss, jloss)
    for name, g in grads.items():
        err = float((g - jgrads[name]).abs().max() / jgrads[name].abs().max())
        print("bf16 step (%s) %s: max|d| / max|g| %.3g" % (route, name, err))
        assert g.dtype == torch.float32
        if name.endswith("weight"):
            assert err <= bars["weight"], (name, err)


def test_bf16_bias_grads_are_one_rounding_of_their_sums():
    """Every bias gradient is bf16 (the cast's cotangent) and within one
    bf16 rounding of the float64 sum of the bf16 cotangent it sums; the
    weight gradients are bf16 values too."""
    _, _, grads, _, sums = _step("tight")
    biases = [g for name, g in grads.items() if name.endswith("bias")]
    assert len(sums) == len(biases)
    for g, want in zip(biases, reversed(sums)):  # the backward runs last conv first
        assert torch.equal(g, g.bfloat16().float())
        assert float((g.double() - want).abs().max()) <= BIAS_RTOL * float(want.abs().max())
    for name, g in grads.items():
        assert torch.equal(g, g.bfloat16().float()), name


def test_packed_trunk_0_trains_bf16_in_f32():
    """With an explicit --packed_trunk 0 JAX trains in f32 whatever
    --train_dtype says: the port's step then equals its f32 step on the same
    graph (the plain tail, as --packed_trunk 0 trains) bit for bit."""
    lr, hr = _batch(1)
    grads = []
    for flags in (["--train_dtype", "bf16", "--packed_trunk", "0"],
                  ["--collapsed_tail_train", "0"]):
        pm = get_model("edsr")
        pm.parse_args(TINY + flags)
        pm.prepare([SCALE], device="cpu", is_training=True)
        assert pm.train_compute_dtype() == torch.float32
        pm._loss_and_grads(torch.from_numpy(lr), torch.from_numpy(hr))
        grads.append([p.grad.clone() for p in pm.module.parameters()])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


# the bf16 serving forward against JAX's bf16 fast path (build_fast_forward):
# EDSR's is the packed trunk with the collapsed tail (one conv for the whole
# upsampler, exact in f32, not in bf16), LarvaNet's the packed trunk. Bars
# on the largest |d| relative to the output's largest |value|, measured
# 4.6e-3 (EDSR) and 5.4e-5 (LarvaNet) here
FAST_BF16_RTOL = {"edsr": 2.0 ** -6, "LarvaNet": 2.0 ** -6}


@pytest.mark.parametrize("name", ["edsr", "LarvaNet"])
def test_bf16_forward_matches_jax_fast_path(name):
    flags = TINY if name == "edsr" else ["--num_blocks", "2,2"]
    jm = jax_get_model(name)
    jm.parse_args(list(flags))
    jm.prepare(is_training=False, scales=[SCALE])
    fwd, _ = build_fast_forward(jm, jnp.bfloat16)
    pm = get_model(name)
    pm.parse_args(list(flags))
    pm.prepare([SCALE], device="cpu")
    pm.load_state_dict(state_dict_from_jax_params(_to_numpy(jm.params), name))
    pm.set_serving_dtype("bf16")
    x = np.random.default_rng(2).uniform(0, 255, (2, 9, 10, 3)).astype(np.float32)
    want = np.asarray(jax.jit(fwd)(jm.params, jnp.asarray(x)), np.float32)
    got = pm.fwd_runtime(torch.from_numpy(x)).numpy()
    err = float(np.abs(got - want).max() / np.abs(want).max())
    print("%s bf16 forward vs JAX's bf16 fast path: max|d| / max|y| %.3g" % (name, err))
    assert got.shape == want.shape and err <= FAST_BF16_RTOL[name]


def test_wgrad_plain_version_takes_bf16():
    """conv3x3_wgrad on bf16 CPU tensors is the plain version on their f32
    values (exact widening): f32 results."""
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((1, 5, 6, 16)).astype(np.float32)).bfloat16()
    g = torch.from_numpy(rng.standard_normal((1, 5, 6, 8)).astype(np.float32)).bfloat16()
    dw, db = conv3x3_wgrad.conv3x3_wgrad(x, g)
    want_w, want_b = conv3x3_wgrad.conv3x3_wgrad_reference(x.float(), g.float())
    assert dw.dtype == db.dtype == torch.float32
    assert torch.equal(dw, want_w) and torch.equal(db, want_b)
