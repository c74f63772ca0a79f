"""The port's MSRR family (larvanet_tpu_torch/models/msrr.py) against the JAX
package's (larvanet_tpu/models/msrr.py, ops/packed/msrr.py), on the CPU, at
--num_blocks 2 (msrr and msrr_test at --num_filters 8): every registered
name's forward against JAX's module and its serving route
`make_packed_msrr_forward` at x2 and x4, odd and even widths, in f32 and
bf16; the converter against JAX's `export_state_dict`; the LR-domain
training forward.

JAX parameters cross over through the port's own `state_dict_from_jax_params`
into a strict load. As drawn, the family's 0.1-scaled init and zero biases
leave the trunk's part of the output (the residual over the base) small, so
every kernel is scaled by KERNEL_GAIN and every bias drawn from N(0, 1), as
tests/test_torch_larvanet.py does. Errors are held relative to the largest
value of that residual. The training, int8 and CLI parity is in
tests/test_torch_msrr_train.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.models.layers import DIV2K_RGB_MEAN
from larvanet_tpu.ops.packed.msrr import make_packed_msrr_forward
from larvanet_tpu.ops.resize import upsample
from larvanet_tpu.utils.torch_convert import export_state_dict
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.models.layers import exact_pair
from larvanet_tpu_torch.utils.torch_convert import state_dict_from_jax_params

BLOCKS = ["--num_blocks", "2"]
NAMES = {
    "msrr": ["--num_filters", "8"], "msrr_test": ["--num_filters", "8"],
    "msrr_reduced": [], "msrr_reduced_def_init": [], "msrr_reduced_NI": [],
    "msrr_reduced_linear": [], "msrr_reduced_relu6": [],
    "msrr_reduced_leaky": ["--slope", "0.2"], "msrr_reduced_meanshift": [],
    "dwsr_reduced": [],
}
DEPTHWISE = ("dwsr_reduced",)
KERNEL_GAIN = 2.0
# f32: the module graphs sum in another order (and the resamplers differ in
# theirs); bf16: both round every conv's output to bf16 and add the f32 base
F32_RTOL = 1e-4
BF16_RTOL = 2.0 ** -5


def _to_numpy(tree):
    if hasattr(tree, "items"):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.array(tree)


def _louder(tree, rng):
    """Every kernel times KERNEL_GAIN, every bias drawn from N(0, 1)."""
    if "kernel" in tree:
        return {"kernel": (tree["kernel"] * KERNEL_GAIN).astype(np.float32),
                "bias": rng.normal(0.0, 1.0, tree["bias"].shape).astype(np.float32)}
    return {k: _louder(v, rng) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _models(name, scale=4):
    """(JAX model with its louder parameters, those parameters as numpy,
    the port's model with them), f32, on the CPU."""
    flags = BLOCKS + NAMES[name]
    jm = jax_get_model(name)
    jm.parse_args(list(flags))
    jm.prepare(is_training=False, scales=[scale])
    params = _louder(_to_numpy(jm.params), np.random.default_rng(len(name) + scale))
    jm.params = jax.tree_util.tree_map(jnp.asarray, params)
    pm = get_model(name)
    pm.parse_args(list(flags))
    pm.prepare([scale], device="cpu")
    pm.load_state_dict(state_dict_from_jax_params(params, name))  # strict
    return jm, params, pm


def _lr(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


def _base(name, jm, x):
    """The part of JAX's output that is not the trunk's: the interpolated
    base, the inverse mean shift, or nothing."""
    if name == "msrr_test":
        return np.asarray(upsample(jnp.asarray(x), 4, "bilinear"))
    if name == "msrr":
        return np.asarray(upsample(jnp.asarray(x), jm.scale, "bilinear"))
    base = jm.module.base
    if base == "meanshift":
        return -np.asarray(DIV2K_RGB_MEAN, np.float32)
    if base is None:
        return np.float32(0.0)
    return np.asarray(upsample(jnp.asarray(x), jm.scale, base))


def _hold(label, got, want, residual, rtol):
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(residual).max())
    print("parity %s: max|d| %.3g, %.3g of the residual's max %.3g"
          % (label, err, err / scale, scale))
    assert scale > 1.0 and err <= rtol * scale


@pytest.mark.parametrize("scale", [2, 4])
@pytest.mark.parametrize("name", sorted(NAMES))
def test_forward_matches_jax_module_and_serving_route(name, scale):
    """The port's f32 forward against JAX's module and (but for the
    depthwise config, which JAX serves with its module) its serving route
    make_packed_msrr_forward, at an odd and an even width."""
    jm, params, pm = _models(name, scale)
    fwd = None if name in DEPTHWISE else make_packed_msrr_forward(jm, dtype=jnp.float32)
    for shape in ((2, 7, 9, 3), (1, 6, 10, 3)):
        x = _lr(shape, seed=shape[2] + scale)
        want = np.asarray(jm.module.apply({"params": params}, jnp.asarray(x)))
        residual = want - _base(name, jm, x)
        with torch.no_grad():
            got = pm.module(torch.from_numpy(x)).numpy()
        _hold("%s x%d %s vs module" % (name, scale, shape), got, want, residual, F32_RTOL)
        if fwd is not None:
            served = np.asarray(fwd(params, jnp.asarray(x)))
            _hold("%s x%d %s vs serving route" % (name, scale, shape), got, served, residual,
                  F32_RTOL)


@pytest.mark.parametrize("name", sorted(NAMES))
def test_bf16_forward_matches_jax(name):
    """The bf16 serving forward at x4 (an even width) against JAX's bf16
    serving route, or for the depthwise config its f32 module: within
    BF16_RTOL of the residual's largest value."""
    jm, params, pm = _models(name)
    x = _lr((1, 6, 10, 3), seed=3)
    if name in DEPTHWISE:
        want = np.asarray(jm.module.apply({"params": params}, jnp.asarray(x)))
    else:
        want = np.asarray(make_packed_msrr_forward(jm, dtype=jnp.bfloat16)(params,
                                                                            jnp.asarray(x)))
    want = want.astype(np.float32)
    pm.set_serving_dtype("bf16")
    try:
        got = pm.fwd_runtime(torch.from_numpy(x)).numpy()
    finally:
        pm.set_serving_dtype("f32")
    _hold("%s bf16" % name, got, want, want - _base(name, jm, x), BF16_RTOL)


@pytest.mark.parametrize("name", sorted(NAMES))
def test_converter_matches_jax_export(name):
    """The port's copy of the export rules gives JAX's `export_state_dict`,
    key for key and value for value (the MeanShifts of msrr and
    msrr_reduced_meanshift, the depthwise (C, 1, 3, 3) kernels), and the
    port's module loads it strictly (`_models`)."""
    _, params, pm = _models(name)
    want = export_state_dict(params, name)
    got = state_dict_from_jax_params(params, name)
    assert sorted(got) == sorted(want) == sorted(pm.module.state_dict())
    for key, value in want.items():
        assert np.array_equal(got[key].numpy(), np.asarray(value, np.float32)), key
    if name in DEPTHWISE:
        assert tuple(got["res_blocks.0.body.0.weight"].shape) == (48, 1, 3, 3)


@pytest.mark.parametrize("name", ["msrr_reduced", "msrr_reduced_NI", "msrr_reduced_meanshift",
                                  "msrr_reduced_leaky"])
def test_lr_domain_forward_matches_jax(name):
    """The training forward before the shuffle (--lr_domain_loss 1): the
    base unshuffled once, or the mean, or nothing, against JAX's
    make_packed_msrr_forward(lr_domain=True)."""
    jm, params, pm = _models(name)
    x = _lr((2, 6, 10, 3), seed=4)
    want = np.asarray(make_packed_msrr_forward(jm, dtype=jnp.float32, lr_domain=True)(
        params, jnp.asarray(x)))
    with torch.no_grad():
        got = pm.module.walk(torch.from_numpy(x), exact_pair, lr_domain=True).numpy()
    full = np.asarray(jm.module.apply({"params": params}, jnp.asarray(x)))
    _hold("%s lr domain" % name, got, want, full - _base(name, jm, x), F32_RTOL)


@pytest.mark.parametrize("name", ["msrr", "msrr_test"])
def test_lr_domain_needs_a_trailing_shuffle(name):
    _, _, pm = _models(name)
    with pytest.raises(ValueError, match="trailing shuffle"):
        pm.module.walk(torch.zeros(1, 4, 4, 3), exact_pair, lr_domain=True)
