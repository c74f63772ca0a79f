"""The port's LarvaNet family (larvanet_tpu_torch/models/larvanet.py) against
the JAX package's, on the CPU, at --num_blocks 2,1.

JAX parameters cross over through the port's own `state_dict_from_jax_params`
into a strict load; inputs are made with numpy from a seed, at odd and even
widths. As drawn, the family's 0.1-scaled init and zero biases leave the
trunk's part of the output (the residual over the interpolated base) under
one uint8 level, where a fault of the trunk would hide under the base; so
the parity tests scale every kernel by KERNEL_GAIN and draw every bias from
N(0, 1), which moves the output by tens of levels.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.models.larvanet import LarvaNetModule as JaxLarvaNetModule
from larvanet_tpu.ops.packed.larvanet import make_packed_larvanet_forward
from larvanet_tpu.ops.resize import upsample
from larvanet_tpu.ops.wino_pallas import make_wino_pallas_larvanet_forward
from larvanet_tpu.utils.torch_convert import EXPORT_RULES as JAX_EXPORT_RULES
from larvanet_tpu.utils.torch_convert import export_state_dict
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.models.larvanet import LarvaNetModule
from larvanet_tpu_torch.models.layers import interpolated_base
from larvanet_tpu_torch.ops import wino_resblock as wr
from larvanet_tpu_torch.utils.torch_convert import state_dict_from_jax_params

BLOCKS = ["--num_blocks", "2,1"]
# every preset's flags at the test size; the w64 presets at their own width
PRESETS = {
    "LarvaNet": [], "LarvaNet_w64": ["--num_features", "64"], "LarvaNet_0c": [],
    "LarvaNet_1c": [], "LarvaNet_4c": [], "LarvaNet_skip": [], "LarvaNet_res": [],
    "LarvaNetV2": [], "LarvaLeg": ["--leg", "1"], "LarvaLeg_w64": ["--num_features", "64",
                                                                    "--leg", "1"],
    "LarvaLegV2": ["--leg", "2"],
}
# the reference names, which the JAX package's EXPORT_RULES list
REFERENCE_NAMES = sorted(set(PRESETS) - {"LarvaNet_w64", "LarvaLeg_w64"})
KERNEL_GAIN = 2.0
# f32 on outputs of -50..350: the module graphs differ in summation order
# (and the resampler's), measured max |d| <= 2e-4
F32_ATOL = 1e-3


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
def _jax_model(name, flags=None):
    """(JAX model, its louder parameters as numpy)."""
    jm = jax_get_model(name)
    jm.parse_args(BLOCKS + PRESETS[name] if flags is None else list(flags))
    jm.prepare(is_training=False, scales=[4])
    return jm, _louder(_to_numpy(jm.params), np.random.default_rng(1))


def _port_model(name, params, flags=None, dtype="f32"):
    pm = get_model(name)
    pm.parse_args(BLOCKS + PRESETS[name] if flags is None else list(flags))
    pm.prepare([4], device="cpu")
    pm.load_state_dict(state_dict_from_jax_params(params, name))
    pm.set_serving_dtype(dtype)
    return pm


def _lr(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


def _check(label, got, want, atol):
    err = float(np.abs(got - want).max())
    print("parity %s: max|d| %.3g" % (label, err))
    assert got.shape == want.shape
    assert err <= atol


@pytest.mark.parametrize("exits", ["last", "all", 0, 1])
@pytest.mark.parametrize("name", sorted(PRESETS))
def test_preset_matches_jax_module(name, exits):
    jm, params = _jax_model(name)
    pm = _port_model(name, params)
    x = _lr((2, 7, 10, 3), seed=len(name))
    want = jm.module.apply({"params": params}, jnp.asarray(x), exits=exits)
    with torch.no_grad():
        got = pm.module(torch.from_numpy(x), exits=exits)
    if exits == "all":
        assert isinstance(got, list) and len(got) == len(want)
    else:
        got, want = [got], [want]
    for i, (g, w) in enumerate(zip(got, want)):
        _check("%s exits=%r output %d vs LarvaNetModule" % (name, exits, i), g.numpy(),
               np.asarray(w), F32_ATOL)


# bf16 against JAX's bf16 packed forward: both round every conv's operands
# and output to bf16 and sum in f32, in another order, and both add the bf16
# residual to an f32 base. Measured at KERNEL_GAIN 2 on these inputs: max
# |d| <= 0.25 and mean |d| <= 0.038 on residuals up to 37, i.e. one bf16
# step (2^-7) of the residual's largest value at most and ~2^-10 of it on
# average. Bars: two steps at most, 2^-9 on average.
BF16_MAX_RTOL = 2.0 ** -6
BF16_MEAN_RTOL = 2.0 ** -9


@pytest.mark.parametrize("name,dtype", [
    ("LarvaNet", "f32"), ("LarvaNet", "bf16"), ("LarvaNet_w64", "f32"),
    ("LarvaNet_w64", "bf16"), ("LarvaNetV2", "f32"), ("LarvaLeg", "f32"),
    ("LarvaNet_res", "f32"),
])
def test_serving_forward_matches_jax_packed_forward(name, dtype):
    """The wrapper's forward (the --leg exit, the V2 tail) against JAX's
    serving route, make_packed_larvanet_forward, at an odd and an even
    width."""
    jm, params = _jax_model(name)
    pm = _port_model(name, params, dtype=dtype)
    jdtype = jnp.float32 if dtype == "f32" else jnp.bfloat16
    fwd = jax.jit(make_packed_larvanet_forward(jm, dtype=jdtype))
    for shape in ((2, 7, 9, 3), (1, 8, 10, 3)):
        x = _lr(shape, seed=shape[2])
        want = np.asarray(fwd(params, jnp.asarray(x)))
        got = pm.fwd_runtime(torch.from_numpy(x)).numpy()
        assert want.dtype == got.dtype == np.float32
        if dtype == "f32":
            _check("%s %s forward vs packed JAX forward" % (name, shape), got, want, F32_ATOL)
            continue
        residual = float(np.abs(want - np.asarray(upsample(jnp.asarray(x), 4))).max())
        diff = np.abs(got - want)
        print("parity %s %s bf16 forward vs packed JAX bf16 forward: max|d| %.3g, mean|d| "
              "%.3g, residual max %.3g" % (name, shape, diff.max(), diff.mean(), residual))
        assert diff.max() <= BF16_MAX_RTOL * residual
        assert diff.mean() <= BF16_MEAN_RTOL * residual


@pytest.mark.parametrize("method", ["bicubic", "bilinear", "nearest"])
@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_interpolated_base_matches_jax(method, dtype):
    """The base against larvanet_tpu.ops.resize.upsample at x4, odd and even
    sizes, in the dtype JAX gives it: a bf16 frame's bicubic and bilinear
    bases are f32 in JAX (its f32 weights promote the frame), nearest stays
    bf16. The CPU build of torch takes bf16 in F.interpolate; the port
    widens the frame to f32 itself."""
    for shape in ((2, 7, 9, 3), (1, 8, 10, 3)):
        x = torch.from_numpy(_lr(shape, seed=3))
        jx = jnp.asarray(x.numpy())
        if dtype == "bf16":
            x, jx = x.to(torch.bfloat16), jx.astype(jnp.bfloat16)
        want = upsample(jx, 4, method)
        got = interpolated_base(x, 4, method)
        assert got.dtype == {"float32": torch.float32,
                             "bfloat16": torch.bfloat16}[str(want.dtype)]
        # f32 sums of 16 taps in another order, values up to ~300
        _check("base %s %s %s" % (method, dtype, shape), got.float().numpy(),
               np.asarray(want, np.float32), 1e-4)


@pytest.mark.parametrize("name,flags,m", [
    ("LarvaNet_w64", ("--num_blocks", "1,1", "--num_features", "64"), 2),
    ("LarvaNet_w64", ("--num_blocks", "1,1", "--num_features", "64"), 4),
    ("LarvaLeg_w64", ("--num_blocks", "1,1", "--num_features", "64", "--leg", "1"), 2),
])
def test_wino_route_matches_jax_interpreted_pallas(name, flags, m):
    """Every body ResBlock of a 64-channel trunk in the fused ResBlock (here
    its plain version), against JAX's Pallas kernels in the interpreter;
    the bar of tests/test_wino_pallas.py's LarvaNet_w64 route."""
    jm, params = _jax_model(name, flags)
    pm = _port_model(name, params, flags)
    calls = []
    run = wr.wino_resblock_transformed

    def counting(*args, **kw):
        calls.append(args[6] if len(args) > 6 else kw["m"])
        return run(*args, **kw)

    x = _lr((1, 12, 16, 3), seed=5)
    want = np.asarray(make_wino_pallas_larvanet_forward(jm, interpret=True, m=m)(
        params, jnp.asarray(x)))
    fwd = wr.make_wino_larvanet_forward(pm, m)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(wr, "wino_resblock_transformed", counting)
        got = fwd(torch.from_numpy(x)).numpy()
    assert calls == [m] * (2 if name == "LarvaNet_w64" else 1)
    _check("%s wino F(%d,3) route vs JAX interpreted Pallas" % (name, m), got, want, 1e-3)


def test_wino_route_of_a_48_channel_trunk_is_the_default_route(monkeypatch):
    """A 48-channel trunk runs its ResBlocks on the direct convs under
    --wino_trunk, as JAX's 96-lane trunks take its exact path: the same
    output bit for bit, no fused call."""
    _, params = _jax_model("LarvaNet")
    pm = _port_model("LarvaNet", params)
    monkeypatch.setattr(wr, "wino_resblock_transformed",
                        lambda *a, **k: pytest.fail("fused ResBlock on a 48-channel trunk"))
    x = torch.from_numpy(_lr((1, 8, 10, 3), seed=6))
    for m in (2, 4):
        pm.set_route(wr.make_wino_larvanet_forward(pm, m))
        got = pm.fwd_runtime(x)
        pm.set_route(None)
        assert torch.equal(got, pm.fwd_runtime(x))


def test_wino_route_refuses_odd_widths_as_jax():
    jm, params = _jax_model("LarvaNet")
    pm = _port_model("LarvaNet", params)
    x = _lr((1, 8, 9, 3))
    with pytest.raises(ValueError, match="even width"):
        wr.make_wino_larvanet_forward(pm, 2)(torch.from_numpy(x))
    with pytest.raises(ValueError, match="even width"):
        make_wino_pallas_larvanet_forward(jm, interpret=True)(params, jnp.asarray(x))


@pytest.mark.parametrize("name", REFERENCE_NAMES)
def test_converter_matches_jax_export(name):
    """The port's export rules give JAX export_state_dict's keys and values,
    and the state_dict loads strictly into the port's module."""
    _, params = _jax_model(name)
    want = export_state_dict(params, name)
    got = state_dict_from_jax_params(params, name)
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        np.testing.assert_array_equal(got[key].numpy(), value)
    pm = get_model(name)
    pm.parse_args(BLOCKS + PRESETS[name])
    pm.prepare([4], device="cpu")
    assert sorted(pm.module.state_dict()) == sorted(want)
    pm.module.load_state_dict(got, strict=True)


@pytest.mark.parametrize("name", ["LarvaNet_w64", "LarvaLeg_w64"])
def test_converter_takes_the_w64_presets(name):
    """JAX has no export rule for the w64 presets; the port's LarvaNet rules
    place every one of their parameters, and the two load each other's
    weights."""
    assert name not in JAX_EXPORT_RULES
    _, params = _jax_model(name)
    state = state_dict_from_jax_params(params, name)
    for other in ("LarvaNet_w64", "LarvaLeg_w64"):
        pm = _port_model(other, params)
        pm.load_state_dict(state)


def test_larvaleg_default_leg_over_two_modules_fails_as_jax():
    """LarvaLeg's default --leg 4 over 2 modules: JAX fails in the forward
    (no body_2), the port refuses the model with a ValueError."""
    flags = ["--num_blocks", "1,1"]
    jm = jax_get_model("LarvaLeg")
    jm.parse_args(list(flags))
    jm.prepare(is_training=False, scales=[4])
    with pytest.raises((KeyError, IndexError)):
        jm.upscale([_lr((3, 6, 7))], 4)
    pm = get_model("LarvaLeg")
    assert pm.parse_args(list(flags))[0].leg == 4
    with pytest.raises(ValueError, match="early exit is a leg 0..2"):
        pm.prepare([4], device="cpu")


def test_refusals_match_jax():
    """--num_blocks must list --num_modules entries (the default "16" over
    2 modules does not), and a leg other than 2conv needs the 48-channel
    trunk: both raise ValueError in JAX and in the port."""
    for get in (jax_get_model, get_model):
        model = get("LarvaNet")
        model.parse_args([])
        with pytest.raises(ValueError, match="num_blocks"):
            model.prepare(**({"is_training": False, "scales": [4]} if get is jax_get_model
                             else {"scales": [4], "device": "cpu"}))
    with pytest.raises(ValueError, match="48-channel"):
        JaxLarvaNetModule(num_blocks=(1,), leg_style="skip", features=64).init(
            jax.random.PRNGKey(0), jnp.zeros((1, 4, 4, 3)))
    with pytest.raises(ValueError, match="48-channel"):
        LarvaNetModule(num_blocks=(1,), leg_style="skip", features=64)


@pytest.mark.parametrize("scale", [2, 3])
def test_other_scales_give_the_x4_output_as_jax(scale):
    """The family's exits are PixelShuffle(4): --scales 2 and 3 are taken
    and the output is x4, as in JAX."""
    flags = BLOCKS
    jm = jax_get_model("LarvaNet")
    jm.parse_args(list(flags))
    jm.prepare(is_training=False, scales=[scale])
    pm = get_model("LarvaNet")
    pm.parse_args(list(flags))
    pm.prepare([scale], device="cpu")
    frame = _lr((3, 5, 6), seed=scale)
    want = jm.upscale([frame], scale)
    assert want.shape == (1, 3, 20, 24)
    assert pm.upscale([frame], scale).shape == want.shape


def test_flagship_parameter_count_matches_jax():
    flags = ["--num_modules", "2", "--num_blocks", "16,16"]
    jm = jax_get_model("LarvaNet")
    jm.parse_args(list(flags))
    jm.prepare(is_training=False, scales=[4])
    want = sum(int(np.prod(np.shape(v))) for v in jax.tree_util.tree_leaves(jm.params))
    pm = get_model("LarvaNet")
    pm.parse_args(list(flags))
    pm.prepare([4], device="cpu")
    assert pm.num_parameters() == want == 1414656


def test_init_is_the_scaled_kaiming_normal():
    """Conv weights ~ N(0, (0.1 sqrt(2 / fan_in))^2), zero biases, drawn
    from the prepare seed."""
    pm = get_model("LarvaNet")
    pm.parse_args(["--num_modules", "2", "--num_blocks", "4,4"])
    pm.prepare([4], device="cpu", seed=3)
    again = get_model("LarvaNet")
    again.parse_args(["--num_modules", "2", "--num_blocks", "4,4"])
    again.prepare([4], device="cpu", seed=3)
    trunk = torch.cat([b.body[i].weight.detach().flatten() for body in pm.module.bodies()
                       for b in body.res_blocks for i in (0, 2)])
    want_std = 0.1 * (2.0 / (48 * 9)) ** 0.5
    assert abs(float(trunk.std()) / want_std - 1.0) < 0.02
    assert abs(float(trunk.mean())) < 0.02 * want_std
    for key, value in pm.module.state_dict().items():
        if key.endswith("bias"):
            assert not value.any()
        assert torch.equal(value, again.module.state_dict()[key])
