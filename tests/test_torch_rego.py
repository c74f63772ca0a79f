"""The port's REGO-Net and REGO-serial (larvanet_tpu_torch/models/rego.py)
against the JAX package's (larvanet_tpu/models/rego.py,
ops/packed/branchy.py), on the CPU, at --len_side 3 --num_filters 16
(length 3 reaches the wavefront's inner fea_in[j-1] + err_in[j] mix;
REGO-serial with --num_regos 2, so its conv_0 merge runs): the forwards
against JAX's module and its `make_packed_rego_forward` at x2 and x4, odd
and even widths, in f32 and bf16; the LR-domain training forward; the
converter against JAX's `export_state_dict` into a strict load; the 'both'
pair kind (exact, and the int8 pair bit for bit with JAX's `pair_int8`);
a checkpoint with a trained MeanShift.

JAX parameters cross over through the port's own
`state_dict_from_jax_params`, louder than drawn (tests/test_torch_msrr.py's
`_louder`), and errors are held relative to the largest value of the
residual over the bilinear base. The training, int8 forwards and QAT are in
tests/test_torch_branchy_train.py.
"""

import functools
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.ops.packed import pairs as jpairs
from larvanet_tpu.ops.packed.branchy import make_packed_rego_forward
from larvanet_tpu.ops.packed.core import grid1_mask, pack_w, unpack_w
from larvanet_tpu.ops.resize import upsample
from larvanet_tpu.utils.torch_convert import export_state_dict
from larvanet_tpu_torch.cli import common
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.models.layers import Conv3x3, exact_pair
from larvanet_tpu_torch.ops import pairs
from larvanet_tpu_torch.utils.torch_convert import state_dict_from_jax_params
from test_torch_msrr import BF16_RTOL, F32_RTOL, _hold, _louder, _lr, _to_numpy

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

SMALL = ["--len_side", "3", "--num_filters", "16"]
NAMES = {"REGO-Net": SMALL, "REGO-serial": SMALL + ["--num_regos", "2"]}
SHAPES = ((2, 7, 9, 3), (1, 6, 10, 3))  # an odd and an even width


@functools.lru_cache(maxsize=None)
def _models(name, scale=4):
    """(JAX model with its louder parameters, those parameters as numpy,
    the port's model with them), f32, on the CPU."""
    jm = jax_get_model(name)
    jm.parse_args(list(NAMES[name]))
    jm.prepare(is_training=False, scales=[scale])
    params = _louder(_to_numpy(jm.params), np.random.default_rng(len(name) + scale))
    jm.params = jax.tree_util.tree_map(jnp.asarray, params)
    pm = get_model(name)
    pm.parse_args(list(NAMES[name]))
    pm.prepare([scale], device="cpu")
    pm.load_state_dict(state_dict_from_jax_params(params, name))  # strict
    return jm, params, pm


def _base(x, scale):
    return np.asarray(upsample(jnp.asarray(x), scale, "bilinear"))


@pytest.mark.parametrize("scale", [2, 4])
@pytest.mark.parametrize("name", sorted(NAMES))
def test_forward_matches_jax_module_and_packed_forward(name, scale):
    """The f32 forward against JAX's module and make_packed_rego_forward at
    an odd and an even width."""
    jm, params, pm = _models(name, scale)
    fwd = jax.jit(make_packed_rego_forward(jm, dtype=jnp.float32))
    apply = jax.jit(lambda p, x: jm.module.apply({"params": p}, x))
    for shape in SHAPES:
        x = _lr(shape, seed=shape[2] + scale)
        want = np.asarray(apply(params, jnp.asarray(x)))
        residual = want - _base(x, scale)
        with torch.no_grad():
            got = pm.module(torch.from_numpy(x)).numpy()
        label = "%s x%d %s" % (name, scale, shape)
        _hold(label + " vs module", got, want, residual, F32_RTOL)
        _hold(label + " vs packed", got, np.asarray(fwd(params, jnp.asarray(x))), residual,
              F32_RTOL)


@pytest.mark.parametrize("name", sorted(NAMES))
def test_bf16_forward_matches_jax(name):
    """The bf16 serving forward at x4 (an even width) against JAX's bf16
    packed forward, within BF16_RTOL of the residual's largest value."""
    jm, params, pm = _models(name)
    x = _lr((1, 6, 10, 3), seed=3)
    want = np.asarray(jax.jit(make_packed_rego_forward(jm, dtype=jnp.bfloat16))(
        params, jnp.asarray(x))).astype(np.float32)
    pm.set_serving_dtype("bf16")
    try:
        got = pm.fwd_runtime(torch.from_numpy(x)).numpy()
    finally:
        pm.set_serving_dtype("f32")
    _hold("%s bf16" % name, got, want, want - _base(x, 4), BF16_RTOL)


@pytest.mark.parametrize("name", sorted(NAMES))
def test_lr_domain_forward_matches_jax(name):
    """The training forward before the shuffle (--lr_domain_loss 1) against
    JAX's make_packed_rego_forward(lr_domain=True)."""
    jm, params, pm = _models(name)
    x = _lr((2, 6, 10, 3), seed=4)
    want = np.asarray(jax.jit(make_packed_rego_forward(jm, dtype=jnp.float32, lr_domain=True))(
        params, jnp.asarray(x)))
    full = np.asarray(jm.module.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = pm.module.walk(torch.from_numpy(x), lr_domain=True).numpy()
    _hold("%s lr domain" % name, got, want, full - _base(x, 4), F32_RTOL)


@pytest.mark.parametrize("name", sorted(NAMES))
def test_converter_matches_jax_export(name):
    """`state_dict_from_jax_params` gives JAX's `export_state_dict` key for
    key and value for value (REGO-Net's blocks without a repeat index,
    REGO-serial's with it, SRrecon.body.0, the forward mean_shift alone),
    which `_models` loads strictly."""
    _, params, pm = _models(name)
    want = export_state_dict(params, name)
    got = state_dict_from_jax_params(params, name)
    assert sorted(got) == sorted(want) == sorted(pm.module.state_dict())
    block = "RESB_1_1_1" if name == "REGO-serial" else "RESB_1_1"
    for key in (block + ".body.2.weight", "SRrecon.body.0.bias", "mean_shift.bias"):
        assert key in got, key
    assert "mean_inverse_shift.weight" not in got
    assert ("conv_0.weight" in got) == (name == "REGO-serial")
    for key, value in want.items():
        assert np.array_equal(got[key].numpy(), np.asarray(value, np.float32)), key


def _pair_convs(c, seed):
    g = torch.Generator().manual_seed(seed)
    rng = np.random.default_rng(seed)
    conv1 = Conv3x3(c, c, act="leaky_relu", generator=g, slope=0.1)
    conv2 = Conv3x3(c, c, generator=g)
    with torch.no_grad():
        conv1.weight.mul_(6.0)  # pre-activations on both sides of 0
        for conv in (conv1, conv2):
            conv.bias.copy_(torch.from_numpy(rng.standard_normal(c).astype(np.float32)))
    jp = [{"kernel": conv.weight.detach().permute(2, 3, 1, 0).numpy(),
           "bias": conv.bias.detach().numpy()} for conv in (conv1, conv2)]
    return conv1, conv2, jp


def _lrelu(t):
    return jax.nn.leaky_relu(t, 0.1)


@pytest.mark.parametrize("res_weight", [1.0, 0.1])
def test_exact_both_pair_matches_jax(res_weight):
    """exact_pair(kind="both") returns JAX's exact_pair's (t, hin + t), each
    within F32_RTOL of its largest value; kinds 'res' and 'none' are its
    second and first halves exactly."""
    c = 16
    conv1, conv2, jp = _pair_convs(c, 1)
    hin = (np.random.default_rng(2).standard_normal((2, 7, 10, c)) * 4).astype(np.float32)
    h = pack_w(jnp.asarray(hin))
    t_j, out_j = jpairs.exact_pair(jnp.float32)(
        0, h, jp[0], jp[1], grid1_mask(h.shape[2] + 1, c, jnp.float32), kind="both",
        act=_lrelu, res_weight=res_weight)
    with torch.no_grad():
        x = torch.from_numpy(hin)
        t, out = exact_pair(0, x, conv1, conv2, kind="both", res_weight=res_weight)
        assert torch.equal(out, exact_pair(0, x, conv1, conv2, "res", res_weight))
        assert torch.equal(t, exact_pair(0, x, conv1, conv2, "none", res_weight))
    for got, want in ((t, t_j), (out, out_j)):
        want = np.asarray(unpack_w(want))
        assert float(np.abs(got.numpy() - want).max()) <= F32_RTOL * float(np.abs(want).max())


def _closure(fn, name):
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


@pytest.mark.parametrize("res_weight", [1.0, 0.1])
@pytest.mark.parametrize("dname", ["f32", "bf16"])
def test_int8_both_pair_equals_jax_bit_for_bit(dname, res_weight):
    """The port's int8 'both' pair (conv_b without the skip, then hin + t in
    hin's dtype) against JAX's pair_int8(kind="both") given its records, the
    REGO RESBlock's LeakyReLU(0.1) inside conv_a: both outputs equal bit for
    bit; the calibrating runner returns the pair too."""
    tdt, jdt = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[
        dname]
    c = 16
    conv1, conv2, jp = _pair_convs(c, 3)
    hin = (np.random.default_rng(4).standard_normal((2, 7, 10, c)) * 4).astype(np.float32)
    pair_cal, pair_int8, finish = jpairs.make_pair_runner(jdt)
    h = pack_w(jnp.asarray(hin, jdt))
    mask1 = grid1_mask(h.shape[2] + 1, c, jdt)
    pair_cal(0, h, jp[0], jp[1], mask1, kind="both", act=_lrelu, res_weight=res_weight)
    finish([(jp[0], jp[1])])
    want = [np.asarray(unpack_w(o), np.float32) for o in pair_int8(
        0, h, jp[0], jp[1], mask1, kind="both", act=_lrelu, res_weight=res_weight)]
    quant = [{k: (np.asarray(v) if not isinstance(v, float) else v) for k, v in q.items()}
             for q in _closure(pair_int8, "quant")]
    q = pairs.load_jax_records(quant, tdt, "cpu", "leaky_relu", 0.1)[0]
    got = pairs.int8_pair(q, torch.from_numpy(hin).to(tdt), "both", res_weight)
    for part, g, w in zip(("t", "hin + t"), got, want):
        g = g.float().numpy()
        differ = int((g.view(np.uint32) != w.view(np.uint32)).sum())
        print("int8 both pair %s res_weight %g %s: %d of %d values differ"
              % (dname, res_weight, part, differ, w.size))
        assert differ == 0
    runner = pairs.PairRunner(tdt)
    with torch.no_grad():
        t, out = runner.calib(0, torch.from_numpy(hin).to(tdt), conv1.to(tdt), conv2.to(tdt),
                              kind="both", res_weight=res_weight)
    assert torch.equal(out, torch.from_numpy(hin).to(tdt) + t)


def test_trained_mean_shift_runs_the_module_affine(tmp_path, capsys):
    """A reference-keyed REGO-Net .pth whose mean_shift is not the intended
    +mean: the port restores it, prints JAX's two restore lines, turns
    --packed_trunk off (training then runs the module graph), its forward
    equals JAX's restored module (which installs the affine), and
    --int8_trunk prints its `...; ignoring` line and keeps the exact route."""
    name = "REGO-Net"
    jm0, params, _ = _models(name)
    state = export_state_dict(params, name)
    rng = np.random.default_rng(9)
    state["mean_shift.weight"] = (np.eye(3) + 0.05 * rng.standard_normal((3, 3))).astype(
        np.float32).reshape(3, 3, 1, 1)
    state["mean_shift.bias"] = (state["mean_shift.bias"] + 10 * rng.standard_normal(3)).astype(
        np.float32)
    path = str(tmp_path / "trained_shift.pth")
    torch.save({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in state.items()}, path)
    jm = jax_get_model(name)
    jm.parse_args(list(NAMES[name]))
    jm.prepare(is_training=False, scales=[4])
    capsys.readouterr()
    jm.restore(path)
    jax_lines = [ln for ln in capsys.readouterr().out.splitlines() if "MeanShift" in ln
                 or "--packed_trunk" in ln]
    pm = get_model(name)
    pm.parse_args(list(NAMES[name]))
    pm.prepare([4], device="cpu")
    pm.restore(path)
    port_lines = capsys.readouterr().out.splitlines()
    assert len(jax_lines) == 2 and port_lines == jax_lines, (port_lines, jax_lines)
    assert pm.args.packed_trunk == 0
    x = _lr((1, 6, 10, 3), seed=10)
    want = np.asarray(jm.module.apply({"params": jm.params}, jnp.asarray(x)))
    with torch.no_grad():
        got = pm.module(torch.from_numpy(x)).numpy()
        intended = jm0.module.apply({"params": params}, jnp.asarray(x))
    _hold("REGO-Net trained mean shift", got, want, want - _base(x, 4), F32_RTOL)
    assert float(np.abs(got - np.asarray(intended)).max()) > 1.0  # the affine matters
    common.maybe_int8_trunk(pm, SimpleNamespace(int8_trunk=1, model=name), lambda: x)
    out = capsys.readouterr().out
    assert "MeanShift affine" in out and out.rstrip().endswith("; ignoring")
    assert pm.route is None
