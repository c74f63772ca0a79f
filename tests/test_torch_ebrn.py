"""The port's EBRN family (larvanet_tpu_torch/models/ebrn.py) against the JAX
package's (larvanet_tpu/models/ebrn.py, ops/packed/branchy.py), on the CPU,
at --num_filters 8 --num_brms 2: the up-projection against JAX's
ConvTranspose2dTorch at x2 / x3 / x4; every name's forward against JAX's
module (full EBRN's only route) and ebrn_rm's against its default
`make_packed_ebrn_rm_forward`, at x2 / x3 / x4, in f32 and bf16; the
LR-domain training forward; the converter against JAX's `export_state_dict`
and a reference-layout `.pth` restored strictly; a trained MeanShift; the
train step's loss and gradients against jax.grad of JAX's `_compute_loss`
(the LR-domain loss, the HR-domain loss, full EBRN's module graph, --qat 1);
`make_int8_ebrn_rm_forward` against JAX's; and what full EBRN refuses.

The port's init, louder than drawn (every kernel times KERNEL_GAIN, every
bias from N(0, 1), every PReLU slope from U(0.05, 0.5), so that a slope on
the wrong channel shows), crosses to JAX by JAX's importer and back through
the port's `state_dict_from_jax_params`, and errors are held relative to
the largest value of the output's part that is not its base (the inverse
mean shift, or BLI's bilinear base).
"""

import functools
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.models.layers import DIV2K_RGB_MEAN, ConvTranspose2dTorch
from larvanet_tpu.ops.packed.branchy import make_int8_ebrn_rm_forward as jax_int8_ebrn_rm
from larvanet_tpu.ops.packed.branchy import make_packed_ebrn_rm_forward
from larvanet_tpu.ops.resize import upsample
from larvanet_tpu.utils import torch_convert as jax_convert
from larvanet_tpu.utils.torch_convert import _conv_transpose, export_state_dict, save_pth
from larvanet_tpu_torch.cli import common
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.models.ebrn import UP_GEOM
from larvanet_tpu_torch.models.layers import UpProjection
from larvanet_tpu_torch.ops import pairs
from larvanet_tpu_torch.ops.int8_forward import Int8Unsupported, make_int8_ebrn_rm_forward
from larvanet_tpu_torch.utils.torch_convert import state_dict_from_jax_params
from test_torch_msrr import BF16_RTOL, F32_RTOL, _hold, _lr, _to_numpy
from test_torch_msrr_train import (FWD_PSNR_DB, LOSS_RTOL, QAT_FLIP_GRAD_RTOL, _batch,
                                   _closure, _psnr)

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

SMALL = ["--num_filters", "8", "--num_brms", "2"]
NAMES = ("ebrn", "ebrn_rm", "ebrn_rm_BLI")
KERNEL_GAIN = 2.0
GRAD_RTOL = 2e-5  # JAX's XLA gradients sit ~1e-5 of their max from float64
SELF_CALIB_MARGIN_DB = 10.0


def _louder(state, rng):
    """The port's state_dict with every conv kernel times KERNEL_GAIN, every
    bias from N(0, 1) and every PReLU slope from U(0.05, 0.5); the mean
    shifts as they are."""
    out = {}
    for key, v in state.items():
        v = v.numpy()
        if key.startswith("mean_"):
            out[key] = v
        elif key.endswith(".bias"):
            out[key] = rng.normal(0.0, 1.0, v.shape).astype(np.float32)
        elif v.ndim == 1:
            out[key] = rng.uniform(0.05, 0.5, v.shape).astype(np.float32)
        else:
            out[key] = (v * KERNEL_GAIN).astype(np.float32)
    return out


def _jax_model(name, scale=4, flags=(), is_training=False, params=None):
    """A JAX model with `params`, its scale and its module, without its flax
    init (whose compiles of full EBRN's HR flows would cost most of the
    file)."""
    jm = jax_get_model(name)
    jm.parse_args(SMALL + list(flags))
    jm.scale, jm.scale_list, jm.is_training = scale, [scale], is_training
    jm.module = jm.build_module()
    if params is not None:
        jm.params = jax.tree_util.tree_map(jnp.asarray, params)
    return jm


@functools.lru_cache(maxsize=None)
def _models(name, scale=4, flags=(), is_training=False):
    """(JAX model, its parameters as numpy, the port's model with them), f32,
    on the CPU. The port's init, louder (`_louder`), crosses to JAX's
    parameters by the JAX package's own importer (convert_state_dict; JAX
    has no parameters for full EBRN's dead last down_block and bp_flow, nor
    rules of its own for ebrn_rm_BLI, which are ebrn_rm's); the port's model
    loads them back strictly through state_dict_from_jax_params."""
    pm = get_model(name)
    pm.parse_args(SMALL + list(flags))
    pm.prepare([scale], device="cpu", is_training=is_training)
    state = _louder(pm.module.state_dict(), np.random.default_rng(len(name) + scale))
    params = jax_convert.convert_state_dict(state, "ebrn_rm" if name == "ebrn_rm_BLI"
                                            else name)[0]
    if name == "ebrn":
        last = params["brm_%d" % (pm.args.num_brms - 1)]
        del last["down_block"], last["bp_flow"]
    pm.load_state_dict(state_dict_from_jax_params(params, name))  # strict
    return _jax_model(name, scale, flags, is_training, params), params, pm


def _base(name, x, scale):
    """The output's part that is not the network's: BLI's bilinear base, else
    the inverse mean shift."""
    if name == "ebrn_rm_BLI":
        return np.asarray(upsample(jnp.asarray(x), scale, "bilinear"))
    return -np.asarray(DIV2K_RGB_MEAN, np.float32)


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_up_projection_matches_jax(scale):
    """UpProjection (torch's ConvTranspose2d weight, F.conv_transpose2d)
    against JAX's ConvTranspose2dTorch given the kernel JAX's importer makes
    of the same weight (flipped, HWIO): the geometry (H - 1) s - 2 p + k = s H
    and the values, at an odd and an even width."""
    k, s, p = UP_GEOM[scale]
    up = UpProjection(8, 8, k, s, p, torch.Generator().manual_seed(scale))
    jparams = _conv_transpose(up.weight.detach().numpy(), up.bias.detach().numpy())
    mod = ConvTranspose2dTorch(8, k, s, p)
    for shape in ((2, 5, 7, 8), (1, 4, 6, 8)):
        x = np.random.default_rng(shape[2]).standard_normal(shape).astype(np.float32)
        want = np.asarray(mod.apply({"params": jparams}, jnp.asarray(x)))
        with torch.no_grad():
            got = up(torch.from_numpy(x)).numpy()
        assert got.shape == (shape[0], s * shape[1], s * shape[2], 8) == want.shape
        err = float(np.abs(got - want).max())
        print("up-projection x%d %s: max|d| %.3g of %.3g" % (scale, shape, err,
                                                             float(np.abs(want).max())))
        assert err <= F32_RTOL * float(np.abs(want).max())


@pytest.mark.parametrize("scale", [2, 3, 4])
@pytest.mark.parametrize("name", NAMES)
def test_forward_matches_jax_module_and_default_route(name, scale):
    """The f32 forward against JAX's module and, for ebrn_rm and BLI, its
    default serving route make_packed_ebrn_rm_forward; an odd and an even
    width (full EBRN, whose only route is its module: one width)."""
    jm, params, pm = _models(name, scale)
    apply = jax.jit(lambda p, x: jm.module.apply({"params": p}, x))
    packed = (None if name == "ebrn"
              else jax.jit(make_packed_ebrn_rm_forward(jm, dtype=jnp.float32)))
    for shape in ((2, 5, 7, 3),) + (() if name == "ebrn" else ((1, 6, 8, 3),)):
        x = _lr(shape, seed=shape[2] + scale)
        want = np.asarray(apply(params, jnp.asarray(x)))
        residual = want - _base(name, x, scale)
        with torch.no_grad():
            got = pm.module(torch.from_numpy(x)).numpy()
        label = "%s x%d %s" % (name, scale, shape)
        _hold(label + " vs module", got, want, residual, F32_RTOL)
        if packed is not None:
            _hold(label + " vs packed", got, np.asarray(packed(params, jnp.asarray(x))),
                  residual, F32_RTOL)


@pytest.mark.parametrize("name", NAMES)
def test_bf16_forward_matches_jax(name):
    """The bf16 serving forward at x4 against JAX's bf16 packed forward.
    Full EBRN serves its f32 module under --serving_dtype bf16, as JAX does
    (its bf16 is the packed graphs'): held to JAX's module at F32_RTOL."""
    jm, params, pm = _models(name)
    x = _lr((1, 6, 8, 3), seed=3)
    if name == "ebrn":
        want = np.asarray(jm.module.apply({"params": params}, jnp.asarray(x)))
    else:
        want = np.asarray(jax.jit(make_packed_ebrn_rm_forward(jm, dtype=jnp.bfloat16))(
            params, jnp.asarray(x))).astype(np.float32)
    pm.set_serving_dtype("bf16")
    try:
        assert (pm.compute_dtype == torch.float32) == (name == "ebrn")
        got = pm.fwd_runtime(torch.from_numpy(x)).numpy()
    finally:
        pm.set_serving_dtype("f32")
    _hold("%s bf16" % name, got, want, want - _base(name, x, 4),
          F32_RTOL if name == "ebrn" else BF16_RTOL)


@pytest.mark.parametrize("name", ["ebrn_rm", "ebrn_rm_BLI"])
def test_lr_domain_forward_matches_jax(name):
    """The training forward before the shuffle (--lr_domain_loss 1): the
    inverse mean shift per sub-pixel, or BLI's base unshuffled, against
    JAX's make_packed_ebrn_rm_forward(lr_domain=True)."""
    jm, params, pm = _models(name)
    x = _lr((2, 6, 8, 3), seed=4)
    want = np.asarray(jax.jit(make_packed_ebrn_rm_forward(jm, dtype=jnp.float32,
                                                          lr_domain=True))(
        params, jnp.asarray(x)))
    full = np.asarray(jm.module.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = pm.module.walk(torch.from_numpy(x), lr_domain=True).numpy()
    _hold("%s lr domain" % name, got, want, full - _base(name, x, 4), F32_RTOL)


@pytest.mark.parametrize("name", NAMES)
def test_converter_and_reference_pth(name, tmp_path):
    """`state_dict_from_jax_params` gives JAX's `export_state_dict` key for
    key and value for value (the up-projection in ConvTranspose2d's layout,
    the PReLUs' `weight`, both MeanShifts, full EBRN's dead last BRM; JAX
    exports no ebrn_rm_BLI, whose keys are ebrn_rm's without the shifts);
    a reference-layout `.pth` restores strictly and serves JAX's output."""
    jm, params, _ = _models(name)
    got = state_dict_from_jax_params(params, name)
    want = export_state_dict(params, "ebrn_rm" if name == "ebrn_rm_BLI" else name)
    if name == "ebrn_rm_BLI":
        want = {k: v for k, v in want.items() if not k.startswith("mean_")}
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert np.array_equal(got[key].numpy(), np.asarray(value, np.float32)), key
    if name == "ebrn":
        assert got["brms.0.up_block.weight"].shape == (8, 8, 8, 8)
        assert float(got["brms.1.bp_flow.1.weight"][0]) == 0.25  # the dead BRM
    path = str(tmp_path / "ref.pth")
    torch.save({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in want.items()}, path)
    pm = get_model(name)
    pm.parse_args(list(SMALL))
    pm.prepare([4], device="cpu")
    pm.restore(path)  # strict
    x = _lr((1, 5, 6, 3), seed=8)
    with torch.no_grad():
        served = pm.module(torch.from_numpy(x)).numpy()
    expect = np.asarray(jm.module.apply({"params": params}, jnp.asarray(x)))
    _hold("%s restored .pth" % name, served, expect, expect - _base(name, x, 4), F32_RTOL)


def test_trained_mean_shift_runs_the_module_affines(tmp_path, capsys):
    """An ebrn_rm `.pth` whose MeanShifts are trained: the port prints JAX's
    two restore lines, turns --packed_trunk off, serves JAX's restored
    module, and --int8_trunk keeps the exact route with its `...; ignoring`
    line."""
    name = "ebrn_rm"
    _, params, _ = _models(name)
    state = export_state_dict(params, name)
    rng = np.random.default_rng(9)
    for key in ("mean_shift", "mean_inverse_shift"):
        state[key + ".weight"] = (np.eye(3) + 0.05 * rng.standard_normal((3, 3))).astype(
            np.float32).reshape(3, 3, 1, 1)
        state[key + ".bias"] = (state[key + ".bias"] + 10 * rng.standard_normal(3)).astype(
            np.float32)
    path = str(tmp_path / "trained_shift.pth")
    torch.save({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in state.items()}, path)
    jm = _jax_model(name, params=params)
    capsys.readouterr()
    jm.restore(path)
    jax_lines = [ln for ln in capsys.readouterr().out.splitlines()
                 if "MeanShift" in ln or "--packed_trunk" in ln]
    pm = get_model(name)
    pm.parse_args(list(SMALL))
    pm.prepare([4], device="cpu")
    pm.restore(path)
    port_lines = capsys.readouterr().out.splitlines()
    assert len(jax_lines) == 2 and port_lines == jax_lines, (port_lines, jax_lines)
    assert pm.args.packed_trunk == 0
    x = _lr((1, 6, 8, 3), seed=10)
    want = np.asarray(jm.module.apply({"params": jm.params}, jnp.asarray(x)))
    with torch.no_grad():
        got = pm.module(torch.from_numpy(x)).numpy()
    _hold("ebrn_rm trained mean shifts", got, want, want - _base(name, x, 4), F32_RTOL)
    common.maybe_int8_trunk(pm, SimpleNamespace(int8_trunk=1, model=name), lambda: x)
    out = capsys.readouterr().out
    assert "MeanShift affines" in out and out.rstrip().endswith("; ignoring")
    assert pm.route is None


# ---- training ----

def _step_vs_jax(name, flags, bar, jit=True):
    """The port's loss and gradients on one batch against jax.grad of JAX's
    `_compute_loss`, jitted but for QAT (eager: XLA's fused graph moves a
    weight's x / s off the clip's tie at +-127)."""
    jm, params, pm = _models(name, 4, tuple(flags), True)
    x, y = _batch(len(name) + len(flags))
    grad = jax.value_and_grad(jm._compute_loss)
    want_loss, want_grads = (jax.jit(grad) if jit else grad)(
        jm.params, jnp.asarray(x), jnp.asarray(y))
    pm.module.zero_grad(set_to_none=True)
    loss = pm._compute_loss(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    want = state_dict_from_jax_params(_to_numpy(want_grads), name)
    rel = abs(float(loss.detach()) - float(want_loss)) / abs(float(want_loss))
    worst = (0.0, None)
    for key, p in pm.module.named_parameters():
        if p.grad is None:  # full EBRN's dead last BRM: JAX has no such parameter
            assert key.startswith("brms.%d." % (pm.args.num_brms - 1)), key
            continue
        err = float((p.grad - want[key]).abs().max()) / float(want[key].abs().max())
        worst = max(worst, (err, key))
    print("train %s %s: loss rel %.3g, worst gradient %.3g of its max (%s)"
          % (name, " ".join(flags), rel, *worst))
    assert rel <= LOSS_RTOL and worst[0] <= bar


@pytest.mark.parametrize("name,flags", [
    ("ebrn_rm", []),                             # the LR-domain loss, 'both' pairs
    ("ebrn_rm_BLI", []),                         # the LR domain with the base unshuffled
    ("ebrn_rm", ["--lr_domain_loss", "0"]),      # on the HR image
    ("ebrn", []),                                # the module graph: projections, PReLUs
])
def test_train_step_matches_jax(name, flags):
    """The train step's loss and every gradient against jax.grad of JAX's
    `_compute_loss` on the same batch."""
    _step_vs_jax(name, flags, GRAD_RTOL)


def test_qat_step_matches_jax():
    """--qat 1 on ebrn_rm ('both' pairs, conv_a at leaky_relu(0.05)) against
    JAX's qat walk taken by eager jax.grad: the loss, and the gradients at
    the bar for flipped codes."""
    _step_vs_jax("ebrn_rm", ["--qat", "1"], QAT_FLIP_GRAD_RTOL, jit=False)


def test_full_ebrn_refusals():
    """Full EBRN refuses --qat 1 at its first step with JAX's message, and
    has no int8 path (the CLIs print `...; ignoring` and keep the exact
    route)."""
    jm = _jax_model("ebrn", flags=("--qat", "1"), is_training=True)
    x, y = _batch(3)
    with pytest.raises(ValueError) as jax_err:
        jm._compute_loss(None, jnp.asarray(x), jnp.asarray(y))
    pm = get_model("ebrn")
    pm.parse_args(SMALL + ["--qat", "1"])
    pm.prepare([4], device="cpu", is_training=True)
    with pytest.raises(ValueError) as port_err:
        pm.train_step(x, 4, y)
    assert str(port_err.value) == str(jax_err.value)
    with pytest.raises(Int8Unsupported, match="no int8 path for model 'ebrn'"):
        common.int8_and_exact_forwards(pm, "ebrn", x)


@pytest.mark.parametrize("name", ["ebrn_rm", "ebrn_rm_BLI"])
def test_int8_forward_matches_jax(name):
    """make_int8_ebrn_rm_forward in f32 against JAX's int8 forward: with
    JAX's records in its runner at FWD_PSNR_DB, calibrated on its own within
    SELF_CALIB_MARGIN_DB of that or of its distance to the exact forward.
    JAX exports no ebrn_rm_BLI maker name, but its maker takes the BLI
    module, so both are held."""
    jm, _, pm = _models(name)
    calib, x = _lr((2, 10, 12, 3), seed=5), _lr((1, 8, 10, 3), seed=6)
    jfwd = jax_int8_ebrn_rm(jm, calib, dtype=jnp.float32)
    want = np.asarray(jfwd(jm.params, jnp.asarray(x)))
    fwd = make_int8_ebrn_rm_forward(pm, calib, torch.float32)
    got = fwd(torch.from_numpy(x)).numpy()
    quant = [{k: (np.asarray(v) if not isinstance(v, float) else v) for k, v in q.items()}
             for q in _closure(_closure(jfwd, "pair_int8"), "quant")]
    assert len(quant) == len(fwd.runner.quant) == 2
    assert all((q.act, q.slope) == ("leaky_relu", 0.05) for q in fwd.runner.quant)
    scales = max(abs(getattr(p, k) - q[k]) / q[k] for p, q in zip(fwd.runner.quant, quant)
                 for k in ("s_in", "s_mid"))
    fwd.runner.quant[:] = pairs.load_jax_records(quant, torch.float32, "cpu", "leaky_relu",
                                                 0.05)
    same = fwd(torch.from_numpy(x)).numpy()
    with torch.no_grad():
        exact = pm.module(torch.from_numpy(x)).numpy()
    print("int8 %s vs JAX: PSNR %.1f dB, with JAX's records %.1f dB; int8 vs exact %.1f dB; "
          "activation scales within %.3g of JAX's"
          % (name, _psnr(got, want), _psnr(same, want), _psnr(got, exact), scales))
    assert _psnr(same, want) >= FWD_PSNR_DB and scales <= 1e-5
    assert _psnr(got, want) >= min(FWD_PSNR_DB, _psnr(got, exact) + SELF_CALIB_MARGIN_DB)
    assert float(np.abs(got - exact).max()) > 1e-3  # it does quantize


def test_cli_int8_route_and_validate(tmp_path):
    """ebrn_rm through the validate CLI from a JAX-written `.pth`, exact and
    with --int8_trunk (each side calibrating its own bf16 int8 forward):
    JAX's validate's mean PSNR on the same set within 1e-3 dB, the int8
    route within 0.05 dB."""
    from larvanet_tpu.cli import validate as jax_validate
    from larvanet_tpu_torch.cli import validate
    from larvanet_tpu_torch.data import io

    root = str(tmp_path)
    rng = np.random.default_rng(12)
    for i in range(2):
        hr = rng.integers(0, 256, (3, 48, 64), dtype=np.uint8)
        lr = np.round(hr.reshape(3, 12, 4, 16, 4).mean((2, 4))).astype(np.uint8)
        io.save_image_chw(hr, os.path.join(root, "HR", "%04d.png" % i))
        io.save_image_chw(lr, os.path.join(root, "LR", "X4", "%04dx4.png" % i))
    _, params, _ = _models("ebrn_rm")
    pth = save_pth(params, "ebrn_rm", os.path.join(root, "m.pth"))
    argv = ["--model", "ebrn_rm", "--scales", "4", "--restore_path", pth,
            "--data_input_path", os.path.join(root, "LR"),
            "--data_truth_path", os.path.join(root, "HR"), *SMALL]
    for extra in ([], ["--int8_trunk", "1"]):
        want = jax_validate.main(argv + extra + ["--data_native", "0"])
        got = validate.main(argv + extra + ["--device", "cpu"])
        print("validate ebrn_rm %s: port %.4f dB, JAX %.4f dB" % (extra, got[4], want[4]))
        assert abs(got[4] - want[4]) <= (1e-3 if not extra else 0.05)
