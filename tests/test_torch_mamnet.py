"""The port's MAMNet (larvanet_tpu_torch/models/mamnet.py, layers.MAMLayer)
against the JAX package's (larvanet_tpu/models/mamnet.py,
ops/packed/mamnet.py), on the CPU, at --mamnet_conv_features 16
--mamnet_res_blocks 2: the MAM gate alone; the f32 forward at x2 / x3 / x4,
odd and even widths, against JAX's module and its default serving route
`make_packed_mamnet_forward` (the port's module graph against the first,
its collapsed-tail route against both); the bf16 route against JAX's module
graph in bf16, with its distance to the packed bf16 forward printed; the
converter and a reference-layout `.pth`; trained MeanShifts; the train
step's loss and gradients against jax.grad of JAX's `_compute_loss` (its
`make_collapsed_mamnet_train_forward` with the LR-domain loss on and off,
the packed training graph, the module graph); the --qat refusal;
the int8 forward on JAX's calibration records; validate's PSNRs
against JAX's validate; the inference CLIs' routes.

Weights: the port's init with first_conv scaled so that the head's output
has a std of HEAD_STD and each block's conv2 so that its output has a std of
1 (`_tame`): at the init's scale the channel variance CSI is in the
hundreds, the gate's sigmoid is 1 everywhere and a fault in the ICD or the
CSD would not show. They cross to JAX by the JAX package's importer and
back through the port's `state_dict_from_jax_params` (strict). Forward
errors are held relative to the largest value of the reference's output.
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
from larvanet_tpu.models.mamnet import MAMLayer as JaxMAMLayer
from larvanet_tpu.ops.packed.mamnet import make_int8_mamnet_forward as jax_int8_mamnet
from larvanet_tpu.ops.packed.mamnet import make_packed_mamnet_forward
from larvanet_tpu.utils import torch_convert as jax_convert
from larvanet_tpu.utils.torch_convert import export_state_dict, save_pth
from larvanet_tpu_torch.cli import common
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.models.layers import DIV2K_RGB_MEAN, MAMLayer, exact_pair
from larvanet_tpu_torch.models.mamnet import QAT_REFUSAL
from larvanet_tpu_torch.ops import pairs
from larvanet_tpu_torch.ops.collapsed_tail import make_collapsed_edsr_forward
from larvanet_tpu_torch.ops.int8_forward import make_int8_edsr_forward
from larvanet_tpu_torch.utils.torch_convert import state_dict_from_jax_params
from test_torch_msrr import _lr, _to_numpy
from test_torch_msrr_train import _batch, _closure, _psnr

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

SMALL = ["--mamnet_conv_features", "16", "--mamnet_res_blocks", "2"]
HEAD_STD = 30.0
F32_RTOL = 2e-5     # of the reference's largest |y|
BF16_RTOL = 1.5e-2
GRAD_RTOL = 5e-5    # of each gradient tensor's largest |g|
LOSS_RTOL = 1e-5
INT8_PSNR_DB = 120.0  # the port's int8 forward on JAX's records against JAX's
SELF_CALIB_MARGIN_DB = 10.0
VALIDATE_DB = 1e-4
# a collapsed tail against a module's own tail: JAX's bar for its collapsed
# forward against its module (tests/test_torch_collapsed_tail.py). The probed
# kernel is a difference of responses that carry the inverse mean shift, so
# each tap is exact only to an f32 step of ~114.
COLLAPSED_ATOL = 0.1


def _tame(module, x):
    """Scale first_conv so that the head's output on `x` has a std of
    HEAD_STD, then each block's conv2, in order, so that its output has a
    std of 1; set the squeeze's bias to 1, so that its one channel's ReLU
    passes (at 16 features the squeeze is 16 -> 1)."""
    with torch.no_grad():
        h = module.first_conv(module.mean_shift(x))
        a = HEAD_STD / float(h.std())
        module.first_conv.weight.mul_(a)
        module.first_conv.bias.mul_(a)
        for i, block in enumerate(module.res_blocks):
            seen = []

            def capture(idx, hin, conv1, conv2, **kw):
                t = exact_pair(idx, hin, conv1, conv2, **kw)
                if idx == i:
                    seen.append(float(t.std()))
                return t

            module(x, capture)
            block.body[2].weight.mul_(1.0 / seen[0])
            block.body[2].bias.mul_(1.0 / seen[0])
            block.body[3].conv_du[0].bias.fill_(1.0)  # the 1-channel squeeze's ReLU live


@functools.lru_cache(maxsize=None)
def _models(scale=4, flags=(), is_training=False):
    """(JAX model, its parameters as numpy, the port's model with them), f32,
    on the CPU, without JAX's flax init."""
    pm = get_model("mamnet")
    pm.parse_args(SMALL + list(flags))
    pm.prepare([scale], device="cpu", is_training=is_training)
    _tame(pm.module, torch.from_numpy(_lr((2, 8, 8, 3), seed=99)))
    state = {k: v.numpy() for k, v in pm.module.state_dict().items()}
    params = jax_convert.convert_state_dict(state, "mamnet")[0]
    pm.load_state_dict(state_dict_from_jax_params(params, "mamnet"))  # strict
    jm = jax_get_model("mamnet")
    jm.parse_args(SMALL + list(flags))
    jm.scale, jm.scale_list, jm.is_training = scale, [scale], is_training
    jm.module = jm.build_module()
    jm.params = jax.tree_util.tree_map(jnp.asarray, params)
    return jm, params, pm


def _hold(label, got, want, rtol):
    assert got.shape == want.shape, (got.shape, want.shape)
    err = float(np.abs(got.astype(np.float64) - want).max())
    scale = float(np.abs(want).max())
    print("parity %s: max|d| %.3g, %.3g of the reference's max %.3g"
          % (label, err, err / scale, scale))
    assert err <= rtol * scale
    return err / scale


@pytest.mark.parametrize("shape", [(2, 7, 9, 16), (1, 6, 8, 16)])
def test_mam_gate_matches_jax(shape):
    """The MAM gate alone, x * sigmoid(CSI + ICD + CSD), against JAX's
    MAMLayer on the same weights, with inputs whose channel variances are
    near 1 (the sigmoid's live range), in f32; the gate's spread shows
    that no path saturates it."""
    rng = np.random.default_rng(shape[2])
    layer = MAMLayer(16, generator=torch.Generator().manual_seed(shape[1]))
    with torch.no_grad():
        for conv in layer.conv_du[0], layer.conv_du[2], layer.depthwise_conv2d:
            conv.bias.copy_(torch.from_numpy(rng.standard_normal(conv.bias.shape)
                                             .astype(np.float32)))
    params = {"du1": layer.conv_du[0], "du2": layer.conv_du[2],
              "depthwise": layer.depthwise_conv2d}
    params = {k: {"kernel": jnp.asarray(m.weight.detach().permute(2, 3, 1, 0).numpy()),
                  "bias": jnp.asarray(m.bias.detach().numpy())} for k, m in params.items()}
    x = (rng.standard_normal(shape) * rng.uniform(0.5, 1.5, shape[3])
         + rng.standard_normal(shape[3])).astype(np.float32)
    want = np.asarray(JaxMAMLayer(16).apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = layer(torch.from_numpy(x)).numpy()
    gate = want / x
    print("MAM gate %s: the gate spans [%.3f, %.3f]" % (shape, gate.min(), gate.max()))
    assert gate.min() < 0.2 and gate.max() > 0.8
    _hold("MAM gate %s" % (shape,), got, want, F32_RTOL)


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_forward_matches_jax_module_and_packed_route(scale):
    """The f32 forward, at an odd and an even width: the port's module graph
    against JAX's module and the port's default route (the collapsed tail,
    set up by the CLIs' maybe_collapse_tail) against JAX's default route
    make_packed_mamnet_forward at F32_RTOL; both collapsed routes against
    JAX's module at JAX's COLLAPSED_ATOL."""
    jm, params, pm = _models(scale)
    apply = jax.jit(lambda p, x: jm.module.apply({"params": p}, x))
    packed = jax.jit(make_packed_mamnet_forward(jm, dtype=jnp.float32))
    route = make_collapsed_edsr_forward(pm)
    for shape in ((2, 7, 9, 3), (1, 6, 8, 3)):
        x = _lr(shape, seed=shape[2] + scale)
        want = np.asarray(apply(params, jnp.asarray(x)))
        want_packed = np.asarray(packed(params, jnp.asarray(x)))
        xt = torch.from_numpy(x)
        with torch.no_grad():
            module = pm.module(xt).numpy()
        collapsed = route(xt).numpy()
        label = "mamnet x%d %s" % (scale, shape)
        _hold(label + " module vs module", module, want, F32_RTOL)
        _hold(label + " collapsed vs packed", collapsed, want_packed, F32_RTOL)
        errs = [float(np.abs(a - want).max()) for a in (collapsed, want_packed)]
        print("  against JAX's module: the port's collapsed route %.3g, JAX's packed route "
              "%.3g (bar %.3g)" % (*errs, COLLAPSED_ATOL))
        assert max(errs) <= COLLAPSED_ATOL


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_bf16_forward_matches_jax_module(scale):
    """The bf16 serving route (the collapsed tail on the bf16 copy; the gate's
    variance in f32, two passes) against JAX's module graph in bf16; its
    distance to JAX's packed bf16 forward (one-pass moments, s1 summed in
    bf16) is printed."""
    jm, params, pm = _models(scale)
    x = _lr((1, 6, 8, 3), seed=3 + scale)
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    apply = jax.jit(lambda p, x: jm.module.apply({"params": p}, x))
    want = np.asarray(apply(bf, jnp.asarray(x, jnp.bfloat16)), np.float32)
    packed = np.asarray(jax.jit(make_packed_mamnet_forward(jm, dtype=jnp.bfloat16))(
        params, jnp.asarray(x)), np.float32)
    pm.set_serving_dtype("bf16")
    try:
        common.maybe_collapse_tail(pm, SimpleNamespace(model="mamnet", collapsed_tail=1))
        got = pm.fwd_runtime(torch.from_numpy(x)).numpy()
    finally:
        pm.set_route(None)
        pm.set_serving_dtype("f32")
    _hold("mamnet x%d bf16 vs JAX's bf16 module" % scale, got, want, BF16_RTOL)
    print("  bf16 vs JAX's packed bf16 forward: %.3g of its max"
          % (float(np.abs(got - packed).max()) / float(np.abs(packed).max())))


def test_converter_and_reference_pth(tmp_path):
    """`state_dict_from_jax_params` gives JAX's `export_state_dict` key for key
    and value for value (the gate's conv_du.0 / conv_du.2 and
    depthwise_conv2d, both MeanShifts); a reference-layout `.pth` restores
    strictly and serves JAX's module output."""
    jm, params, _ = _models()
    got = state_dict_from_jax_params(params, "mamnet")
    want = export_state_dict(params, "mamnet")
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert np.array_equal(got[key].numpy(), np.asarray(value, np.float32)), key
    assert got["res_blocks.1.body.3.conv_du.0.weight"].shape == (1, 16, 1, 1)
    assert got["res_blocks.0.body.3.depthwise_conv2d.weight"].shape == (16, 1, 3, 3)
    path = str(tmp_path / "ref.pth")
    torch.save({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in want.items()}, path)
    pm = get_model("mamnet")
    pm.parse_args(list(SMALL))
    pm.prepare([4], device="cpu")
    pm.restore(path)  # strict
    x = _lr((1, 5, 6, 3), seed=8)
    with torch.no_grad():
        served = pm.module(torch.from_numpy(x)).numpy()
    _hold("mamnet restored .pth", served,
          np.asarray(jm.module.apply({"params": params}, jnp.asarray(x))), F32_RTOL)


def test_trained_mean_shift_runs_the_module_affines(tmp_path, capsys):
    """A `.pth` whose MeanShifts are trained: the port prints JAX's restore
    line, and its CLI route keeps the module graph, which equals JAX's
    restored module. JAX's CLI route, make_packed_mamnet_forward, bakes the
    intended shifts instead: the recorded difference (ROADMAP.md queue 3),
    shown by its distance to that module."""
    _, params, _ = _models()
    state = export_state_dict(params, "mamnet")
    rng = np.random.default_rng(9)
    for key in ("mean_shift", "mean_inverse_shift"):
        state[key + ".weight"] = (np.eye(3) + 0.05 * rng.standard_normal((3, 3))).astype(
            np.float32).reshape(3, 3, 1, 1)
        state[key + ".bias"] = (state[key + ".bias"] + 10 * rng.standard_normal(3)).astype(
            np.float32)
    path = str(tmp_path / "trained_shift.pth")
    torch.save({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in state.items()}, path)
    jm = jax_get_model("mamnet")
    jm.parse_args(list(SMALL))
    jm.scale, jm.scale_list, jm.is_training = 4, [4], False
    jm.module = jm.build_module()
    jm.params = jax.tree_util.tree_map(jnp.asarray, params)  # for restore's shape check
    capsys.readouterr()
    jm.restore(path)
    jax_lines = [ln for ln in capsys.readouterr().out.splitlines() if "MeanShift" in ln]
    pm = get_model("mamnet")
    pm.parse_args(list(SMALL))
    pm.prepare([4], device="cpu")
    pm.restore(path)
    port_lines = capsys.readouterr().out.splitlines()
    assert len(jax_lines) == 1 and port_lines == jax_lines, (port_lines, jax_lines)
    common.maybe_collapse_tail(pm, SimpleNamespace(model="mamnet", collapsed_tail=1))
    assert pm.route is None and "MeanShift affines" in capsys.readouterr().out
    x = _lr((1, 6, 8, 3), seed=10)
    want = np.asarray(jax.jit(jm.module.apply)({"params": jm.params}, jnp.asarray(x)))
    got = pm.fwd_runtime(torch.from_numpy(x)).numpy()
    _hold("mamnet trained mean shifts", got, want, F32_RTOL)
    jax_route = np.asarray(jax.jit(make_packed_mamnet_forward(jm))(jm.params, jnp.asarray(x)))
    off = float(np.abs(jax_route - want).max())
    print("JAX's CLI route against its restored module: max|d| %.3g" % off)
    assert off > 1.0


# ---- the inference CLIs' routes ----

def test_cli_routes(capsys):
    """maybe_collapse_tail routes MAMNet through the collapsed tail by default,
    under --collapsed_tail 0 too (JAX's CLIs serve make_packed_mamnet_forward
    whatever it says), and keeps the module graph under --packed_trunk 0;
    --wino_trunk prints JAX's line and takes the standard path; the
    TPU-only notice (note_ignored) leaves --packed_trunk out for MAMNet."""
    _, _, pm = _models()
    for flags, routed in (({}, True), ({"collapsed_tail": 0}, True),
                          ({"packed_trunk": "0"}, False), ({"packed_trunk": "1"}, True)):
        pm.set_route(None)
        common.maybe_collapse_tail(pm, SimpleNamespace(**{"model": "mamnet",
                                                          "collapsed_tail": 1, **flags}))
        assert (pm.route is not None) == routed, flags
    pm.set_route(None)
    capsys.readouterr()
    common.maybe_wino_trunk(pm, SimpleNamespace(model="mamnet", wino_trunk=2))
    assert "only the EDSR/LarvaNet families are routed" in capsys.readouterr().out
    assert pm.route is None
    common.note_ignored(SimpleNamespace(packed_trunk="0"), ("packed_trunk",), "validate", pm)
    assert "ignored" not in capsys.readouterr().out


# ---- training ----

@functools.lru_cache(maxsize=None)
def _jax_grads(flags, width):
    jm, params, _ = _models(4, flags, True)
    x, y = _batch(len(flags) + width, w=width)
    loss, grads = jax.jit(jax.value_and_grad(jm._compute_loss))(
        jm.params, jnp.asarray(x), jnp.asarray(y))
    return float(loss), _to_numpy(grads)


@pytest.mark.parametrize("flags,route", [
    ((), "lr_domain"),                               # JAX's default: the LR-domain loss
    (("--lr_domain_loss", "0"), "collapsed"),        # the HR image, the live tail
    (("--collapsed_tail_train", "0"), None),         # the module graph
    (("--packed_trunk_train", "1"), "collapsed"),    # JAX's packed graph, HR loss
])
def test_train_step_matches_jax(flags, route):
    """The train step's loss and every gradient against jax.grad of JAX's
    `_compute_loss` on the same batch (its make_collapsed_mamnet_train_forward
    with the LR-domain loss on and off, its packed training graph, its
    module graph); the CSD's gradients through DWConv3x3Train."""
    _, _, pm = _models(4, flags, True)
    x, y = _batch(len(flags) + 8)
    assert pm.train_tail_route(x.shape[2]) == route
    want_loss, want_grads = _jax_grads(flags, 8)
    pm.module.zero_grad(set_to_none=True)
    loss = pm._compute_loss(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    want = state_dict_from_jax_params(want_grads, "mamnet")
    rel = abs(float(loss.detach()) - want_loss) / abs(want_loss)
    worst = (0.0, None)
    for key, p in pm.module.named_parameters():
        err = float((p.grad - want[key]).abs().max()) / float(want[key].abs().max())
        worst = max(worst, (err, key))
    print("train mamnet %s: loss rel %.3g, worst gradient %.3g of its max (%s)"
          % (" ".join(flags), rel, *worst))
    assert rel <= LOSS_RTOL and worst[0] <= GRAD_RTOL


def test_packed_trunk_train_odd_width_warns_once(capsys):
    """--packed_trunk_train 1 at an odd patch width: JAX's warning, once, and
    the collapsed-tail route (the LR-domain loss), as JAX falls back."""
    _, _, pm = _models(4, ("--packed_trunk_train", "1"), True)
    pm._warned_odd_packed = False
    assert pm.train_tail_route(7) == "lr_domain"
    assert pm.train_tail_route(7) == "lr_domain"
    out = capsys.readouterr().out
    assert out.count("WARNING: --packed_trunk_train 1 but patch width 7 is odd") == 1
    assert "collapsed-tail graph" in out


def test_qat_is_refused_with_jax_message():
    jm = jax_get_model("mamnet")
    jm.parse_args(SMALL + ["--qat", "1"])
    with pytest.raises(ValueError) as jax_err:
        jm.prepare(is_training=True, scales=[4])
    pm = get_model("mamnet")
    pm.parse_args(SMALL + ["--qat", "1"])
    with pytest.raises(ValueError) as port_err:
        pm.prepare([4], device="cpu", is_training=True)
    assert str(port_err.value) == str(jax_err.value) == QAT_REFUSAL
    pm.prepare([4], device="cpu", is_training=False)  # serving takes it


# ---- int8 ----

def test_int8_forward_matches_jax():
    """make_int8_edsr_forward on MAMNet in f32 against JAX's
    make_int8_mamnet_forward: with JAX's records in its runner at
    INT8_PSNR_DB, calibrated on its own within
    SELF_CALIB_MARGIN_DB of that or of its distance to the exact forward;
    'none'-kind pairs, relu in conv_a; the exact forward of the CLIs'
    route is the collapsed one."""
    jm, _, pm = _models()
    calib, x = _lr((2, 10, 12, 3), seed=5), _lr((1, 8, 10, 3), seed=6)
    jfwd = jax_int8_mamnet(jm, calib, dtype=jnp.float32)
    want = np.asarray(jax.jit(jfwd)(jm.params, jnp.asarray(x)))
    fwd = make_int8_edsr_forward(pm, calib, torch.float32)
    got = fwd(torch.from_numpy(x)).numpy()
    quant = [{k: (np.asarray(v) if not isinstance(v, float) else v) for k, v in q.items()}
             for q in _closure(_closure(jfwd, "pair_int8"), "quant")]
    assert len(quant) == len(fwd.runner.quant) == 2
    assert all(q.act == "relu" for q in fwd.runner.quant)
    scales = max(abs(getattr(p, k) - q[k]) / q[k] for p, q in zip(fwd.runner.quant, quant)
                 for k in ("s_in", "s_mid"))
    fwd.runner.quant[:] = pairs.load_jax_records(quant, torch.float32, "cpu", "relu")
    same = fwd(torch.from_numpy(x)).numpy()
    exact = make_collapsed_edsr_forward(pm)(torch.from_numpy(x)).numpy()
    print("int8 mamnet vs JAX: PSNR %.1f dB, with JAX's records %.1f dB; int8 vs exact "
          "%.1f dB; activation scales within %.3g of JAX's"
          % (_psnr(got, want), _psnr(same, want), _psnr(got, exact), scales))
    assert _psnr(same, want) >= INT8_PSNR_DB
    assert _psnr(got, want) >= min(INT8_PSNR_DB, _psnr(got, exact) + SELF_CALIB_MARGIN_DB)
    assert float(np.abs(got - exact).max()) > 1e-3  # it does quantize
    int8_fwd, exact_fwd = common.int8_and_exact_forwards(pm, "mamnet", calib)
    assert np.array_equal(exact_fwd(torch.from_numpy(x)).numpy(), exact)


# ---- validate ----

def test_validate_matches_jax_validate(tmp_path):
    """MAMNet through the validate CLI from a JAX-written `.pth`: the default
    route (the collapsed tail; JAX's packed forward) within VALIDATE_DB of
    JAX's validate's mean PSNR; --int8_trunk (the bf16 int8 forward, held to
    JAX's in test_int8_forward_matches_jax) within 0.05 dB of it."""
    from larvanet_tpu.cli import validate as jax_validate
    from larvanet_tpu_torch.cli import validate
    from larvanet_tpu_torch.data import io

    root = str(tmp_path)
    rng = np.random.default_rng(12)
    for i in range(2):
        hr = rng.integers(0, 256, (3, 32, 40), dtype=np.uint8)
        lr = np.round(hr.reshape(3, 8, 4, 10, 4).mean((2, 4))).astype(np.uint8)
        io.save_image_chw(hr, os.path.join(root, "HR", "%04d.png" % i))
        io.save_image_chw(lr, os.path.join(root, "LR", "X4", "%04dx4.png" % i))
    _, params, _ = _models()
    params = jax.tree_util.tree_map(np.array, params)
    # served frames around mid-grey, not around minus the mean
    params["final_conv"]["bias"] += np.asarray(DIV2K_RGB_MEAN, np.float32) + 128.0
    pth = save_pth(params, "mamnet", os.path.join(root, "m.pth"))
    argv = ["--model", "mamnet", "--scales", "4", "--restore_path", pth,
            "--data_input_path", os.path.join(root, "LR"),
            "--data_truth_path", os.path.join(root, "HR"), *SMALL]
    want = jax_validate.main(argv + ["--data_native", "0"])[4]
    got = validate.main(argv + ["--device", "cpu"])[4]
    int8 = validate.main(argv + ["--device", "cpu", "--int8_trunk", "1"])[4]
    print("validate mamnet: port %.6f dB, JAX %.6f dB; --int8_trunk %.6f dB"
          % (got, want, int8))
    assert abs(got - want) <= VALIDATE_DB and 0 < abs(int8 - got) <= 0.05
