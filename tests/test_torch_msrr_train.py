"""The port's MSRR family in training, int8 and the test CLI against the JAX
package's, on the CPU, at --num_blocks 1 or 2: the train step's loss and
gradients (the LR-domain loss, relu6, leaky_relu at --slope, the depthwise
blocks' kernels through their autograd Function) against jax.grad of JAX's
`_compute_loss`; QAT's; the int8 pair with relu6 and leaky_relu bit for bit
with JAX's `pair_int8`, and `make_int8_msrr_forward` against JAX's; the
depthwise config's refusals; msrr_reduced's volume-driven steps; and
msrr_test's [0, 1] contract in the test CLI.

Parameters cross over through `state_dict_from_jax_params`, louder than
drawn (tests/test_torch_msrr.py's `_louder`) where the residual would hide
a fault; inputs come from numpy seeds.
"""

import functools
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvanet_tpu.cli import test as jax_test
from larvanet_tpu.core.registry import get_loader as jax_get_loader
from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.ops.packed import pairs as jpairs
from larvanet_tpu.ops.packed.core import grid1_mask, pack_w, unpack_w
from larvanet_tpu.ops.packed.msrr import make_int8_msrr_forward as jax_make_int8_msrr
from larvanet_tpu.utils.torch_convert import save_pth
from larvanet_tpu_torch.cli import test as port_test
from larvanet_tpu_torch.core.registry import get_loader, get_model
from larvanet_tpu_torch.data import io
from larvanet_tpu_torch.models.layers import Conv3x3
from larvanet_tpu_torch.ops import conv3x3, pairs
from larvanet_tpu_torch.ops.int8_forward import Int8Unsupported, make_int8_msrr_forward
from larvanet_tpu_torch.utils.torch_convert import state_dict_from_jax_params
from test_torch_msrr import _louder, _lr, _to_numpy

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-5  # the plain step: JAX's XLA gradients sit ~1e-5 of their max from float64
QAT_GRAD_RTOL = 2e-4  # a QAT pair's gradients on the same input
# QAT's whole-model gradients, where codes flip: the exact convs sum in
# another order, a flipped code moves the next pair's batch maximum and every
# code after it (tests/test_torch_qat.py's FLIP_GRAD_RTOL)
QAT_FLIP_GRAD_RTOL = 5e-2
FWD_PSNR_DB = 80.0  # f32 int8 forwards against JAX's
BATCH, PATCH = 2, 8


def _jax_tree(params):
    return jax.tree_util.tree_map(jnp.asarray, params)


@functools.lru_cache(maxsize=None)
def _train_models(name, flags=(), scale=4, louder=True):
    """(JAX model, port model) prepared for training with the same
    parameters, f32, on the CPU."""
    jm = jax_get_model(name)
    jm.parse_args(list(flags))
    jm.prepare(is_training=True, scales=[scale])
    params = _to_numpy(jm.params)
    if louder:
        params = _louder(params, np.random.default_rng(len(name)))
    jm.params = _jax_tree(params)
    pm = get_model(name)
    pm.parse_args(list(flags))
    pm.prepare([scale], device="cpu", is_training=True)
    pm.load_state_dict(state_dict_from_jax_params(params, name))
    return jm, pm


def _batch(seed, out_scale=4, w=PATCH):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, (BATCH, PATCH, w, 3)).astype(np.float32)
    y = rng.uniform(0, 255, (BATCH, out_scale * PATCH, out_scale * w, 3)).astype(np.float32)
    return x, y


def _step_vs_jax(name, flags, bar, out_scale=4, scale=4, louder=True):
    jm, pm = _train_models(name, tuple(flags), scale, louder)
    x, y = _batch(len(name), out_scale)
    want_loss, want_grads = jax.value_and_grad(
        lambda p: jm._compute_loss(p, jnp.asarray(x), jnp.asarray(y)))(jm.params)
    pm.module.zero_grad(set_to_none=True)
    loss = pm._compute_loss(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    want = state_dict_from_jax_params(_to_numpy(want_grads), name)
    rel = abs(float(loss.detach()) - float(want_loss)) / abs(float(want_loss))
    worst = (0.0, None)
    for key, p in pm.module.named_parameters():
        err = float((p.grad - want[key]).abs().max()) / float(want[key].abs().max())
        worst = max(worst, (err, key))
    print("train %s %s: loss rel %.3g, worst gradient %.3g of its max (%s)"
          % (name, " ".join(flags), rel, *worst))
    assert rel <= LOSS_RTOL and worst[0] <= bar


@pytest.mark.parametrize("name,flags", [
    ("msrr_reduced_relu6", ["--num_blocks", "2"]),          # relu6, the LR-domain loss
    ("msrr_reduced_leaky", ["--num_blocks", "2", "--slope", "0.2", "--lr_domain_loss", "0"]),
    ("dwsr_reduced", ["--num_blocks", "2"]),                # the depthwise kernels' Function
    ("msrr", ["--num_blocks", "1", "--num_filters", "8"]),  # leaky after the shuffles
])
def test_train_step_matches_jax(name, flags):
    """The train step's loss and every gradient against jax.grad of JAX's
    `_compute_loss` on the same batch."""
    _step_vs_jax(name, flags, GRAD_RTOL)


QAT_MODELS = {"msrr_reduced_leaky": ["--num_blocks", "2", "--slope", "0.2", "--qat", "1"],
              "msrr_reduced_relu6": ["--num_blocks", "2", "--qat", "1"],
              "msrr_test": ["--num_blocks", "1", "--num_filters", "8", "--qat", "1"]}


@pytest.mark.parametrize("name", sorted(QAT_MODELS))
def test_qat_step_matches_jax(name):
    """--qat 1: every ResBlock pair fake-quantized, against JAX's
    make_packed_msrr_forward(qat=True) step: the loss, and the gradients at
    the bar for flipped codes (the pairs are held on the same inputs below)."""
    _step_vs_jax(name, QAT_MODELS[name], QAT_FLIP_GRAD_RTOL, louder=False)


def _jax_act(conv):
    return {"relu": jax.nn.relu, "relu6": lambda t: jnp.clip(t, 0.0, 6.0),
            "leaky_relu": lambda t: jax.nn.leaky_relu(t, conv.slope)}[conv.act]


@pytest.mark.parametrize("name", sorted(QAT_MODELS))
def test_qat_pair_gradients_match_jax_on_the_same_inputs(name):
    """Every ResBlock pair of the QAT walk, on the input the port's walk gives
    it and one random output gradient: JAX's qat_pair (packed, with conv1's
    activation) and the port's, the gradients of the input and of both
    convs' kernels and biases within QAT_GRAD_RTOL of each tensor's max."""
    from larvanet_tpu_torch.models.layers import exact_pair

    _, pm = _train_models(name, tuple(QAT_MODELS[name]), louder=False)
    x, _ = _batch(7)
    seen = []

    def cap(idx, hin, conv1, conv2, **k):
        seen.append((hin.detach().clone(), conv1, conv2, k))
        return exact_pair(idx, hin, conv1, conv2, **k)

    with torch.no_grad():
        pm.module.walk(torch.from_numpy(x), cap)
    rng = np.random.default_rng(8)
    worst = 0.0
    for hin, conv1, conv2, k in seen:
        c = hin.shape[3]
        jparams = [{"kernel": jnp.asarray(conv.weight.detach().permute(2, 3, 1, 0).numpy()),
                    "bias": jnp.asarray(conv.bias.detach().numpy())} for conv in (conv1, conv2)]
        ct = rng.standard_normal(tuple(hin.shape)).astype(np.float32)

        def jf(h, p1, p2):
            hp = pack_w(h)
            m = grid1_mask(hp.shape[2] + 1, c, jnp.float32)
            out = jpairs.qat_pair(jnp.float32)(0, hp, p1, p2, m, act=_jax_act(conv1), **k)
            return jnp.sum(unpack_w(out) * ct)

        _, (gh, g1, g2) = jax.value_and_grad(jf, argnums=(0, 1, 2))(
            jnp.asarray(hin.numpy()), *jparams)
        h = hin.clone().requires_grad_(True)
        for conv in (conv1, conv2):
            conv.zero_grad(set_to_none=True)
        (pairs.qat_pair(torch.float32)(0, h, conv1, conv2, **k)
         * torch.from_numpy(ct)).sum().backward()
        for got, want in ((h.grad, gh), (conv1.weight.grad.permute(2, 3, 1, 0), g1["kernel"]),
                          (conv1.bias.grad, g1["bias"]),
                          (conv2.weight.grad.permute(2, 3, 1, 0), g2["kernel"]),
                          (conv2.bias.grad, g2["bias"])):
            want = np.asarray(want)
            err = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
            worst = max(worst, err)
            assert err <= QAT_GRAD_RTOL, err
    print("qat %s: %d pairs, worst gradient on the same input %.3g of its max"
          % (name, len(seen), worst))


def test_relu6_gradient_takes_jax_half_at_the_ends():
    """jnp.clip(z, 0, 6)'s gradient is 1/2 where z is exactly 0 or 6: the
    Function keeps z, so it does too (a zero kernel makes z the bias)."""
    c = 4
    x = torch.zeros(1, 3, 3, c, requires_grad=True)
    k = torch.zeros(3, 3, c, c, requires_grad=True)
    bias = torch.tensor([0.0, 6.0, 3.0, -1.0], requires_grad=True)
    out = conv3x3.Conv3x3Train.apply(x, k, bias, "relu6")
    out.sum().backward()
    want = jax.grad(lambda b: jnp.clip(jnp.zeros((1, 3, 3, c)) + b, 0.0, 6.0).sum())(
        jnp.zeros(c).at[1].set(6.0).at[2].set(3.0).at[3].set(-1.0))
    assert np.array_equal(bias.grad.numpy(), np.asarray(want))
    assert bias.grad.tolist() == [4.5, 4.5, 9.0, 0.0]


# ---- int8 ----

ACTS = {"relu6": (lambda t: jnp.clip(t, 0.0, 6.0), 0.1),
        "leaky_relu": (lambda t: jax.nn.leaky_relu(t, 0.2), 0.2)}


def _closure(fn, name):
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("act", sorted(ACTS))
def test_int8_pair_with_new_activations_equals_jax_bit_for_bit(act, dname):
    """The port's int8 pair, conv1's act (relu6, leaky_relu at 0.2) inside
    conv_a before the requantize, against JAX's pair_int8 given the same
    activation and its records: every output bit equal."""
    tdt, jdt = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}[
        dname]
    jact, slope = ACTS[act]
    rng = np.random.default_rng(len(act) + len(dname))
    c = 16
    g = torch.Generator().manual_seed(3)
    conv1 = Conv3x3(c, c, act=act, generator=g, slope=slope)
    conv2 = Conv3x3(c, c, generator=g)
    with torch.no_grad():
        conv1.weight.mul_(20.0)  # pre-activations well past 6
        for conv in (conv1, conv2):
            conv.bias.copy_(torch.from_numpy(rng.standard_normal(c).astype(np.float32)))
    p1, p2 = [{"kernel": conv.weight.detach().permute(2, 3, 1, 0).numpy(),
               "bias": conv.bias.detach().numpy()} for conv in (conv1, conv2)]
    hin = (rng.standard_normal((2, 7, 10, c)) * 4).astype(np.float32)
    pair_cal, pair_int8, finish = jpairs.make_pair_runner(jdt)
    h = pack_w(jnp.asarray(hin, jdt))
    mask1 = grid1_mask(h.shape[2] + 1, c, jdt)
    pair_cal(0, h, p1, p2, mask1, act=jact)
    finish([(p1, p2)])
    want = np.asarray(unpack_w(pair_int8(0, h, p1, p2, mask1, act=jact)), np.float32)
    quant = [{k: (np.asarray(v) if not isinstance(v, float) else v) for k, v in q.items()}
             for q in _closure(pair_int8, "quant")]
    q = pairs.load_jax_records(quant, tdt, "cpu", act, slope)[0]
    got = pairs.int8_pair(q, torch.from_numpy(hin).to(tdt), "res").float().numpy()
    differ = int((got.view(np.uint32) != want.view(np.uint32)).sum())
    print("int8 pair %s %s: %d of %d values differ" % (dname, act, differ, want.size))
    assert differ == 0
    # the port's own calibration records JAX's maxima (the max after the
    # activation: relu6 caps it at 6), up to the float convs' summation order
    runner = pairs.PairRunner(tdt)
    with torch.no_grad():
        runner.calib(0, torch.from_numpy(hin).to(tdt), conv1.to(tdt), conv2.to(tdt))
    for got_max, want_max in zip(runner.record[0], _closure(pair_cal, "record")[0]):
        assert abs(float(got_max) - float(want_max)) <= 2e-2 * float(want_max)
    assert act != "relu6" or float(runner.record[0][1]) <= 6.0


def _psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


@pytest.mark.parametrize("name,flags", [("msrr_reduced", []), ("msrr_reduced_relu6", []),
                                        ("msrr_reduced_leaky", ["--slope", "0.2"])])
def test_int8_forward_matches_jax(name, flags):
    """make_int8_msrr_forward in f32, calibrated on its own and then with
    JAX's records in its runner, against JAX's make_int8_msrr_forward: the
    pairs are JAX's bit for bit (above), the exact head and shuffle sum in
    another order, so the forwards are held by PSNR."""
    jm, pm = _train_models(name, tuple(["--num_blocks", "2"] + flags))
    calib, x = _lr((2, 12, 14, 3), seed=5), _lr((1, 10, 12, 3), seed=6)
    jfwd = jax_make_int8_msrr(jm, calib, dtype=jnp.float32)
    want = np.asarray(jfwd(jm.params, jnp.asarray(x)))
    fwd = make_int8_msrr_forward(pm, calib, torch.float32)
    got = fwd(torch.from_numpy(x)).numpy()
    assert all(q.act == pm.module.res_blocks[0].body[0].act for q in fwd.runner.quant)
    quant = [{k: (np.asarray(v) if not isinstance(v, float) else v) for k, v in q.items()}
             for q in _closure(_closure(jfwd, "pair_int8"), "quant")]
    conv1 = pm.module.res_blocks[0].body[0]
    fwd.runner.quant[:] = pairs.load_jax_records(quant, torch.float32, "cpu", conv1.act,
                                                 conv1.slope)
    same = fwd(torch.from_numpy(x)).numpy()
    with torch.no_grad():
        exact = pm.module(torch.from_numpy(x)).numpy()
    print("int8 %s vs JAX: PSNR %.1f dB, with JAX's records %.1f dB; int8 vs exact %.1f dB"
          % (name, _psnr(got, want), _psnr(same, want), _psnr(got, exact)))
    assert _psnr(got, want) >= FWD_PSNR_DB and _psnr(same, want) >= FWD_PSNR_DB
    assert float(np.abs(got - exact).max()) > 1e-3  # it does quantize


def test_depthwise_config_refuses_what_jax_refuses():
    """dwsr_reduced has no packed pairs: --qat 1 and --remat 1 fail at the
    first step, and the int8 maker refuses, each with JAX's message."""
    x, y = _batch(0)
    for flag in ("--qat", "--remat"):
        flags = ("--num_blocks", "1", flag, "1")
        jm, pm = _train_models("dwsr_reduced", flags, louder=False)
        with pytest.raises(ValueError) as jerr:
            jm._compute_loss(jm.params, jnp.asarray(x), jnp.asarray(y))
        with pytest.raises(ValueError) as perr:
            pm._compute_loss(torch.from_numpy(x), torch.from_numpy(y))
        assert str(perr.value) == str(jerr.value) and "depthwise" in str(jerr.value)
    jm, pm = _train_models("dwsr_reduced", ("--num_blocks", "1"), louder=False)
    calib = _lr((1, 8, 8, 3))
    with pytest.raises(ValueError) as jerr:
        jax_make_int8_msrr(jm, calib, dtype=jnp.float32)
    with pytest.raises(Int8Unsupported) as perr:
        make_int8_msrr_forward(pm, calib, torch.float32)
    assert str(perr.value) == str(jerr.value)


# ---- msrr_reduced's volume-driven steps ----

VOLUME_PER_STEP = PATCH * PATCH * BATCH * 3
# validation every 3 steps; --patience 0 and a threshold no step improves
# by: every validation after the first halves the lr
VOLUME_FLAGS = ["--num_blocks", "1", "--val_volume", str(3 * VOLUME_PER_STEP), "--patience",
                "0", "--cooldown", "0", "--threshold", "0.5"]
STEPS = 6


@pytest.fixture(scope="module")
def div2k_root(tmp_path_factory):
    """A DIV2K-layout set written by the port's PNG encoder (LR 16x20)."""
    root = str(tmp_path_factory.mktemp("div2k"))
    rng = np.random.default_rng(11)
    for i in range(2):
        hr = rng.integers(0, 256, (3, 64, 80), dtype=np.uint8)
        lr = np.round(hr.reshape(3, 16, 4, 20, 4).mean((2, 4))).astype(np.uint8)
        io.save_image_chw(hr, os.path.join(root, "HR", "%04d.png" % i))
        io.save_image_chw(lr, os.path.join(root, "LR", "X4", "%04dx4.png" % i))
    return root


def test_msrr_reduced_volume_steps_match_jax(div2k_root, tmp_path):
    """train_step_larva on both sides from the same weights and batches:
    the steps that validate, the PSNRs, the lr after each step, the
    volumes and the checkpoints' names."""
    jm, pm = _train_models("msrr_reduced", tuple(VOLUME_FLAGS), louder=False)
    out = {}
    for side, model, loader in (("jax", jm, jax_get_loader("div2k_val_loader")),
                                ("port", pm, get_loader("div2k_val_loader"))):
        loader.parse_args(["--data_input_path", os.path.join(div2k_root, "LR"),
                           "--data_truth_path", os.path.join(div2k_root, "HR")]
                          + (["--data_native", "0"] if side == "jax" else []))
        loader.prepare([4])
        path = str(tmp_path / side)
        validations, steps = [], []
        orig = model.validate_for_train

        def validate(args, dl, orig=orig, model=model, validations=validations):
            psnr = orig(args, dl)
            validations.append((model.global_step, psnr))
            return psnr

        model.validate_for_train = validate
        model.volume_per_step = VOLUME_PER_STEP
        for step in range(STEPS):
            x, y = _batch(step)
            chw = lambda a: list(a.transpose(0, 3, 1, 2))  # noqa: E731
            model.train_step_larva(SimpleNamespace(train_path=path), loader, chw(x), chw(y))
            steps.append((model.global_step, model.get_learning_rate(), model.temp_volume,
                          model.total_volume))
        out[side] = (validations, steps, sorted(os.listdir(path)))
    (pv, ps, pfiles), (jv, js, jfiles) = out["port"], out["jax"]
    print("msrr_reduced validations: port %s, JAX %s" % (pv, jv))
    assert [s for s, _ in pv] == [s for s, _ in jv] == [1, 3, 6]
    assert all(abs(a - b) <= 1e-3 for (_, a), (_, b) in zip(pv, jv))
    assert ps == js
    assert [s[1] for s in ps] == [4e-4] * 2 + [2e-4] * 3 + [1e-4]
    stems = ["model_step%d_vol0G" % s for s in (3, 6)]
    assert [f for f in jfiles if f.endswith(".ckpt")] == [s + ".ckpt" for s in stems]
    assert pfiles == sorted([s + ".pth" for s in stems] + [s + ".state.pt" for s in stems])


# ---- msrr_test's [0, 1] contract in the test CLI ----

def test_test_cli_runs_msrr_test_in_the_unit_range(tmp_path):
    """The test CLI on msrr_test: the frame over 255 in, the output clipped
    to [0, 1], times 255, rounded (JAX's cli/test.py:130, :149-152), per
    image Y-PSNR and SSIM against JAX's CLI on the same `.pth`."""
    rng = np.random.default_rng(12)
    for i in range(2):
        hr = rng.integers(0, 256, (3, 32, 40), dtype=np.uint8)
        lr = np.round(hr.reshape(3, 8, 4, 10, 4).mean((2, 4))).astype(np.uint8)
        io.save_image_chw(hr, str(tmp_path / "HR" / "Set5" / ("img%d.png" % i)))
        io.save_image_chw(lr, str(tmp_path / "LR" / "Set5" / ("img%d.png" % i)))
    flags = ["--num_blocks", "1", "--num_filters", "8"]
    jm = jax_get_model("msrr_test")
    jm.parse_args(list(flags))
    jm.prepare(is_training=False, scales=[4])
    pth = save_pth(_to_numpy(jm.params), "msrr_test", str(tmp_path / "msrr_test.pth"))
    argv = ["--model", "msrr_test", "--restore_path", pth, "--input_root_path",
            str(tmp_path / "LR"), "--truth_root_path", str(tmp_path / "HR"), "--datasets",
            "Set5", *flags]
    jax_test.main(argv + ["--output_root_path", str(tmp_path / "jax"), "--report_json",
                          str(tmp_path / "jax.json")])
    port_test.main(argv + ["--device", "cpu", "--output_root_path", str(tmp_path / "port"),
                           "--report_json", str(tmp_path / "port.json")])
    ref, got = (json.loads((tmp_path / f).read_text())["Set5"] for f in ("jax.json",
                                                                         "port.json"))
    for key, want in ref["per_image"].items():
        print("test msrr_test %s: PSNR %.4f / %.4f, SSIM %.5f / %.5f" % (
            key, got["per_image"][key]["psnr"], want["psnr"], got["per_image"][key]["ssim"],
            want["ssim"]))
        assert abs(got["per_image"][key]["psnr"] - want["psnr"]) <= 1e-3
        assert abs(got["per_image"][key]["ssim"] - want["ssim"]) <= 1e-5
    assert 12.0 < ref["mean_psnr"] < 60.0  # the bilinear base scored: not a clipped frame
    sr = io.load_image_u8(str(tmp_path / "port" / "msrr_test" / "Set5" / "img0.png"))
    assert sr.shape == (32, 40, 3) and 20 < float(sr.mean()) < 235
