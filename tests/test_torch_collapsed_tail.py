"""The port's collapsed linear tail (larvanet_tpu_torch/ops/collapsed_tail.py)
against the JAX package's (larvanet_tpu/ops/collapsed_tail.py), on the CPU,
at tiny widths (EDSR 8 features), with the kernels' plain versions.

The probes subtract the tail's response to zeros from its response to
deltas, both of magnitude ~|DIV2K mean| (the inverse mean shift), so a
probed value carries about one f32 step of that magnitude of rounding
(2^-17 = 7.6e-6 at 64..128), on JAX's side as on the port's: their
operators are held within two such steps (PROBE_STEPS), not at a bar below
that floor. A forward through independently probed operators inherits that
step times the sum of |trunk features| over the kernel's taps (~0.05 at 8
features), so the port's collapsed forward is held to JAX's collapsed
forward and to its own module forward at JAX's own bar, 0.1
(tests/test_collapsed_tail.py:26-28); with JAX's probed operators fed to the
port's `apply_collapsed_tail`, the two forwards are held at 1e-3. Inputs
come from numpy seeds.
"""

import argparse
import functools
import os
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.ops import collapsed_tail as jct
from larvanet_tpu.ops.pixel_shuffle import pixel_unshuffle as jax_unshuffle
from larvanet_tpu.utils import torch_convert as jax_convert
from larvanet_tpu_torch.cli import common
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.data import io
from larvanet_tpu_torch.models.base import SRModel
from larvanet_tpu_torch.ops import collapsed_tail as pct
from larvanet_tpu_torch.ops import conv_kxk as ck
from larvanet_tpu_torch.ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle
from larvanet_tpu_torch.utils.torch_convert import state_dict_from_jax_params

TINY = ["--edsr_conv_features", "8", "--edsr_res_blocks", "2"]
PROBE_STEPS = 2
COLLAPSED_ATOL = 0.1   # JAX's bar for its collapsed forward against its module
SAME_OPS_ATOL = 1e-3   # the port's apply path on JAX's probed operators
BF16_RTOL = 2.0 ** -6  # bf16 forwards: two bf16 steps of the output's max
# frames: an interior and border (13x17), a square one (9x9), one too small
# for an interior (2b >= h: the original tail)
FRAMES = ((13, 17), (9, 9), (4, 5))
# JAX's default training route against the port's: the loss relative, each
# weight gradient relative to its tensor's largest |g|
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """The plain versions' small matmuls (the probes run ~1,000 tiny images)
    on one thread: many threads on these shapes spend their time
    synchronising, not computing."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _to_numpy(tree):
    if hasattr(tree, "items"):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


@functools.lru_cache(maxsize=None)
def _models(scale, flags=tuple(TINY), is_training=False, name="edsr"):
    """(JAX model, port model) on the same weights: the port's init, crossed
    to JAX's parameters by the JAX package's own converter
    (torch_convert.convert_state_dict). The JAX model gets its parameters,
    scale and module without its flax init, whose eager conv compiles would
    cost more than the rest of the file."""
    pm = get_model(name)
    pm.parse_args(list(flags))
    pm.prepare([scale], device="cpu", is_training=is_training)
    state = {k: v.numpy() for k, v in pm.module.state_dict().items()}
    jm = jax_get_model(name)
    jm.parse_args(list(flags))
    jm.params = jax_convert.convert_state_dict(state, name)[0]
    jm.scale, jm.scale_list, jm.is_training = scale, [scale], is_training
    jm.module = jm.build_module()
    return jm, pm


def _lr(shape, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _jax_operators(scale):
    """JAX's probed kernel (trimmed), bias tile and border operators, from
    its own original-tail function (live_collapsed_edsr_tail's tail_fn, the
    chain of make_collapsed_edsr_forward)."""
    jm, _ = _models(scale)
    sp = serialization.to_state_dict(jm.params)
    _, _, tail_fn = jct.live_collapsed_edsr_tail(sp, scale)
    radius = 1 + len([k for k in sp["upsample"] if k.startswith("conv")])
    kernel = jct.extract_collapsed_kernel(tail_fn, 8, scale, radius)
    kernel = pct.trim_zero_rings(kernel)
    canvas = 4 * radius + 2
    cc = canvas // 2
    zero = np.asarray(jct.make_cpu_probe(tail_fn)(np.zeros((1, canvas, canvas, 8), np.float32)))
    tile = zero[0, cc * scale:(cc + 1) * scale, cc * scale:(cc + 1) * scale]
    border = jct.extract_border_ops(tail_fn, 8, scale, kernel.shape[0] // 2, tile)
    return kernel, tile, border, float(np.abs(zero).max())


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_probes_match_jax(scale):
    """The probed kernel, bias tile and border operators against JAX's on the
    same weights: the same trimmed radius (2: 7x7 trims to 5x5 at x4), every
    operator within PROBE_STEPS f32 steps of the tail's response."""
    jm, pm = _models(scale)
    jk, jtile, jborder, magnitude = _jax_operators(scale)
    tail = pct.collapsed_edsr_tail(pm)
    assert tail.radius == jk.shape[0] // 2 == 2
    bar = PROBE_STEPS * float(np.spacing(np.float32(magnitude + np.abs(jk).max())))
    pairs = [("kernel", tail.kernel_np, jk), ("bias_tile", tail.bias_tile_np, jtile)]
    for key in ("k_top", "k_bot", "k_left", "k_right",
                "bias_top", "bias_bot", "bias_left", "bias_right"):
        pairs.append((key, tail.border_np[key], jborder[key]))
    for key in ("tl", "tr", "bl", "br"):
        pairs.append(("corner_k " + key, tail.border_np["corner_k"][key],
                      jborder["corner_k"][key]))
        pairs.append(("corner_b " + key, tail.border_np["corner_b"][key],
                      jborder["corner_b"][key]))
    for name, got, want in pairs:
        assert got.shape == want.shape, name
        err = float(np.abs(got - want).max())
        print("x%d probe %s: max|d| %.3g (bar %.3g, %.3g of its max)"
              % (scale, name, err, bar, err / max(float(np.abs(want).max()), 1e-30)))
        assert err <= bar, name


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_collapsed_forward_matches_jax(scale):
    jm, pm = _models(scale)
    jfwd = jax.jit(jct.make_collapsed_edsr_forward(jm))
    pfwd = pct.make_collapsed_edsr_forward(pm)
    jk, jtile, jborder, _ = _jax_operators(scale)
    border = pct.BorderOps(jborder, 8, "cpu", torch.float32)
    tail_fn = pct.edsr_tail_fn(pm.module)

    def jax_ops_tail(h):
        return pct.apply_collapsed_tail(h, torch.from_numpy(np.array(jk)),
                                        torch.from_numpy(np.array(jtile)), tail_fn, scale,
                                        border)

    for i, hw in enumerate(FRAMES):
        x = _lr((1,) + hw + (3,), seed=i)
        want = np.asarray(jfwd(jm.params, jnp.asarray(x)))
        xt = torch.from_numpy(x)
        got = pfwd(xt).numpy()
        with torch.no_grad():
            module = pm.module(xt).numpy()
            same_ops = pm.module(xt, tail=jax_ops_tail).numpy()
        assert got.shape == want.shape == (1, scale * hw[0], scale * hw[1], 3)
        errs = [float(np.abs(a - b).max()) for a, b in
                ((got, want), (got, module), (same_ops, want))]
        print("x%d %s: collapsed vs JAX's %.3g, vs the module %.3g; on JAX's operators vs "
              "JAX's %.3g" % (scale, hw, *errs))
        assert errs[0] <= COLLAPSED_ATOL and errs[1] <= COLLAPSED_ATOL
        assert errs[2] <= SAME_OPS_ATOL


def test_collapsed_forward_bf16_matches_jax():
    """--serving_dtype bf16 through the collapsed route against JAX's bf16
    collapsed forward (the kernel probed in f32, cast to bf16)."""
    jm, pm = _models(4)
    jfwd = jax.jit(jct.make_collapsed_edsr_forward(jm, dtype=jnp.bfloat16))
    x = _lr((1, 13, 17, 3), seed=3)
    want = np.asarray(jfwd(jm.params, jnp.asarray(x, jnp.bfloat16)).astype(jnp.float32))
    pm.set_serving_dtype("bf16")
    pm.set_route(pct.make_collapsed_edsr_forward(pm))
    try:
        got = pm.fwd_runtime(torch.from_numpy(x)).numpy()
    finally:
        pm.set_route(None)
        pm.set_serving_dtype("f32")
    err = float(np.abs(got - want).max())
    print("bf16 collapsed vs JAX: max|d| %.3g of max %.3g" % (err, np.abs(want).max()))
    assert err <= BF16_RTOL * float(np.abs(want).max())


def test_live_tail_matches_jax_and_the_probe():
    """live_collapsed_edsr_tail's kernel and bias tile (composed in the graph)
    against JAX's on the same weights, and against the port's probed kernel
    at JAX's own bar for the same comparison (tests/test_collapsed_tail.py:
    78-106)."""
    for scale in (2, 3, 4):
        jm, pm = _models(scale)
        jk, jtile, _ = jct.live_collapsed_edsr_tail(serialization.to_state_dict(jm.params),
                                                    scale)
        with torch.no_grad():
            kernel, tile, _ = pct.live_collapsed_edsr_tail(pm.module, scale)
        jk, jtile = np.asarray(jk), np.asarray(jtile)
        probed = pct.collapsed_edsr_tail(pm)
        err_k = float(np.abs(kernel.numpy() - jk).max())
        err_t = float(np.abs(tile.numpy() - jtile).max())
        err_p = float(np.abs(kernel.numpy() - probed.kernel_np).max())
        print("x%d live kernel vs JAX's %.3g (max %.3g), tile %.3g; vs the probe %.3g"
              % (scale, err_k, np.abs(jk).max(), err_t, err_p))
        assert kernel.shape == jk.shape == probed.kernel_np.shape
        assert err_k <= 1e-5 * float(np.abs(jk).max()) and err_t <= 1e-5 * 255
        assert err_p <= 1e-5


def _grads_by_port_name(jgrads, names):
    state = state_dict_from_jax_params(_to_numpy(jgrads), "edsr")
    return {k: state[k].numpy() for k in names}


def _train_batch(seed=5, hw=(8, 10)):
    x = _lr((2,) + hw + (3,), seed=seed)
    t = _lr((2, 4 * hw[0], 4 * hw[1], 3), seed=seed + 1)
    return x, t


@pytest.mark.parametrize("flags", [(), ("--lr_domain_loss", "0")])
def test_train_step_matches_jax_default_route(flags):
    """One EDSR step on JAX's default route (packed trunk, live collapsed
    tail, the loss before the shuffle) and with --lr_domain_loss 0, against
    JAX's: the loss within LOSS_RTOL, every gradient within GRAD_RTOL of its
    tensor's largest |g|."""
    jm, pm = _models(4, tuple(TINY) + flags, is_training=True)
    assert pm.train_tail_route() == ("collapsed" if flags else "lr_domain")
    x, t = _train_batch()
    jloss, jgrads = jax.jit(jax.value_and_grad(jm._compute_loss))(jm.params, jnp.asarray(x),
                                                       jnp.asarray(t))
    pm.optimizer.zero_grad(set_to_none=True)
    ploss = float(pm._loss_and_grads(torch.from_numpy(x), torch.from_numpy(t)))
    want = _grads_by_port_name(jgrads, [k for k, _ in pm.module.named_parameters()])
    worst = max((float(np.abs(p.grad.numpy() - want[k]).max() / np.abs(want[k]).max()), k)
                for k, p in pm.module.named_parameters())
    rel = abs(ploss - float(jloss)) / abs(float(jloss))
    print("train %s: loss rel %.3g, worst gradient %s %.3g" % (flags, rel, worst[1], worst[0]))
    assert rel <= LOSS_RTOL and worst[0] <= GRAD_RTOL, worst


def _port_step(flags, x, t):
    pm = get_model("edsr")
    pm.parse_args(TINY + list(flags))
    pm.prepare([4], device="cpu", is_training=True)
    loss = float(pm._loss_and_grads(torch.from_numpy(x), torch.from_numpy(t)))
    return pm, loss, {k: p.grad.clone() for k, p in pm.module.named_parameters()}


@pytest.mark.parametrize("flag", ["--qat", "--remat"])
def test_qat_and_remat_compose_with_the_collapsed_tail(flag):
    """--qat 1 and --remat 1 on the default (collapsed, LR-domain) route.
    --remat 1 recomputes the pairs' forwards: the loss and every gradient
    equal --remat 0's bit for bit. --qat 1 against --qat 1 on the plain tail
    (--collapsed_tail_train 0; its JAX parity is tests/test_torch_qat.py's):
    the trunk, and so every fake-quant code, is the same, the tail an exact
    reparametrisation: the loss within LOSS_RTOL, the gradients within
    GRAD_RTOL of each tensor's largest |g|."""
    x, t = _train_batch(seed=7, hw=(8, 10))
    pm, loss, grads = _port_step((flag, "1"), x, t)
    assert pm.train_tail_route() == "lr_domain"
    other = ("--remat", "0") if flag == "--remat" else ("--qat", "1", "--collapsed_tail_train", "0")
    _, loss0, grads0 = _port_step(other, x, t)
    worst = max((float((grads[k] - grads0[k]).abs().max() / grads0[k].abs().max()), k)
                for k in grads)
    rel = abs(loss - loss0) / abs(loss0)
    print("train %s 1 against %s: loss rel %.3g, worst gradient %s %.3g"
          % (flag, " ".join(other), rel, worst[1], worst[0]))
    if flag == "--remat":
        assert loss == loss0 and all(torch.equal(grads[k], grads0[k]) for k in grads)
    else:
        assert rel <= LOSS_RTOL and worst[0] <= GRAD_RTOL


def test_lr_domain_output_is_the_permuted_hr_output():
    """The live tail before the shuffle is the HR output's pixel_unshuffle bit
    for bit, and the model's LR-domain loss equals the HR one's to f32
    summation order."""
    _, pm = _models(4, tuple(TINY), is_training=True)
    x, t = _train_batch(seed=9)
    xt = torch.from_numpy(x)
    with torch.no_grad():
        hr = pm.module(xt, tail=pct.live_collapsed_tail_hook(pm.module, 4))
        lr = pm.module(xt, tail=pct.live_collapsed_tail_hook(pm.module, 4, lr_domain=True))
    assert torch.equal(pixel_shuffle(lr, 4), hr)
    assert torch.equal(pixel_unshuffle(hr, 4), lr)
    tt = torch.from_numpy(t)
    with torch.no_grad():
        l_hr = float(torch.mean(torch.abs(hr - tt)))
        l_lr = float(torch.mean(torch.abs(lr - pixel_unshuffle(tt, 4))))
    assert abs(l_hr - l_lr) <= 1e-6 * l_hr


def test_plain_train_tail_under_the_flags():
    """--collapsed_tail_train 0, an explicit --packed_trunk 0, or trained
    MeanShift affines train the plain tail, as in JAX."""
    for flags, route in ((("--collapsed_tail_train", "0"), None),
                         (("--packed_trunk", "0"), None),
                         (("--collapsed_tail_train", "1", "--lr_domain_loss", "0"), "collapsed")):
        pm = get_model("edsr")
        pm.parse_args(TINY + list(flags))
        pm.prepare([4], device="cpu", is_training=True)
        assert pm.train_tail_route() == route, flags
    with torch.no_grad():
        pm.module.mean_shift.weight.mul_(1.5)
    assert pm.train_tail_route() is None


def test_larvanet_lr_domain_step_matches_jax():
    """A LarvaNet multi-exit step with --lr_domain_loss 1 (every exit before
    the shuffle, the base unshuffled once) against JAX's, and each exit the
    HR exit unshuffled bit for bit."""
    jm, pm = _models(4, ("--num_blocks", "1,2"), True, "LarvaNet")
    assert jm._lr_domain_loss() and pm.lr_domain_loss()
    x, t = _train_batch(seed=11)
    jloss, jgrads = jax.jit(jax.value_and_grad(jm._compute_loss))(jm.params, jnp.asarray(x),
                                                       jnp.asarray(t))
    ploss = float(pm._loss_and_grads(torch.from_numpy(x), torch.from_numpy(t)))
    state = state_dict_from_jax_params(_to_numpy(jgrads), "LarvaNet")
    worst = max((float((p.grad - state[k]).abs().max() / state[k].abs().max()), k)
                for k, p in pm.module.named_parameters())
    rel = abs(ploss - float(jloss)) / abs(float(jloss))
    print("LarvaNet LR-domain step: loss rel %.3g, worst gradient %s %.3g" % (rel, *worst[::-1]))
    assert rel <= LOSS_RTOL and worst[0] <= GRAD_RTOL
    with torch.no_grad():
        xt = torch.from_numpy(x)
        exits = pm.module.walk(xt, "all")
        lr_exits = pm.module.walk(xt, "all", lr_domain=True)
    assert [e.shape[-1] for e in lr_exits] == [48, 48]
    for hr, lr in zip(exits, lr_exits):
        assert torch.equal(pixel_unshuffle(hr, 4), lr)
    assert np.array_equal(np.asarray(jax_unshuffle(jnp.asarray(t), 4)),
                          pixel_unshuffle(torch.from_numpy(t), 4).numpy())


# ---- the routes ----


def _kxk_calls():
    """A spy on the conv_kxk plain version (what a CPU call of conv_kxk runs)."""
    real = ck.conv_kxk_reference
    calls = []

    def spy(*a, **k):
        calls.append(a[1].shape)
        return real(*a, **k)

    return calls, mock.patch.object(ck, "conv_kxk_reference", spy)


def test_int8_and_wino_forwards_bake_the_tail():
    """The int8 and --wino_trunk EDSR forwards run the baked tail: the main
    5x5 conv, 4 side and 4 corner operators (9 conv_kxk calls) a forward,
    as JAX's make_int8_edsr_forward and make_wino_pallas_edsr_forward bake
    it; the module forward runs none."""
    from larvanet_tpu_torch.ops.int8_forward import make_int8_edsr_forward
    from larvanet_tpu_torch.ops.wino_resblock import make_wino_edsr_forward

    _, pm = _models(4)
    x = torch.from_numpy(_lr((1, 10, 12, 3), seed=4))
    calib = _lr((2, 10, 12, 3), seed=5)
    int8_fwd = make_int8_edsr_forward(pm, calib, torch.float32)
    for label, fwd, want in (("int8", int8_fwd, 9), ("wino", make_wino_edsr_forward(pm, 2), 9),
                             ("module", lambda z: pm.module(z), 0)):
        calls, spy = _kxk_calls()
        with spy, torch.no_grad():
            out = fwd(x)
        print("%s forward: conv_kxk calls %s" % (label, calls))
        assert len(calls) == want and out.shape == (1, 40, 48, 3)


def _write_cli_data(root):
    """A tiny EDSR x4 .pth and its data: a DIV2K-layout set, a directory of
    LR PNGs and a test-CLI tree."""
    _, pm = _models(4)
    pth = os.path.join(root, "m.pth")
    torch.save(pm.module.state_dict(), pth)
    rng = np.random.default_rng(0)
    for i in range(2):
        hr = rng.integers(0, 256, (3, 32, 40), dtype=np.uint8)
        lr = np.round(hr.reshape(3, 8, 4, 10, 4).mean((2, 4))).astype(np.uint8)
        io.save_image_chw(hr, os.path.join(root, "HR", "%04d.png" % i))
        io.save_image_chw(lr, os.path.join(root, "LR", "X4", "%04dx4.png" % i))
        io.save_image_chw(lr, os.path.join(root, "flat", "%04d.png" % i))
        io.save_image_chw(hr, os.path.join(root, "test_HR", "Set5", "img%d.png" % i))
        io.save_image_chw(lr, os.path.join(root, "test_LR", "Set5", "img%d.png" % i))
    return pth


@pytest.mark.parametrize("cli", ["validate", "get_sr", "test", "runtime", "serve"])
def test_collapsed_tail_flag_routes_the_inference_clis(cli, tmp_path):
    """--collapsed_tail 1 (the default) routes EDSR through the collapsed
    tail in each inference CLI; 0 keeps the module."""
    from larvanet_tpu_torch.cli import get_sr, runtime, serve, validate
    from larvanet_tpu_torch.cli import test as test_cli

    root = str(tmp_path)
    pth = _write_cli_data(root)
    base = ["--device", "cpu", "--model", "edsr", "--scales", "4"] + TINY
    argv = {
        "validate": base + ["--restore_path", pth, "--data_input_path",
                            os.path.join(root, "LR"), "--data_truth_path",
                            os.path.join(root, "HR")],
        "get_sr": base + ["--restore_path", pth, "--input_path", os.path.join(root, "flat"),
                          "--output_path", os.path.join(root, "sr")],
        "test": base + ["--restore_path", pth, "--input_root_path",
                        os.path.join(root, "test_LR"), "--truth_root_path",
                        os.path.join(root, "test_HR"), "--output_root_path",
                        os.path.join(root, "out"), "--datasets", "Set5"],
        "runtime": base + ["--input_height", "8", "--input_width", "10", "--num_warmup", "0",
                           "--num_iters", "1"],
        "serve": base + ["--restore_path", pth],
    }[cli]
    mains = {"validate": validate.main, "get_sr": get_sr.main, "test": test_cli.main,
             "runtime": runtime.main,
             "serve": lambda a: serve.build_service(*serve.build_parser().parse_known_args(a))}
    parser = {"validate": validate, "get_sr": get_sr, "test": test_cli, "runtime": runtime,
              "serve": serve}[cli]
    assert "collapsed_tail" not in parser.IGNORED
    assert parser.build_parser().parse_known_args(argv)[0].collapsed_tail == 1
    real = SRModel.set_route
    for flag in ("1", "0"):
        routes = []

        def recording(model, forward):
            routes.append(getattr(forward, "__qualname__", ""))
            return real(model, forward)

        with mock.patch.object(SRModel, "set_route", recording):
            mains[cli](argv + ["--collapsed_tail", flag])
        collapsed = [r for r in routes if r.startswith("make_collapsed_edsr_forward")]
        print("%s --collapsed_tail %s: routes %s" % (cli, flag, routes))
        assert len(collapsed) == (1 if flag == "1" else 0)


def test_meanshift_guard_keeps_the_module_graph(capsys):
    """Trained (non-identity) MeanShift affines, as a reference checkpoint
    carries: maybe_collapse_tail keeps the module graph with JAX's notice,
    and no baked tail is made."""
    pm = get_model("edsr")
    pm.parse_args(list(TINY))
    pm.prepare([4], device="cpu")
    state = dict(pm.module.state_dict())
    state["mean_inverse_shift.weight"] = 1.01 * state["mean_inverse_shift.weight"]
    pm.load_state_dict(state)
    common.maybe_collapse_tail(pm, argparse.Namespace(collapsed_tail=1, model="edsr"))
    assert pm.route is None and pct.collapsed_edsr_tail(pm) is None
    assert "MeanShift" in capsys.readouterr().out
    with pytest.raises(ValueError, match="MeanShift"):
        pct.make_collapsed_edsr_forward(pm)
    state["mean_inverse_shift.weight"] = torch.eye(3).reshape(3, 3, 1, 1)
    pm.load_state_dict(state)
    common.maybe_collapse_tail(pm, argparse.Namespace(collapsed_tail=1, model="edsr"))
    assert pm.route is not None


# ---- the interpolated base (unwired, as in JAX) ----


@pytest.mark.parametrize("mode,scale", [("bicubic", 4), ("bilinear", 4), ("bicubic", 3),
                                        ("bicubic", 2), ("nearest", 4), ("nearest", 2)])
def test_collapsed_base_matches_jax(mode, scale):
    """make_collapsed_base against JAX's at the cases of JAX's
    test_collapsed_base_exact, and against the resampler itself at its bar
    (2e-3 on the 0-255 scale)."""
    from larvanet_tpu_torch.models.layers import interpolated_base

    jbase = jax.jit(jct.make_collapsed_base(scale, mode))
    base = pct.make_collapsed_base(scale, mode)
    for i, hw in enumerate([(11, 13), (3, 3)]):  # odd sides; too small for an interior
        x = _lr((2,) + hw + (3,), seed=20 + i)
        want = np.asarray(jbase(jnp.asarray(x)))
        got = base(torch.from_numpy(x))
        resampled = interpolated_base(torch.from_numpy(x), scale, mode)
        err = float(np.abs(got.numpy() - want).max())
        err_r = float((pixel_shuffle(got, scale) - resampled).abs().max())
        print("base %s x%d %s: vs JAX's %.3g, vs the resampler %.3g" % (mode, scale, hw, err,
                                                                      err_r))
        assert got.shape == want.shape and err <= 2e-3 and err_r <= 2e-3


def test_bicubic_phase_conv_kernel_is_jax_s():
    for scale in (2, 3, 4):
        np.testing.assert_array_equal(pct.bicubic_phase_conv_kernel(scale),
                                      jct.bicubic_phase_conv_kernel(scale))


def test_collapsed_larvanet_forward_matches_jax():
    """make_collapsed_larvanet_forward on a --num_blocks 2,3 LarvaNet against
    JAX's (atol 0.05, JAX's own bar against its module), and the refusal of
    other configurations."""
    jm, pm = _models(4, ("--num_blocks", "2,3"), False, "LarvaNet")
    jfwd = jax.jit(jct.make_collapsed_larvanet_forward(jm))
    fwd = pct.make_collapsed_larvanet_forward(pm)
    for i, hw in enumerate([(13, 17), (4, 6)]):
        x = _lr((1,) + hw + (3,), seed=30 + i)
        want = np.asarray(jfwd(jm.params, jnp.asarray(x)))
        got = fwd(torch.from_numpy(x)).numpy()
        with torch.no_grad():
            module = pm.module(torch.from_numpy(x)).numpy()
        errs = float(np.abs(got - want).max()), float(np.abs(got - module).max())
        print("collapsed LarvaNet %s: vs JAX's %.3g, vs the module %.3g" % (hw, *errs))
        assert got.shape == want.shape and max(errs) <= 0.05
    v2 = get_model("LarvaNetV2")
    v2.parse_args(["--num_blocks", "1,1"])
    v2.prepare([4], device="cpu")
    with pytest.raises(ValueError, match="flagship"):
        pct.make_collapsed_larvanet_forward(v2)
