"""EDSR training in the port (models/base.py's training half, models/edsr.py,
data/{dataset,loaders}.py's patches, cli/train.py) against the JAX
package's, on the CPU, at a tiny width.

The port trains the plain module graph, as the JAX package does with
--packed_trunk 0: one step's loss and gradients, and the parameters after
three Adam steps, must agree with `SRModel._train_step_impl` from the same
parameters and batches. The JAX parameters cross into the port with
`state_dict_from_jax_params`; the batches are made with numpy from a seed.
Each comparison is its own case.
"""

import functools
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvanet_tpu.core.registry import get_loader as jax_get_loader
from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.models.base import StepDecayMixin as JaxStepDecayMixin
from larvanet_tpu.models.base import find_ema
from larvanet_tpu.train import losses as jax_losses
from larvanet_tpu_torch.cli import train
from larvanet_tpu_torch.core.registry import get_loader, get_model
from larvanet_tpu_torch.data import io
from larvanet_tpu_torch.models.base import StepDecayMixin
from larvanet_tpu_torch.train import losses
from larvanet_tpu_torch.utils.checkpoints import find_latest, resolve_restore_path
from larvanet_tpu_torch.utils.torch_convert import state_dict_from_jax_params

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

TINY = ["--edsr_conv_features", "16", "--edsr_res_blocks", "2"]
BATCH, PATCH, SCALE = 2, 12, 4
# the loss: f32 sums of the same values in another order
LOSS_RTOL = 1e-6
# a gradient: f32 sums in another order through 7 convs, relative to its
# tensor's largest |g| (an L1 gradient's sign may flip where |o - t| lies
# within rounding, so element-wise relative bars would not hold). 2e-5, not
# 1e-5: upsample.body.2's bias gradient, a sum of 1,152 pixels' gradients
# that cancel to a small value, comes out of XLA 1.09e-5 of its largest
# value away from the float64 gradient, while every port gradient lies
# within 6.6e-7 of it (`test_grads_match_float64_module_graph` prints both
# and holds the port to 1e-6)
GRAD_RTOL = 2e-5
# the port's gradients against the same graph in float64
F64_RTOL = 1e-6
# parameters after 3 Adam steps of lr 1e-4 (ROADMAP's bar)
PARAM_ATOL = 1e-5
# against JAX's default route (packed trunk, collapsed tail, pre-shuffle
# loss): the same per-element gradients through another graph
DEFAULT_ROUTE_RTOL = 1e-4
# name -> (model, --grad_accum, --ema_decay, optimizer)
VARIANTS = {
    "adam": ("edsr", 1, 0.0, "adam"),
    "grad_accum_2": ("edsr", 2, 0.0, "adam"),
    "ema_0.9": ("edsr", 1, 0.9, "adam"),
    "adamw": ("edsr", 1, 0.0, "adamw"),
    "edsr_loss": ("edsr_loss", 1, 0.0, "adam"),
}


def _to_numpy(tree):
    if hasattr(tree, "items"):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _batch(seed):
    """A CHW host batch: LR patches and HR truths (smooth plus noise)."""
    rng = np.random.default_rng(seed)
    lr = rng.uniform(0, 255, (BATCH, 3, PATCH, PATCH)).astype(np.float32)
    hr = np.repeat(np.repeat(lr, SCALE, 2), SCALE, 3)
    hr = np.clip(hr + rng.normal(0, 8, hr.shape), 0, 255).astype(np.float32)
    return list(lr), list(hr)


def _nhwc(frames):
    return np.ascontiguousarray(np.stack(frames).transpose(0, 2, 3, 1))


def _port_params(pm):
    return {k: v.detach().numpy() for k, v in pm.module.named_parameters()}


def _as_port(jax_tree, names):
    state = state_dict_from_jax_params(_to_numpy(jax_tree), "edsr")
    return {k: state[k].numpy() for k in names}


def _models(name, accum, ema, kind, flags=("--packed_trunk", "0")):
    jm = jax_get_model(name)
    jm.parse_args(TINY + list(flags))
    jm.ema_decay, jm.optimizer_kind, jm.grad_accum = ema, kind, accum
    jm.prepare(is_training=True, scales=[SCALE])
    pm = get_model(name)
    pm.parse_args(TINY)
    pm.ema_decay, pm.optimizer_kind, pm.grad_accum = ema, kind, accum
    pm.prepare([SCALE], device="cpu", is_training=True)
    pm.load_state_dict(state_dict_from_jax_params(_to_numpy(jm.params), "edsr"))
    if pm.ema is not None:  # JAX's average starts at its init weights: so does the port's
        pm.ema.load([p.detach().clone() for p in pm.module.parameters()])
    return jm, pm


@functools.lru_cache(maxsize=None)
def _run(variant):
    """{quantity: (port, jax)} for one variant: the first step's loss and
    gradients, the parameters after 3 steps, and the average if any."""
    name, accum, ema, kind = VARIANTS[variant]
    jm, pm = _models(name, accum, ema, kind)
    names = list(_port_params(pm))
    lr, hr = _batch(0)
    x, t = jnp.asarray(_nhwc(lr)), jnp.asarray(_nhwc(hr))
    if accum > 1:
        jloss, jgrads = jm._accumulated_grads(jm.params, x, t, accum)
    else:
        jloss, jgrads = jax.value_and_grad(jm._compute_loss)(jm.params, x, t)
    ploss = pm._loss_and_grads(torch.from_numpy(_nhwc(lr)), torch.from_numpy(_nhwc(hr)))
    out = {"loss": (float(ploss), float(jloss)),
           "grads": ({k: p.grad.numpy().copy() for k, p in pm.module.named_parameters()},
                     _as_port(jgrads, names))}
    pm.optimizer.zero_grad(set_to_none=True)
    for step in range(3):
        lr, hr = _batch(step)
        pm.train_step(lr, SCALE, hr)
        jm.train_step(lr, SCALE, hr)
    out["params"] = (_port_params(pm), _as_port(jm.params, names))
    if ema:
        out["ema"] = ({k: a.numpy() for k, a in zip(names, pm.ema.average)},
                      _as_port(find_ema(jm.opt_state), names))
    return out


CASES = [(v, q) for v in VARIANTS for q in ("loss", "grads", "params")] + [("ema_0.9", "ema")]


@pytest.mark.parametrize("variant,quantity", CASES)
def test_train_step_matches_jax(variant, quantity):
    got, want = _run(variant)[quantity]
    if quantity == "loss":
        err = abs(got - want) / abs(want)
        print("train %s loss: port %.8g jax %.8g, rel %.3g" % (variant, got, want, err))
        assert err <= LOSS_RTOL
        return
    assert set(got) == set(want)
    worst = (-1.0, "")
    for k in got:
        assert got[k].shape == want[k].shape, k
        if quantity == "grads":
            err = float(np.abs(got[k] - want[k]).max() / np.abs(want[k]).max())
            bar = GRAD_RTOL
        else:
            err, bar = float(np.abs(got[k] - want[k]).max()), PARAM_ATOL
        worst = max(worst, (err, k))
    print("train %s %s: worst %s %.3g (bar %g)" % (variant, quantity, worst[1], worst[0], bar))
    assert worst[0] <= bar


def test_grads_match_jax_default_route():
    """JAX's default training graph (--packed_trunk 1 --collapsed_tail_train
    1 --lr_domain_loss 1) is an exact reparametrisation of the module graph
    the port trains: the same gradients, to float tolerance."""
    jm, pm = _models("edsr", 1, 0.0, "adam", flags=())
    assert jm.args.packed_trunk and jm.args.collapsed_tail_train and jm.args.lr_domain_loss
    lr, hr = _batch(5)
    _, jgrads = jax.value_and_grad(jm._compute_loss)(jm.params, jnp.asarray(_nhwc(lr)),
                                                     jnp.asarray(_nhwc(hr)))
    pm._loss_and_grads(torch.from_numpy(_nhwc(lr)), torch.from_numpy(_nhwc(hr)))
    want = _as_port(jgrads, list(_port_params(pm)))
    for k, p in pm.module.named_parameters():
        err = float(np.abs(p.grad.numpy() - want[k]).max() / np.abs(want[k]).max())
        assert err <= DEFAULT_ROUTE_RTOL, (k, err)


def _f64_grads(pm, x, t):
    """The L1 loss's gradients of `pm`'s EDSR in float64 (torch's conv2d),
    by parameter name."""
    import torch.nn.functional as F

    sd = {k: v.double().clone().requires_grad_() for k, v in pm.module.state_dict().items()}

    def conv(h, name, relu=False):
        y = F.conv2d(h, sd[name + ".weight"], sd[name + ".bias"], padding=1)
        return torch.relu(y) if relu else y

    def shift(h, name):
        return (torch.einsum("nchw,dc->ndhw", h, sd[name + ".weight"].reshape(3, 3))
                + sd[name + ".bias"].view(1, 3, 1, 1))

    h = conv(shift(torch.from_numpy(x).double().permute(0, 3, 1, 2), "mean_shift"),
             "first_conv")
    res = h
    for i in range(len(pm.module.res_blocks)):
        res = res + conv(conv(res, "res_blocks.%d.body.0" % i, True),
                         "res_blocks.%d.body.2" % i)
    h = h + conv(res, "after_res_conv")
    for i in (0, 2):
        h = F.pixel_shuffle(conv(h, "upsample.body.%d" % i), 2)
    h = shift(conv(h, "final_conv"), "mean_inverse_shift")
    (h - torch.from_numpy(t).double().permute(0, 3, 1, 2)).abs().mean().backward()
    return {k: sd[k].grad.numpy() for k, _ in pm.module.named_parameters()}


def test_grads_match_float64_module_graph():
    """The port's f32 gradients (the Function's backward formulas) against
    the same graph's in float64; JAX's distance from it is printed beside
    (-s), the reason GRAD_RTOL is 2e-5."""
    jm, pm = _models("edsr", 1, 0.0, "adam")
    lr, hr = _batch(0)
    x, t = _nhwc(lr), _nhwc(hr)
    pm._loss_and_grads(torch.from_numpy(x), torch.from_numpy(t))
    _, jgrads = jax.value_and_grad(jm._compute_loss)(jm.params, jnp.asarray(x), jnp.asarray(t))
    jax_grads = _as_port(jgrads, list(_port_params(pm)))
    worst = {"port": (-1.0, ""), "jax": (-1.0, "")}
    for k, want in _f64_grads(pm, x, t).items():
        scale = np.abs(want).max()
        got = dict(pm.module.named_parameters())[k].grad.numpy()
        for side, value in (("port", got), ("jax", jax_grads[k])):
            worst[side] = max(worst[side], (float(np.abs(value - want).max() / scale), k))
    print("gradients against float64, worst: port %s %.3g, JAX %s %.3g"
          % (worst["port"][1], worst["port"][0], worst["jax"][1], worst["jax"][0]))
    assert worst["port"][0] <= F64_RTOL


@pytest.mark.parametrize("name", ["l1_loss", "robust_sqrt_loss", "multi_exit_l1"])
def test_losses_match_jax(name):
    rng = np.random.default_rng(len(name))
    outs = [rng.uniform(0, 255, (2, 8, 9, 3)).astype(np.float32) for _ in range(3)]
    t = rng.uniform(0, 255, (2, 8, 9, 3)).astype(np.float32)
    args = ((outs,) if name == "multi_exit_l1" else (outs[0],))
    want = float(getattr(jax_losses, name)(*[[jnp.asarray(o) for o in a] if isinstance(a, list)
                                              else jnp.asarray(a) for a in args],
                                            jnp.asarray(t)))
    got = float(getattr(losses, name)(*[[torch.from_numpy(o) for o in a] if isinstance(a, list)
                                        else torch.from_numpy(a) for a in args],
                                      torch.from_numpy(t)))
    assert abs(got - want) <= LOSS_RTOL * abs(want)


@pytest.mark.parametrize("step", [0, 199999, 200000, 450000])
def test_learning_rate_schedules_match_jax(step):
    """EDSR's step decay (1e-4 halved every 200k steps) and the shared
    StepDecayMixin, at the same global steps as JAX's."""
    jm, pm = jax_get_model("edsr"), get_model("edsr")
    jm.parse_args(TINY)
    pm.parse_args(TINY)
    jm.global_step = pm.global_step = step
    assert pm.get_learning_rate() == jm.get_learning_rate()

    class Args:
        lr, lr_decay, lr_step = 5e-4, 0.1, 100000

    mixins = [type("M", (cls,), {"args": Args, "global_step": step})()
              for cls in (StepDecayMixin, JaxStepDecayMixin)]
    assert mixins[0].get_learning_rate() == mixins[1].get_learning_rate()


def test_grad_accum_refuses_a_batch_that_does_not_divide():
    pm = get_model("edsr")
    pm.parse_args(TINY)
    pm.grad_accum = 3
    pm.prepare([SCALE], device="cpu", is_training=True)
    lr, hr = _batch(0)
    with pytest.raises(ValueError, match="not divisible by --grad_accum 3"):
        pm.train_step(lr, SCALE, hr)


def test_set_serving_dtype_keeps_the_f32_weights():
    """bf16 serving runs a cast copy: switching back to f32 gives the output
    of a model that was never cast, bit for bit."""
    def model():
        m = get_model("edsr")
        m.parse_args(TINY)
        m.prepare([SCALE], device="cpu", seed=4)
        return m

    x = torch.from_numpy(np.random.default_rng(1).uniform(0, 255, (1, 9, 7, 3))
                         .astype(np.float32))
    never = model().fwd_runtime(x)
    m = model()
    m.set_serving_dtype("bf16")
    half = m.fwd_runtime(x)
    m.set_serving_dtype("f32")
    assert m.module.first_conv.weight.dtype == torch.float32
    assert torch.equal(m.fwd_runtime(x), never)
    assert not torch.equal(half, never)


# ---- data ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def div2k_train_root(tmp_path_factory):
    """A DIV2K-layout train set written by the port's PNG encoder."""
    root = str(tmp_path_factory.mktemp("div2k_train"))
    rng = np.random.default_rng(11)
    for i in range(3):
        hr = rng.integers(0, 256, (3, 64, 80), dtype=np.uint8)
        lr = np.round(hr.reshape(3, 16, 4, 20, 4).mean((2, 4))).astype(np.uint8)
        io.save_image_chw(hr, os.path.join(root, "HR", "%04d.png" % i))
        io.save_image_chw(lr, os.path.join(root, "LR", "X4", "%04dx4.png" % i))
    return root


def test_train_loader_draws_jax_numpy_stream(div2k_train_root):
    """--data_seed 7: the port's patches equal the JAX loader's with
    --data_native 0, bit for bit, over 5 re-seeded steps."""
    flags = ["--data_input_path", os.path.join(div2k_train_root, "LR"),
             "--data_truth_path", os.path.join(div2k_train_root, "HR"), "--data_seed", "7"]
    port = get_loader("div2k_train_loader")
    port.parse_args(flags)
    port.prepare([4])
    jl = jax_get_loader("div2k_train_loader")
    jl.parse_args(flags + ["--data_native", "0"])
    jl.prepare([4])
    for step in range(5):
        port.reseed_for_step(step)
        jl.reseed_for_step(step)
        got = port.get_patch_batch(3, 4, 8)
        want = jl.get_patch_batch(3, 4, 8)
        for g_list, w_list in zip(got, want):
            for g, w in zip(g_list, w_list):
                assert g.dtype == w.dtype == np.float32 and g.tobytes() == w.tobytes()
    # the NHWC batch takes the same draws
    port.reseed_for_step(4)
    ins, truths = port.dataset.patch_batch_nhwc(3, 4, 8)
    assert ins.shape == (3, 8, 8, 3) and truths.shape == (3, 32, 32, 3)
    np.testing.assert_array_equal(ins, np.stack(got[0]).transpose(0, 2, 3, 1))
    np.testing.assert_array_equal(truths, np.stack(got[1]).transpose(0, 2, 3, 1))


def test_saved_pth_restores_in_the_jax_package(tmp_path):
    pm = get_model("edsr")
    pm.parse_args(TINY)
    pm.prepare([SCALE], device="cpu", is_training=True)
    lr, hr = _batch(0)
    pm.train_step(lr, SCALE, hr)
    path = pm.save(str(tmp_path))
    assert os.path.basename(path) == "model_1.pth"
    jm = jax_get_model("edsr")
    jm.parse_args(TINY)
    jm.prepare(is_training=False, scales=[SCALE])
    jm.restore(path)
    got = _as_port(jm.params, list(_port_params(pm)))
    for k, v in _port_params(pm).items():
        np.testing.assert_array_equal(got[k], v)


# the average after one step from a known start: f32 d e + (1 - d) p against
# the same formula in float64
EMA_ATOL = 1e-6


@functools.lru_cache(maxsize=None)
def _pth_only_restore(tmp_dir):
    """Both sides train with --ema_decay 0.9 from their own init, restore a
    `.pth` alone (saved by an untrained port model of another seed), and
    take one step. {side: (init, after restore, restored, after the step,
    params after the step)}, each {name: array} in the port's names."""
    src = get_model("edsr")
    src.parse_args(TINY)
    src.prepare([SCALE], device="cpu", seed=7)
    path = src.save(tmp_dir)
    assert os.path.basename(path) == "model_0.pth"
    assert not os.path.exists(os.path.splitext(path)[0] + ".state.pt")
    restored = _port_params(src)
    names = list(restored)
    lr, hr = _batch(4)

    jm = jax_get_model("edsr")
    jm.parse_args(TINY + ["--packed_trunk", "0"])
    jm.ema_decay = 0.9
    jm.prepare(is_training=True, scales=[SCALE])
    j_init = _as_port(jm.params, names)
    jm.restore(path)
    j_after = _as_port(find_ema(jm.opt_state), names)
    j_restored = _as_port(jm.params, names)
    jm.train_step(lr, SCALE, hr)
    out = {"jax": (j_init, j_after, j_restored, _as_port(find_ema(jm.opt_state), names),
                   _as_port(jm.params, names))}

    pm = get_model("edsr")
    pm.parse_args(TINY)
    pm.ema_decay = 0.9
    pm.prepare([SCALE], device="cpu", is_training=True)
    p_init = {k: v.copy() for k, v in _port_params(pm).items()}
    pm.restore(path)

    def average():
        return {k: a.numpy().copy() for k, a in zip(names, pm.ema.average)}

    p_after, p_restored = average(), {k: v.copy() for k, v in _port_params(pm).items()}
    pm.train_step(lr, SCALE, hr)
    out["port"] = (p_init, p_after, p_restored, average(), _port_params(pm))
    return out


@pytest.mark.parametrize("check", ["jax_keeps_init", "port_keeps_init", "one_step"])
def test_pth_only_restore_leaves_the_average_at_the_init(tmp_path_factory, check):
    """A training restore of a `.pth` alone replaces the weights and leaves
    the average where `prepare` made it: JAX's `_restore_pth` does, and the
    port follows (ROADMAP fault 3). One step later each side's average is
    0.9 init + 0.1 the new weights."""
    runs = _pth_only_restore(str(tmp_path_factory.getbasetemp() / "pth_only"))
    if check == "one_step":
        for side, (init, _, _, stepped, params) in runs.items():
            for k in init:
                want = 0.9 * init[k].astype(np.float64) + 0.1 * params[k].astype(np.float64)
                err = float(np.abs(stepped[k] - want).max())
                assert err <= EMA_ATOL, (side, k, err)
        return
    init, after, restored, _, _ = runs["jax" if check == "jax_keeps_init" else "port"]
    for k in init:
        np.testing.assert_array_equal(after[k], init[k], err_msg=k)
        assert np.abs(restored[k] - init[k]).max() > 0, k  # the restore changed the weights


# ---- the CLI --------------------------------------------------------------------


def _cli(root, train_path, *extra):
    return train.main([
        "--dataloader", "div2k_train_loader", "--model", "edsr", "--scales", "4",
        "--device", "cpu", "--train_path", train_path,
        "--data_input_path", os.path.join(root, "LR"),
        "--data_truth_path", os.path.join(root, "HR"), "--data_cached", "--data_seed", "3",
        "--batch_size", "2", "--input_patch_size", "8", "--edsr_conv_features", "8",
        "--edsr_res_blocks", "1", "--edsr_learning_rate", "1e-3", "--ema_decay", "0.9",
        "--log_freq", "1", "--save_freq", "3", "--summary_freq", "3", *extra])


@pytest.fixture(scope="module")
def straight_and_resumed(div2k_train_root, tmp_path_factory):
    straight = _cli(div2k_train_root, str(tmp_path_factory.mktemp("straight")),
                    "--max_steps", "6")
    path = str(tmp_path_factory.mktemp("resumed"))
    first = _cli(div2k_train_root, path, "--max_steps", "3")
    resumed = _cli(div2k_train_root, path, "--max_steps", "6", "--restore_path", "latest")
    return straight, first, resumed, path


@pytest.mark.parametrize("part", ["losses", "params", "ema", "adam"])
def test_cli_resume_repeats_a_straight_run(straight_and_resumed, part):
    """3 steps, then --restore_path latest to 6: the same losses, weights,
    average and Adam state as 6 straight steps, bit for bit."""
    (sm, slosses), (_, flosses), (rm, rlosses), _ = straight_and_resumed
    if part == "losses":
        assert sorted(flosses) == [1, 2, 3] and sorted(rlosses) == [4, 5, 6]
        assert {**flosses, **rlosses} == slosses
        assert slosses[6] < slosses[1]
    elif part == "params":
        for (k, a), (_, b) in zip(sm.module.named_parameters(), rm.module.named_parameters()):
            assert torch.equal(a, b), k
    elif part == "ema":
        assert all(torch.equal(a, b) for a, b in zip(sm.ema.average, rm.ema.average))
    else:
        sa, ra = sm.optimizer.state_dict()["state"], rm.optimizer.state_dict()["state"]
        assert sa.keys() == ra.keys()
        for i in sa:
            assert all(torch.equal(sa[i][k], ra[i][k]) for k in sa[i])


def test_cli_writes_checkpoints_arguments_and_scalars(straight_and_resumed):
    *_, path = straight_and_resumed
    names = sorted(os.listdir(path))
    for step in (3, 6):
        assert "model_%d.pth" % step in names and "model_%d.state.pt" % step in names
    with open(os.path.join(path, "arguments.json")) as f:
        args = json.load(f)
    assert args["model"] == "edsr" and args["data_seed"] == 3 and args["edsr_res_blocks"] == 1
    # a summary every 3rd step of each run: steps 3 and 6, loss and lr
    (_, slosses), *_ = straight_and_resumed
    with open(os.path.join(path, "x4", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [(r["tag"], r["step"]) for r in rows] == [
        ("loss", 3), ("lr", 3), ("loss", 6), ("lr", 6)]
    assert [r["value"] for r in rows if r["tag"] == "loss"] == [slosses[3], slosses[6]]
    assert all(r["value"] == 1e-3 for r in rows if r["tag"] == "lr")


def test_restore_path_latest_finds_the_highest_step(tmp_path):
    for name in ("model_2.pth", "model_10.pth", "model_9.state.pt", "notes.txt"):
        (tmp_path / name).write_bytes(b"")
    assert find_latest(str(tmp_path)) == str(tmp_path / "model_10.pth")
    assert resolve_restore_path("latest", str(tmp_path)) == str(tmp_path / "model_10.pth")
    (tmp_path / "empty").mkdir()
    assert resolve_restore_path("latest", str(tmp_path / "empty")) is None  # starts fresh
    assert resolve_restore_path("m.pth", str(tmp_path)) == "m.pth"


@pytest.mark.parametrize("flags", [["--orbax_checkpoint", "1"], ["--dp_devices", "2"]])
def test_cli_refuses_what_is_not_ported(div2k_train_root, straight_and_resumed, tmp_path,
                                        flags):
    """The parallel package's train flags, refused until the port had it,
    now train. --orbax_checkpoint 1: directory checkpoints, from which a
    resume repeats the straight run bit for bit. --dp_devices 2 (a mesh that
    repeats the CPU): the straight run's losses and weights to f32
    tolerance, and JAX's refusals of --device_pipeline and of a batch the
    mesh does not divide."""
    (sm, slosses), (fm, flosses), *_ = straight_and_resumed
    path = str(tmp_path / "run")
    if flags[0] == "--orbax_checkpoint":
        _cli(div2k_train_root, path, "--max_steps", "3", *flags)
        assert os.path.isdir(os.path.join(path, "model_3.pth"))
        resumed, rlosses = _cli(div2k_train_root, path, "--max_steps", "6", *flags,
                                "--restore_path", "latest")
        assert rlosses == {k: v for k, v in slosses.items() if k > 3}
        for a, b in zip(sm.module.parameters(), resumed.module.parameters()):
            assert torch.equal(a, b)
        assert all(torch.equal(a, b) for a, b in zip(sm.ema.average, resumed.ema.average))
        return
    model, losses = _cli(div2k_train_root, path, "--max_steps", "3", *flags)
    assert model.data_parallel is not None and len(model.data_parallel.devices) == 2
    assert sorted(losses) == [1, 2, 3]
    for step, loss in flosses.items():
        assert abs(losses[step] - loss) <= 1e-5 * abs(loss)
    for a, b in zip(fm.module.parameters(), model.module.parameters()):
        assert float((a - b).abs().max()) <= PARAM_ATOL
    with pytest.raises(SystemExit, match="--device_pipeline"):
        _cli(div2k_train_root, path, "--max_steps", "1", *flags, "--device_pipeline", "2")
    with pytest.raises(SystemExit, match="must be divisible by --dp_devices"):
        _cli(div2k_train_root, path, "--max_steps", "1", "--dp_devices", "4")


def test_cli_trains_with_qat(div2k_train_root, tmp_path):
    """--qat 1 is accepted and trains through the fake-quant pairs: its
    first loss differs from the exact run's on the same batch and weights,
    and a resume repeats the straight run bit for bit; --qat 1 with an
    explicit --packed_trunk 0 is refused, as in JAX."""
    exact, exact_losses = _cli(div2k_train_root, str(tmp_path / "exact"), "--max_steps", "1")
    straight, losses = _cli(div2k_train_root, str(tmp_path / "qat"), "--max_steps", "4",
                            "--qat", "1")
    assert straight.args.qat == 1 and losses[1] != exact_losses[1]
    path = str(tmp_path / "resumed")
    _cli(div2k_train_root, path, "--max_steps", "3", "--qat", "1")
    resumed, resumed_losses = _cli(div2k_train_root, path, "--max_steps", "4", "--qat", "1",
                                   "--restore_path", "latest")
    assert resumed_losses[4] == losses[4]
    for a, b in zip(straight.module.parameters(), resumed.module.parameters()):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="requires --packed_trunk 1"):
        _cli(div2k_train_root, str(tmp_path / "p0"), "--max_steps", "1", "--qat", "1",
             "--packed_trunk", "0")


@pytest.mark.parametrize("name,flags", [("LarvaNet", []), ("LarvaNetV2", []),
                                        ("LarvaLeg", ["--leg", "1"])])
def test_cli_trains_a_larvanet_preset(div2k_train_root, tmp_path, name, flags):
    """The step-driven CLI trains the LarvaNet family as JAX's does: from
    the same weights (a .pth of the JAX init) and the same --data_seed
    batch, its first step's multi-exit loss is the loss of JAX's train
    step, `_compute_loss`, evaluated op by op. The jitted `train_step`
    returns it summed in XLA's fused order, which on this batch lies
    1.3e-6 from the float64 loss (the port's: 1.7e-8), so it is printed
    beside it and not held at LOSS_RTOL."""
    model_flags = ["--num_blocks", "1,1", *flags]
    jm = jax_get_model(name)
    jm.parse_args(model_flags + ["--packed_trunk", "0"])
    jm.prepare(is_training=True, scales=[SCALE])
    pth = str(tmp_path / "init.pth")
    torch.save(state_dict_from_jax_params(_to_numpy(jm.params), name), pth)
    data = ["--data_input_path", os.path.join(div2k_train_root, "LR"),
            "--data_truth_path", os.path.join(div2k_train_root, "HR"), "--data_seed", "3"]
    _, losses = train.main(["--dataloader", "div2k_train_loader", "--model", name,
                            "--scales", "4", "--device", "cpu",
                            "--train_path", str(tmp_path / "run"), "--batch_size", "2",
                            "--input_patch_size", "8", "--max_steps", "1",
                            "--restore_path", pth, *data, *model_flags])
    jl = jax_get_loader("div2k_train_loader")
    jl.parse_args(data + ["--data_native", "0"])
    jl.prepare([4])
    jl.reseed_for_step(0)
    lr, hr = jl.get_patch_batch(2, 4, 8)
    want = float(jm._compute_loss(jm.params, jnp.asarray(_nhwc(lr)), jnp.asarray(_nhwc(hr))))
    jitted = jm.train_step(lr, SCALE, hr)
    print("train CLI %s step 1: loss %.8g, JAX %.8g (its jitted train_step %.8g)"
          % (name, losses[1], want, jitted))
    assert sorted(losses) == [1]
    assert abs(losses[1] - want) <= LOSS_RTOL * abs(want)


def test_cli_runs_on_the_card_unless_told_otherwise(div2k_train_root, tmp_path):
    """Without --device cpu and without a card it exits; it never falls back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(SystemExit, match="no CUDA device"):
        train.main(["--train_path", str(tmp_path),
                    "--data_input_path", os.path.join(div2k_train_root, "LR"),
                    "--data_truth_path", os.path.join(div2k_train_root, "HR")])
