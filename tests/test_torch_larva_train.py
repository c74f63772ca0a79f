"""LarvaNet-family training in the port (models/larvanet.py's training half,
train/schedules.py, the queue loaders of data/loaders.py, cli/train_larva.py
and cli/train_larvaV2.py) against the JAX package's, on the CPU, at tiny
sizes: --num_blocks 1,1 (two modules), batches of 2 LR patches of 8x8,
LarvaNet_w64 at --num_features 16.

JAX is held at --packed_trunk 0, the module graph the port trains, unless
a test says otherwise: its default packed trunk with the pre-shuffle loss
is an exact reparametrisation, equal only up to f32 summation order. The
JAX parameters cross into the port with `state_dict_from_jax_params`; the
batches are made with numpy from a seed. With the family's 0.1 init the
legs' gradients into the trunk are small against the base's, so each
gradient is held relative to its tensor's largest |g|.
"""

import functools
import json
import os
import threading
from types import SimpleNamespace
from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvanet_tpu.core import registry as jax_registry
from larvanet_tpu.core.registry import get_loader as jax_get_loader
from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.train.schedules import ReduceLROnPlateau as JaxPlateau
from larvanet_tpu.train.schedules import StepLR as JaxStepLR
from larvanet_tpu_torch.cli import train_larva, train_larvaV2
from larvanet_tpu_torch.core.registry import get_loader, get_model
from larvanet_tpu_torch.data import io
from larvanet_tpu_torch.models.base import state_path
from larvanet_tpu_torch.train.schedules import ReduceLROnPlateau, StepLR
from larvanet_tpu_torch.utils.torch_convert import state_dict_from_jax_params

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

BLOCKS = ["--num_blocks", "1,1"]
# the presets whose step is held, with their flags at the test size
PRESETS = {"LarvaNet": [], "LarvaNet_res": [], "LarvaNet_skip": [], "LarvaNet_1c": [],
           "LarvaNet_0c": [], "LarvaNetV2": [], "LarvaNet_w64": ["--num_features", "16"]}
BATCH, PATCH, SCALE = 2, 8, 4
VOLUME_PER_STEP = PATCH * PATCH * BATCH * 3
# the bars of tests/test_torch_train.py (the reasons are there): the loss,
# f32 sums in another order; a gradient relative to its tensor's largest
# |g|; parameters after 3 AdamW steps; JAX's default route
LOSS_RTOL = 1e-6
GRAD_RTOL = 2e-5
PARAM_ATOL = 1e-5
DEFAULT_ROUTE_RTOL = 1e-4
# a validation PSNR: the two forwards differ by f32 rounding, which moves a
# pixel to another uint8 level rarely (tests/test_torch_validate.py's bar)
PSNR_ATOL = 1e-3
# forwards after a partial restore (tests/test_torch_larvanet.py's bar)
F32_ATOL = 1e-3


def _to_numpy(tree):
    if hasattr(tree, "items"):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _batch(seed):
    """A CHW host batch: LR patches and HR truths (blocky plus noise)."""
    rng = np.random.default_rng(seed)
    lr = rng.uniform(0, 255, (BATCH, 3, PATCH, PATCH)).astype(np.float32)
    hr = np.repeat(np.repeat(lr, SCALE, 2), SCALE, 3)
    hr = np.clip(hr + rng.normal(0, 8, hr.shape), 0, 255).astype(np.float32)
    return list(lr), list(hr)


def _nhwc(frames):
    return np.ascontiguousarray(np.stack(frames).transpose(0, 2, 3, 1))


def _port_params(pm):
    return {k: v.detach().numpy().copy() for k, v in pm.module.named_parameters()}


def _as_port(jax_tree, name, names):
    state = state_dict_from_jax_params(_to_numpy(jax_tree), name)
    return {k: state[k].numpy() for k in names}


def _models(name, flags, jax_flags=("--packed_trunk", "0"), is_training=True):
    """(JAX model, port model with the JAX model's weights)."""
    jm = jax_get_model(name)
    jm.parse_args(list(flags) + list(jax_flags))
    jm.prepare(is_training=is_training, scales=[SCALE])
    pm = get_model(name)
    pm.parse_args(list(flags))
    pm.prepare([SCALE], device="cpu", is_training=is_training)
    pm.load_state_dict(state_dict_from_jax_params(_to_numpy(jm.params), name))
    return jm, pm


# ---- one multi-exit step ----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _run(name):
    """{quantity: (port, jax)}: the first step's loss and gradients, and the
    parameters after 3 AdamW steps."""
    jm, pm = _models(name, BLOCKS + PRESETS[name])
    assert pm.optimizer_kind == jm.optimizer_kind == "adamw"
    names = list(_port_params(pm))
    lr, hr = _batch(0)
    jloss, jgrads = jax.value_and_grad(jm._compute_loss)(
        jm.params, jnp.asarray(_nhwc(lr)), jnp.asarray(_nhwc(hr)))
    ploss = pm._loss_and_grads(torch.from_numpy(_nhwc(lr)), torch.from_numpy(_nhwc(hr)))
    out = {"loss": (float(ploss), float(jloss)),
           "grads": ({k: p.grad.numpy().copy() for k, p in pm.module.named_parameters()},
                     _as_port(jgrads, name, names))}
    pm.optimizer.zero_grad(set_to_none=True)
    for step in range(3):
        lr, hr = _batch(step)
        pm.train_step(lr, SCALE, hr)
        jm.train_step(lr, SCALE, hr)
    out["params"] = (_port_params(pm), _as_port(jm.params, name, names))
    return out


def _hold(label, quantity, got, want):
    if quantity == "loss":
        err = abs(got - want) / abs(want)
        print("%s loss: port %.8g jax %.8g, rel %.3g" % (label, got, want, err))
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
    print("%s %s: worst %s %.3g (bar %g)" % (label, quantity, worst[1], worst[0], bar))
    assert worst[0] <= bar


@pytest.mark.parametrize("quantity", ["loss", "grads", "params"])
@pytest.mark.parametrize("name", sorted(PRESETS))
def test_multi_exit_step_matches_jax(name, quantity):
    """The mean of every exit's L1 (V2: the tail's too), its gradients, and
    three AdamW steps at the plateau schedule's lr, against JAX's
    `_train_step_impl` on the module graph."""
    _hold("train %s" % name, quantity, *_run(name)[quantity])


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_multi_exit_step_matches_jax_default_route(name):
    """JAX's default training graph (--packed_trunk 1 --lr_domain_loss 1)
    reparametrises the module graph the port trains: the same loss and
    gradients, to float tolerance."""
    jm, pm = _models(name, BLOCKS + PRESETS[name], jax_flags=())
    assert jm.args.packed_trunk and jm.args.lr_domain_loss
    lr, hr = _batch(5)
    jloss, jgrads = jax.value_and_grad(jm._compute_loss)(
        jm.params, jnp.asarray(_nhwc(lr)), jnp.asarray(_nhwc(hr)))
    ploss = float(pm._loss_and_grads(torch.from_numpy(_nhwc(lr)),
                                     torch.from_numpy(_nhwc(hr))))
    assert abs(ploss - float(jloss)) <= DEFAULT_ROUTE_RTOL * abs(float(jloss))
    want = _as_port(jgrads, name, list(_port_params(pm)))
    worst = max((float(np.abs(p.grad.numpy() - want[k]).max() / np.abs(want[k]).max()), k)
                for k, p in pm.module.named_parameters())
    print("train %s against JAX's default route: loss rel %.3g, worst gradient %s %.3g"
          % (name, abs(ploss - float(jloss)) / abs(float(jloss)), worst[1], worst[0]))
    assert worst[0] <= DEFAULT_ROUTE_RTOL, worst


@pytest.mark.parametrize("layout", ["chw_list", "nhwc", "nchw", "unknown"])
def test_input_batches_take_jax_layouts(layout):
    """A list is always CHW; a 4-D array whose last axis is 3 is NHWC, one
    whose axis 1 is 3 is NCHW (chw_list_to_nhwc's rule)."""
    pm = get_model("LarvaNet")
    pm.parse_args(BLOCKS)
    pm.prepare([SCALE], device="cpu")
    lr, _ = _batch(1)
    want = _nhwc(lr)
    batch = {"chw_list": lr, "nhwc": want, "nchw": np.stack(lr),
             "unknown": np.zeros((2, 4, 5, 6), np.float32)}[layout]
    if layout == "unknown":
        with pytest.raises(ValueError, match="layout"):
            pm._input_to_device(batch)
        return
    got = pm._input_to_device(batch)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)


# ---- ReduceLROnPlateau --------------------------------------------------------------

# PSNR series (dB), stepped one value a validation
SERIES = {
    "rising": [20.0, 20.5, 21.0, 21.6, 22.0, 22.3, 22.5, 22.8],
    "flat": [25.0] * 14,
    # each step up is within --threshold 1e-3 of the best, or just past it
    "within_threshold": [25.0, 25.0005, 25.001, 25.0011, 25.0015, 25.0021, 25.0021,
                         25.0030, 25.0031, 25.0040, 25.0041, 25.0041, 25.0041, 25.0041],
    # the floor: halvings down to min_lr, then none (the eps skip)
    "past_min_lr": [30.0] + [29.0] * 16,
}


def _plateaus(series, cooldown):
    kw = dict(lr=4e-4 if series != "past_min_lr" else 4e-7, factor=0.5, patience=1,
              cooldown=cooldown, threshold=1e-3, min_lr=1e-8 if series != "past_min_lr"
              else 1.5e-7, mode="max")
    return ReduceLROnPlateau(**kw), JaxPlateau(**kw)


@pytest.mark.parametrize("cooldown", [0, 2])
@pytest.mark.parametrize("series", sorted(SERIES))
def test_plateau_schedule_matches_jax(series, cooldown):
    """The lr and the whole state after every step."""
    port, ref = _plateaus(series, cooldown)
    lrs = []
    for metric in SERIES[series]:
        assert port.step(metric) == ref.step(metric)
        assert port.state_dict() == ref.state_dict()
        lrs.append(port.lr)
    print("%s, cooldown %d: lr %s" % (series, cooldown, lrs))
    if series in ("flat", "past_min_lr"):
        assert lrs[-1] < lrs[0]  # the series reaches a reduction


def test_plateau_state_round_trips_through_a_state_file(tmp_path):
    """Half the series, the state through torch.save / weights_only load
    into a fresh schedule, the other half: JAX's lr sequence."""
    port, ref = _plateaus("within_threshold", 2)
    series = SERIES["within_threshold"]
    for metric in series[:7]:
        port.step(metric)
        ref.step(metric)
    torch.save(port.state_dict(), tmp_path / "s.pt")
    again = ReduceLROnPlateau(lr=1.0)
    again.load_state_dict(torch.load(tmp_path / "s.pt", weights_only=True))
    for metric in series[7:]:
        assert again.step(metric) == ref.step(metric)
        assert again.state_dict() == ref.state_dict()


def test_step_lr_matches_jax():
    port, ref = StepLR(base_lr=1e-3, step_size=3, gamma=0.5), JaxStepLR(
        base_lr=1e-3, step_size=3, gamma=0.5)
    for _ in range(10):
        assert port.step() == ref.step()
    assert port.state_dict() == ref.state_dict()


# ---- a DIV2K-layout set ---------------------------------------------------------------


def _write_set(root, n=3, seed=11):
    rng = np.random.default_rng(seed)
    for i in range(n):
        hr = rng.integers(0, 256, (3, 64, 80), dtype=np.uint8)
        lr = np.round(hr.reshape(3, 16, 4, 20, 4).mean((2, 4))).astype(np.uint8)
        io.save_image_chw(hr, os.path.join(root, "HR", "%04d.png" % i))
        io.save_image_chw(lr, os.path.join(root, "LR", "X4", "%04dx4.png" % i))
    return root


@pytest.fixture(scope="module")
def div2k_root(tmp_path_factory):
    """A DIV2K-layout set written by the port's PNG encoder (LR 16x20)."""
    return _write_set(str(tmp_path_factory.mktemp("div2k")))


def _set_flags(root, prefix="data"):
    return ["--%s_input_path" % prefix, os.path.join(root, "LR"),
            "--%s_truth_path" % prefix, os.path.join(root, "HR")]


# ---- train_step_larva's bookkeeping -------------------------------------------------

# validation every 3 steps; --patience 0 and a threshold no step of this
# run improves by, so every validation after the first halves the lr
LARVA_FLAGS = BLOCKS + ["--val_volume", str(3 * VOLUME_PER_STEP), "--patience", "0",
                        "--cooldown", "0", "--threshold", "0.5"]
LARVA_STEPS = 9


def _record(model, steps, validations):
    orig = model.validate_for_train

    def validate(args, loader):
        psnr = orig(args, loader)
        validations.append((model.global_step, psnr))
        return psnr

    model.validate_for_train = validate
    model.volume_per_step = VOLUME_PER_STEP


@pytest.fixture(scope="module")
def larva_runs(div2k_root, tmp_path_factory):
    """9 train_step_larva steps on each side from the same weights and
    batches: {side: (validations [(step, psnr)], [(step, lr, temp_volume,
    total_volume)] after each step, checkpoint files)}."""
    jm, pm = _models("LarvaNet", LARVA_FLAGS)
    out = {}
    for side, model, loader in (
            ("jax", jm, jax_get_loader("div2k_val_loader")),
            ("port", pm, get_loader("div2k_val_loader"))):
        loader.parse_args(_set_flags(div2k_root)
                          + (["--data_native", "0"] if side == "jax" else []))
        loader.prepare([SCALE])
        path = str(tmp_path_factory.mktemp("larva_" + side))
        args = SimpleNamespace(train_path=path)
        validations, steps = [], []
        _record(model, steps, validations)
        for step in range(LARVA_STEPS):
            lr, hr = _batch(step)
            # the port takes the NHWC batch the unthreaded loop hands it
            model.train_step_larva(args, loader, lr if side == "jax" else _nhwc(lr),
                                   hr if side == "jax" else _nhwc(hr))
            steps.append((model.global_step, model.get_learning_rate(), model.temp_volume,
                          model.total_volume))
        out[side] = (validations, steps, sorted(os.listdir(path)))
    return out


@pytest.mark.parametrize("part", ["validation_steps", "psnr", "lr", "volume",
                                  "checkpoints"])
def test_train_step_larva_bookkeeping_matches_jax(larva_runs, part):
    (pv, ps, pfiles), (jv, js, jfiles) = larva_runs["port"], larva_runs["jax"]
    if part == "validation_steps":
        assert [s for s, _ in pv] == [s for s, _ in jv] == [1, 3, 6, 9]
    elif part == "psnr":
        print("validation PSNRs: port %s, JAX %s" % ([p for _, p in pv], [p for _, p in jv]))
        for (_, a), (_, b) in zip(pv, jv):
            assert abs(a - b) <= PSNR_ATOL, (a, b)
    elif part == "lr":
        assert [s[1] for s in ps] == [s[1] for s in js]
        # read after each step: a validation's reduction shows at once
        assert [s[1] for s in ps] == [4e-4] * 2 + [2e-4] * 3 + [1e-4] * 3 + [5e-5]
    elif part == "volume":
        assert [s[2:] for s in ps] == [s[2:] for s in js]
        assert ps[-1][3] == LARVA_STEPS * VOLUME_PER_STEP and ps[-1][2] == 0
    else:
        stems = ["model_step%d_vol0G" % s for s in (3, 6, 9)]
        assert [f for f in jfiles if f.endswith(".ckpt")] == [s + ".ckpt" for s in stems]
        assert pfiles == sorted([s + ".pth" for s in stems] + [s + ".state.pt" for s in stems])


# ---- the train_larva CLI ----------------------------------------------------------------


def _larva_cli(root, train_path, *extra, main=train_larva.main, model_flags=LARVA_FLAGS):
    return main([
        "--dataloader", "div2k_train_loader", "--device", "cpu", "--train_path", train_path,
        *_set_flags(root), *_set_flags(root, "val_data"), "--data_cached", "--data_seed", "3",
        "--batch_size", str(BATCH), "--input_patch_size", str(PATCH), "--log_freq", "1",
        "--summary_freq", "3", *model_flags, *extra])


@pytest.fixture(scope="module")
def straight_and_resumed(div2k_root, tmp_path_factory):
    """6 steps straight; 3 steps, then --restore_path latest to 6."""
    straight = _larva_cli(div2k_root, str(tmp_path_factory.mktemp("straight")),
                          "--max_steps", "6")
    path = str(tmp_path_factory.mktemp("resumed"))
    first = _larva_cli(div2k_root, path, "--max_steps", "3")
    resumed = _larva_cli(div2k_root, path, "--max_steps", "6", "--restore_path", "latest")
    return straight, first, resumed, path


@pytest.mark.parametrize("part", ["losses", "params", "adamw", "scheduler", "volume"])
def test_cli_resume_at_a_val_volume_boundary_repeats_a_straight_run(straight_and_resumed,
                                                                    part):
    """Bit for bit: the checkpoint at step 3 carries the step, the volume,
    AdamW's moments and the schedule, and --data_seed the batches."""
    (sm, slosses), (_, flosses), (rm, rlosses), _ = straight_and_resumed
    if part == "losses":
        assert sorted(flosses) == [1, 2, 3] and sorted(rlosses) == [4, 5, 6]
        assert {**flosses, **rlosses} == slosses
    elif part == "params":
        for (k, a), (_, b) in zip(sm.module.named_parameters(), rm.module.named_parameters()):
            assert torch.equal(a, b), k
    elif part == "adamw":
        sa, ra = sm.optimizer.state_dict(), rm.optimizer.state_dict()
        assert sa["param_groups"] == ra["param_groups"]
        assert sa["state"].keys() == ra["state"].keys()
        for i in sa["state"]:
            assert all(torch.equal(sa["state"][i][k], ra["state"][i][k]) for k in sa["state"][i])
    elif part == "scheduler":
        assert rm.scheduler.state_dict() == sm.scheduler.state_dict()
        assert sm.scheduler.lr == 1e-4  # halved at steps 3 and 6
    else:
        assert rm.total_volume == sm.total_volume == 6 * VOLUME_PER_STEP
        assert rm.temp_volume == sm.temp_volume == 0


def test_cli_writes_checkpoints_arguments_and_scalars(straight_and_resumed):
    (_, slosses), *_, path = straight_and_resumed
    names = sorted(os.listdir(path))
    for step in (3, 6):
        stem = "model_step%d_vol0G" % step
        assert stem + ".pth" in names and stem + ".state.pt" in names
    with open(os.path.join(path, "arguments.json")) as f:
        args = json.load(f)
    assert args["model"] == "LarvaNet" and args["data_seed"] == 3
    assert args["num_blocks"] == "1,1" and args["val_volume"] == 3 * VOLUME_PER_STEP
    # a summary at the --val_volume boundaries that are --summary_freq steps
    with open(os.path.join(path, "x4", "scalars.jsonl")) as f:
        rows = [json.loads(line) for line in f]
    assert [(r["tag"], r["step"]) for r in rows] == [
        ("loss", 3), ("lr", 3), ("loss", 6), ("lr", 6)]
    assert [r["value"] for r in rows if r["tag"] == "loss"] == [slosses[3], slosses[6]]
    assert [r["value"] for r in rows if r["tag"] == "lr"] == [4e-4, 2e-4]


def test_cli_takes_ema_decay_and_grad_accum(div2k_root, tmp_path):
    """As in cli/train.py: the average is kept and saved, and the step sums
    the gradients of equal microbatches (the same loss as one batch, to f32
    tolerance)."""
    one, losses = _larva_cli(div2k_root, str(tmp_path / "one"), "--max_steps", "3")
    model, accum = _larva_cli(div2k_root, str(tmp_path / "two"), "--max_steps", "3",
                              "--ema_decay", "0.9", "--grad_accum", "2")
    assert model.grad_accum == 2 and model.ema is not None and one.ema is None
    state = torch.load(state_path(os.path.join(str(tmp_path / "two"),
                                               "model_step3_vol0G.pth")), weights_only=True)
    assert all(torch.equal(a, b) for a, b in zip(state["ema"], model.ema.average))
    assert abs(accum[1] - losses[1]) <= LOSS_RTOL * abs(losses[1])


@pytest.mark.parametrize("flags", [["--orbax_checkpoint", "1"], ["--dp_devices", "2"]])
def test_cli_refuses_what_is_not_ported(div2k_root, straight_and_resumed, tmp_path, flags):
    """The parallel package's train flags, refused until the port had it,
    now train. --orbax_checkpoint 1: a directory at the --val_volume
    boundary, from which a resume repeats the straight run bit for bit
    (step, volume, AdamW, schedule). --dp_devices 2 (a mesh that repeats
    the CPU): the multi-exit loss and the weights of the straight run to
    f32 tolerance."""
    (sm, slosses), (fm, flosses), *_ = straight_and_resumed
    path = str(tmp_path / "run")
    if flags[0] == "--orbax_checkpoint":
        _larva_cli(div2k_root, path, "--max_steps", "3", *flags)
        assert os.path.isdir(os.path.join(path, "model_step3_vol0G.pth"))
        resumed, rlosses = _larva_cli(div2k_root, path, "--max_steps", "6", *flags,
                                      "--restore_path", "latest")
        assert rlosses == {k: v for k, v in slosses.items() if k > 3}
        for a, b in zip(sm.module.parameters(), resumed.module.parameters()):
            assert torch.equal(a, b)
        assert resumed.scheduler.state_dict() == sm.scheduler.state_dict()
        assert resumed.total_volume == sm.total_volume
        return
    model, losses = _larva_cli(div2k_root, path, "--max_steps", "3", *flags)
    assert model.data_parallel is not None
    for step, loss in flosses.items():
        assert abs(losses[step] - loss) <= 1e-5 * abs(loss)
    for a, b in zip(fm.module.parameters(), model.module.parameters()):
        assert float((a - b).abs().max()) <= PARAM_ATOL


def test_cli_trains_with_qat(div2k_root, tmp_path, monkeypatch):
    """--qat 1 is accepted: the loss runs every body and leg pair through
    the fake-quant pair (3 body pairs and 2 legs a step here); --qat 1 with
    an explicit --packed_trunk 0 is refused, as in JAX."""
    from larvanet_tpu_torch.ops import pairs

    calls = []
    real = pairs.qat_pair

    def counting(dtype=torch.float32):
        pair = real(dtype)

        def counted(*a, **k):
            calls.append(a[0])
            return pair(*a, **k)

        return counted

    monkeypatch.setattr(pairs, "qat_pair", counting)
    model, losses = _larva_cli(div2k_root, str(tmp_path), "--max_steps", "2", "--qat", "1")
    assert model.args.qat == 1 and all(np.isfinite(v) for v in losses.values())
    n_pairs = sum(int(b) for b in BLOCKS[1].split(",")) + len(BLOCKS[1].split(","))
    assert len(calls) == 2 * n_pairs and -1 in calls
    with pytest.raises(ValueError, match="requires --packed_trunk 1"):
        _larva_cli(div2k_root, str(tmp_path / "p0"), "--max_steps", "1", "--qat", "1",
                   "--packed_trunk", "0")


def test_cli_runs_on_the_card_unless_told_otherwise(div2k_root, tmp_path):
    """Without --device cpu and without a card it exits; it never falls back."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a card")
    with pytest.raises(SystemExit, match="no CUDA device"):
        train_larva.main(["--train_path", str(tmp_path), *_set_flags(div2k_root)])


def _jax_v2_injection(argv):
    """What JAX's train_larvaV2 prints, sets on the model and hands on, its
    training stubbed out."""
    from larvanet_tpu.cli import train_larvaV2 as jax_v2

    seen = {}

    def stub(args):
        seen["argv"] = list(args)
        seen["steps_per_epoch"] = jax_registry.get_model("LarvaNetV2").steps_per_epoch

    with mock.patch("larvanet_tpu.cli.train_larva.main", stub):
        jax_v2.main(list(argv))
    return seen


@pytest.mark.parametrize("given", [None, "123"])
def test_train_larva_v2_injects_jax_steps_per_epoch(div2k_root, tmp_path, capsys, given):
    extra = ["--max_steps", "1"] + ([] if given is None else ["--steps_per_epoch", given])
    seen = _jax_v2_injection(["--train_path", "x", "--batch_size", str(BATCH),
                              "--input_patch_size", str(PATCH)] + extra)
    want_line = capsys.readouterr().out.splitlines()[0]
    # the V2 presets have no --cooldown flag
    model, losses = _larva_cli(div2k_root, str(tmp_path), *extra, main=train_larvaV2.main,
                               model_flags=LARVA_FLAGS[:-4] + LARVA_FLAGS[-2:])
    out = capsys.readouterr().out
    assert out.splitlines()[0] == want_line
    print(want_line)
    assert model.registry_name == "LarvaNetV2" and type(model).__name__ == "LarvaNetV2"
    assert model.steps_per_epoch == seen["steps_per_epoch"] == (800000 if given is None
                                                                else 123)
    assert "--steps_per_epoch" not in seen["argv"] and "unhandled arguments" not in out
    assert sorted(losses) == [1]


# ---- the queue loaders -----------------------------------------------------------------


def _runners():
    return [t for t in threading.enumerate() if t.name.startswith("queue-runner")]


def _queue_loader(name, root, *extra):
    loader = get_loader(name)
    loader.parse_args(_set_flags(root) + list(extra))
    loader.prepare([SCALE])
    return loader


@pytest.mark.parametrize("name,runners", [("combined_loader", 6),
                                          ("div2k_train_loader_queue", 8)])
def test_queue_loader_gives_nhwc_batches(div2k_root, name, runners):
    loader = _queue_loader(name, div2k_root, "--data_cached")
    assert loader.is_threaded and loader.args.data_num_queue_runners == runners
    loader.start_training_queue_runner(batch_size=3, input_patch_size=PATCH)
    try:
        assert len(_runners()) == runners
        for _ in range(4):
            ins, truths = loader.get_queue_data(SCALE)
            assert ins.shape == (3, PATCH, PATCH, 3) and ins.dtype == np.float32
            assert truths.shape == (3, PATCH * SCALE, PATCH * SCALE, 3)
            assert truths.dtype == np.float32 and 0 <= ins.min() and truths.max() <= 255
    finally:
        loader.stop_queue_runners()
    assert _runners() == []


def test_queue_runner_error_is_raised_by_get_queue_data(tmp_path):
    """A set whose LR frames are missing: the runners' error reaches the
    consumer instead of dying with the thread."""
    root = _write_set(str(tmp_path), n=2)
    for i in range(2):
        os.remove(os.path.join(root, "LR", "X4", "%04dx4.png" % i))
    loader = _queue_loader("combined_loader", root, "--data_num_queue_runners", "2")
    loader.start_training_queue_runner(batch_size=2, input_patch_size=PATCH)
    try:
        with pytest.raises(FileNotFoundError):
            loader.get_queue_data(SCALE)
    finally:
        loader.stop_queue_runners()
    assert _runners() == []


def test_stop_queue_runners_twice_is_safe(div2k_root):
    loader = _queue_loader("div2k_train_loader_queue", div2k_root,
                           "--data_num_queue_runners", "2")
    loader.stop_queue_runners()  # never started
    loader.start_training_queue_runner(batch_size=2, input_patch_size=PATCH)
    loader.get_queue_data(SCALE)
    loader.stop_queue_runners()
    loader.stop_queue_runners()
    assert _runners() == []


@pytest.mark.parametrize("name", ["combined_loader", "div2k_train_loader_queue"])
def test_train_larva_takes_steps_on_a_queue_loader(div2k_root, tmp_path, name):
    model, losses = _larva_cli(div2k_root, str(tmp_path), "--dataloader", name,
                               "--data_num_queue_runners", "2", "--max_steps", "2")
    assert sorted(losses) == [1, 2] and all(np.isfinite(v) for v in losses.values())
    assert model.global_step == 2
    assert _runners() == []  # joined in the loop's finally


# ---- checkpoints across the boundary --------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _larvanet_pth(tmp_dir):
    """A port LarvaNet trained one step and saved: (model, .pth path)."""
    pm = get_model("LarvaNet")
    pm.parse_args(BLOCKS)
    pm.prepare([SCALE], device="cpu", seed=3, is_training=True)
    lr, hr = _batch(2)
    pm.train_step(lr, SCALE, hr)
    path = pm.save(tmp_dir)
    assert os.path.basename(path) == "model_step1_vol0G.pth"
    return pm, path


def test_trained_pth_restores_in_the_jax_package(tmp_path_factory):
    pm, path = _larvanet_pth(str(tmp_path_factory.getbasetemp() / "larvanet_pth"))
    jm = jax_get_model("LarvaNet")
    jm.parse_args(BLOCKS)
    jm.prepare(is_training=False, scales=[SCALE])
    jm.restore(path)
    want = _port_params(pm)
    got = _as_port(jm.params, "LarvaNet", list(want))
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@functools.lru_cache(maxsize=None)
def _v2_restores(tmp_dir):
    """LarvaNetV2 on each side from the same init (JAX's), then the port
    LarvaNet .pth restored into both: (JAX model, port model, the port's
    init, the LarvaNet model)."""
    src, path = _larvanet_pth(tmp_dir)
    jm, pm = _models("LarvaNetV2", BLOCKS, jax_flags=("--packed_trunk", "0"),
                     is_training=False)
    init = _port_params(pm)
    jm.restore(path)
    pm.restore(path)
    return jm, pm, init, src


@pytest.mark.parametrize("check", ["bodies_and_legs_load", "tail_keeps_init",
                                   "forward_matches_jax"])
def test_v2_partial_restore(tmp_path_factory, check):
    jm, pm, init, src = _v2_restores(str(tmp_path_factory.getbasetemp() / "larvanet_pth"))
    got, loaded = _port_params(pm), _port_params(src)
    if check == "bodies_and_legs_load":
        assert set(loaded) < set(got)
        for k, v in loaded.items():
            np.testing.assert_array_equal(got[k], v, err_msg=k)
    elif check == "tail_keeps_init":
        tail = [k for k in got if k.startswith("tail.")]
        assert tail and not set(tail) & set(loaded)
        for k in tail:
            np.testing.assert_array_equal(got[k], init[k], err_msg=k)
    else:
        x = np.random.default_rng(4).uniform(0, 255, (1, 7, 10, 3)).astype(np.float32)
        want = jm.module.apply({"params": jm.params}, jnp.asarray(x), exits="all")
        with torch.no_grad():
            outs = pm.module(torch.from_numpy(x), exits="all")
        assert len(outs) == len(want) == 3
        for g, w in zip(outs, want):
            assert float(np.abs(g.numpy() - np.asarray(w)).max()) <= F32_ATOL


def test_v2_partial_restore_refuses_a_shape_mismatch(tmp_path):
    """A LarvaNet_w64 checkpoint (16 channels here) against V2's 48."""
    w64 = get_model("LarvaNet_w64")
    w64.parse_args(BLOCKS + ["--num_features", "16"])
    w64.prepare([SCALE], device="cpu")
    path = w64.save(str(tmp_path))
    pm = get_model("LarvaNetV2")
    pm.parse_args(BLOCKS)
    pm.prepare([SCALE], device="cpu", is_training=True)
    with pytest.raises(ValueError, match="shape mismatch"):
        pm.restore(path)


def test_v2_partial_restore_skips_the_state_file(tmp_path_factory, capsys):
    """A training restore from a .pth that covers part of the model loads no
    step, volume, moments or schedule; a complete one loads them."""
    src, path = _larvanet_pth(str(tmp_path_factory.getbasetemp() / "larvanet_pth"))
    assert os.path.exists(state_path(path))
    pm = get_model("LarvaNetV2")
    pm.parse_args(BLOCKS)
    pm.prepare([SCALE], device="cpu", is_training=True)
    pm.restore(path)
    assert "is not loaded" in capsys.readouterr().out
    assert pm.global_step == 0 and not pm.optimizer.state_dict()["state"]
    same = get_model("LarvaNet")
    same.parse_args(BLOCKS)
    same.prepare([SCALE], device="cpu", is_training=True)
    same.restore(path)
    assert same.global_step == 1 and same.optimizer.state_dict()["state"]
