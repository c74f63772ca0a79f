"""The port's train_schedule CLI (larvanet_tpu_torch/cli/train_schedule.py)
against the JAX package's (larvanet_tpu/cli/train_schedule.py), on the CPU,
on a tiny hrsr (--num_lr_blocks 1 --num_hr_blocks 1) and a two-image
DIV2K-layout set: both sides restore one `.pth` and train 10 steps of 2 x
8x8 patches with an epoch of one step, validating every 2 (--threshold 100,
so that only the first validation improves and the plateau halves the lr
at the third and fifth). Held: the validation cadence and its lines, the
lr after every plateau step, the PSNRs and losses, the checkpoints; a
resume from the step-6 checkpoint equal to the uninterrupted run bit for
bit, and one from JAX's step-6 `.ckpt` following JAX's run; the device
pipeline's chunks cut to each validation; a model without a scheduler
(hrsr_c3); the default epoch; the refusals.
"""

import contextlib
import functools
import io as _io
import os
import re

import jax
import numpy as np
import pytest
import torch

from larvanet_tpu.cli import train_schedule as jax_train_schedule
from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.utils.torch_convert import save_pth
from larvanet_tpu_torch.cli import train_schedule
from larvanet_tpu_torch.data import io

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

MODEL = ["--num_lr_blocks", "1", "--num_hr_blocks", "1", "--threshold", "100"]
STEPS = 10
VALIDATIONS = [2, 4, 6, 8, 10]
LRS = [1e-3, 1e-3, 5e-4, 5e-4, 2.5e-4]  # the lr after each validation's plateau step
VAL_LINE = r"^step (\d+), epoch (\d+), psnr=([0-9.]+), lr = ([0-9.]+)$"
STEP_LINE = r"^step (\d+), lr ([0-9.]+), loss ([0-9.]+) "
PSNR_TOL_DB = 1e-4
LOSS_RTOL = 1e-5


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """A DIV2K-layout set (LR 16x20) written by the port's PNG encoder, and a
    random tiny hrsr saved by the JAX package as a reference `.pth`."""
    root = str(tmp_path_factory.mktemp("schedule"))
    rng = np.random.default_rng(11)
    for i in range(2):
        hr = rng.integers(0, 256, (3, 64, 80), dtype=np.uint8)
        lr = np.round(hr.reshape(3, 16, 4, 20, 4).mean((2, 4))).astype(np.uint8)
        io.save_image_chw(hr, os.path.join(root, "HR", "%04d.png" % i))
        io.save_image_chw(lr, os.path.join(root, "LR", "X4", "%04dx4.png" % i))
    jm = jax_get_model("hrsr")
    jm.parse_args(list(MODEL))
    jm.prepare(is_training=False, scales=[4])
    save_pth(jax.tree_util.tree_map(np.asarray, jm.params), "hrsr",
             os.path.join(root, "hrsr.pth"))
    return root


def _argv(root, run, restore="hrsr.pth", model="hrsr", extra=()):
    return ["--model", model, "--train_path", os.path.join(root, run),
            "--data_input_path", os.path.join(root, "LR"),
            "--data_truth_path", os.path.join(root, "HR"), "--data_seed", "0",
            "--val_data_input_path", os.path.join(root, "LR"),
            "--val_data_truth_path", os.path.join(root, "HR"),
            "--batch_size", "2", "--input_patch_size", "8", "--step_per_epoch", "1",
            "--val_freq_epochs", "2", "--max_steps", str(STEPS), "--log_freq", "1",
            "--restore_path", os.path.join(root, restore), *MODEL, *extra]


def _run(main, argv):
    """(main's result, its stdout)."""
    out = _io.StringIO()
    with contextlib.redirect_stdout(out):
        result = main(argv)
    return result, out.getvalue()


@functools.lru_cache(maxsize=None)
def _jax_run(root):
    _, out = _run(jax_train_schedule.main, _argv(root, "jax", extra=["--data_native", "0"]))
    return out


@functools.lru_cache(maxsize=None)
def _port_run(root):
    return _run(train_schedule.main, _argv(root, "port", extra=["--device", "cpu"]))


def _lines(out):
    """The validation lines (step, epoch, PSNR, lr before its plateau step)
    and the step lines (step, lr, loss)."""
    vals = [(int(s), int(e), float(p), l) for s, e, p, l in re.findall(VAL_LINE, out, re.M)]
    steps = [(int(s), l, float(v)) for s, l, v in re.findall(STEP_LINE, out, re.M)]
    return vals, steps


def test_cadence_lr_and_psnr_match_jax(root):
    """The same validation steps and epochs, the lr each prints and the lr
    each step after a plateau step trains at, equal; the PSNRs within
    PSNR_TOL_DB and the losses within LOSS_RTOL; one checkpoint a
    validation; `main`'s record of the validations."""
    jvals, jsteps = _lines(_jax_run(root))
    (model, losses, validations), out = _port_run(root)
    pvals, psteps = _lines(out)
    print("validations: port %s, JAX %s" % (pvals, jvals))
    assert [v[:2] for v in pvals] == [v[:2] for v in jvals] == [(s, s) for s in VALIDATIONS]
    assert [v[3] for v in pvals] == [v[3] for v in jvals]
    assert all(abs(a[2] - b[2]) <= PSNR_TOL_DB for a, b in zip(pvals, jvals))
    assert [s[:2] for s in psteps] == [s[:2] for s in jsteps]
    assert len(psteps) == STEPS
    assert all(abs(a[2] - b[2]) <= LOSS_RTOL * b[2] for a, b in zip(psteps, jsteps))
    assert [(s, lr) for s, _, lr in validations] == list(zip(VALIDATIONS, LRS))
    assert sorted(losses) == list(range(1, STEPS + 1))
    assert model.get_learning_rate() == LRS[-1]
    files = os.listdir(os.path.join(root, "port"))
    assert all("model_%d%s" % (s, ext) in files for s in VALIDATIONS
               for ext in (".pth", ".state.pt"))


def test_resume_equals_the_uninterrupted_run(root):
    """A run restored from the step-6 checkpoint (its state file: Adam, the
    plateau) trains steps 7-10 to the uninterrupted run's weights and
    scheduler bit for bit, with its validations."""
    (model, _, validations), _ = _port_run(root)
    (resumed, _, rest), _ = _run(train_schedule.main, _argv(
        root, "resumed", restore=os.path.join("port", "model_6.pth"), extra=["--device", "cpu"]))
    assert rest == validations[3:]
    assert resumed.lr_scheduler == model.lr_scheduler
    for (key, a), b in zip(model.module.state_dict().items(),
                           resumed.module.state_dict().values()):
        assert torch.equal(a, b), key


def test_resume_from_a_jax_checkpoint(root):
    """A run restored from JAX's step-6 `.ckpt` (its AdamW state and its
    plateau) validates at steps 8 and 10 as JAX's run did: the lr equal,
    the PSNRs within PSNR_TOL_DB."""
    jvals, _ = _lines(_jax_run(root))
    (_, _, rest), out = _run(train_schedule.main, _argv(
        root, "from_jax", restore=os.path.join("jax", "model_6.ckpt"), extra=["--device", "cpu"]))
    pvals, _ = _lines(out)
    print("resumed from JAX: %s, JAX %s" % (pvals, jvals[3:]))
    assert [v[:2] for v in pvals] == [v[:2] for v in jvals[3:]]
    assert [v[3] for v in pvals] == [v[3] for v in jvals[3:]]
    assert all(abs(a[2] - b[2]) <= PSNR_TOL_DB for a, b in zip(pvals, jvals[3:]))
    assert [lr for _, _, lr in rest] == LRS[3:]


def test_device_pipeline_chunks_land_on_each_validation(root):
    """--device_pipeline 3 with a validation every 4 steps: chunks of 3, 1,
    3, 1 and the last 2, validating at 4, 8 and the end (10), the plateau
    stepped at each; the loss finite."""
    argv = _argv(root, "chunks", extra=["--device", "cpu", "--device_pipeline", "3",
                                        "--step_per_epoch", "2"])
    (model, losses, validations), out = _run(train_schedule.main, argv)
    print(out[-600:])
    assert sorted(losses) == [3, 4, 7, 8, 10]
    assert all(np.isfinite(v) for v in losses.values())
    assert [(s, lr) for s, _, lr in validations] == [(4, 1e-3), (8, 1e-3), (10, 5e-4)]
    assert model.global_step == STEPS


def test_model_without_a_scheduler_and_the_default_epoch(root):
    """hrsr_c3 has no lr_scheduler: it validates and saves at the same
    cadence with its step-decay lr. Without --step_per_epoch an epoch is
    round_to_1(300 MiB / patch^2 batch 3) steps, printed as JAX prints it."""
    argv = _argv(root, "c3", model="hrsr_c3", restore="none", extra=["--device", "cpu"])
    argv = argv[:argv.index("--restore_path")] + argv[argv.index("--restore_path") + 2:]
    argv = [a for a in argv if a not in ("--threshold", "100")]
    (model, _, validations), _ = _run(train_schedule.main, argv)
    assert [(s, lr) for s, _, lr in validations] == [(s, 1e-4) for s in VALIDATIONS]
    assert getattr(model, "lr_scheduler", None) is None
    i = argv.index("--step_per_epoch")
    default = argv[:i] + argv[i + 2:]
    default[default.index("--max_steps") + 1] = "1"
    (_, _, validations), out = _run(train_schedule.main, default)
    assert validations == [] and "800000.0 steps equal to 1 epoch" in out
    assert jax_train_schedule.round_to_1(300 * 1024 ** 2 / (8 * 8 * 2 * 3)) == 800000.0


@pytest.mark.parametrize("flag", ["--orbax_checkpoint", "--dp_devices"])
def test_refusals(root, flag):
    with pytest.raises(SystemExit, match="ROADMAP") as exc:
        train_schedule.main(_argv(root, "refused", extra=["--device", "cpu", flag, "2"]))
    assert exc.value.code not in (0, None)


def test_validate_tree_refuses_other_models(root):
    """validate_tree scores TreeNet's branches; any other model exits
    non-zero naming TreeNet (JAX's CLI fails on the missing flag)."""
    from larvanet_tpu_torch.cli import validate_tree

    with pytest.raises(SystemExit, match="TreeNet") as exc:
        validate_tree.main(["--model", "hrsr", "--device", "cpu",
                            "--restore_path", os.path.join(root, "hrsr.pth"),
                            "--data_input_path", os.path.join(root, "LR"),
                            "--data_truth_path", os.path.join(root, "HR"), *MODEL[:4]])
    assert exc.value.code not in (0, None)


TINY = {"ebrn": ["--num_filters", "8", "--num_brms", "2"],
        "ebrn_rm": ["--num_filters", "8", "--num_brms", "2"],
        "ebrn_rm_BLI": ["--num_filters", "8", "--num_brms", "2"],
        "hrsr": MODEL[:4], "hrsr_": MODEL[:4], "hrsr_c3": ["--num_lr_blocks", "1"]}


@pytest.mark.parametrize("name", sorted(TINY))
def test_the_clis_take_the_new_names(root, name):
    """train (2 steps, a checkpoint), get_sr (its PNG the restored model's
    uint8 forward, bit for bit), validate (its PSNR the one of that forward)
    and runtime take each of the six names."""
    from larvanet_tpu_torch.cli import get_sr, runtime, train, validate
    from larvanet_tpu_torch.core.registry import get_model
    from larvanet_tpu_torch.eval import metrics

    flags = ["--model", name, "--scales", "4", "--device", "cpu", *TINY[name]]
    data = ["--data_input_path", os.path.join(root, "LR"),
            "--data_truth_path", os.path.join(root, "HR")]
    run = os.path.join(root, "cli_" + name)
    _, losses = train.main(flags + data + [
        "--train_path", run, "--data_seed", "0", "--batch_size", "2",
        "--input_patch_size", "8", "--max_steps", "2", "--save_freq", "2"])
    assert sorted(losses) == [1, 2] and all(np.isfinite(v) for v in losses.values())
    pth = os.path.join(run, "model_2.pth")
    get_sr.main(flags + ["--restore_path", pth, "--input_path", os.path.join(root, "LR", "X4"),
                         "--output_path", os.path.join(run, "sr")])
    model = get_model(name)
    model.parse_args(list(TINY[name]))
    model.prepare([4], device="cpu")
    model.restore(pth)
    lr = io.load_image_u8(os.path.join(root, "LR", "X4", "0000x4.png"))
    want = model.upscale_uint8([lr.transpose(2, 0, 1)], 4)[0].transpose(1, 2, 0)
    got = io.load_image_u8(os.path.join(run, "sr", "0000x4.png"))
    assert got.shape == (64, 80, 3) and np.array_equal(got, want)
    psnr = validate.main(flags + data + ["--restore_path", pth])[4]
    truth = io.load_image_u8(os.path.join(root, "HR", "0000.png"))
    assert psnr < 100 and np.isfinite(psnr)
    assert metrics.psnr_rgb(want, truth) > 0
    runtime.main(flags + ["--restore_path", pth, "--input_height", "12", "--input_width", "16",
                          "--num_warmup", "1", "--num_iters", "1"])
