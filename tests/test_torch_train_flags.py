"""The train CLIs' remaining flags in the port against the JAX package's,
on the CPU, at tiny sizes: ChunkRateMeter (cli/common.py), --profile_dir
(utils/profiling.py), --async_checkpoint (utils/checkpoints.py,
SRModel.save), --remat (ops/pairs.remat_pair), --widen_from
(utils/width_transfer.py, cli/common.maybe_widen_from) and the tensor
loader (data/loaders.py div2k_train_loader_tensor).
"""

import json
import os
import time
from types import SimpleNamespace

import numpy as np
import pytest
import torch

from larvanet_tpu.cli.common import ChunkRateMeter as JaxChunkRateMeter
from larvanet_tpu.core.registry import get_loader as jax_get_loader
from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.utils.width_transfer import widen_params
from larvanet_tpu_torch.cli import common, train
from larvanet_tpu_torch.core.registry import get_loader, get_model
from larvanet_tpu_torch.data import io
from larvanet_tpu_torch.models.base import state_path
from larvanet_tpu_torch.utils import profiling
from larvanet_tpu_torch.utils.checkpoints import AsyncCheckpointWriter
from larvanet_tpu_torch.utils.torch_convert import load_pth, state_dict_from_jax_params

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

SCALE = 4
EDSR_TINY = ["--edsr_conv_features", "8", "--edsr_res_blocks", "2"]
# a forward of the widened model against the narrow one: the same products
# plus zero ones, f32 sums in another order (tests/test_torch_larvanet.py's bar)
F32_ATOL = 1e-3


def _to_numpy(tree):
    if hasattr(tree, "items"):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


# ---- ChunkRateMeter ------------------------------------------------------------------

def test_chunk_rate_meter_matches_jax(monkeypatch):
    """The same (global_step, n, dt) series on the same clock: the same
    rates, averages, trust flags and log suffixes, the compile chunk and an
    implausible chunk (an early readback) included."""
    now = [0.0]
    series = [(100.0, 10, 10, 30.0), (101.0, 20, 10, 1.0), (102.5, 30, 10, 1.5),
              (103.0, 40, 10, 0.001), (110.0, 50, 10, 7.0)]
    mine, theirs = common.ChunkRateMeter(), JaxChunkRateMeter()
    monkeypatch.setattr(time, "time", lambda: now[0])
    got, want = [], []
    for clock, step, n, dt in series:
        now[0] = clock
        got.append(mine.update(step, n, dt))
        want.append(theirs.update(step, n, dt))
    assert got == want
    assert [mine.suffix(a, t) for _, a, t in got] == [theirs.suffix(a, t) for _, a, t in want]
    assert any(not t for _, _, t in got) and "[untrusted]" in mine.suffix(1.0, False)


# ---- --profile_dir ----------------------------------------------------------------------

def test_profile_dir_writes_a_trace_on_the_cpu(tmp_path):
    """trace() writes trace.json (a Chrome trace) holding the body's spans and
    the ops it ran; without a directory it is a no-op."""
    with profiling.trace(None) as prof:
        assert prof is None
    with profiling.trace(str(tmp_path / "p")):
        with profiling.annotate("train_step"):
            torch.ones(8, 8) @ torch.ones(8, 8)
    events = json.load(open(tmp_path / "p" / profiling.TRACE_FILE))["traceEvents"]
    names = {e.get("name") for e in events}
    assert "train_step" in names and "aten::mm" in names


def test_step_timer_accounts_segments():
    timer = profiling.StepTimer()
    for _ in range(2):
        with timer.segment("data"):
            pass
    assert timer.counts["data"] == 2 and "data" in timer.report()
    timer.reset()
    assert timer.mean("data") == 0.0


# ---- --async_checkpoint ----------------------------------------------------------------

def _trained_edsr(seed=0):
    m = get_model("edsr")
    m.parse_args(EDSR_TINY)
    m.ema_decay = 0.9
    m.prepare([SCALE], device="cpu", is_training=True, seed=seed)
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, (2, 8, 8, 3)).astype(np.float32)
    t = np.repeat(np.repeat(x, SCALE, 1), SCALE, 2)
    m.train_step(x, SCALE, t)
    return m


def test_async_checkpoint_equals_sync_checkpoint(tmp_path):
    """--async_checkpoint's files hold the synchronous save's tensors bit
    for bit, taken at the save: a step right after the submit changes
    nothing in them."""
    m = _trained_edsr()
    sync = m.save(str(tmp_path / "sync"))
    m.async_checkpoints = True
    path = m.save(str(tmp_path / "async"))
    x = np.zeros((2, 8, 8, 3), np.float32)
    m.train_step(x, SCALE, np.zeros((2, 32, 32, 3), np.float32))  # moves every weight
    m.wait_for_checkpoints()
    a, b = load_pth(sync), load_pth(path)
    assert a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)
    sa = torch.load(state_path(sync), weights_only=True)
    sb = torch.load(state_path(path), weights_only=True)
    assert sa["global_step"] == sb["global_step"] == 1
    assert all(torch.equal(u, v) for u, v in zip(sa["ema"], sb["ema"]))
    for i, st in sa["optimizer"]["state"].items():
        for k, v in st.items():
            assert torch.equal(v, sb["optimizer"]["state"][i][k]), (i, k)


def test_async_writer_reraises_errors_on_wait(tmp_path):
    def failing(obj, path):
        raise OSError("disk full")

    writer = AsyncCheckpointWriter(max_pending=1)
    writer.submit([({"w": torch.ones(2)}, str(tmp_path / "a.pt"))], failing)
    with pytest.raises(RuntimeError, match="async checkpoint write failed"):
        writer.wait()
    writer.submit([({"w": torch.ones(2)}, str(tmp_path / "b.pt"))], torch.save)
    writer.close()
    assert torch.equal(torch.load(tmp_path / "b.pt")["w"], torch.ones(2))


# ---- --remat ---------------------------------------------------------------------------

@pytest.mark.parametrize("name,flags", [("edsr", EDSR_TINY),
                                        ("LarvaNet", ["--num_blocks", "2,1"])])
def test_remat_gradients_equal_plain_gradients_bit_for_bit(name, flags):
    """--remat 1 recomputes each pair in the backward on the same inputs:
    the loss and every gradient equal --remat 0's bit for bit, and the
    pairs run twice (forward, recompute)."""
    from larvanet_tpu_torch.ops import conv3x3

    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.uniform(0, 255, (2, 8, 8, 3)).astype(np.float32))
    t = torch.from_numpy(rng.uniform(0, 255, (2, 32, 32, 3)).astype(np.float32))
    out, calls = [], []
    real = conv3x3.conv3x3_bias_act_reference

    def counting(*a, **k):
        calls[-1] += 1
        return real(*a, **k)

    conv3x3.conv3x3_bias_act_reference = counting
    try:
        for remat in ("0", "1"):
            m = get_model(name)
            m.parse_args(flags + ["--remat", remat])
            m.prepare([SCALE], device="cpu", is_training=True)
            calls.append(0)
            loss = m._loss_and_grads(x, t)
            out.append((loss, [p.grad for p in m.module.parameters()]))
    finally:
        conv3x3.conv3x3_bias_act_reference = real
    assert torch.equal(out[0][0], out[1][0])
    assert all(torch.equal(a, b) for a, b in zip(out[0][1], out[1][1]))
    assert calls[1] > calls[0]


def test_remat_is_refused_with_packed_trunk_0():
    m = get_model("edsr")
    m.parse_args(EDSR_TINY + ["--remat", "1", "--packed_trunk", "0"])
    with pytest.raises(ValueError, match="--remat 1 requires --packed_trunk 1"):
        m.prepare([SCALE], device="cpu", is_training=True)
    m.prepare([SCALE], device="cpu", is_training=False)  # serving is not refused


# ---- --widen_from ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def narrow_ckpt(tmp_path_factory):
    """A JAX LarvaNet (48 channels) checkpoint, and the JAX widening of its
    params into LarvaNet_w64 at --num_features 64."""
    jm = jax_get_model("LarvaNet")
    jm.parse_args(["--num_blocks", "1,1"])
    jm.prepare(is_training=False, scales=[SCALE])
    path = jm.save(str(tmp_path_factory.mktemp("narrow")))
    wide = jax_get_model("LarvaNet_w64")
    wide.parse_args(["--num_blocks", "1,1", "--num_features", "64"])
    wide.prepare(is_training=False, scales=[SCALE])
    widened = widen_params(jm.params, wide.params)
    return path, jm, state_dict_from_jax_params(_to_numpy(widened), "LarvaNet_w64")


def _wide_port(ckpt, **extra):
    m = get_model("LarvaNet_w64")
    m.parse_args(["--num_blocks", "1,1", "--num_features", "64"])
    m.prepare([SCALE], device="cpu", is_training=True, seed=5)
    common.maybe_widen_from(m, SimpleNamespace(widen_from=ckpt, **extra))
    return m


@pytest.mark.parametrize("source", ["ckpt", "pth"])
def test_widen_from_matches_jax_bit_for_bit(narrow_ckpt, tmp_path, source):
    """--widen_from a JAX .ckpt, or the same weights as the port's own .pth:
    the widened parameters equal JAX's widen_params on the same seed, bit
    for bit; the optimizer starts fresh."""
    path, jm, want = narrow_ckpt
    if source == "pth":
        narrow = get_model("LarvaNet")
        narrow.parse_args(["--num_blocks", "1,1"])
        narrow.prepare([SCALE], device="cpu")
        narrow.restore(path)
        path = narrow.save(str(tmp_path))
    m = _wide_port(path)
    got = m.module.state_dict()
    assert got.keys() == want.keys()
    for k in got:
        assert torch.equal(got[k], want[k]), k
    assert not m.optimizer.state


def test_widened_model_computes_the_narrow_function(narrow_ckpt):
    path, _, _ = narrow_ckpt
    narrow = get_model("LarvaNet")
    narrow.parse_args(["--num_blocks", "1,1"])
    narrow.prepare([SCALE], device="cpu")
    narrow.restore(path)
    wide = _wide_port(path)
    x = torch.from_numpy(np.random.default_rng(0).uniform(0, 255, (1, 9, 10, 3))
                         .astype(np.float32))
    got, want = wide.fwd_runtime(x), narrow.fwd_runtime(x)
    assert float((got - want).abs().max()) <= F32_ATOL


def test_widen_from_is_exclusive_and_refuses_another_topology(narrow_ckpt, tmp_path):
    path, _, _ = narrow_ckpt
    with pytest.raises(SystemExit, match="mutually exclusive"):
        _wide_port(path, restore_path="m.pth")
    (tmp_path / "orbax").mkdir()
    with pytest.raises(SystemExit, match="orbax"):
        _wide_port(str(tmp_path / "orbax"))
    m = get_model("LarvaNet_w64")
    m.parse_args(["--num_blocks", "2,1", "--num_features", "64"])
    m.prepare([SCALE], device="cpu")
    with pytest.raises(ValueError, match="same topology"):
        common.maybe_widen_from(m, SimpleNamespace(widen_from=path))


# ---- the tensor loader and the CLI -------------------------------------------------------

@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("flags_set"))
    rng = np.random.default_rng(9)
    for i in range(2):
        hr = rng.integers(0, 256, (3, 64, 80), dtype=np.uint8)
        lr = np.round(hr.reshape(3, 16, 4, 20, 4).mean((2, 4))).astype(np.uint8)
        io.save_image_chw(hr, os.path.join(root, "HR", "%04d.png" % i))
        io.save_image_chw(lr, os.path.join(root, "LR", "X4", "%04dx4.png" % i))
    return root


def test_tensor_loader_draws_jax_stream(train_root):
    """div2k_train_loader_tensor under the reference's path names: the
    port's NHWC batches equal JAX's loader's (--data_native 0 on both), bit
    for bit, over 3 re-seeded steps."""
    flags = ["--train_input_path", os.path.join(train_root, "LR"),
             "--train_truth_path", os.path.join(train_root, "HR"), "--data_seed", "7",
             "--data_native", "0"]
    jl = jax_get_loader("div2k_train_loader_tensor")
    jl.parse_args(flags)
    jl.prepare([SCALE])
    pl = get_loader("div2k_train_loader_tensor")
    _, left = pl.parse_args(flags)
    assert left == []
    pl.prepare([SCALE])
    for step in range(3):
        jl.reseed_for_step(step)
        pl.reseed_for_step(step)
        want = jl.get_patch_batch(2, SCALE, 6)
        got = pl.get_patch_batch(2, SCALE, 6)
        for g, w in zip(got, want):
            assert np.array_equal(np.asarray(g), np.asarray(w))


def test_train_cli_takes_the_new_flags(train_root, tmp_path):
    """train with --async_checkpoint 1 --profile_dir on the tensor loader:
    the checkpoints are on disk when main returns, the trace holds the
    loop's spans, and a --widen_from run starts from the narrow weights."""
    base = ["--dataloader", "div2k_train_loader_tensor", "--scales", "4", "--device", "cpu",
            "--data_input_path", os.path.join(train_root, "LR"),
            "--data_truth_path", os.path.join(train_root, "HR"), "--data_seed", "1",
            "--batch_size", "2", "--input_patch_size", "8", "--model", "edsr",
            "--edsr_res_blocks", "1", "--save_freq", "2"]
    path = str(tmp_path / "run")
    model, losses = train.main(base + ["--train_path", path, "--max_steps", "4",
                                       "--edsr_conv_features", "8", "--async_checkpoint", "1",
                                       "--profile_dir", str(tmp_path / "trace")])
    assert sorted(losses) == [1, 2, 3, 4]
    assert {"model_2.pth", "model_4.pth", "model_4.state.pt"} <= set(os.listdir(path))
    events = json.load(open(tmp_path / "trace" / profiling.TRACE_FILE))["traceEvents"]
    assert sum(e.get("name") == "train_step" for e in events) == 4
    wide, _ = train.main(base + ["--train_path", str(tmp_path / "wide"), "--max_steps", "0",
                                 "--edsr_conv_features", "16", "--widen_from",
                                 os.path.join(path, "model_4.pth")])
    w = wide.module.first_conv.weight.detach()
    assert torch.equal(w[:8], model.module.first_conv.weight.detach())
