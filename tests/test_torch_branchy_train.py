"""TreeNet and the REGOs in training against the JAX package, on the CPU,
at tests/test_torch_treenet.py's and tests/test_torch_rego.py's sizes: the
train step's loss and gradients against jax.grad of JAX's `_compute_loss`
(the LR-domain loss, the HR-domain loss, --remat 1, --qat 1), QAT's 'both'
pair on the same inputs; TreeNet's volume-driven steps (StepLR per batch,
no validation at step 1, `model_<step>` checkpoints), a resume bit for bit
with an uninterrupted run and a JAX `.ckpt` resume of the schedule. The
int8 forwards and the TreeNet CLIs are in tests/test_torch_branchy_cli.py.
"""

import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvanet_tpu.core.registry import get_loader as jax_get_loader
from larvanet_tpu.ops.packed import pairs as jpairs
from larvanet_tpu.ops.packed.core import grid1_mask, pack_w, unpack_w
from larvanet_tpu_torch.core.registry import get_loader, get_model
from larvanet_tpu_torch.data import io
from larvanet_tpu_torch.models.layers import exact_pair
from larvanet_tpu_torch.ops import pairs
from larvanet_tpu_torch.utils.torch_convert import state_dict_from_jax_params
from test_torch_msrr import _to_numpy
from test_torch_msrr_train import (LOSS_RTOL, QAT_FLIP_GRAD_RTOL, QAT_GRAD_RTOL, _batch,
                                   _train_models)

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

GRAD_RTOL = 2e-5  # JAX's XLA gradients sit ~1e-5 of their max from float64
TREE = ["--num_common_blocks", "2", "--num_branches", "2", "--num_branch_blocks", "1"]
REGO = ["--len_side", "3", "--num_filters", "16"]
SERIAL = REGO + ["--num_regos", "2"]


def _step_vs_jax(name, flags, bar, louder=True, jit=True):
    """The port's loss and gradients on one batch against jax.grad of JAX's
    `_compute_loss`, jitted (eager JAX takes ~10 s a step at these sizes)
    but for QAT: XLA's fused graph moves a weight's x / s off the clip's
    tie at +-127, where the eager graph and the port take its half
    gradient."""
    jm, pm = _train_models(name, tuple(flags), 4, louder)
    x, y = _batch(len(name))
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
        err = float((p.grad - want[key]).abs().max()) / float(want[key].abs().max())
        worst = max(worst, (err, key))
    print("train %s %s: loss rel %.3g, worst gradient %.3g of its max (%s)"
          % (name, " ".join(flags), rel, *worst))
    assert rel <= LOSS_RTOL and worst[0] <= bar


@pytest.mark.parametrize("name,flags", [
    ("TreeNet", TREE),                               # the branch mean, LR-domain loss
    ("TreeNet", TREE + ["--lr_domain_loss", "0"]),   # on the HR image
    ("REGO-Net", REGO),                              # 'both' pairs, the 384-wide fuse's kind
    ("REGO-serial", SERIAL + ["--remat", "1"]),      # the tuple through the checkpoint
])
def test_train_step_matches_jax(name, flags):
    """The train step's loss and every gradient against jax.grad of JAX's
    `_compute_loss` on the same batch."""
    _step_vs_jax(name, flags, GRAD_RTOL)


def test_qat_step_matches_jax():
    """--qat 1 against JAX's qat walk on TreeNet (both branches' pairs): the
    loss, and the gradients at the bar for flipped codes; REGO's 'both'
    pairs are held on the same inputs below."""
    _step_vs_jax("TreeNet", TREE + ["--qat", "1"], QAT_FLIP_GRAD_RTOL, louder=False, jit=False)


def test_rego_qat_step_matches_jax():
    """--qat 1 against JAX's qat walk on REGO-Net, every RESBlock a 'both'
    pair: the loss, and the gradients at the bar for flipped codes (none
    flips at this size; the worst sits ~1e-6 of its tensor's max).
    REGO-serial's second repeat flips one input code of RESB_1_1_0 here, a
    float summation order apart, so its pairs are held on the same inputs
    below."""
    _step_vs_jax("REGO-Net", REGO + ["--qat", "1"], QAT_FLIP_GRAD_RTOL, louder=False, jit=False)


def test_qat_both_pair_gradients_match_jax_on_the_same_inputs():
    """Every RESBlock of REGO-serial's QAT walk, on the input the port's walk
    gives it and random cotangents of both outputs: JAX's qat_pair(kind=
    "both") and the port's, the gradients of the input and of both convs
    within QAT_GRAD_RTOL of each tensor's max."""
    _, pm = _train_models("REGO-serial", tuple(SERIAL + ["--qat", "1"]), louder=False)
    x, _ = _batch(7)
    seen = []

    def cap(idx, hin, conv1, conv2, **k):
        seen.append((hin.detach().clone(), conv1, conv2, k))
        return exact_pair(idx, hin, conv1, conv2, **k)

    with torch.no_grad():
        pm.module.walk(torch.from_numpy(x), cap)
    assert len(seen) == 12 and all(k["kind"] == "both" for *_, k in seen)
    rng = np.random.default_rng(8)
    worst = 0.0
    for hin, conv1, conv2, k in seen:
        c = hin.shape[3]
        jparams = [{"kernel": jnp.asarray(conv.weight.detach().permute(2, 3, 1, 0).numpy()),
                    "bias": jnp.asarray(conv.bias.detach().numpy())} for conv in (conv1, conv2)]
        ct = [rng.standard_normal(tuple(hin.shape)).astype(np.float32) for _ in range(2)]

        def jf(h, p1, p2):
            hp = pack_w(h)
            m = grid1_mask(hp.shape[2] + 1, c, jnp.float32)
            t, out = jpairs.qat_pair(jnp.float32)(
                0, hp, p1, p2, m, act=lambda v: jax.nn.leaky_relu(v, 0.1), **k)
            return jnp.sum(unpack_w(t) * ct[0]) + jnp.sum(unpack_w(out) * ct[1])

        gh, g1, g2 = jax.grad(jf, argnums=(0, 1, 2))(jnp.asarray(hin.numpy()), *jparams)
        h = hin.clone().requires_grad_(True)
        for conv in (conv1, conv2):
            conv.zero_grad(set_to_none=True)
        t, out = pairs.qat_pair(torch.float32)(0, h, conv1, conv2, **k)
        ((t * torch.from_numpy(ct[0])).sum() + (out * torch.from_numpy(ct[1])).sum()).backward()
        for got, want in ((h.grad, gh), (conv1.weight.grad.permute(2, 3, 1, 0), g1["kernel"]),
                          (conv1.bias.grad, g1["bias"]),
                          (conv2.weight.grad.permute(2, 3, 1, 0), g2["kernel"]),
                          (conv2.bias.grad, g2["bias"])):
            want = np.asarray(want)
            err = float(np.abs(got.numpy() - want).max() / np.abs(want).max())
            worst = max(worst, err)
            assert err <= QAT_GRAD_RTOL, err
    print("qat both pairs: worst gradient on the same input %.3g of its max" % worst)


# ---- TreeNet's volume-driven steps ----

BATCH, PATCH = 2, 8
VOLUME_PER_STEP = PATCH * PATCH * BATCH * 3
VOLUME_FLAGS = TREE + ["--val_volume", str(3 * VOLUME_PER_STEP), "--lr_step", "2"]
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


def _loaders(root):
    out = []
    for side, loader in (("jax", jax_get_loader("div2k_val_loader")),
                         ("port", get_loader("div2k_val_loader"))):
        loader.parse_args(["--data_input_path", os.path.join(root, "LR"),
                           "--data_truth_path", os.path.join(root, "HR")]
                          + (["--data_native", "0"] if side == "jax" else []))
        loader.prepare([4])
        out.append(loader)
    return out


def _run_steps(model, loader, path, steps):
    """train_step_larva over `steps` batches; returns the validations (step,
    PSNR) and (step, lr, temp and total volume) after each step."""
    validations, record = [], []
    orig = model.validate_for_train

    def validate(args, dl):
        psnr = orig(args, dl)
        validations.append((model.global_step, psnr))
        return psnr

    model.validate_for_train = validate
    model.volume_per_step = VOLUME_PER_STEP
    for step in steps:
        x, y = _batch(step)
        chw = lambda a: list(a.transpose(0, 3, 1, 2))  # noqa: E731
        model.train_step_larva(SimpleNamespace(train_path=path), loader, chw(x), chw(y))
        record.append((model.global_step, model.get_learning_rate(), model.temp_volume,
                       model.total_volume))
    return validations, record


def test_treenet_volume_steps_match_jax_and_resume(div2k_root, tmp_path):
    """train_step_larva on both sides from the same weights and batches: the
    StepLR's lr after each batch, the steps that validate (none at step 1),
    the PSNRs, the volumes and the checkpoints' names (model_<step>); then a
    port resume from its step-3 checkpoint equals the uninterrupted run bit
    for bit, and a training restore of JAX's step-6 `.ckpt` takes its
    schedule."""
    jm, pm = _train_models("TreeNet", tuple(VOLUME_FLAGS), louder=False)
    jax_loader, port_loader = _loaders(div2k_root)
    jv, js = _run_steps(jm, jax_loader, str(tmp_path / "jax"), range(STEPS))
    pv, ps = _run_steps(pm, port_loader, str(tmp_path / "port"), range(STEPS))
    print("TreeNet validations: port %s, JAX %s" % (pv, jv))
    assert [s for s, _ in pv] == [s for s, _ in jv] == [3, 6]
    assert all(abs(a - b) <= 1e-3 for (_, a), (_, b) in zip(pv, jv))
    assert ps == js
    assert [s[1] for s in ps] == [4e-4, 2e-4, 2e-4, 1e-4, 1e-4, 5e-5]
    assert sorted(os.listdir(tmp_path / "jax")) == ["model_3.ckpt", "model_6.ckpt"]
    assert sorted(os.listdir(tmp_path / "port")) == [
        "model_3.pth", "model_3.state.pt", "model_6.pth", "model_6.state.pt"]

    resumed = get_model("TreeNet")
    resumed.parse_args(list(VOLUME_FLAGS))
    resumed.prepare([4], device="cpu", is_training=True)
    resumed.restore(str(tmp_path / "port" / "model_3.pth"))
    assert resumed.global_step == 3 and resumed.scheduler.last_epoch == 3
    _run_steps(resumed, port_loader, str(tmp_path / "resumed"), range(3, STEPS))
    for (key, a), b in zip(pm.module.state_dict().items(), resumed.module.state_dict().values()):
        assert torch.equal(a, b), key
    assert resumed.scheduler == pm.scheduler

    from_jax = get_model("TreeNet")
    from_jax.parse_args(list(VOLUME_FLAGS))
    from_jax.prepare([4], device="cpu", is_training=True)
    from_jax.restore(str(tmp_path / "jax" / "model_6.ckpt"))
    assert from_jax.global_step == 6 and from_jax.scheduler == pm.scheduler
    assert from_jax.get_learning_rate() == jm.get_learning_rate()
