"""Quantization-aware training (--qat 1) of the port (ops/pairs.qat_pair through
the EDSR and LarvaNet pair walks) against the JAX package's
(make_packed_edsr_train_forward(qat=True), make_packed_larvanet_forward(
all_exits=True, qat=True)), on the CPU, at tiny widths.

Every QAT pair of a model, given the same input and output gradient (the
pair inputs the port's walk captures), gives JAX's gradients within 2e-4 of
each tensor's largest |g| (the card's GRAD_RTOL). The whole model's loss is
held within 1e-5 relative of JAX's. Its gradients are not held at 2e-4:
the two forwards sum their convs in another order, a fake-quant code that
lands on the other side of a rounding boundary moves the next pair's batch
maximum, and with it the scale of every code after it (EDSR 3 x 16 here: 1
flipped input code at pair 1, then 31 at pair 2, whose scale moved by
1.5e-4), which moves the gradients as ReLU flips do: up to 7.7e-3 of a
tensor's max. LarvaNetV2 at its init (zero biases) flips no input code but
moves body_0's first conv's gradients by 1.9e-2 of their max: with equal
integer codes, a conv_a sum whose integers cancel is 0 on one side and a
rounding residue on the other, which flips its ReLU. Those two
configurations (FLIPPED) are held at FLIP_GRAD_RTOL; every other one flips
nothing and is held at GRAD_RTOL. The gradients are printed beside the
flipped input codes. Inputs come from numpy seeds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.ops.packed import pairs as jpairs
from larvanet_tpu.ops.packed.core import unpack_w
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.models.layers import exact_pair
from larvanet_tpu_torch.ops import int8_forward, pairs
from larvanet_tpu_torch.utils.torch_convert import state_dict_from_jax_params

LOSS_RTOL = 1e-5
GRAD_RTOL = 2e-4  # a pair's gradients on the same input
FLIP_GRAD_RTOL = 5e-2  # the whole model's, where codes flip (the module docstring)
# the configurations whose whole-model gradients move with a flip, and their
# readings on the CPU: worst gradient error of its max, flipped input codes
FLIPPED = {"edsr": (7.65e-3, 32), "LarvaNetV2": (1.86e-2, 0)}
EDSR_FLAGS = ["--edsr_res_blocks", "3", "--edsr_conv_features", "16"]
LARVA_FLAGS = ["--num_blocks", "1,2"]


def _to_numpy(tree):
    if hasattr(tree, "items"):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.array(tree)


@functools.lru_cache(maxsize=None)
def _models(name):
    """(JAX model, its parameters as numpy, port model) with --qat 1."""
    flags = (EDSR_FLAGS if name.startswith("edsr") else LARVA_FLAGS) + ["--qat", "1"]
    jm = jax_get_model(name)
    jm.parse_args(list(flags))
    jm.prepare(is_training=True, scales=[4])
    params = _to_numpy(jm.params)
    pm = get_model(name)
    pm.parse_args(list(flags))
    pm.prepare([4], device="cpu", is_training=True)
    pm.load_state_dict(state_dict_from_jax_params(params, name))
    return jm, params, pm


def _batch(seed, w=12):
    rng = np.random.default_rng(seed)
    x = rng.uniform(0, 255, (2, 10, w, 3)).astype(np.float32)
    y = rng.uniform(0, 255, (2, 40, 4 * w, 3)).astype(np.float32)
    return x, y


def _jax_qat(name, jm):
    """JAX's QAT training walk (params, x, pair) and how its outputs make
    the loss."""
    if name.startswith("edsr"):
        from larvanet_tpu.ops.packed.edsr import _edsr_walk
        return _edsr_walk(jm, jnp.float32, "live_plain"), lambda outs: [outs]
    from larvanet_tpu.ops.packed.larvanet import _larvanet_walk
    return _larvanet_walk(jm, jnp.float32, all_exits=True), lambda outs: list(outs)


def _port_walk(name, pm):
    """The port's training walk: walk(x, pair)."""
    if name.startswith("edsr"):
        return pm.module
    return lambda x, pair: pm.module.walk(x, "all", pair)


def _codes(h):
    s = np.float32(float(np.abs(h).max()) * 1.05 / 127.0 + 1e-12)
    return np.rint(np.clip(h / s, -127.0, 127.0))


def _flipped_codes(name, jm, pm, x):
    """Every QAT pair's input, captured on both sides and fake-quantized
    with its own batch scale: the codes that differ."""
    jwalk, _ = _jax_qat(name, jm)
    jseen, pseen = {}, {}
    jq, pq = jpairs.qat_pair(jnp.float32), pairs.qat_pair(torch.float32)

    def key(seen, idx):
        # the body pairs and the serving leg by index; the other legs (-1)
        # in their order (JAX runs them after every body, the port after
        # their own)
        return idx if idx >= 0 else ("leg", sum(1 for k in seen if isinstance(k, tuple)))

    def jcap(idx, hin, *a, **k):
        jseen[key(jseen, idx)] = np.array(unpack_w(hin))
        return jq(idx, hin, *a, **k)

    def pcap(idx, hin, *a, **k):
        pseen[key(pseen, idx)] = hin.detach().numpy().copy()
        return pq(idx, hin, *a, **k)

    jwalk(jm.params, jnp.asarray(x), jcap)
    with torch.no_grad():
        _port_walk(name, pm)(torch.from_numpy(x), pcap)
    assert sorted(map(str, jseen)) == sorted(map(str, pseen))
    flips = sum(int((_codes(a) != _codes(pseen[k])).sum()) for k, a in jseen.items())
    return flips, sum(a.size for a in jseen.values())


@pytest.mark.parametrize("name", ["edsr", "edsr_loss", "LarvaNet", "LarvaNetV2"])
def test_qat_loss_and_gradients_match_jax(name):
    jm, params, pm = _models(name)
    x, y = _batch(len(name))
    walk, outs_of = _jax_qat(name, jm)
    pair = jpairs.qat_pair(jnp.float32)

    def one(o):
        d = jnp.abs(o - jnp.asarray(y))
        # edsr_loss: the robust sqrt loss (reference models/edsr_loss.py:35-37)
        return jnp.mean((d + 1e-5) ** 0.5) if name == "edsr_loss" else jnp.mean(d)

    def jloss(p):
        losses = [one(o) for o in outs_of(walk(p, jnp.asarray(x), pair))]
        return sum(losses) / len(losses)

    want_loss, want_grads = jax.value_and_grad(jloss)(jm.params)
    pm.module.zero_grad(set_to_none=True)
    loss = pm._compute_loss(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    rel = abs(float(loss.detach()) - float(want_loss)) / abs(float(want_loss))
    flips, total = _flipped_codes(name, jm, pm, x)
    want = state_dict_from_jax_params(_to_numpy(want_grads), name)
    bar = FLIP_GRAD_RTOL if name in FLIPPED else GRAD_RTOL
    worst = 0.0
    for key, p in pm.module.named_parameters():
        g, w = p.grad, want[key]
        scale = float(w.abs().max())
        err = float((g - w).abs().max()) / max(scale, 1e-30)
        worst = max(worst, err)
        assert err <= bar, (key, err, flips)
    print("qat %s: loss rel %.3g, worst gradient %.3g of its max, %d of %d input codes "
          "flipped" % (name, rel, worst, flips, total))
    assert rel <= LOSS_RTOL
    if name not in FLIPPED:
        assert flips == 0


@pytest.mark.parametrize("name", ["edsr", "LarvaNet_1c", "LarvaNetV2"])
def test_qat_pair_gradients_match_jax_on_the_same_inputs(name):
    """Every pair of the model's QAT walk, on the input the port's walk gives
    it and one random output gradient: JAX's qat_pair (packed) and the
    port's, their gradients of the input and of both convs' kernels and
    biases within GRAD_RTOL of each tensor's max."""
    from larvanet_tpu.ops.packed.core import grid1_mask, pack_w
    _, _, pm = _models(name)
    x, _ = _batch(7)
    seen = []

    def cap(idx, hin, conv1, conv2, **k):
        seen.append((hin.detach().clone(), conv1, conv2, k))
        return exact_pair(idx, hin, conv1, conv2, **k)

    with torch.no_grad():
        _port_walk(name, pm)(torch.from_numpy(x), cap)
    rng = np.random.default_rng(8)
    worst = 0.0
    for hin, conv1, conv2, k in seen:
        c = hin.shape[3]
        jparams = [{"kernel": jnp.asarray(conv.weight.detach().permute(2, 3, 1, 0).numpy()),
                    "bias": jnp.asarray(conv.bias.detach().numpy())} for conv in (conv1, conv2)]
        out_shape = hin.shape[:3] + (conv2.weight.shape[0],)
        ct = rng.standard_normal(out_shape).astype(np.float32)

        def jf(h, p1, p2):
            hp = pack_w(h)
            m = grid1_mask(hp.shape[2] + 1, c, jnp.float32)
            out = jpairs.qat_pair(jnp.float32)(0, hp, p1, p2, m, **k)
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
            assert err <= GRAD_RTOL, err
    print("qat %s: %d pairs, worst gradient on the same input %.3g of its max"
          % (name, len(seen), worst))


def test_qat_matches_int8_serving_edsr():
    """The QAT forward on a batch equals the int8 forward calibrated on that
    batch (the same scales by construction) up to the float emulation's
    rounding (tests/test_qat.py:36-76)."""
    _, _, pm = _models("edsr")
    x, _ = _batch(3)
    with torch.no_grad():
        qat = pm.module(torch.from_numpy(x), pairs.qat_pair(torch.float32))
        int8 = int8_forward.make_int8_edsr_forward(pm, x, torch.float32)(torch.from_numpy(x))
    err = float((qat - int8).abs().max())
    scale = float(int8.abs().max())
    print("qat vs int8 serving, same batch: max|d| %.3g of %.3g" % (err, scale))
    assert err <= 2e-2 * max(scale, 1.0)


def test_qat_differs_from_exact():
    """Fake-quant must quantize (a guard against a silent no-op)."""
    _, _, pm = _models("edsr")
    x, _ = _batch(4)
    with torch.no_grad():
        exact = pm.module(torch.from_numpy(x))
        quant = pm.module(torch.from_numpy(x), pairs.qat_pair(torch.float32))
    assert float((exact - quant).abs().max()) > 1e-4


def test_qat_refuses_odd_width_and_packed_trunk_0():
    _, _, pm = _models("edsr")
    x, y = _batch(5, w=11)
    with pytest.raises(ValueError, match="even patch width"):
        pm._compute_loss(torch.from_numpy(x), torch.from_numpy(y))
    for name in ("edsr", "LarvaNet"):
        m = get_model(name)
        m.parse_args((EDSR_FLAGS if name == "edsr" else LARVA_FLAGS)
                     + ["--qat", "1", "--packed_trunk", "0"])
        with pytest.raises(ValueError, match="requires --packed_trunk 1"):
            m.prepare([4], device="cpu", is_training=True)
        m.prepare([4], device="cpu", is_training=False)  # serving is not refused


def test_qat_trains_every_pair_with_a_nonzero_gradient():
    _, _, pm = _models("LarvaNet")
    x, y = _batch(6)
    pm.module.zero_grad(set_to_none=True)
    pm._compute_loss(torch.from_numpy(x), torch.from_numpy(y)).backward()
    for key, p in pm.module.named_parameters():
        assert bool(torch.isfinite(p.grad).all()), key
        if key.endswith("weight") and ("res_blocks" in key or "leg" in key):
            assert float(p.grad.abs().max()) > 0.0, key
