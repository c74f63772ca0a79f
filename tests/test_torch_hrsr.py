"""The port's HRSR family (larvanet_tpu_torch/models/hrsr.py) against the JAX
package's (larvanet_tpu/models/hrsr.py, ops/packed/branchy.py), on the CPU,
at --num_lr_blocks 2 --num_hr_blocks 1: the forwards of hrsr (3-channel HR
blocks; --num_hr_filters 8 with --hr_filter_size 5 and 4, which run on the
conv_kxk kernel with XLA's SAME pads and add final_conv), hrsr_ and hrsr_c3
(--res_weight 0.5 on its 3-channel HR block) against JAX's module and its
default `make_packed_hrsr_forward`, in f32 and bf16; the converter against
JAX's `export_state_dict` and a reference-layout `.pth` restored strictly;
the train step's loss and gradients against jax.grad of JAX's
`_compute_loss` (the packed walk, --packed_trunk 0, --remat 1, --qat 1);
`make_int8_hrsr_forward` against JAX's; and hrsr's plateau scheduler, its
flags, and its state across save and restore (a JAX `.ckpt`'s too). The
train_schedule CLI that steps it is in tests/test_torch_schedule_cli.py.

The port's init, louder than drawn (every kernel times KERNEL_GAIN, every
bias from N(0, 1): the family's 0.1-scaled init and zero biases leave the
output's residual over its bilinear base small), crosses to JAX by JAX's
importer and back through the port's `state_dict_from_jax_params`; errors
are held relative to the largest value of that residual.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.ops.packed.branchy import make_int8_hrsr_forward as jax_int8_hrsr
from larvanet_tpu.ops.packed.branchy import make_packed_hrsr_forward
from larvanet_tpu.ops.resize import upsample
from larvanet_tpu.utils import torch_convert as jax_convert
from larvanet_tpu.utils.torch_convert import export_state_dict
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.models.layers import ConvKxK
from larvanet_tpu_torch.ops import conv_kxk, pairs
from larvanet_tpu_torch.ops.int8_forward import make_int8_hrsr_forward
from larvanet_tpu_torch.utils.torch_convert import state_dict_from_jax_params
from test_torch_msrr import BF16_RTOL, F32_RTOL, _hold, _lr, _to_numpy
from test_torch_msrr_train import (FWD_PSNR_DB, LOSS_RTOL, QAT_FLIP_GRAD_RTOL, _batch,
                                   _closure, _psnr)

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

SMALL = ["--num_lr_blocks", "2", "--num_hr_blocks", "1"]
CONFIGS = {
    "hrsr": ("hrsr", []),
    "hrsr K5": ("hrsr", ["--num_hr_filters", "8", "--hr_filter_size", "5"]),
    "hrsr K4": ("hrsr", ["--num_hr_filters", "8", "--hr_filter_size", "4"]),
    "hrsr_": ("hrsr_", []),
    "hrsr_c3": ("hrsr_c3", ["--res_weight", "0.5"]),
}
KERNEL_GAIN = 2.0
GRAD_RTOL = 2e-5  # JAX's XLA gradients sit ~1e-5 of their max from float64
SELF_CALIB_MARGIN_DB = 10.0


def _jax_model(name, flags, scale=4, is_training=False, params=None):
    """A JAX model with `params`, its scale and its module, without its flax
    init."""
    jm = jax_get_model(name)
    jm.parse_args(SMALL + list(flags))
    jm.scale, jm.scale_list, jm.is_training = scale, [scale], is_training
    jm.module = jm.build_module()
    if is_training and hasattr(jm, "default_min_lr"):
        from larvanet_tpu.train.schedules import ReduceLROnPlateau

        a = jm.args  # HRSR.prepare's scheduler (hrsr.py:163-169)
        jm.lr_scheduler = ReduceLROnPlateau(lr=a.lr, factor=a.lr_decay, patience=1,
                                            cooldown=int(a.cooldown), threshold=a.threshold,
                                            min_lr=a.min_lr, mode="max")
    if params is not None:
        jm.params = jax.tree_util.tree_map(jnp.asarray, params)
    return jm


@functools.lru_cache(maxsize=None)
def _models(config, scale=4, extra=(), is_training=False):
    """(JAX model, its parameters as numpy, the port's model with them), f32,
    on the CPU: the port's init, every kernel times KERNEL_GAIN and every
    bias from N(0, 1), crossed to JAX by convert_state_dict and loaded back
    strictly through state_dict_from_jax_params."""
    name, flags = CONFIGS[config]
    flags = list(flags) + list(extra)
    pm = get_model(name)
    pm.parse_args(SMALL + flags)
    pm.prepare([scale], device="cpu", is_training=is_training)
    rng = np.random.default_rng(len(config) + scale)
    state = {k: (rng.normal(0.0, 1.0, v.shape) if k.endswith(".bias")
                 else v.numpy() * KERNEL_GAIN).astype(np.float32)
             for k, v in pm.module.state_dict().items()}
    params = jax_convert.convert_state_dict(state, name)[0]
    pm.load_state_dict(state_dict_from_jax_params(params, name))  # strict
    return _jax_model(name, flags, scale, is_training, params), params, pm


def _base(x, scale):
    return np.asarray(upsample(jnp.asarray(x), scale, "bilinear"))


@pytest.mark.parametrize("config,scale", [(c, 4) for c in CONFIGS] + [("hrsr", 2),
                                                                       ("hrsr K5", 3)])
def test_forward_matches_jax_module_and_default_route(config, scale):
    """The f32 forward against JAX's module and its default serving route
    make_packed_hrsr_forward, at an odd and an even width."""
    jm, params, pm = _models(config, scale)
    apply = jax.jit(lambda p, x: jm.module.apply({"params": p}, x))
    packed = jax.jit(make_packed_hrsr_forward(jm, dtype=jnp.float32))
    for shape in ((2, 5, 7, 3), (1, 6, 8, 3)):
        x = _lr(shape, seed=shape[2] + scale)
        want = np.asarray(apply(params, jnp.asarray(x)))
        residual = want - _base(x, scale)
        with torch.no_grad():
            got = pm.module(torch.from_numpy(x)).numpy()
        label = "%s x%d %s" % (config, scale, shape)
        _hold(label + " vs module", got, want, residual, F32_RTOL)
        _hold(label + " vs packed", got, np.asarray(packed(params, jnp.asarray(x))),
              residual, F32_RTOL)


def test_hr_blocks_of_other_sizes_run_conv_kxk_with_xla_pads():
    """--hr_filter_size 5 and 4 make both convs of every HR block ConvKxKs
    with XLA's SAME pads (4: one above and left, two below and right), and
    the forward calls conv_kxk twice a block."""
    calls = []
    real = conv_kxk.conv_kxk

    def spy(x, kernel, bias=None, pads=None, dgrad=False):
        calls.append((tuple(kernel.shape), tuple(pads)))
        return real(x, kernel, bias, pads, dgrad)

    for config, k, pads in (("hrsr K5", 5, (2, 2, 2, 2)), ("hrsr K4", 4, (1, 2, 1, 2))):
        _, _, pm = _models(config)
        blk = pm.module.hr_res_blocks[0]
        assert all(isinstance(blk.body[i], ConvKxK) and blk.body[i].pads == pads
                   for i in (0, 2))
        calls.clear()
        conv_kxk.conv_kxk = spy
        try:
            with torch.no_grad():
                pm.module(torch.from_numpy(_lr((1, 4, 6, 3))))
        finally:
            conv_kxk.conv_kxk = real
        assert calls == [((k, k, 8, 8), pads)] * 2


@pytest.mark.parametrize("config", ["hrsr", "hrsr K5", "hrsr_c3"])
def test_bf16_forward_matches_jax(config):
    """The bf16 serving forward against JAX's bf16 packed forward, within
    BF16_RTOL of the residual's largest value."""
    jm, params, pm = _models(config)
    x = _lr((1, 6, 8, 3), seed=3)
    want = np.asarray(jax.jit(make_packed_hrsr_forward(jm, dtype=jnp.bfloat16))(
        params, jnp.asarray(x))).astype(np.float32)
    pm.set_serving_dtype("bf16")
    try:
        got = pm.fwd_runtime(torch.from_numpy(x)).numpy()
    finally:
        pm.set_serving_dtype("f32")
    _hold("%s bf16" % config, got, want, want - _base(x, 4), BF16_RTOL)


@pytest.mark.parametrize("config", ["hrsr K5", "hrsr_c3"])
def test_converter_and_reference_pth(config, tmp_path):
    """`state_dict_from_jax_params` gives JAX's `export_state_dict` key for
    key and value for value (lr_res_blocks / hr_res_blocks, middle_conv,
    final_conv where there is one, no MeanShift); a reference-layout `.pth`
    restores strictly and serves JAX's output."""
    jm, params, _ = _models(config)
    name, flags = CONFIGS[config]
    want = export_state_dict(params, name)
    got = state_dict_from_jax_params(params, name)
    assert sorted(got) == sorted(want)
    assert ("final_conv.weight" in got) == (config == "hrsr K5")
    assert got["hr_res_blocks.0.body.2.weight"].shape == ((8, 8, 5, 5) if config == "hrsr K5"
                                                          else (3, 3, 3, 3))
    for key, value in want.items():
        assert np.array_equal(got[key].numpy(), np.asarray(value, np.float32)), key
    path = str(tmp_path / "ref.pth")
    torch.save({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in want.items()}, path)
    pm = get_model(name)
    pm.parse_args(SMALL + flags)
    pm.prepare([4], device="cpu")
    pm.restore(path)  # strict
    x = _lr((1, 5, 6, 3), seed=8)
    with torch.no_grad():
        served = pm.module(torch.from_numpy(x)).numpy()
    expect = np.asarray(jm.module.apply({"params": params}, jnp.asarray(x)))
    _hold("%s restored .pth" % config, served, expect, expect - _base(x, 4), F32_RTOL)


# ---- training ----

def _step_vs_jax(config, extra, bar, jit=True):
    """The port's loss and gradients on one batch against jax.grad of JAX's
    `_compute_loss`, jitted but for QAT (eager: XLA's fused graph moves a
    weight's x / s off the clip's tie at +-127)."""
    jm, _, pm = _models(config, 4, tuple(extra), True)
    name = CONFIGS[config][0]
    x, y = _batch(len(config) + len(extra))
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
          % (config, " ".join(extra), rel, *worst))
    assert rel <= LOSS_RTOL and worst[0] <= bar


@pytest.mark.parametrize("config,extra", [
    ("hrsr", []),                          # the LR pairs through the walk
    ("hrsr K5", ["--remat", "1"]),         # ConvKxKTrain's gradients; the pairs recomputed
    ("hrsr_c3", []),                       # res_weight on both sides of the shuffle
    ("hrsr", ["--packed_trunk", "0"]),     # the module graph
])
def test_train_step_matches_jax(config, extra):
    """The train step's loss and every gradient against jax.grad of JAX's
    `_compute_loss` on the same batch (HRSR's loss is on the HR image)."""
    _step_vs_jax(config, extra, GRAD_RTOL)


def test_qat_step_matches_jax():
    """--qat 1 on hrsr_c3's LR pairs against JAX's qat walk taken by eager
    jax.grad: the loss, and the gradients at the bar for flipped codes."""
    _step_vs_jax("hrsr_c3", ["--qat", "1"], QAT_FLIP_GRAD_RTOL, jit=False)


@pytest.mark.parametrize("config", ["hrsr", "hrsr_c3"])
def test_int8_forward_matches_jax(config):
    """make_int8_hrsr_forward in f32 against JAX's int8 forward: with JAX's
    records in its runner at FWD_PSNR_DB, calibrated on its own within
    SELF_CALIB_MARGIN_DB of that or of its distance to the exact forward;
    the HR part exact."""
    jm, _, pm = _models(config)
    calib, x = _lr((2, 10, 12, 3), seed=5), _lr((1, 8, 10, 3), seed=6)
    jfwd = jax_int8_hrsr(jm, calib, dtype=jnp.float32)
    want = np.asarray(jfwd(jm.params, jnp.asarray(x)))
    fwd = make_int8_hrsr_forward(pm, calib, torch.float32)
    got = fwd(torch.from_numpy(x)).numpy()
    quant = [{k: (np.asarray(v) if not isinstance(v, float) else v) for k, v in q.items()}
             for q in _closure(_closure(jfwd, "pair_int8"), "quant")]
    assert len(quant) == len(fwd.runner.quant) == 2
    scales = max(abs(getattr(p, k) - q[k]) / q[k] for p, q in zip(fwd.runner.quant, quant)
                 for k in ("s_in", "s_mid"))
    fwd.runner.quant[:] = pairs.load_jax_records(quant, torch.float32, "cpu", "relu")
    same = fwd(torch.from_numpy(x)).numpy()
    with torch.no_grad():
        exact = pm.module(torch.from_numpy(x)).numpy()
    print("int8 %s vs JAX: PSNR %.1f dB, with JAX's records %.1f dB; int8 vs exact %.1f dB; "
          "activation scales within %.3g of JAX's"
          % (config, _psnr(got, want), _psnr(same, want), _psnr(got, exact), scales))
    assert _psnr(same, want) >= FWD_PSNR_DB and scales <= 1e-5
    assert _psnr(got, want) >= min(FWD_PSNR_DB, _psnr(got, exact) + SELF_CALIB_MARGIN_DB)
    assert float(np.abs(got - exact).max()) > 1e-3  # it does quantize


# ---- the plateau scheduler ----

@pytest.mark.parametrize("name,min_lr", [("hrsr", 1e-5), ("hrsr_", 0.0)])
def test_plateau_scheduler_flags_and_sequence(name, min_lr):
    """hrsr's and hrsr_'s ReduceLROnPlateau (patience 1, mode max, --lr_decay,
    --threshold, --min_lr, --cooldown) against JAX's model's on one PSNR
    series: the lr after every step equal; none for evaluation or hrsr_c3,
    whose lr is the step decay."""
    flags = ["--lr", "0.004", "--cooldown", "1", "--threshold", "0.01"]
    series = [20.0, 20.5, 20.505, 20.4, 20.3, 20.2, 21.0, 20.0, 19.0, 18.0, 17.0, 16.0]
    jm = jax_get_model(name)
    jm.parse_args(SMALL + flags)
    jm.prepare(is_training=True, scales=[4])
    pm = get_model(name)
    pm.parse_args(SMALL + flags)
    pm.prepare([4], device="cpu", is_training=True)
    assert pm.lr_scheduler.min_lr == min_lr and pm.optimizer_kind == "adamw"
    got, want = [], []
    for psnr in series:
        jm.lr_scheduler.step(psnr)
        pm.lr_scheduler.step(psnr)
        got.append(pm.get_learning_rate())
        want.append(jm.get_learning_rate())
    print("plateau %s: %s" % (name, got))
    assert got == want and got[-1] < got[0]
    pm.prepare([4], device="cpu")
    assert pm.lr_scheduler is None and pm.get_learning_rate() == 0.004
    c3 = get_model("hrsr_c3")
    c3.parse_args(SMALL + ["--learning_rate_decay_steps", "2"])
    c3.prepare([4], device="cpu", is_training=True)
    c3.global_step = 5
    assert getattr(c3, "lr_scheduler", None) is None and c3.get_learning_rate() == 2.5e-5


def test_scheduler_state_survives_save_and_restore(tmp_path):
    """hrsr's plateau state in the training state file: a restore gives the
    same best, bad-epoch count and lr; a training restore of JAX's `.ckpt`
    takes JAX's scheduler."""
    flags = ["--lr", "0.004"]
    pm = get_model("hrsr")
    pm.parse_args(SMALL + flags)
    pm.prepare([4], device="cpu", is_training=True)
    for psnr in (20.0, 19.0, 18.0):
        pm.lr_scheduler.step(psnr)
    pm.global_step = 7
    path = pm.save(str(tmp_path / "port"))
    back = get_model("hrsr")
    back.parse_args(SMALL + flags)
    back.prepare([4], device="cpu", is_training=True)
    back.restore(path)
    assert back.lr_scheduler == pm.lr_scheduler and back.get_learning_rate() == 0.002
    assert back.global_step == 7

    jm = jax_get_model("hrsr")
    jm.parse_args(SMALL + flags)
    jm.prepare(is_training=True, scales=[4])
    for psnr in (20.0, 21.0, 20.0, 19.0, 18.0, 17.0):
        jm.lr_scheduler.step(psnr)
    jm.global_step = 9
    ckpt = jm.save(str(tmp_path / "jax"))
    from_jax = get_model("hrsr")
    from_jax.parse_args(SMALL + flags)
    from_jax.prepare([4], device="cpu", is_training=True)
    from_jax.restore(ckpt)
    assert from_jax.global_step == 9
    assert from_jax.lr_scheduler.state_dict() == jm.lr_scheduler.state_dict()
    assert from_jax.get_learning_rate() == jm.get_learning_rate() == 0.001
