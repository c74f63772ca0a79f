"""The port's IMDN (larvanet_tpu_torch/models/imdn.py) against the JAX
package's (larvanet_tpu/models/imdn.py, ops/packed/light.py), on the CPU,
at --num_filters 16 --num_blocks 2 (d = 4 distilled, r = 12 passed on): the
f32 forward at x2 / x3 / x4, odd and even widths, against JAX's module and,
at even widths, against `make_packed_imdn_forward` (JAX's inference CLIs'
default route); the bf16 forward against JAX's module graph in bf16, with
its distance to the packed bf16 forward printed; the converter and a
reference-layout `.pth`; the train step's loss and gradients against
jax.grad of JAX's `_compute_loss` (its module graph, and its packed graph
under --packed_trunk 1); the three slice copies a block; the CLIs' lines
for --int8_trunk and --wino_trunk; validate's PSNRs against JAX's validate.

Weights: the port's init, which crosses to JAX by the JAX package's
importer and back through the port's `state_dict_from_jax_params` (strict).
Errors are held relative to the largest value of the reference's output.
"""

import functools
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvanet_tpu.cli import common as jax_common
from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.ops.packed.light import make_packed_imdn_forward
from larvanet_tpu.utils import torch_convert as jax_convert
from larvanet_tpu.utils.torch_convert import export_state_dict, save_pth
from larvanet_tpu_torch.cli import common
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.models import imdn
from larvanet_tpu_torch.models.layers import DIV2K_RGB_MEAN
from larvanet_tpu_torch.utils.torch_convert import state_dict_from_jax_params
from test_torch_msrr import _lr, _to_numpy
from test_torch_msrr_train import _batch

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

SMALL = ["--num_filters", "16", "--num_blocks", "2"]
F32_RTOL = 2e-5     # of the reference's largest |y|
BF16_RTOL = 1.5e-2
GRAD_RTOL = 5e-5    # of each gradient tensor's largest |g|
LOSS_RTOL = 1e-5
VALIDATE_DB = 1e-4


@functools.lru_cache(maxsize=None)
def _models(scale=4, flags=(), is_training=False):
    """(JAX model, its parameters as numpy, the port's model with them), f32,
    on the CPU, without JAX's flax init."""
    pm = get_model("imdn_aim2019")
    pm.parse_args(SMALL + list(flags))
    pm.prepare([scale], device="cpu", is_training=is_training)
    state = {k: v.numpy() for k, v in pm.module.state_dict().items()}
    params = jax_convert.convert_state_dict(state, "imdn_aim2019")[0]
    pm.load_state_dict(state_dict_from_jax_params(params, "imdn_aim2019"))  # strict
    jm = jax_get_model("imdn_aim2019")
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


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_forward_matches_jax_module_and_packed_route(scale):
    """The f32 forward against JAX's module at an odd and an even width, and
    against make_packed_imdn_forward (even widths only, as in JAX)."""
    jm, params, pm = _models(scale)
    apply = jax.jit(lambda p, x: jm.module.apply({"params": p}, x))
    packed = jax.jit(make_packed_imdn_forward(jm, dtype=jnp.float32))
    for shape in ((2, 7, 9, 3), (1, 6, 8, 3)):
        x = _lr(shape, seed=shape[2] + scale)
        with torch.no_grad():
            got = pm.module(torch.from_numpy(x)).numpy()
        label = "imdn x%d %s" % (scale, shape)
        _hold(label + " vs module", got, np.asarray(apply(params, jnp.asarray(x))), F32_RTOL)
        if shape[2] % 2 == 0:
            _hold(label + " vs packed", got, np.asarray(packed(params, jnp.asarray(x))),
                  F32_RTOL)


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_bf16_forward_matches_jax_module(scale):
    """The bf16 serving forward (the module's bf16 copy) against JAX's module
    graph in bf16; its distance to JAX's packed bf16 forward is printed."""
    jm, params, pm = _models(scale)
    x = _lr((1, 6, 8, 3), seed=3 + scale)
    bf = jax.tree_util.tree_map(lambda a: jnp.asarray(a, jnp.bfloat16), params)
    apply = jax.jit(lambda p, x: jm.module.apply({"params": p}, x))
    want = np.asarray(apply(bf, jnp.asarray(x, jnp.bfloat16)), np.float32)
    packed = np.asarray(jax.jit(make_packed_imdn_forward(jm, dtype=jnp.bfloat16))(
        params, jnp.asarray(x)), np.float32)
    pm.set_serving_dtype("bf16")
    try:
        got = pm.fwd_runtime(torch.from_numpy(x)).numpy()
    finally:
        pm.set_serving_dtype("f32")
    _hold("imdn x%d bf16 vs JAX's bf16 module" % scale, got, want, BF16_RTOL)
    print("  bf16 vs JAX's packed bf16 forward: %.3g of its max"
          % (float(np.abs(got - packed).max()) / float(np.abs(packed).max())))


def test_converter_and_reference_pth(tmp_path):
    """`state_dict_from_jax_params` gives JAX's `export_state_dict` key for key
    and value for value (conv1.0 ... conv4.0, the 1x1 conv5, upsample.body.0,
    both MeanShifts); a reference-layout `.pth` restores strictly and serves
    JAX's module output."""
    jm, params, _ = _models()
    got = state_dict_from_jax_params(params, "imdn_aim2019")
    want = export_state_dict(params, "imdn_aim2019")
    assert sorted(got) == sorted(want)
    for key, value in want.items():
        assert np.array_equal(got[key].numpy(), np.asarray(value, np.float32)), key
    assert got["res_blocks.1.conv4.0.weight"].shape == (4, 12, 3, 3)
    assert got["res_blocks.0.conv5.weight"].shape == (16, 16, 1, 1)
    assert got["upsample.body.0.weight"].shape == (48, 16, 3, 3)
    path = str(tmp_path / "ref.pth")
    torch.save({k: torch.from_numpy(np.asarray(v, np.float32)) for k, v in want.items()}, path)
    pm = get_model("imdn_aim2019")
    pm.parse_args(list(SMALL))
    pm.prepare([4], device="cpu")
    pm.restore(path)  # strict
    x = _lr((1, 5, 6, 3), seed=8)
    with torch.no_grad():
        served = pm.module(torch.from_numpy(x)).numpy()
    _hold("imdn restored .pth", served,
          np.asarray(jax.jit(jm.module.apply)({"params": params}, jnp.asarray(x))), F32_RTOL)


def test_three_slice_copies_a_block():
    """rem1, rem2 and rem3 are copied (the conv kernel takes contiguous NHWC):
    three copies a block, counted."""
    _, _, pm = _models()
    imdn.reset_slice_copies()
    with torch.no_grad():
        pm.module(torch.from_numpy(_lr((1, 5, 6, 3))))
    assert imdn.SLICE_COPIES == 3 * 2


@pytest.mark.parametrize("flags", [(), ("--packed_trunk", "1")])
def test_train_step_matches_jax(flags):
    """The train step's loss and every gradient against jax.grad of JAX's
    `_compute_loss` on the same batch: its module graph, and under
    --packed_trunk 1 its packed graph (the same function); the port trains
    its module graph in both."""
    jm, _, pm = _models(4, flags, True)
    x, y = _batch(len(flags) + 11)
    want_loss, want_grads = jax.jit(jax.value_and_grad(jm._compute_loss))(
        jm.params, jnp.asarray(x), jnp.asarray(y))
    pm.module.zero_grad(set_to_none=True)
    loss = pm._compute_loss(torch.from_numpy(x), torch.from_numpy(y))
    loss.backward()
    want = state_dict_from_jax_params(_to_numpy(want_grads), "imdn_aim2019")
    rel = abs(float(loss.detach()) - float(want_loss)) / abs(float(want_loss))
    worst = (0.0, None)
    for key, p in pm.module.named_parameters():
        err = float((p.grad - want[key]).abs().max()) / float(want[key].abs().max())
        worst = max(worst, (err, key))
    print("train imdn %s: loss rel %.3g, worst gradient %.3g of its max (%s)"
          % (" ".join(flags), rel, *worst))
    assert rel <= LOSS_RTOL and worst[0] <= GRAD_RTOL


def test_int8_and_wino_lines_are_jax_s(capsys):
    """--int8_trunk: JAX's `no int8 path ...; ignoring` line, the exact route
    kept; --wino_trunk: JAX's line, the standard path."""
    jm, _, pm = _models()
    with pytest.raises(ValueError) as jax_err:
        jax_common.int8_and_exact_forwards(jm, "imdn_aim2019", None)
    capsys.readouterr()
    common.maybe_int8_trunk(pm, SimpleNamespace(int8_trunk=1, model="imdn_aim2019"),
                            lambda: _lr((1, 6, 8, 3)))
    assert capsys.readouterr().out == "--int8_trunk: %s; ignoring\n" % (jax_err.value,)
    common.maybe_wino_trunk(pm, SimpleNamespace(model="imdn_aim2019", wino_trunk=4))
    assert "running the standard path for 'imdn_aim2019'" in capsys.readouterr().out
    assert pm.route is None


def test_validate_matches_jax_validate(tmp_path):
    """IMDN through the validate CLI from a JAX-written `.pth` (JAX serves its
    packed forward there, the port its module): the mean PSNR within
    VALIDATE_DB of JAX's validate's."""
    from larvanet_tpu.cli import validate as jax_validate
    from larvanet_tpu_torch.cli import validate
    from larvanet_tpu_torch.data import io

    root = str(tmp_path)
    rng = np.random.default_rng(13)
    for i in range(2):
        hr = rng.integers(0, 256, (3, 32, 40), dtype=np.uint8)
        lr = np.round(hr.reshape(3, 8, 4, 10, 4).mean((2, 4))).astype(np.uint8)
        io.save_image_chw(hr, os.path.join(root, "HR", "%04d.png" % i))
        io.save_image_chw(lr, os.path.join(root, "LR", "X4", "%04dx4.png" % i))
    _, params, _ = _models()
    params = jax.tree_util.tree_map(np.array, params)
    # served frames around mid-grey, mostly inside [0, 255]: the shuffle's
    # channel c s^2 + i s + j is colour c, whose mean the inverse shift takes
    up = params["upsample_conv"]
    up["kernel"] *= 0.25
    up["bias"] += np.repeat(np.asarray(DIV2K_RGB_MEAN, np.float32), 16) + 128.0
    pth = save_pth(params, "imdn_aim2019", os.path.join(root, "m.pth"))
    argv = ["--model", "imdn_aim2019", "--scales", "4", "--restore_path", pth,
            "--data_input_path", os.path.join(root, "LR"),
            "--data_truth_path", os.path.join(root, "HR"), *SMALL]
    want = jax_validate.main(argv + ["--data_native", "0"])[4]
    got = validate.main(argv + ["--device", "cpu"])[4]
    print("validate imdn: port %.6f dB, JAX %.6f dB" % (got, want))
    assert abs(got - want) <= VALIDATE_DB
