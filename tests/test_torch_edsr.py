"""The port's EDSR (larvanet_tpu_torch/models/edsr.py) against the JAX
package's EDSRModule, at a tiny width, on the CPU.

The JAX parameters cross over through the port's own
`state_dict_from_jax_params` into a strict `load_state_dict`; inputs are
made with numpy from a seed and fed to both.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.ops.fastpath import build_fast_forward
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.models.edsr import EDSRModule
from larvanet_tpu_torch.utils.torch_convert import state_dict_from_jax_params

TINY = ["--edsr_res_blocks", "2", "--edsr_conv_features", "8"]
# f32 on [0, 255] outputs: the plain graphs differ only in summation order
# through 7 convs, about 1e-5 of values up to a few hundred.
ATOL = 2e-4
# The JAX fast path (width-packed trunk + collapsed tail) composes the
# upsample convs and the final conv into one precomputed linear map: the
# same function with another order of f32 rounding, which the JAX package
# itself holds to its module graph at atol 0.1 (tests/test_collapsed_tail.py).
FAST_ATOL = 0.1


def _jax_model(scale):
    m = jax_get_model("edsr")
    m.parse_args(list(TINY))
    m.prepare(is_training=False, scales=[scale])
    return m


def _port_model(scale, jax_model):
    m = get_model("edsr")
    m.parse_args(list(TINY))
    m.prepare([scale], device="cpu")
    m.load_state_dict(state_dict_from_jax_params(_to_numpy(jax_model.params), "edsr"))
    return m


def _to_numpy(tree):
    if hasattr(tree, "items"):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _check(name, got, want, atol):
    print("parity %s: max|d| %.3g" % (name, np.abs(got - want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def _lr(shape=(2, 11, 13, 3), seed=0):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


@pytest.mark.parametrize("scale", [2, 3, 4])
def test_forward_matches_jax_module(scale):
    jm = _jax_model(scale)
    pm = _port_model(scale, jm)
    x = _lr()
    want = np.asarray(jm.module.apply({"params": jm.params}, jnp.asarray(x)))
    got = pm.fwd_runtime(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, 11 * scale, 13 * scale, 3)
    _check("EDSR x%d vs EDSRModule" % scale, got, want, ATOL)


def test_forward_matches_jax_fast_path_x4():
    jm = _jax_model(4)
    pm = _port_model(4, jm)
    fwd, desc = build_fast_forward(jm, jnp.float32)
    assert "collapsed" in desc
    x = _lr((1, 12, 10, 3), seed=3)
    want = np.asarray(fwd(jm.params, jnp.asarray(x)))
    got = pm.fwd_runtime(torch.from_numpy(x)).numpy()
    _check("EDSR x4 vs build_fast_forward (%s)" % desc, got, want, FAST_ATOL)


def test_meanshift_affine_override_matches_jax():
    """Random frozen MeanShift affines, as genuine reference checkpoints
    carry, load into the port's buffers and match the JAX module with
    ms_affine / mis_affine installed."""
    jm = _jax_model(4)
    pm = _port_model(4, jm)
    rng = np.random.default_rng(7)
    state = {k: v.clone() for k, v in pm.module.state_dict().items()}
    affines = {}
    for name in ("mean_shift", "mean_inverse_shift"):
        mb = rng.uniform(-1, 1, (3, 4)).astype(np.float32)
        mb[:, 3] *= 100.0
        state[name + ".weight"] = torch.from_numpy(mb[:, :3].reshape(3, 3, 1, 1).copy())
        state[name + ".bias"] = torch.from_numpy(mb[:, 3].copy())
        affines[name] = tuple(tuple(float(v) for v in row) for row in mb)
    pm.load_state_dict(state)
    module = dataclasses.replace(jm.module, ms_affine=affines["mean_shift"],
                                 mis_affine=affines["mean_inverse_shift"])
    x = _lr((1, 9, 8, 3), seed=5)
    want = np.asarray(module.apply({"params": jm.params}, jnp.asarray(x)))
    got = pm.fwd_runtime(torch.from_numpy(x)).numpy()
    _check("EDSR x4 MeanShift affines vs EDSRModule", got, want, ATOL)


def test_full_width_parameter_count():
    module = EDSRModule(features=64, num_blocks=16, scale=4,
                        generator=torch.Generator().manual_seed(0))
    assert sum(p.numel() for p in module.parameters()) == 1517571
    # MeanShift matrices and biases are buffers, outside the count
    assert "mean_shift.weight" in module.state_dict()


def test_strict_restore_rejects_wrong_shapes(tmp_path):
    jm = _jax_model(4)
    pm = _port_model(4, jm)
    state = pm.module.state_dict()
    state["first_conv.weight"] = torch.zeros(16, 3, 3, 3)
    path = str(tmp_path / "wrong.pth")
    torch.save(state, path)
    with pytest.raises(ValueError, match="shape mismatch"):
        pm.restore(path)
    del state["first_conv.weight"]
    torch.save(state, path)
    with pytest.raises(ValueError, match="missing"):
        pm.restore(path)


def test_restore_reads_a_jax_msgpack_checkpoint(tmp_path):
    """A `.ckpt` the JAX package wrote restores without flax: the forward
    equals JAX's module on the same input, and the step comes with it."""
    jm = _jax_model(4)
    jm.global_step = 5
    path = jm.save(str(tmp_path))
    assert path.endswith("model_5.ckpt")
    pm = get_model("edsr")
    pm.parse_args(list(TINY))
    pm.prepare([4], device="cpu", seed=3)
    pm.restore(path)
    assert pm.global_step == 5
    x = _lr((1, 9, 7, 3), seed=5)
    want = np.asarray(jm.module.apply({"params": jm.params}, jnp.asarray(x)))
    _check("EDSR restored from .ckpt vs EDSRModule", pm.fwd_runtime(torch.from_numpy(x)).numpy(),
           want, ATOL)


def test_restore_refuses_orbax_directories(tmp_path):
    pm = get_model("edsr")
    pm.parse_args(list(TINY))
    pm.prepare([4], device="cpu")
    with pytest.raises(ValueError, match="orbax directory.*save_pth"):
        pm.restore(str(tmp_path))


def test_host_contract_uint8_push_and_quantization():
    """uint8 frames cast on the device equal the f32 path; upscale_uint8
    equals round-half-to-even + clip of upscale; keep trims the batch."""
    jm = _jax_model(2)
    pm = _port_model(2, jm)
    rng = np.random.default_rng(11)
    frames = [rng.integers(0, 256, (3, 6, 7), dtype=np.uint8) for _ in range(2)]
    f32 = pm.upscale([f.astype(np.float32) for f in frames], 2)
    u8_in = pm.upscale(frames, 2)
    np.testing.assert_array_equal(f32, u8_in)
    q = pm.upscale_uint8(frames, 2)
    assert q.dtype == np.uint8 and q.shape == (2, 3, 12, 14)
    np.testing.assert_array_equal(q, np.clip(np.round(f32), 0, 255).astype(np.uint8))
    kept = pm.upscale_device(frames, 2, uint8=True, keep=1)
    assert tuple(kept.shape) == (1, 12, 14, 3)


def test_bf16_serving_dtype_runs_bf16_convs_and_returns_f32():
    jm = _jax_model(2)
    pm = _port_model(2, jm)
    x = torch.from_numpy(_lr((1, 6, 5, 3), seed=2))
    want = pm.fwd_runtime(x)
    pm.set_serving_dtype("bf16")
    assert pm.serving_module.first_conv.weight.dtype == torch.bfloat16
    assert pm.module.first_conv.weight.dtype == torch.float32  # the f32 weights stay
    got = pm.fwd_runtime(x)
    assert got.dtype == torch.float32
    # bf16 keeps 8 significant bits: a few levels on [0, 255] after 7 convs
    assert float((got - want).abs().max()) < 8.0
