"""The port's fused 3x3 conv (larvanet_tpu_torch/ops/conv3x3.py) against
the JAX package's `conv3x3_bias_act` (ops/pallas_conv.py), which runs its
XLA path on the CPU.

On the CPU the port's wrapper takes the plain version, so these tests
hold the arithmetic the CUDA kernel is compared with on the card
(chip_smoke.py) against JAX. Inputs are made with numpy from a seed.
"""

import numpy as np
import pytest
import torch

from larvanet_tpu.ops.pallas_conv import conv3x3_bias_act as jax_conv3x3
from larvanet_tpu_torch.ops import conv3x3

# f32 sums of at most 9*32 products of unit-scale values taken in another
# order than XLA's: differences stay near 1e-6; the TPU kernel's own bar
# (tools/pallas_check.py) is 2e-4.
ATOL = 1e-4

SHAPES = [((1, 33, 48, 32), 16),  # tools/pallas_check.py:33
          ((1, 8, 8, 8), 8),
          ((2, 7, 9, 3), 8),       # C = 3, as EDSR's first_conv
          ((1, 10, 13, 8), 3)]     # F = 3, as EDSR's final_conv


def _inputs(shape, f, seed=0):
    rng = np.random.default_rng(seed)
    c = shape[-1]
    x = rng.standard_normal(shape).astype(np.float32)
    k = (0.1 * rng.standard_normal((3, 3, c, f))).astype(np.float32)
    b = rng.standard_normal((f,)).astype(np.float32)
    return x, k, b


@pytest.mark.parametrize("act", [None, "relu", "leaky_relu"])
@pytest.mark.parametrize("shape,f", SHAPES)
def test_cpu_path_matches_jax(shape, f, act):
    x, k, b = _inputs(shape, f)
    want = np.asarray(jax_conv3x3(x, k, b, act))
    got = conv3x3.conv3x3_bias_act(torch.from_numpy(x), torch.from_numpy(k),
                                   torch.from_numpy(b), act)
    assert got.shape == want.shape and got.dtype == torch.float32
    print("parity conv3x3 %s->%d %s: max|d| %.3g" % (
        shape, f, act, np.abs(got.numpy() - want).max()))
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=0)


def test_cpu_tensor_routes_to_plain_version_without_launch(monkeypatch):
    x, k, b = _inputs((1, 5, 6, 4), 4)
    calls = []
    real = conv3x3.conv3x3_bias_act_reference

    def spy(*args):
        calls.append(args)
        return real(*args)

    monkeypatch.setattr(conv3x3, "conv3x3_bias_act_reference", spy)
    before = conv3x3.LAUNCHES
    out = conv3x3.conv3x3_bias_act(torch.from_numpy(x), torch.from_numpy(k),
                                   torch.from_numpy(b), "relu")
    assert len(calls) == 1 and conv3x3.LAUNCHES == before
    assert out.shape == (1, 5, 6, 4) and float(out.min()) >= 0.0


def test_bf16_plain_version_rounds_once_from_f32_sums():
    """bf16 in, bf16 out: the sum is taken in f32 over the bf16 inputs and
    rounded once, as the kernel's epilogue does."""
    x, k, b = _inputs((1, 6, 7, 8), 5, seed=1)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    got = conv3x3.conv3x3_bias_act(xb, torch.from_numpy(k), torch.from_numpy(b))
    f32 = conv3x3.conv3x3_bias_act(xb.float(), torch.from_numpy(k).to(torch.bfloat16).float(),
                                   torch.from_numpy(b))
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, f32.to(torch.bfloat16))


def test_wrapper_rejects_unknown_activation():
    x, k, b = _inputs((1, 4, 4, 2), 2)
    with pytest.raises(ValueError, match="activation"):
        conv3x3.conv3x3_bias_act(torch.from_numpy(x), torch.from_numpy(k),
                                 torch.from_numpy(b), "gelu")
