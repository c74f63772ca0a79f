"""The epilogues MSRR's ablations add to the conv kernels (relu6 and
leaky_relu at any slope), on the CPU builds of `csrc/conv3x3_bias_act.cu`
(every entry) and `csrc/conv3x3_s8.cu` (conv_a, bit for bit) by
larvanet_tpu_torch/ops/emulate.py, against their plain versions. One small
shape an entry: the sources' other tests cover their tiling
(tests/test_torch_kernels_emulated.py, tests/test_torch_s8_emulated.py).
"""

import numpy as np
import pytest
import torch

from larvanet_tpu_torch.ops import conv3x3
from larvanet_tpu_torch.ops import conv3x3_s8 as s8
from torch_emulated import BF16_ATOL, BF16_RTOL, DTYPES, F32_ATOL
from torch_emulated import lib as _lib
from torch_emulated import t as _t

# (act, slope): MSRR's relu6 ablation, and leaky_relu at a slope of
# --slope's, not the 0.1 the kernels used to fix
ACTS = [("relu6", 0.1), ("leaky_relu", 0.2)]


@pytest.fixture(scope="module")
def conv_lib():
    return _lib(conv3x3.SOURCE)


@pytest.fixture(scope="module")
def s8_lib():
    return _lib(s8.SOURCE)


# one shape a path, as path_for sends them: the CUDA cores (MSRR's head 3 ->
# 48), the tensor cores (the 48 -> 48 trunk), the narrow path (48 -> 3)
@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("act,slope", ACTS)
@pytest.mark.parametrize("shape,f,path", [((1, 5, 7, 3), 48, "cuda_core"),
                                          ((1, 5, 7, 48), 48, "tensor_core"),
                                          ((1, 5, 7, 48), 3, "narrow")])
def test_conv3x3_new_epilogues_match_plain_version(conv_lib, shape, f, path, act, slope,
                                                   dname):
    dtype = DTYPES[dname]
    assert conv3x3.path_for(shape[3], f, dtype) == path
    rng = np.random.default_rng(sum(shape) + f)
    # values around 0 and 6, where the activations bend
    x = _t(3.0 * rng.standard_normal(shape)).to(dtype)
    k = _t(0.3 * rng.standard_normal((3, 3, shape[3], f)))
    b = _t(3.0 + 3.0 * rng.standard_normal(f))
    fn = conv3x3.bind(conv_lib, dtype, path)
    got = conv3x3._run(fn, x, k, b, act, None, path, slope=slope)
    want = conv3x3.conv3x3_bias_act_reference(x, k, b, act, slope)
    plain = conv3x3.conv3x3_bias_act_reference(x, k, b, None)
    diff = (got.float() - want.float()).abs()
    print("emulated conv3x3 %s %s %s(%g): max|d| %.3g; below 0: %d, above 6: %d of %d"
          % (path, dname, act, slope, float(diff.max()), int((plain < 0).sum()),
             int((plain > 6).sum()), plain.numel()))
    assert int((plain < 0).sum()) > 0 and (act != "relu6" or int((plain > 6).sum()) > 0)
    if dname == "f32":
        assert float(diff.max()) <= F32_ATOL["conv"]
    else:
        assert bool((diff <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("act,slope", ACTS)
def test_conv3x3_s8_conv_a_new_epilogues_match_plain_version_bit_for_bit(s8_lib, act, slope,
                                                                         dname):
    rng = np.random.default_rng(17)
    dtype = DTYPES[dname]
    c, f, hw = 48, 48, (1, 5, 19)
    s_in = 0.25
    hin = _t(rng.integers(-300, 300, hw + (c,)) / 8.0).to(dtype)
    codes = rng.integers(-127, 128, (3, 3, c, f)).astype(np.int8)
    sa = (rng.uniform(0.5, 2.0, f) * 1e-3).astype(np.float32)
    wt = s8.make_weight(codes, sa, s_in, _t(2.0 * rng.standard_normal(f)), dtype, "cpu")
    t = s8._dequant(s8.conv_codes_reference(s8.quantize(hin, s_in), wt.codes), wt, dtype)
    # the activation's range: some codes clip, relu6's 6 lands on a code
    s_mid = 6.0 / 100.0 if act == "relu6" else float(t.float().abs().max()) * 0.8 / 127.0
    assert float(t.float().min()) < 0 and (act != "relu6" or float(t.float().max()) > 6)
    got = s8._run_a(s8.bind(s8_lib, "conv_a", dtype), hin, wt, s_in, s_mid, act, None, slope)
    want = s8.conv_a_reference(hin, wt, s_in, s_mid, act, slope)
    flips = int((got != want).sum())
    print("emulated conv3x3_s8 conv_a %s %s(%g): %d of %d codes differ"
          % (dname, act, slope, flips, want.numel()))
    assert got.dtype == torch.int8 and flips == 0
