"""The port's CUDA sources, built for the CPU by larvanet_tpu_torch/ops/emulate.py
(a thread per CUDA thread, a barrier for __syncthreads), against their plain
versions.

The kernels run through the wrappers' own `bind` and `_run`, so this checks
the sources' indexing, masking, tiling and arithmetic and the wrappers'
operand preparation; what nvcc accepts and how fast the kernels run only
the card shows (chip_smoke.py). Inputs come from numpy with a seed.
"""

import numpy as np
import pytest
import torch

from larvanet_tpu_torch.ops import conv3x3, emulate
from larvanet_tpu_torch.ops import wino_resblock as wr

# f32: the kernel sums the same f32 products as the plain version in another
# order (chip_smoke.py's F32_ATOL; the JAX tests' 5x for F(4,3))
F32_ATOL = {"conv": 2e-4, 2: 2e-4, 4: 1e-3}
# bf16 conv: the same bf16 operands, f32 sums, one rounding of the output
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-3
# bf16 wino, normwise: operands rounded to bf16 from f32 transforms summed in
# another order may land on neighbouring bf16 values (chip_smoke.py)
WINO_BF16_RTOL = 2.0 ** -6
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def _lib(source):
    try:
        emulate.compiler()
    except RuntimeError as exc:
        pytest.skip(str(exc))
    return emulate.load(source)


@pytest.fixture(scope="module")
def conv_lib():
    return _lib(conv3x3.SOURCE)


@pytest.fixture(scope="module")
def wino_lib():
    return _lib(wr.SOURCE)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("shape,f,act", [
    ((1, 9, 13, 64), 64, "relu"),     # a trunk conv, ragged M tile
    ((2, 7, 5, 3), 64, None),         # first_conv, C = 3
    ((1, 10, 11, 64), 3, None),       # final_conv, the F <= 4 tile
    ((1, 5, 6, 64), 256, "leaky_relu"),  # upsample conv, 4 F tiles
])
def test_conv3x3_kernel_matches_plain_version(conv_lib, shape, f, act, dname):
    rng = np.random.default_rng(sum(shape) + f)
    dtype = DTYPES[dname]
    x = _t(rng.standard_normal(shape)).to(dtype)
    k = _t(0.1 * rng.standard_normal((3, 3, shape[3], f)))
    b = _t(rng.standard_normal(f))
    got = conv3x3._run(conv3x3.bind(conv_lib, dtype), x, k, b, act, None)
    want = conv3x3.conv3x3_bias_act_reference(x, k, b, act)
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got.float() - want.float()).abs()
    print("emulated conv3x3 %s %s->%d %s: max|d| %.3g" % (dname, shape, f, act,
                                                         float(diff.max())))
    if dname == "f32":
        assert float(diff.max()) <= F32_ATOL["conv"]
    else:
        assert bool((diff <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("dname,shape,rw,b_a", [
    ("f32", (1, 13, 34, 64), 0.7, None),   # odd H, ragged tiles in H and W
    ("f32", (2, 8, 10, 64), 1.0, 7.5),     # the boundary trap, frame < one tile
    ("f32", (1, 25, 40, 64), 1.0, None),   # several blocks each way
    ("bf16", (1, 17, 31, 64), 0.1, None),  # odd W
])
def test_wino_kernel_matches_plain_version(wino_lib, m, dname, shape, rw, b_a):
    rng = np.random.default_rng(sum(shape) + m)
    dtype = DTYPES[dname]
    c = shape[3]
    x = _t(rng.standard_normal(shape)).to(dtype)
    k_a, k_b = (_t(0.05 * rng.standard_normal((3, 3, c, c))) for _ in range(2))
    b_a = _t(np.full(c, b_a) if b_a is not None else rng.standard_normal(c))
    b_b = _t(rng.standard_normal(c))
    u_a = wr.h_transform_kernel(k_a, m).to(dtype)
    u_b = wr.h_transform_kernel(k_b, m).to(dtype)
    got = wr._run(wr.bind(wino_lib, m, dtype), x, u_a, b_a, u_b, b_b, rw, m, None)
    want = wr.wino_resblock_transformed_reference(x, u_a, b_a, u_b, b_b, rw, m)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float((got.float() - want.float()).abs().max())
    print("emulated wino F(%d,3) %s %s rw=%g: max|d| %.3g" % (m, dname, shape, rw, err))
    assert torch.isfinite(got.float()).all()
    if dname == "f32":
        assert err <= F32_ATOL[m]
    else:
        assert err <= WINO_BF16_RTOL * float(want.float().abs().max())


def test_translate_rewrites_launches_and_dynamic_shared_memory():
    src = ("  extern __shared__ __align__(16) float smem[];\n"
           "  kern<T, 4><<<grid, 256, bytes, static_cast<cudaStream_t>(s)>>>(a, b);\n")
    out = emulate.translate(src)
    assert "float* smem = reinterpret_cast<float*>(emu_smem());" in out
    assert "  emu_launch(kern<T, 4>, grid, 256, bytes, static_cast<cudaStream_t>(s), a, b);" in out
