"""The port's CUDA source `csrc/wino_resblock.cu` (the fused Winograd ResBlocks), built for the CPU
by larvanet_tpu_torch/ops/emulate.py (a thread per CUDA thread, a barrier
for __syncthreads), against its plain version.

The kernels run through the wrapper's own `bind` and `_run`, so this checks
the source's indexing, masking, tiling and arithmetic and the wrapper's
operand preparation; what nvcc accepts and how fast the kernels run only
the card shows (chip_smoke.py). Inputs come from numpy with a seed.
"""

import numpy as np
import pytest
import torch

from larvanet_tpu_torch.ops import wino_resblock as wr
from torch_emulated import DTYPES, F32_ATOL, WINO_BF16_RTOL
from torch_emulated import lib as _lib
from torch_emulated import t as _t

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give


@pytest.fixture(scope="module")
def wino_lib():
    return _lib(wr.SOURCE)


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


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("shape,rw,b_a", [
    ((1, 13, 34, 64), 0.7, None),   # odd H, ragged tiles in H and W
    ((2, 3, 9, 64), 1.0, None),     # batch 2, frames smaller than one tile
    ((1, 25, 64, 64), 1.0, None),   # several tiles each way
    ((2, 8, 10, 64), 1.0, 7.5),     # the boundary trap: t must be 0, not ReLU(b_a)
    ((1, 24, 90, 64), 1.0, 7.5),    # the trap where a tile's window ends on the last row
    ((1, 17, 31, 64), 0.1, None),   # odd W, res_weight 0.1
])
def test_wino_tensor_core_entry_matches_plain_version(wino_lib, m, shape, rw, b_a):
    """The persistent kernel on the stand-in's one-SM card: one block walks
    every tile, prefetching the next tile's x window during stage B."""
    assert wr.path_for(torch.bfloat16) == "tensor_core"
    rng = np.random.default_rng(sum(shape) + m)
    c = shape[3]
    x = _t(rng.standard_normal(shape)).to(torch.bfloat16)
    k_a, k_b = (_t(0.05 * rng.standard_normal((3, 3, c, c))) for _ in range(2))
    b_a = _t(np.full(c, b_a) if b_a is not None else rng.standard_normal(c))
    b_b = _t(rng.standard_normal(c))
    u_a = wr.h_transform_kernel(k_a, m).to(torch.bfloat16)
    u_b = wr.h_transform_kernel(k_b, m).to(torch.bfloat16)
    fn = wr.bind(wino_lib, m, torch.bfloat16, "tensor_core")
    got = wr._run(fn, x, wr.entry_basis(u_a, "tensor_core"), b_a,
                  wr.entry_basis(u_b, "tensor_core"), b_b, rw, m, None)
    want = wr.wino_resblock_transformed_reference(x, u_a, b_a, u_b, b_b, rw, m)
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got.float() - want.float()).abs()
    scale = float(want.float().abs().max())
    print("emulated wino F(%d,3) tensor_core %s rw=%g: max|d| %.3g (max|y| %.3g), %d of %d "
          "values differ" % (m, shape, rw, float(diff.max()), scale, int((diff > 0).sum()),
                             diff.numel()))
    assert torch.isfinite(got.float()).all()
    assert float(diff.max()) <= WINO_BF16_RTOL * scale


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("case", ["misaligned_x", "misaligned_u", "empty"])
def test_wino_tensor_core_entry_refuses_what_it_cannot_take(wino_lib, m, case):
    """Nothing is launched and the wrapper raises: x or a basis not 16-byte
    aligned (cudaErrorMisalignedAddress), an empty frame
    (cudaErrorInvalidValue)."""
    c = wr.KERNEL_CHANNELS
    shape = (1, 0, 5, c) if case == "empty" else (1, 4, 5, c)
    x = torch.ones(shape, dtype=torch.bfloat16)
    if case == "misaligned_x":
        x = torch.ones(x.numel() + 1, dtype=torch.bfloat16)[1:].view(shape)
    basis = (m + 2, 3, c, c)
    u = torch.zeros(basis, dtype=torch.bfloat16)
    u_a = torch.zeros(u.numel() + 1, dtype=torch.bfloat16)[1:].view(basis) \
        if case == "misaligned_u" else u
    b = torch.zeros(c)
    fn = wr.bind(wino_lib, m, torch.bfloat16, "tensor_core")
    code = 1 if case == "empty" else 716
    with pytest.raises(RuntimeError, match="CUDA error %d" % code):
        wr._run(fn, x, u_a, b, u, b, 1.0, m, None)


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("shape,rw,b_a", [
    ((1, 13, 34, 64), 0.7, None),   # odd H, ragged tiles in H and W
    ((2, 3, 9, 64), 1.0, None),     # batch 2, frames smaller than one tile
    ((1, 25, 64, 64), 1.0, None),   # several tiles each way
    ((2, 8, 10, 64), 1.0, 7.5),     # the boundary trap: t must be 0, not ReLU(b_a)
    ((1, 24, 90, 64), 1.0, 7.5),    # the trap where a tile's window ends on the last row
    ((1, 17, 31, 64), 0.1, None),   # odd W, res_weight 0.1
])
def test_wino_f32_tensor_core_entry_matches_plain_version(wino_lib, m, shape, rw, b_a):
    """The split-TF32 entry (V_p built one basis tap at a time, three tf32
    products an f32 product) on the stand-in's one-SM card, whose mma reads
    each operand as the card does, its low 13 bits dropped: one TF32
    product, V or the weights fed unrounded, miss F32_ATOL at C = 64."""
    assert wr.path_for(torch.float32) == "tensor_core"
    rng = np.random.default_rng(sum(shape) + m)
    c = shape[3]
    x = _t(rng.standard_normal(shape))
    k_a, k_b = (_t(0.05 * rng.standard_normal((3, 3, c, c))) for _ in range(2))
    b_a = _t(np.full(c, b_a) if b_a is not None else rng.standard_normal(c))
    b_b = _t(rng.standard_normal(c))
    u_a, u_b = wr.h_transform_kernel(k_a, m), wr.h_transform_kernel(k_b, m)
    fn = wr.bind(wino_lib, m, torch.float32, "tensor_core")
    got = wr._run(fn, x, wr.entry_basis(u_a, "tensor_core"), b_a,
                  wr.entry_basis(u_b, "tensor_core"), b_b, rw, m, None)
    want = wr.wino_resblock_transformed_reference(x, u_a, b_a, u_b, b_b, rw, m)
    assert got.shape == want.shape and got.dtype == want.dtype
    err = float((got - want).abs().max())
    print("emulated wino F(%d,3) f32 tensor_core %s rw=%g: max|d| %.3g" % (m, shape, rw, err))
    assert torch.isfinite(got).all()
    assert err <= F32_ATOL[m]


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("case", ["misaligned_x", "misaligned_u", "empty"])
def test_wino_f32_tensor_core_entry_refuses_what_it_cannot_take(wino_lib, m, case):
    """Nothing is launched and the wrapper raises: x or a split basis not
    16-byte aligned (cudaErrorMisalignedAddress), an empty frame
    (cudaErrorInvalidValue)."""
    c = wr.KERNEL_CHANNELS
    shape = (1, 0, 5, c) if case == "empty" else (1, 4, 5, c)
    x = torch.ones(shape)
    if case == "misaligned_x":
        x = torch.ones(x.numel() + 1)[1:].view(shape)
    split = (3, m + 2, 3, c, c)
    u = torch.zeros(split)
    u_a = torch.zeros(u.numel() + 1)[1:].view(split) if case == "misaligned_u" else u
    b = torch.zeros(c)
    fn = wr.bind(wino_lib, m, torch.float32, "tensor_core")
    code = 1 if case == "empty" else 716
    with pytest.raises(RuntimeError, match="CUDA error %d" % code):
        wr._run(fn, x, u_a, b, u, b, 1.0, m, None)

