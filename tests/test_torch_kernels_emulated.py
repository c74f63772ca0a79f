"""The port's CUDA sources, built for the CPU by larvanet_tpu_torch/ops/emulate.py
(a thread per CUDA thread, a barrier for __syncthreads), against their plain
versions.

The kernels run through the wrappers' own `bind` and `_run`, so this checks
the sources' indexing, masking, tiling and arithmetic and the wrappers'
operand preparation; what nvcc accepts and how fast the kernels run only
the card shows (chip_smoke.py). Inputs come from numpy with a seed.
"""

import re

import numpy as np
import pytest
import torch

from larvanet_tpu_torch.ops import build, conv3x3, emulate
from larvanet_tpu_torch.ops import conv3x3_wgrad as wg
from larvanet_tpu_torch.ops import wino_resblock as wr
from larvanet_tpu_torch.ops import conv3x3_s8 as s8

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


@pytest.fixture(scope="module")
def wgrad_lib():
    return _lib(wg.SOURCE)


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


@pytest.mark.parametrize("shape,f,act", [
    ((1, 29, 19, 64), 64, "relu"),       # trunk conv; 2 x 2 tiles of 24 x 16, ragged
    ((2, 5, 7, 64), 64, None),           # frames smaller than one tile, batch 2
    ((1, 6, 20, 64), 256, None),         # upsample conv, 4 F tiles x 2 pixel tiles
    ((1, 9, 17, 48), 48, "leaky_relu"),  # C = F = 48: a part-filled F tile
    ((2, 7, 10, 96), 32, "relu"),        # C = 96: two channel chunks, 64 + 32
])
def test_conv3x3_tensor_core_path_matches_plain_version(conv_lib, shape, f, act):
    """The persistent kernel on the stand-in's one-SM card: one block per F
    tile walks every pixel tile (and every chunk of C) in turn."""
    assert conv3x3.path_for(shape[3], f, torch.bfloat16) == "tensor_core"
    rng = np.random.default_rng(sum(shape) + f)
    x = _t(rng.standard_normal(shape)).to(torch.bfloat16)
    k = _t(0.1 * rng.standard_normal((3, 3, shape[3], f)))
    b = _t(rng.standard_normal(f))
    fn = conv3x3.bind(conv_lib, torch.bfloat16, "tensor_core")
    got = conv3x3._run(fn, x, k, b, act, None)
    want = conv3x3.conv3x3_bias_act_reference(x, k, b, act)
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got.float() - want.float()).abs()
    print("emulated conv3x3 tensor_core %s->%d %s: max|d| %.3g, %d of %d values differ"
          % (shape, f, act, float(diff.max()), int((diff > 0).sum()), diff.numel()))
    assert torch.isfinite(got.float()).all()
    assert bool((diff <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())


@pytest.mark.parametrize("shape,f,act", [
    ((1, 9, 13, 64), 64, "relu"),          # a trunk conv, one ragged tile
    ((2, 5, 7, 16), 16, None),             # C = F = 16, batch 2, frames < one tile
    ((1, 24, 32, 32), 32, "leaky_relu"),   # tile windows end on the last row and column
    ((1, 7, 6, 64), 80, "relu"),           # F = 64 + 16: a ragged BN chunk
    ((1, 6, 5, 32), 256, "leaky_relu"),    # upsample-like F = 256: 4 F tiles
    ((1, 5, 9, 96), 16, None),             # C = 96: two channel chunks, 64 + 32
])
def test_conv3x3_f32_tensor_core_path_matches_plain_version(conv_lib, shape, f, act):
    """The split-TF32 entry (three tf32 products an f32 product: lo x hi,
    hi x lo, hi x hi) on the stand-in's one-SM card, whose mma reads each
    operand as the card does, its low 13 bits dropped: a single TF32
    product, or operands fed unrounded, miss F32_ATOL at C = 64."""
    assert conv3x3.path_for(shape[3], f, torch.float32) == "tensor_core"
    rng = np.random.default_rng(sum(shape) + f)
    x = _t(rng.standard_normal(shape))
    k = _t(0.1 * rng.standard_normal((3, 3, shape[3], f)))
    b = _t(rng.standard_normal(f))
    fn = conv3x3.bind(conv_lib, torch.float32, "tensor_core")
    got = conv3x3._run(fn, x, k, b, act, None, "tensor_core")
    want = conv3x3.conv3x3_bias_act_reference(x, k, b, act)
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got - want).abs()
    print("emulated conv3x3 f32 tensor_core %s->%d %s: max|d| %.3g"
          % (shape, f, act, float(diff.max())))
    assert torch.isfinite(got).all()
    assert float(diff.max()) <= F32_ATOL["conv"]


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["c_not_16", "f_not_16", "misaligned"])
def test_conv3x3_tensor_core_entry_refuses_what_it_cannot_take(conv_lib, case, dname):
    """Nothing is launched and the wrapper raises: C or F not a multiple of 16
    (cudaErrorInvalidValue), x not 16-byte aligned (cudaErrorMisalignedAddress)."""
    dtype = DTYPES[dname]
    c, f = {"c_not_16": (24, 16), "f_not_16": (16, 24)}.get(case, (16, 16))
    shape = (1, 4, 5, c)
    x = torch.zeros(shape, dtype=dtype)
    if case == "misaligned":
        x = torch.zeros(x.numel() + 1, dtype=dtype)[1:].view(shape)
    k, b = torch.zeros((3, 3, c, f)), torch.zeros(f)
    fn = conv3x3.bind(conv_lib, dtype, "tensor_core")
    code = 716 if case == "misaligned" else 1
    with pytest.raises(RuntimeError, match="CUDA error %d" % code):
        conv3x3._run(fn, x, k, b, None, None, "tensor_core")


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("shape,f,act", [
    ((1, 10, 11, 64), 3, None),          # final_conv, a frame smaller than one tile
    ((1, 32, 64, 16), 8, "leaky_relu"),  # tiles end exactly on the last row and column
    ((2, 37, 45, 64), 1, "relu"),        # batch 2, ragged in H and W, several tiles
    ((1, 20, 40, 16), 3, "relu"),        # C = 16, ragged last column tile
    ((1, 33, 35, 64), 8, None),          # one row and three columns past a tile
    ((1, 9, 70, 32), 5, "leaky_relu"),   # C = 32, three tiles along W
])
def test_conv3x3_narrow_path_matches_plain_version(conv_lib, shape, f, act, dname):
    """The persistent narrow kernels (f32: 32 x 32 tiles in 16-channel chunks;
    bf16: 16 x 32 tiles on mma.sync) on the stand-in's one-SM card: one block
    walks every tile, copying the next halo while the current one is used."""
    dtype = DTYPES[dname]
    assert conv3x3.path_for(shape[3], f, dtype) == "narrow"
    rng = np.random.default_rng(sum(shape) + f)
    x = _t(rng.standard_normal(shape)).to(dtype)
    k = _t(0.1 * rng.standard_normal((3, 3, shape[3], f)))
    b = _t(rng.standard_normal(f))
    got = conv3x3._run(conv3x3.bind(conv_lib, dtype, "narrow"), x, k, b, act, None)
    want = conv3x3.conv3x3_bias_act_reference(x, k, b, act)
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got.float() - want.float()).abs()
    print("emulated conv3x3 narrow %s %s->%d %s: max|d| %.3g, %d of %d values differ"
          % (dname, shape, f, act, float(diff.max()), int((diff > 0).sum()), diff.numel()))
    assert torch.isfinite(got.float()).all()
    if dname == "f32":
        assert float(diff.max()) <= F32_ATOL["conv"]
    else:
        assert bool((diff <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("shape,f,act,path", [
    ((2, 7, 9, 3), 48, None, "cuda_core"),          # head 3 -> 48
    ((1, 13, 17, 48), 48, "relu", "tensor_core"),   # trunk conv 1, leg recon1
    ((1, 13, 17, 48), 48, None, "tensor_core"),     # trunk conv 2, leg recon2
    ((1, 11, 10, 64), 48, None, "tensor_core"),     # w64 leg recon2, 64 -> 48
    ((1, 9, 12, 96), 48, None, "tensor_core"),      # V2 tail merge, 96 -> 48
])
def test_conv3x3_larvanet_shapes_match_plain_version(conv_lib, shape, f, act, path, dname):
    """The LarvaNet family's conv shapes on the path `path_for` gives them:
    F = 48 fills part of the tensor-core entries' output tiles and C = 48
    (or 96) ends on a part-filled channel chunk, so both masks run here."""
    dtype = DTYPES[dname]
    assert conv3x3.path_for(shape[3], f, dtype) == path
    rng = np.random.default_rng(sum(shape) + f)
    x = _t(rng.standard_normal(shape)).to(dtype)
    k = _t(0.1 * rng.standard_normal((3, 3, shape[3], f)))
    b = _t(rng.standard_normal(f))
    got = conv3x3._run(conv3x3.bind(conv_lib, dtype, path), x, k, b, act, None, path)
    want = conv3x3.conv3x3_bias_act_reference(x, k, b, act)
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got.float() - want.float()).abs()
    print("emulated conv3x3 %s %s %s->%d %s: max|d| %.3g"
          % (path, dname, shape, f, act, float(diff.max())))
    assert torch.isfinite(got.float()).all()
    if dname == "f32":
        assert float(diff.max()) <= F32_ATOL["conv"]
    else:
        assert bool((diff <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("case", ["f_9", "c_not_16", "c_80", "misaligned"])
def test_conv3x3_narrow_entry_refuses_what_it_cannot_take(conv_lib, case, dname):
    """Nothing is launched and the wrapper raises: F > 8, C not a multiple of
    16 or above 64 (cudaErrorInvalidValue), x not 16-byte aligned
    (cudaErrorMisalignedAddress)."""
    dtype = DTYPES[dname]
    c, f = {"f_9": (16, 9), "c_not_16": (24, 3), "c_80": (80, 3)}.get(case, (16, 3))
    shape = (1, 4, 5, c)
    x = torch.zeros(shape, dtype=dtype)
    if case == "misaligned":
        x = torch.zeros(x.numel() + 1, dtype=dtype)[1:].view(shape)
    k, b = torch.zeros((3, 3, c, f)), torch.zeros(f)
    fn = conv3x3.bind(conv_lib, dtype, "narrow")
    code = 716 if case == "misaligned" else 1
    with pytest.raises(RuntimeError, match="CUDA error %d" % code):
        conv3x3._run(fn, x, k, b, None, None)


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


def test_translate_rewrites_launches_and_dynamic_shared_memory():
    src = ("  extern __shared__ __align__(16) float smem[];\n"
           "  kern<T, 4><<<grid, 256, bytes, static_cast<cudaStream_t>(s)>>>(a, b);\n")
    out = emulate.translate(src)
    assert "float* smem = reinterpret_cast<float*>(emu_smem());" in out
    assert "  emu_launch(kern<T, 4>, grid, 256, bytes, static_cast<cudaStream_t>(s), a, b);" in out


@pytest.mark.parametrize("shape,f,path", [
    ((1, 6, 7, 256), 64, "tensor_core"),   # upsample dgrad 256 -> 64: four chunks of 64
    ((2, 5, 9, 256), 64, "tensor_core"),   # batch 2, frames smaller than one tile
    ((1, 30, 19, 3), 64, "cuda_core"),     # final_conv's dgrad 3 -> 64, several M tiles
])
def test_conv3x3_dgrad_shapes_match_plain_version(conv_lib, shape, f, path):
    """The input gradients of a train step's convs that no forward has: C =
    256 on the f32 tensor-core entry and 3 -> 64 on the CUDA cores, with the
    rotated kernel (`dgrad_kernel`) split afresh, not cached (`cache=False`)."""
    assert conv3x3.path_for(shape[3], f, torch.float32) == path
    rng = np.random.default_rng(sum(shape) + f)
    g = _t(rng.standard_normal(shape))
    k = conv3x3.dgrad_kernel(_t(0.05 * rng.standard_normal((3, 3, f, shape[3]))))
    zero = torch.zeros(f)
    fn = conv3x3.bind(conv_lib, torch.float32, path)
    cached = len(conv3x3._SPLIT_CACHE)
    got = conv3x3._run(fn, g, k, zero, None, None, path, cache=False)
    assert len(conv3x3._SPLIT_CACHE) == cached
    want = conv3x3.conv3x3_bias_act_reference(g, k, zero, None)
    err = float((got - want).abs().max())
    print("emulated conv3x3 dgrad %s %s->%d: max|d| %.3g" % (path, shape, f, err))
    assert torch.isfinite(got).all() and err <= F32_ATOL["conv"]


def _chunk_for(m, splits):
    chunk = wg._cdiv(wg._cdiv(m, splits), 16) * 16
    return wg._cdiv(m, chunk), chunk


@pytest.mark.parametrize("shape,f,splits", [
    ((2, 5, 7, 16), 16, 1),    # one split: the reduce pass copies
    ((2, 9, 11, 16), 16, 5),   # five splits, the last one short
    ((1, 6, 5, 3), 64, 2),     # first_conv's 3 -> 64: 28 rows, one tile
    ((1, 12, 13, 64), 3, 4),   # final_conv's 64 -> 3 on the narrow 256 x 4 tiles
    ((2, 4, 6, 8), 80, 3),     # F = 64 + 16: a ragged F tile
    ((1, 7, 9, 32), 4, 1),     # F = 4, the narrow tile's full width
])
def test_conv3x3_wgrad_kernel_matches_plain_version(wgrad_lib, shape, f, splits):
    """The CUDA-core entries' weight and bias gradient through the wrapper's
    `bind` and `_run`,
    the pixel sum cut into `splits` runs and the partials added in order:
    f32 sums of the same products in another order, within 1e-5 of the
    largest |dW| (|db|)."""
    rng = np.random.default_rng(sum(shape) + f + splits)
    x = _t(rng.standard_normal(shape))
    g = _t(rng.standard_normal(shape[:3] + (f,)))
    n_split, chunk = _chunk_for(shape[0] * shape[1] * shape[2], splits)
    assert n_split == splits
    fn = wg.bind(wgrad_lib, wg.entry_for("cuda_core", f))
    dw, db = wg._run(fn, x, g, n_split, chunk, None)
    want_w, want_b = wg.conv3x3_wgrad_reference(x, g)
    assert dw.shape == want_w.shape and db.shape == want_b.shape
    err_w = float((dw - want_w).abs().max() / want_w.abs().max())
    err_b = float((db - want_b).abs().max() / want_b.abs().max())
    print("emulated conv3x3_wgrad %s->%d, %d splits: max|d| / max|g| dW %.3g, db %.3g"
          % (shape, f, splits, err_w, err_b))
    assert torch.isfinite(dw).all() and err_w <= 1e-5 and err_b <= 1e-5
    again = wg._run(fn, x, g, n_split, chunk, None)
    assert torch.equal(again[0], dw) and torch.equal(again[1], db)  # deterministic


@pytest.mark.parametrize("case", ["empty_split", "short", "no_pixels", "narrow_f8"])
def test_conv3x3_wgrad_entry_refuses_what_it_cannot_take(wgrad_lib, case):
    """Nothing is launched and the wrapper raises cudaErrorInvalidValue: an
    empty split, splits that miss pixels, no pixels, F > 4 on the narrow
    entry."""
    shape = (1, 0, 5, 16) if case == "no_pixels" else (1, 4, 5, 16)
    f = 8 if case == "narrow_f8" else 4
    x, g = torch.zeros(shape), torch.zeros(shape[:3] + (f,))
    splits, chunk = {"empty_split": (3, 16), "short": (1, 16)}.get(case, (1, 32))
    fn = wg.bind(wgrad_lib, "cuda_core_narrow")
    with pytest.raises(RuntimeError, match="CUDA error 1"):
        wg._run(fn, x, g, splits, chunk, None)


def _tile_count(path, shape):
    th, tw = wg.PIXEL_TILE[path]
    return shape[0] * wg._cdiv(shape[1], th) * wg._cdiv(shape[2], tw)


# the tiled entries sum f32 products (split TF32 on the tensor-core entry,
# whose three products carry each product to ~2^-22 of itself) in another
# order than the plain version: within 1e-5 of the largest |dW| (|db|), as
# the CUDA-core entries are held
WGRAD_RTOL = 1e-5


def _wgrad_case(lib, path, shape, f, splits):
    """The tiled entry of `path` with its pixel tiles cut into `splits`
    runs (the last one short where the tiles allow), against the plain
    version, and again, bit for bit."""
    rng = np.random.default_rng(sum(shape) * 7 + f + splits)
    x = _t(rng.standard_normal(shape))
    g = _t(rng.standard_normal(shape[:3] + (f,)))
    tiles = _tile_count(path, shape)
    chunk = wg._cdiv(tiles, splits)
    assert wg._cdiv(tiles, chunk) == splits
    fn = wg.bind(lib, path)
    dw, db = wg._run(fn, x, g, splits, chunk, None)
    want_w, want_b = wg.conv3x3_wgrad_reference(x, g)
    assert dw.shape == want_w.shape and db.shape == want_b.shape
    err_w = float((dw - want_w).abs().max() / want_w.abs().max())
    err_b = float((db - want_b).abs().max() / want_b.abs().max())
    print("emulated conv3x3_wgrad %s %s->%d, %d of %d tiles a split: max|d| / max|g| dW "
          "%.3g, db %.3g" % (path, shape, f, chunk, tiles, err_w, err_b))
    assert torch.isfinite(dw).all() and err_w <= WGRAD_RTOL and err_b <= WGRAD_RTOL
    again = wg._run(fn, x, g, splits, chunk, None)
    assert torch.equal(again[0], dw) and torch.equal(again[1], db)  # deterministic


# (the stand-in's cost is one warp barrier an mma: 27 C F / 8 of them a
# pixel tile, so the shapes stay small)
@pytest.mark.parametrize("shape,f,splits", [
    ((5, 5, 9, 16), 16, 3),    # N = 5 tiles ending inside H and W; splits of 2, 2, 1
    ((1, 5, 7, 48), 16, 1),    # C = 48: a part-filled channel chunk (27 of 36 m tiles)
    ((1, 5, 7, 16), 48, 1),    # F = 48: a part-filled F tile
    ((1, 5, 7, 64), 16, 1),    # C = 64: all 12 warps' m tiles
    ((1, 5, 7, 16), 256, 1),   # the upsample's 256 outputs: four F tiles of 64
])
def test_conv3x3_wgrad_tensor_core_entry_matches_plain_version(wgrad_lib, shape, f, splits):
    _wgrad_case(wgrad_lib, "tensor_core", shape, f, splits)


@pytest.mark.parametrize("shape,f,splits", [
    ((2, 9, 33, 64), 3, 3),    # final_conv's 64 -> 3: 8 tiles, ragged H and W, splits 3, 3, 2
    ((1, 12, 20, 16), 1, 1),   # F = 1
    ((3, 5, 7, 32), 4, 2),     # F = 4, the narrow entry's widest; N = 3
    ((1, 5, 7, 80), 3, 1),     # C = 80: two channel chunks
])
def test_conv3x3_wgrad_narrow_entry_matches_plain_version(wgrad_lib, shape, f, splits):
    _wgrad_case(wgrad_lib, "narrow", shape, f, splits)


@pytest.mark.parametrize("path", ["tensor_core", "narrow"])
@pytest.mark.parametrize("case", ["c_not_16", "f_out_of_range", "empty_split", "short",
                                  "no_pixels", "misaligned"])
def test_conv3x3_wgrad_tiled_entry_refuses_what_it_cannot_take(wgrad_lib, path, case):
    """Nothing is launched and the wrapper raises cudaErrorInvalidValue: C
    not a multiple of 16, F the entry does not take (12 on the tensor-core
    entry, 8 on the narrow one), an empty split, splits that miss a tile, no
    pixels, x not 16-byte aligned."""
    c = 8 if case == "c_not_16" else 16
    f = {"tensor_core": 16, "narrow": 3}[path]
    if case == "f_out_of_range":
        f = {"tensor_core": 12, "narrow": 8}[path]
    shape = (1, 0, 5, c) if case == "no_pixels" else (2, 9, 5, c)  # 4 tiles
    x, g = torch.zeros(shape), torch.zeros(shape[:3] + (f,))
    if case == "misaligned":
        x = torch.zeros(x.numel() + 1)[1:].view(shape)
    splits, chunk = {"empty_split": (3, 2), "short": (1, 3)}.get(case, (1, 4))
    fn = wg.bind(wgrad_lib, path)
    with pytest.raises(RuntimeError, match="CUDA error 1$"):
        wg._run(fn, x, g, splits, chunk, None)


# ---- conv3x3_s8: the int8 conv of the W8A8 pair, bit for bit ----

@pytest.fixture(scope="module")
def s8_lib():
    return _lib(s8.SOURCE)


def _s8_weight(rng, c, f, s, dtype):
    codes = rng.integers(-127, 128, (3, 3, c, f)).astype(np.int8)
    sa = (rng.uniform(0.5, 2.0, f) * 1e-3).astype(np.float32)
    return s8.make_weight(codes, sa, s, _t(rng.standard_normal(f)), dtype, "cpu")


# C and F of the pairs' shapes (EDSR 64->64, LarvaNet 48->48 and its leg
# 48->48, LarvaNet_w64's leg 64->48) and of narrow pairs (JAX quantizes any
# width); H odd and W not a multiple of the 16-pixel tile, batch 2. Then the
# kernel's other edges: C not a multiple of 4 and F odd (padded codes and
# outputs masked), C of three 32-code chunks, F past one 64-output pass.
# The stand-in's card holds one block, which walks every tile through the
# ring: 48->48 at 33 x 35 runs 9 tiles (the rings wrap); 40->24 pads C
# to 64 and F to 32 (codes and outputs past them zero and masked); 16->72
# runs a second 16-output pass of which 8 are outputs; 256->256 (the large
# EDSR's width) keeps its weights in global memory, takes conv_b's halo by
# the producer's copy (a TMA box holds 256 codes, not Kp + 16) and
# conv_a's straight from x (no raw slot fits)
S8_CASES = [(8, 8, (2, 5, 19)), (16, 48, (2, 5, 19)), (48, 48, (2, 17, 7)),
            (48, 16, (2, 5, 19)), (64, 64, (2, 5, 19)), (64, 48, (1, 3, 33)),
            (6, 5, (2, 5, 19)), (96, 16, (1, 17, 18)), (16, 80, (1, 5, 19)),
            (48, 48, (1, 33, 35)), (40, 24, (1, 9, 17)), (16, 72, (1, 5, 19)),
            (256, 256, (1, 3, 9))]


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("c,f,hw", S8_CASES)
def test_conv3x3_s8_conv_a_matches_plain_version_bit_for_bit(s8_lib, c, f, hw, dname):
    rng = np.random.default_rng(c * 100 + f)
    dtype = DTYPES[dname]
    # hin / s_in lands on many exact halves: rint must round them to even
    s_in = 0.25
    hin = _t(rng.integers(-300, 300, hw + (c,)) / 8.0).to(dtype)
    wt = _s8_weight(rng, c, f, s_in, dtype)
    t = s8._dequant(s8.conv_codes_reference(s8.quantize(hin, s_in), wt.codes), wt, dtype)
    s_mid = float(t.float().abs().max()) * 0.8 / 127.0  # some codes clip
    got = s8._run_a(s8.bind(s8_lib, "conv_a", dtype), hin, wt, s_in, s_mid, "relu", None)
    want = s8.conv_a_reference(hin, wt, s_in, s_mid, "relu")
    assert got.dtype == torch.int8 and got.shape == want.shape
    flips = int((got != want).sum())
    print("emulated conv3x3_s8 conv_a %s %d->%d %s: %d of %d codes differ, %d clip"
          % (dname, c, f, hw, flips, want.numel(), int((want.abs() == 127).sum())))
    assert flips == 0


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("c,f,hw", S8_CASES)
def test_conv3x3_s8_conv_b_matches_plain_version_bit_for_bit(s8_lib, c, f, hw, dname):
    rng = np.random.default_rng(c * 100 + f + 7)
    dtype = DTYPES[dname]
    tq = torch.from_numpy(rng.integers(-127, 128, hw + (c,)).astype(np.int8))
    wt = _s8_weight(rng, c, f, 0.03, dtype)
    res = _t(rng.standard_normal(hw + (f,))).to(dtype)
    fn = s8.bind(s8_lib, "conv_b", dtype)
    for r, rw in ((res, 1.0), (res, 0.1), (None, 1.0), (None, 0.1)):
        got = s8._run_b(fn, tq, wt, dtype, r, rw, None)
        want = s8.conv_b_reference(tq, wt, dtype, r, rw)
        assert got.dtype == dtype and got.shape == want.shape
        assert torch.equal(got.view(torch.int16 if dname == "bf16" else torch.int32),
                           want.view(torch.int16 if dname == "bf16" else torch.int32)), \
            (c, f, r is None, rw, float((got.float() - want.float()).abs().max()))


def test_conv3x3_s8_cases_walk_more_tiles_than_ring_slots():
    # the stand-in's one block walks every tile: the 48->48 case must take
    # each of the kernel's rings round more than once (the rings wrap)
    src = (build.CSRC / s8.SOURCE).read_text()
    const = {k: int(re.search(r"constexpr int %s = (\d+);" % k, src).group(1))
             for k in ("kTH", "kTW", "kRawSlots", "kCodeSlots")}
    n, h, w = (1, 33, 35)
    assert (48, 48, (n, h, w)) in S8_CASES
    tiles = n * -(-h // const["kTH"]) * -(-w // const["kTW"])
    assert tiles > 2 * max(const["kRawSlots"], const["kCodeSlots"]), tiles


def _center_identity(c, s, dtype):
    # codes 1 on the centre tap's diagonal, sa 1, bias 0: conv_a's t is
    # T(xq * s) per channel
    codes = np.zeros((3, 3, c, c), np.int8)
    codes[1, 1] = np.eye(c, dtype=np.int8)
    return s8.make_weight(codes, np.ones(c, np.float32), s, torch.zeros(c), dtype, "cpu")


@pytest.mark.parametrize("dname", ["f32", "bf16"])
def test_conv3x3_s8_quantizes_values_next_to_a_half_as_the_division_does(s8_lib, dname):
    # the kernel's codes are rint(v * f32(1 / s)) away from the halves and the
    # IEEE division's next to them: values a few ulps either side of (k +
    # 1/2) s, at both clip edges, and scales whose reciprocal is inexact or
    # not a normal number (every code then divides)
    dtype = DTYPES[dname]
    fn = s8.bind(s8_lib, "conv_a", dtype)
    c, shape = 16, (1, 8, 17)
    halves = np.arange(-129, 129, dtype=np.float64) + 0.5

    def near(s):
        v = np.asarray(halves * s, np.float32)
        ulps = np.arange(-3, 4, dtype=np.int32)
        bits = v.view(np.int32)[:, None] + np.where(v[:, None] < 0, -ulps, ulps)
        v = np.concatenate([bits.reshape(-1).view(np.float32), [0.0, -0.0]])
        return _t(np.resize(v, shape + (c,))).to(dtype)

    # the input's codes: the output repeats them (s_mid = s_in, no act)
    for s_in in (0.3, 0.0731, 1.7e-39):
        hin = near(s_in)
        wt = _center_identity(c, s_in, dtype)
        got = s8._run_a(fn, hin, wt, s_in, s_in, None, None)
        want = s8.conv_a_reference(hin, wt, s_in, s_in, None)
        assert torch.equal(got, want), (s_in, int((got != want).sum()))
    # the output's codes: t = xq / 4 exact in T, s_mid a few ulps off 1/2
    hin = _t(np.resize(np.arange(-127, 128, dtype=np.float32) / 4, shape + (c,))).to(dtype)
    wt = _center_identity(c, 0.25, dtype)
    offs = (np.float32(0.5).view(np.int32) + np.arange(-2, 3, dtype=np.int32)).view(np.float32)
    for s_mid in (*offs, 3.0e38):
        got = s8._run_a(fn, hin, wt, 0.25, float(s_mid), None, None)
        want = s8.conv_a_reference(hin, wt, 0.25, float(s_mid), None)
        assert torch.equal(got, want), (float(s_mid), int((got != want).sum()))


@pytest.mark.parametrize("case", ["misaligned_w", "act_2", "empty", "too_wide"])
def test_conv3x3_s8_entry_refuses_what_it_cannot_take(s8_lib, case):
    rng = np.random.default_rng(3)
    # too_wide: one halo of 1280 codes a pixel (324 pixels x 1296 bytes)
    # passes a block's 227 KB of shared memory
    c = 1280 if case == "too_wide" else 16
    wt = _s8_weight(rng, c, 16, 0.1, torch.float32)
    hin = _t(rng.standard_normal((1, 4, 4, c)))
    n = 1
    if case == "misaligned_w":
        buf = torch.zeros(wt.entry.numel() + 16, dtype=torch.int8)
        wt._entry = buf[1:1 + wt.entry.numel()].view(wt.entry.shape)
    fn = s8.bind(s8_lib, "conv_a", torch.float32)
    out = torch.empty((1, 4, 4, 16), dtype=torch.int8)
    err = fn(hin.data_ptr(), wt.entry.data_ptr(), wt.scale.data_ptr(), wt.bias.data_ptr(),
             out.data_ptr(), 0 if case == "empty" else n, 4, 4, c, 16, 0.1, 0.1,
             2 if case == "act_2" else 1, None)
    assert err == (716 if case == "misaligned_w" else 1)


@pytest.mark.parametrize("case", ["dtype", "layout", "kernel_shape", "scale_shape"])
def test_conv3x3_s8_wrapper_refuses_what_the_entry_cannot_take(case):
    rng = np.random.default_rng(4)
    wt = _s8_weight(rng, 16, 16, 0.1, torch.float32)
    x = _t(rng.standard_normal((1, 4, 4, 16)))
    if case == "dtype":
        with pytest.raises(TypeError):
            s8._check(x.double(), wt, (torch.float32, torch.bfloat16), "conv_a")
    elif case == "layout":
        with pytest.raises(ValueError):
            s8._check(x.transpose(1, 2), wt, (torch.float32, torch.bfloat16), "conv_a")
    elif case == "kernel_shape":
        with pytest.raises(ValueError):
            s8._check(x[..., :8].contiguous(), wt, (torch.float32, torch.bfloat16), "conv_a")
    else:
        wt.scale = wt.scale[:8]
        with pytest.raises(ValueError, match="scale and bias"):
            s8._check(x, wt, (torch.float32, torch.bfloat16), "conv_a")
