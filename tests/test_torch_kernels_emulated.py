"""The port's conv3x3 CUDA source (`csrc/conv3x3_bias_act.cu`: the forward
paths and the input gradient), built for the CPU by
larvanet_tpu_torch/ops/emulate.py (a thread per CUDA thread, a barrier for
__syncthreads), against its plain version.

The kernels run through the wrapper's own `bind` and `_run`, so this checks
the source's indexing, masking, tiling and arithmetic and the wrapper's
operand preparation; what nvcc accepts and how fast the kernels run only
the card shows (chip_smoke.py). Inputs come from numpy with a seed. The
other sources are held in tests/test_torch_{wino,wgrad,s8,conv_kxk,
dwconv}_emulated.py.
"""

import numpy as np
import pytest
import torch

from larvanet_tpu_torch.ops import conv3x3, emulate
from torch_emulated import BF16_ATOL, BF16_RTOL, DTYPES, F32_ATOL
from torch_emulated import lib as _lib
from torch_emulated import t as _t

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give


@pytest.fixture(scope="module")
def conv_lib():
    return _lib(conv3x3.SOURCE)


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



@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("shape,f,act", [
    ((1, 3, 5, 384), 48, None),          # REGO's SRrecon 384 -> 48: six channel chunks
    ((1, 3, 5, 384), 64, None),          # REGO-serial's merge conv_0, 384 -> 64
    ((1, 5, 7, 64), 64, "leaky_relu"),   # the RESBlock's conv1 with LeakyReLU(0.1)
])
def test_conv3x3_branchy_shapes_match_plain_version(conv_lib, shape, f, act, dname):
    """The REGO family's conv shapes on the tensor-core path in both dtypes:
    the fuse's C = 384 (six 64-channel chunks) into F = 48 and 64, and
    64 -> 64 with leaky_relu at the default slope 0.1 (the f32 cases at C =
    384 take the stand-in ~7-10 s each: three products an mma)."""
    dtype = DTYPES[dname]
    assert conv3x3.path_for(shape[3], f, dtype) == "tensor_core"
    rng = np.random.default_rng(sum(shape) + f + 384)
    x = _t(rng.standard_normal(shape)).to(dtype)
    k = _t(0.05 * rng.standard_normal((3, 3, shape[3], f)))
    b = _t(rng.standard_normal(f))
    fn = conv3x3.bind(conv_lib, dtype, "tensor_core")
    got = conv3x3._run(fn, x, k, b, act, None, "tensor_core")
    want = conv3x3.conv3x3_bias_act_reference(x, k, b, act)
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got.float() - want.float()).abs()
    print("emulated conv3x3 tensor_core %s %s->%d %s: max|d| %.3g"
          % (dname, shape, f, act, float(diff.max())))
    assert torch.isfinite(got.float()).all()
    if dname == "f32":
        assert float(diff.max()) <= F32_ATOL["conv"]
    else:
        assert bool((diff <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())


def test_conv3x3_dgrad_of_the_384_channel_fuse_matches_plain_version(conv_lib):
    """The input gradient of REGO's SRrecon (384 -> 48): a 48 -> 384 conv of
    the output gradient on the f32 tensor-core entry, six F tiles of 64."""
    shape, f = (1, 4, 6, 48), 384
    assert conv3x3.path_for(shape[3], f, torch.float32) == "tensor_core"
    rng = np.random.default_rng(48384)
    g = _t(rng.standard_normal(shape))
    k = conv3x3.dgrad_kernel(_t(0.05 * rng.standard_normal((3, 3, f, shape[3]))))
    fn = conv3x3.bind(conv_lib, torch.float32, "tensor_core")
    got = conv3x3._run(fn, g, k, torch.zeros(f), None, None, "tensor_core", cache=False)
    want = conv3x3.conv3x3_bias_act_reference(g, k, torch.zeros(f), None)
    err = float((got - want).abs().max())
    print("emulated conv3x3 dgrad tensor_core %s->%d: max|d| %.3g" % (shape, f, err))
    assert torch.isfinite(got).all() and err <= F32_ATOL["conv"]


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("shape,f,act,path", [
    ((1, 4, 6, 3), 256, None, "cuda_core"),        # EBRN's fe0 3 -> 4F
    ((1, 4, 6, 256), 64, None, "tensor_core"),     # EBRN's fe1 4F -> F: four chunks
    ((1, 3, 5, 640), 3, None, "cuda_core"),        # EBRN's recon 10F -> 3 over the concat
    ((1, 3, 5, 640), 48, None, "tensor_core"),     # ebrn_rm's upsample 10F -> 48: ten chunks
    ((2, 7, 9, 3), 3, "relu", "cuda_core"),        # HRSR's 3-channel HR convs
    ((1, 5, 7, 64), 64, "leaky_relu", "tensor_core"),  # ebrn_rm's BRM conv1 at slope 0.05
])
def test_conv3x3_ebrn_hrsr_shapes_match_plain_version(conv_lib, shape, f, act, path, dname):
    """The EBRN and HRSR families' new conv shapes on the path `path_for`
    gives them: C = 640 (ten 64-channel chunks, or the CUDA cores where F =
    3), 3 -> 256 and 3 -> 3 on the CUDA cores, 256 -> 64, and leaky_relu at
    ebrn_rm's slope 0.05."""
    dtype = DTYPES[dname]
    assert conv3x3.path_for(shape[3], f, dtype) == path
    rng = np.random.default_rng(sum(shape) + f + 640)
    x = _t(rng.standard_normal(shape)).to(dtype)
    k = _t(0.05 * rng.standard_normal((3, 3, shape[3], f)))
    b = _t(rng.standard_normal(f))
    got = conv3x3._run(conv3x3.bind(conv_lib, dtype, path), x, k, b, act, None, path,
                       slope=0.05)
    want = conv3x3.conv3x3_bias_act_reference(x, k, b, act, 0.05)
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
@pytest.mark.parametrize("shape,f,act,path", [
    ((1, 5, 7, 48), 64, "leaky_relu", "tensor_core"),  # IMDN's conv2 / conv3 r -> F at 0.05
    ((1, 5, 7, 48), 16, "leaky_relu", "tensor_core"),  # IMDN's conv4 r -> d
    ((1, 5, 7, 64), 48, None, "tensor_core"),          # IMDN's upsample conv 64 -> 3 s^2, x4
    ((1, 5, 7, 64), 27, None, "cuda_core"),            # the same at x3
])
def test_conv3x3_imdn_shapes_match_plain_version(conv_lib, shape, f, act, path, dname):
    """IMDN's new conv shapes on the path `path_for` gives them: the 48-channel
    inputs of its distillation stages at leaky_relu(0.05), one of them to 16
    outputs, and the upsample conv to 48 (tensor cores) and 27 (CUDA cores)."""
    dtype = DTYPES[dname]
    assert conv3x3.path_for(shape[3], f, dtype) == path
    rng = np.random.default_rng(sum(shape) + f + 1948)
    x = _t(rng.standard_normal(shape)).to(dtype)
    k = _t(0.05 * rng.standard_normal((3, 3, shape[3], f)))
    b = _t(rng.standard_normal(f))
    got = conv3x3._run(conv3x3.bind(conv_lib, dtype, path), x, k, b, act, None, path,
                       slope=0.05)
    want = conv3x3.conv3x3_bias_act_reference(x, k, b, act, 0.05)
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got.float() - want.float()).abs()
    print("emulated conv3x3 %s %s %s->%d %s: max|d| %.3g"
          % (path, dname, shape, f, act, float(diff.max())))
    assert torch.isfinite(got.float()).all()
    if act is not None:
        assert bool((want < 0).any())  # the slope's side is taken
    if dname == "f32":
        assert float(diff.max()) <= F32_ATOL["conv"]
    else:
        assert bool((diff <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())
