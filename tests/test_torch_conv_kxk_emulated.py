"""csrc/conv_kxk.cu built for the CPU by larvanet_tpu_torch/ops/emulate.py (a
thread per CUDA thread, a barrier for __syncthreads), against the plain
versions of ops/conv_kxk.py.

The kernels run through the wrapper's own `bind` / `bind_wgrad` and `_run` /
`_run_group` / `_run_wgrad`, so this checks the source's indexing, padding,
tiles (8 x 16 and 16 x 16 in the interior, 1 x 128, 128 x 1 and 16 images
of one pixel), its TMA halo ring and weight chunks (resident and streamed),
the split-TF32 and bf16 products, the grouped launches, the wgrad's split
and second pass on both paths, and the wrapper's operand layouts (the
chunked, swizzled and split weight); what nvcc accepts and how fast the
kernels run only the card shows (chip_smoke.py phase 14). The shapes are
the collapsed tail's at 16 channels instead of 64: the main 5x5 SAME conv
to 3 s^2 = 12, 27 and 48 outputs, the border operators (4x5 and 5x4 on
4-pixel strips to b q outputs, the corners as 4x4 convs of a 4x4 patch),
the interpolated base's 3 -> 48 on the CUDA cores, the input gradient 48
-> 16, the weight gradient 16 -> 48; at images of one or two tiles,
because the stand-in runs every warp-wide product behind a barrier of its
32 threads. Inputs come from numpy with a seed.
"""

import ctypes
import subprocess

import numpy as np
import pytest
import torch

from larvanet_tpu_torch.ops import conv_kxk as ck
from larvanet_tpu_torch.ops import emulate

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

# f32: the kernel sums the same f32 products as the plain version in another
# order, in split TF32 (a_lo b_lo, ~2^-22 of each product, dropped): sums of
# 25 x 16 products of N(0, 1) x 0.1 N(0, 1) values, ~1e-6 apart; the bar of
# the 3x3 conv kernels (chip_smoke.py F32_ATOL)
F32_ATOL = 2e-4
# bf16: the same bf16 operands and f32 sums, one rounding of the output: one
# bf16 step of the value plus a floor near 0
BF16_RTOL, BF16_ATOL = 2.0 ** -7, 1e-3
# the weight gradient, f32 sums of f32 products in another order, relative
# to the largest |dW| (chip_smoke.py GRAD_RTOL's 3x3 counterpart is 2e-4)
WGRAD_RTOL = 1e-5
DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
CUDA_ERROR_INVALID_VALUE = 1
CUDA_ERROR_MISALIGNED_ADDRESS = 716


@pytest.fixture(scope="module")
def lib():
    try:
        emulate.compiler()
    except RuntimeError as exc:
        pytest.skip(str(exc))
    return emulate.load(ck.SOURCE)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a, np.float32))


def _operands(rng, shape, kh, kw, f, dtype):
    x = _t(rng.standard_normal(shape)).to(dtype)
    k = _t(0.1 * rng.standard_normal((kh, kw, shape[3], f)))
    b = _t(rng.standard_normal(f))
    return x, k, b


def _held(got, want, dname):
    assert got.shape == want.shape and got.dtype == want.dtype
    diff = (got.float() - want.float()).abs()
    assert torch.isfinite(got.float()).all()
    if dname == "f32":
        assert float(diff.max()) <= F32_ATOL, float(diff.max())
    else:
        assert bool((diff <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())
    return float(diff.max())


CASES = [
    ((1, 6, 18, 16), 5, 5, 12, (2, 2, 2, 2), "tensor_core"),   # x2 main conv, 2 W tiles
    ((2, 5, 7, 16), 5, 5, 27, (2, 2, 2, 2), "tensor_core"),    # x3 main conv, batch 2
    ((1, 9, 7, 16), 5, 5, 48, (2, 2, 2, 2), "tensor_core"),    # x4 main conv, 2 H tiles
    ((2, 4, 11, 16), 4, 5, 24, (0, 0, 2, 2), "tensor_core"),   # x2 top/bottom side op
    ((1, 9, 4, 16), 5, 4, 24, (2, 2, 0, 0), "tensor_core"),    # x2 left/right side op
    ((1, 4, 4, 16), 4, 4, 12, (0, 0, 0, 0), "tensor_core"),    # a corner: 1x1 output
    ((1, 5, 7, 48), 5, 5, 16, (2, 2, 2, 2), "tensor_core"),    # the input gradient 48 -> 16
    ((2, 5, 6, 3), 5, 5, 48, (2, 2, 2, 2), "cuda_core"),       # the bicubic base 3 -> 48
    ((1, 5, 7, 8), 3, 3, 12, (1, 1, 1, 1), "cuda_core"),       # a narrow width, bilinear
]


@pytest.mark.parametrize("dname,shape,kh,kw,f,pads,path", [
    (d,) + case for d in ("f32", "bf16") for case in CASES] + [
    # x4's side operator: 96 outputs, a block of 64 and one of 32 (bf16: one
    # product a k-step where f32 takes three, the same indexing)
    ("bf16", (1, 4, 11, 16), 4, 5, 96, (0, 0, 2, 2), "tensor_core")])
def test_conv_kxk_matches_plain_version(lib, dname, shape, kh, kw, f, pads, path):
    assert ck.path_for(shape[3]) == path
    dtype = DTYPES[dname]
    x, k, b = _operands(np.random.default_rng(sum(shape) + kh * f), shape, kh, kw, f, dtype)
    got = ck._run(ck.bind(lib, dtype, path), x, k, b, pads, None, path)
    err = _held(got, ck.conv_kxk_reference(x, k, b, pads), dname)
    print("emulated conv_kxk %s %s %dx%d -> %d pads %s (%s): max|d| %.3g"
          % (dname, shape, kh, kw, f, pads, path, err))


# more tile shapes and rings, each against the plain version: (shape, kh,
# kw, F, pads, dtypes)
TILE_CASES = [
    ((1, 10, 19, 16), 3, 3, 8, (1, 1, 1, 1), "f32 bf16"),  # ragged in H and W: 2 x 2 tiles
    ((1, 4, 131, 16), 4, 5, 16, (0, 0, 2, 2), "f32 bf16"),  # one row: 1 x 64 tiles, ragged
    ((1, 130, 4, 16), 5, 4, 16, (2, 2, 0, 0), "f32 bf16"),  # one column: 64 x 1 tiles, ragged
    ((18, 4, 4, 16), 4, 4, 8, (0, 0, 0, 0), "f32 bf16"),    # 18 corners: tiles of 16 images
    ((1, 5, 9, 16), 9, 9, 96, (4, 4, 4, 4), "bf16"),        # weights past shared memory: streamed
    ((1, 5, 9, 16), 7, 7, 48, (3, 3, 3, 3), "f32"),         # streamed split weights
]


@pytest.mark.parametrize("dname,case", [(d, i) for d in ("f32", "bf16")
                                        for i in range(len(TILE_CASES))
                                        if d in TILE_CASES[i][5].split()])
def test_conv_kxk_tile_shapes_match_plain_version(lib, dname, case):
    shape, kh, kw, f, pads, _ = TILE_CASES[case]
    dtype = DTYPES[dname]
    x, k, b = _operands(np.random.default_rng(31 + case), shape, kh, kw, f, dtype)
    got = ck._run(ck.bind(lib, dtype), x, k, b, pads, None)
    err = _held(got, ck.conv_kxk_reference(x, k, b, pads), dname)
    print("emulated conv_kxk %s %s %dx%d -> %d pads %s: max|d| %.3g"
          % (dname, shape, kh, kw, f, pads, err))


def test_chunked_weight_is_the_split_kernel_swizzled():
    """The tensor-core operand: f32 hi + lo rebuild the kernel to 2^-22, both
    tf32 values; granule q of output row n sits at q ^ (n % 8); C past a
    chunk is padded with zeros."""
    rng = np.random.default_rng(4)
    k = _t(rng.standard_normal((2, 3, 40, 10)))
    op = ck.chunked_weight([k], torch.float32)
    assert op.shape == (1, 2, 6, 2, 10, 32)
    # un-swizzle: physical granule q' of row n holds logical q' ^ (n % 8)
    rows = torch.arange(10)[:, None]
    logical = torch.arange(8)[None, :] ^ (rows % 8)
    plain = torch.empty_like(op.reshape(1, 2, 6, 2, 10, 8, 4))
    plain[..., torch.arange(10)[:, None], logical, :] = op.reshape(1, 2, 6, 2, 10, 8, 4)
    plain = plain.reshape(1, 2, 6, 2, 10, 32)[0]                 # (chunks, taps, 2, F, 32)
    hi, lo = plain[:, :, 0], plain[:, :, 1]
    full = (hi + lo).permute(1, 0, 3, 2).reshape(2, 3, 64, 10)   # (kh, kw, C padded, F)
    assert float((full[:, :, :40] - k).abs().max()) <= 2.0 ** -21 * float(k.abs().max())
    assert torch.equal(full[:, :, 40:], torch.zeros(2, 3, 24, 10))
    for part in (hi, lo):
        assert not bool((part.view(torch.int32) & 0x1FFF).any())
    bf = ck.chunked_weight([k], torch.bfloat16)
    assert bf.shape == (1, 1, 6, 1, 10, 64) and bf.dtype == torch.bfloat16


GROUP_CASES = [
    ((2, 4, 11, 16), 4, 5, 24, (0, 0, 2, 2), 2),   # top + bottom of a x2 tail
    ((1, 9, 4, 16), 5, 4, 24, (2, 2, 0, 0), 2),    # left + right
    ((2, 4, 4, 16), 4, 4, 12, (0, 0, 0, 0), 4),    # four corners
    ((1, 6, 5, 3), 3, 3, 8, (1, 1, 1, 1), 2),      # C = 3: the CUDA-core group
]


@pytest.mark.parametrize("dname,case", [(d, i) for d in ("f32", "bf16")
                                        for i in range(len(GROUP_CASES))])
def test_conv_kxk_group_matches_plain_version(lib, dname, case):
    """One grouped launch of G problems with distinct weights and biases:
    each output against its plain version, and bit for bit the single
    launch of the same problem."""
    shape, kh, kw, f, pads, groups = GROUP_CASES[case]
    dtype = DTYPES[dname]
    path = ck.path_for(shape[3])
    rng = np.random.default_rng(51 + case)
    ops = [_operands(rng, shape, kh, kw, f, dtype) for _ in range(groups)]
    xs, ks, bs = (list(part) for part in zip(*ops))
    got = ck._run_group(ck.bind(lib, dtype, path, group=True), torch.stack(xs),
                        ck.ConvGroup(ks, bs), pads, None, path)
    assert got.shape[0] == groups
    for x, k, b, y in zip(xs, ks, bs, got):
        _held(y, ck.conv_kxk_reference(x, k, b, pads), dname)
        assert torch.equal(y, ck._run(ck.bind(lib, dtype, path), x, k, b, pads, None, path))


def test_conv_kxk_group_on_the_cpu_is_the_plain_version_per_problem():
    rng = np.random.default_rng(8)
    ops = [_operands(rng, (1, 4, 9, 8), 4, 5, 6, torch.float32) for _ in range(2)]
    xs, ks, bs = (list(part) for part in zip(*ops))
    for kernels, biases in ((ks, bs), (ck.ConvGroup(ks, bs), None)):
        got = ck.conv_kxk_group([x[:, :, 1:] for x in xs], kernels, biases, (0, 0, 2, 2))
        for x, k, b, y in zip(xs, ks, bs, got):
            assert torch.equal(y, ck.conv_kxk_reference(x[:, :, 1:], k, b, (0, 0, 2, 2)))
    ks[1].requires_grad_(True)
    with pytest.raises(ValueError, match="no gradient"):
        ck.conv_kxk_group(xs, ks, bs, (0, 0, 2, 2))


@pytest.mark.parametrize("dname,c", [("f32", 16), ("bf16", 3)])
def test_conv_kxk_fixed_kernel_is_the_kernel_call(lib, dname, c):
    """A fixed kernel held as a ConvGroup of one (the baked tail's main conv)
    gives the bits of the same HWIO kernel laid out for the call, makes its
    operands once, and takes no gradient; on the CPU it is the plain
    version."""
    dtype = DTYPES[dname]
    path = ck.path_for(c)
    x, k, b = _operands(np.random.default_rng(12 + c), (1, 5, 7, c), 5, 5, 12, dtype)
    fixed = ck.ConvGroup([k], [b])
    fn = ck.bind(lib, dtype, path)
    want = ck._run(fn, x, k, b, (2, 2, 2, 2), None, path)
    for _ in range(2):
        assert torch.equal(ck._run(fn, x, fixed, None, (2, 2, 2, 2), None, path), want)
    assert list(fixed._operands) == [(dtype, path)]
    assert torch.equal(ck.conv_kxk(x, fixed, None, (2, 2, 2, 2)),
                       ck.conv_kxk_reference(x, k, b, (2, 2, 2, 2)))
    with pytest.raises(ValueError, match="one problem"):
        ck.conv_kxk(x, ck.ConvGroup([k, k]))
    with pytest.raises(ValueError, match="one problem"):
        ck.conv_kxk(x, fixed, b)
    with pytest.raises(ValueError, match="no gradient"):
        ck.conv_kxk_op(x.clone().requires_grad_(True), fixed)


@pytest.mark.parametrize("dname", ["f32", "bf16"])
def test_conv_kxk_pixel_sums_ignore_tile_place_and_batch(lib, dname):
    """A pixel's bits depend on its neighbourhood only: the same image shifted
    by (3, 5) inside a larger zero canvas, and batched after another image,
    gives the same interior outputs bit for bit (the collapsed tail's probes
    subtract responses and the tilings must equal the full frame); so do a
    strip's row through the 1 x 128 tile and inside a taller image through
    the interior tile, a column through the 128 x 1 tile, a corner through
    the tile of 16 images, and a grouped launch against a single one."""
    dtype = DTYPES[dname]
    rng = np.random.default_rng(5)
    x, k, b = _operands(rng, (1, 6, 12, 16), 3, 3, 8, dtype)
    fn = ck.bind(lib, dtype, "tensor_core")
    out = ck._run(fn, x, k, b, (1, 1, 1, 1), None)
    canvas = torch.zeros((2, 11, 16, 16), dtype=dtype)
    canvas[0] = _t(rng.standard_normal((11, 16, 16))).to(dtype)
    canvas[1, 3:9, 3:15] = x[0]
    moved = ck._run(fn, canvas.contiguous(), k, b, (1, 1, 1, 1), None)
    inner = out[0, 1:-1, 1:-1]
    assert torch.equal(moved[1, 4:8, 4:14], inner)

    image, kr, br = _operands(rng, (1, 9, 10, 16), 4, 5, 8, dtype)
    tall = ck._run(fn, image, kr, br, (0, 0, 2, 2), None)            # 6 x 10: 8 x 16 tiles
    strip = ck._run(fn, image[:, 3:7].contiguous(), kr, br, (0, 0, 2, 2), None)  # 1 x 10
    assert strip.shape[1] == 1 and torch.equal(strip[:, 0], tall[:, 3])
    kc = kr.permute(1, 0, 2, 3).contiguous()                        # 5 x 4
    wide = ck._run(fn, image, kc, br, (2, 2, 0, 0), None)            # 9 x 7
    column = ck._run(fn, image[:, :, 2:6].contiguous(), kc, br, (2, 2, 0, 0), None)
    assert column.shape[2] == 1 and torch.equal(column[:, :, 0], wide[:, :, 2])
    kq = kr[:, :4].contiguous()                                     # 4 x 4, no pads
    whole = ck._run(fn, image, kq, br, (0, 0, 0, 0), None)            # 6 x 7
    corner = ck._run(fn, image[:, 2:6, 3:7].contiguous(), kq, br, (0, 0, 0, 0), None)
    assert corner.shape[1:3] == (1, 1) and torch.equal(corner[:, 0, 0], whole[:, 2, 3])
    pair = ck._run_group(ck.bind(lib, dtype, group=True),
                         torch.stack([image[:, 3:7], image[:, 5:9]]),
                         ck.ConvGroup([kr, kr], [br, br]), (0, 0, 2, 2), None)
    assert torch.equal(pair[0], strip) and torch.equal(pair[1][:, 0], tall[:, 5])


@pytest.mark.parametrize("dname,shape,f,splits_chunk", [
    ("f32", (1, 6, 8, 16), 48, None),     # the live tail's 5x5 conv, the wrapper's split
    ("bf16", (1, 6, 8, 16), 48, None),
    ("f32", (1, 8, 65, 16), 48, (3, 2)),  # three runs of 8 x 16 tiles, the last one shorter
    ("f32", (1, 7, 6, 3), 48, (2, 32)),   # C = 3 (CUDA cores): rows of one tile, db inside
])
def test_conv_kxk_wgrad_matches_plain_version(lib, dname, shape, f, splits_chunk):
    dtype = DTYPES[dname]
    rng = np.random.default_rng(sum(shape) + f)
    x = _t(rng.standard_normal(shape)).to(dtype)
    g = _t(rng.standard_normal(shape[:3] + (f,))).to(dtype)
    path = ck.wgrad_path_for(shape[3], 5, 5)
    splits, chunk = splits_chunk or ck.wgrad_splits(path, *shape, 5, 5, f, 1, dtype)
    dw, db = ck._run_wgrad(ck.bind_wgrad(lib, dtype, path), x, g, 5, 5, (2, 2, 2, 2), splits,
                           chunk, None)
    want_w, want_b = ck.conv_kxk_wgrad_reference(x, g, 5, 5, (2, 2, 2, 2))
    assert dw.shape == want_w.shape and db.shape == want_b.shape
    rel_w = float((dw - want_w).abs().max() / want_w.abs().max())
    rel_b = float((db - want_b).abs().max() / want_b.abs().max())
    print("emulated conv_kxk_wgrad %s %s -> %d (%s), %d runs of %d: %.3g / %.3g of max |dW| / "
          "|db|" % (dname, shape, f, path, splits, chunk, rel_w, rel_b))
    assert rel_w <= WGRAD_RTOL and rel_b <= WGRAD_RTOL


# the tensor-core weight gradient at more shapes: (shape, kh, kw, F, pads)
WGRAD_TC_CASES = [
    ((1, 6, 8, 16), 5, 5, 27, (2, 2, 2, 2)),    # F not a multiple of 8: g copied element-wise
    ((1, 4, 9, 16), 4, 5, 56, (0, 0, 2, 2)),    # a side operator's shape; F > 48: 2 output blocks
    ((2, 5, 6, 32), 3, 3, 8, (1, 1, 1, 1)),     # 2 channel chunks, 9 taps, batch 2
]


@pytest.mark.parametrize("dname,case", [(d, i) for d in ("f32", "bf16")
                                        for i in range(len(WGRAD_TC_CASES))])
def test_conv_kxk_wgrad_tensor_core_shapes(lib, dname, case):
    shape, kh, kw, f, pads = WGRAD_TC_CASES[case]
    dtype = DTYPES[dname]
    rng = np.random.default_rng(71 + case)
    x = _t(rng.standard_normal(shape)).to(dtype)
    ho, wo = ck.out_size(shape[1], shape[2], kh, kw, pads)
    g = _t(rng.standard_normal((shape[0], ho, wo, f))).to(dtype)
    assert ck.wgrad_path_for(shape[3], kh, kw) == "tensor_core"
    splits, chunk = ck.wgrad_splits("tensor_core", shape[0], ho, wo, shape[3], kh, kw, f, 1,
                                    dtype)
    dw, db = ck._run_wgrad(ck.bind_wgrad(lib, dtype, "tensor_core"), x, g, kh, kw, pads,
                           splits, chunk, None)
    want_w, want_b = ck.conv_kxk_wgrad_reference(x, g, kh, kw, pads)
    rel_w = float((dw - want_w).abs().max() / want_w.abs().max())
    rel_b = float((db - want_b).abs().max() / want_b.abs().max())
    print("emulated conv_kxk_wgrad %s %s %dx%d -> %d: %.3g / %.3g" % (
        dname, shape, kh, kw, f, rel_w, rel_b))
    assert rel_w <= WGRAD_RTOL and rel_b <= WGRAD_RTOL


def test_conv_kxk_wgrad_is_the_same_on_every_run(lib):
    """No float atomics: two runs of the tensor-core entry, its pixel sum in
    two runs of tiles, give the same bits."""
    rng = np.random.default_rng(9)
    x = _t(rng.standard_normal((1, 12, 6, 16)))
    g = _t(rng.standard_normal((1, 12, 6, 24)))
    fn = ck.bind_wgrad(lib, torch.float32, "tensor_core")
    first = ck._run_wgrad(fn, x, g, 5, 5, (2, 2, 2, 2), 2, 1, None)
    again = ck._run_wgrad(fn, x, g, 5, 5, (2, 2, 2, 2), 2, 1, None)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def _call(lib, dtype, path, x, kernel, pads, f):
    kmat = (ck.chunked_weight([kernel], dtype) if path == "tensor_core"
            else ck.entry_weight(kernel, dtype))
    y = torch.empty(64 * 64, dtype=dtype)
    b = torch.zeros(f)
    n, h, w, c = x.shape
    kh, kw = kernel.shape[:2]
    return ck.bind(lib, dtype, path)(x.data_ptr(), kmat.data_ptr(), b.data_ptr(), y.data_ptr(),
                                     n, h, w, c, kh, kw, f, *pads, None)


@pytest.mark.parametrize("dname,case", [
    (d, c) for d in ("f32", "bf16") for c in ("c_not_16", "negative_pad", "no_output", "smem")
] + [("bf16", "misaligned")])  # every f32 pointer is 4-byte aligned
def test_conv_kxk_tensor_core_entry_refuses_what_it_cannot_take(lib, dname, case):
    dtype = DTYPES[dname]
    c = 8 if case == "c_not_16" else 16
    x = torch.zeros((1, 4, 6, c), dtype=dtype)
    pads = {"negative_pad": (-1, 2, 2, 2), "no_output": (0, 0, 0, 0)}.get(case, (2, 2, 2, 2))
    kernel, f = torch.zeros((5, 5, c, 12)), 12
    if case == "smem":
        # 31x31 taps: one halo of an 8 x 16 (bf16) or 16 x 16 (f32) tile is
        # past a block's shared memory (the weights stream, whatever F)
        kernel, f, pads = torch.zeros((31, 31, c, 64)), 64, (15, 15, 15, 15)
    if case == "misaligned":
        # a view one element in: 2 bytes off a 16-byte boundary
        x = torch.zeros(1 + 4 * 6 * c, dtype=dtype)[1:].view(1, 4, 6, c)
    want = (CUDA_ERROR_MISALIGNED_ADDRESS if case == "misaligned"
            else CUDA_ERROR_INVALID_VALUE)
    assert _call(lib, dtype, "tensor_core", x, kernel, pads, f) == want


@pytest.mark.parametrize("case", ["empty_split", "past_the_end", "short", "no_output"])
def test_conv_kxk_wgrad_entry_refuses_what_it_cannot_take(lib, case):
    x = torch.zeros((1, 4, 6, 16))
    g = torch.zeros((1, 4, 6, 12))
    m = 24
    splits, chunk, pads = {"empty_split": (0, 24, (2, 2, 2, 2)),
                           "past_the_end": (3, 16, (2, 2, 2, 2)),
                           "short": (1, m - 1, (2, 2, 2, 2)),
                           "no_output": (1, 24, (0, 0, 0, 0))}[case]
    ws = torch.empty(max(splits, 1) * (25 * 16 + 1) * 12)
    out = torch.empty((25 * 16 + 1) * 12)
    fn = ck.bind_wgrad(lib, torch.float32)
    err = fn(x.data_ptr(), g.data_ptr(), ws.data_ptr(), out.data_ptr(), 1, 4, 6, 16, 5, 5, 12,
             *pads, splits, chunk, None)
    assert err == CUDA_ERROR_INVALID_VALUE


@pytest.mark.parametrize("case", ["c_not_16", "taps", "split_past_the_end", "empty_split",
                                  "misaligned"])
def test_conv_kxk_wgrad_tensor_core_entry_refuses_what_it_cannot_take(lib, case):
    c = 8 if case == "c_not_16" else 16
    kh = 7 if case == "taps" else 5  # 49 taps: past a block's 25
    x = torch.zeros((1, 12, 6, c))
    if case == "misaligned":
        x = torch.zeros(1 + 12 * 6 * c)[1:].view(1, 12, 6, c)
    g = torch.zeros((1, 12, 6, 12))
    splits, chunk = {"split_past_the_end": (3, 1), "empty_split": (0, 2)}.get(case, (1, 2))
    rows = kh * kh * c + 1
    ws = torch.empty(max(splits, 1) * rows * 12)
    out = torch.empty(rows * 12)
    fn = ck.bind_wgrad(lib, torch.float32, "tensor_core")
    err = fn(x.data_ptr(), g.data_ptr(), ws.data_ptr(), out.data_ptr(), 1, 12, 6, c, kh, kh, 12,
             kh // 2, kh // 2, kh // 2, kh // 2, splits, chunk, None)
    assert err == (CUDA_ERROR_MISALIGNED_ADDRESS if case == "misaligned"
                   else CUDA_ERROR_INVALID_VALUE)


def test_ldmatrix_trans_stand_in_follows_the_ptx_layout(tmp_path):
    """emu_ldmatrix_x4_trans (csrc/emu/cuda_runtime.h): lane l = 4 g + t
    receives in r[i] the elements (2t, g) and (2t + 1, g) of matrix i, the
    rows named by lanes 8 i .. 8 i + 7 (the PTX ISA's ldmatrix .trans)."""
    try:
        cxx = emulate.compiler()
    except RuntimeError as exc:
        pytest.skip(str(exc))
    src = tmp_path / "ldsm.cpp"
    src.write_text(r"""
#include <cstring>
#include <cuda_runtime.h>
void kern(const unsigned short* in, unsigned* out) {
  unsigned short* sm = reinterpret_cast<unsigned short*>(emu_smem());
  if (threadIdx.x == 0) std::memcpy(sm, in, 4 * 8 * 8 * 2);
  __syncthreads();
  // lane l names row l % 8 of matrix l / 8, the rows of the matrices in
  // reverse order in memory so that the names matter
  const int l = threadIdx.x;
  unsigned r[4];
  emu_ldmatrix_x4_trans(r, sm + (l / 8) * 64 + (7 - l % 8) * 8);
  for (int i = 0; i < 4; ++i) out[4 * l + i] = r[i];
}
extern "C" void run(const unsigned short* in, unsigned* out) {
  emu_launch(kern, dim3(1), 32, 4 * 8 * 8 * 2, nullptr, in, out);
}
""")
    lib_path = tmp_path / "ldsm.so"
    subprocess.run([cxx, *emulate.CXX_FLAGS, "-I", str(emulate.EMU_DIR), "-o", str(lib_path),
                    str(src)], check=True, capture_output=True)
    run = ctypes.CDLL(str(lib_path)).run
    run.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    mem = np.arange(4 * 8 * 8, dtype=np.uint16)   # matrix i, stored row s, column c
    out = np.zeros(32 * 4, dtype=np.uint32)
    run(mem.ctypes.data, out.ctypes.data)
    for lane in range(32):
        g, t = lane // 4, lane % 4
        for i in range(4):
            # row r of matrix i is stored row 7 - r
            lo = mem[i * 64 + (7 - 2 * t) * 8 + g]
            hi = mem[i * 64 + (7 - (2 * t + 1)) * 8 + g]
            assert out[4 * lane + i] == int(lo) | (int(hi) << 16), (lane, i)
