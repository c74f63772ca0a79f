"""csrc/conv_kxk.cu built for the CPU by larvanet_tpu_torch/ops/emulate.py (a
thread per CUDA thread, a barrier for __syncthreads), against the plain
versions of ops/conv_kxk.py.

The kernels run through the wrapper's own `bind` / `bind_wgrad` and `_run` /
`_run_wgrad`, so this checks the source's indexing, padding, tiling, the
in-kernel padding of F, the split-TF32 and bf16 products and the wgrad's
split and second pass, and the wrapper's operand layout; what nvcc accepts
and how fast the kernels run only the card shows (chip_smoke.py phase 14).
The shapes are the collapsed tail's at 16 channels instead of 64: the main
5x5 SAME conv to 3 s^2 = 12, 27 and 48 outputs, the border operators (4x5
and 5x4 on 4-pixel strips to b q outputs, the corners as 4x4 convs of a
4x4 patch), the interpolated base's 3 -> 48 on the CUDA cores, the input
gradient 48 -> 16, the weight gradient 16 -> 48; at images of one or two
tiles, because the stand-in runs every warp-wide product behind a
barrier of its 32 threads. Inputs come from numpy with a seed.
"""

import numpy as np
import pytest
import torch

from larvanet_tpu_torch.ops import conv_kxk as ck
from larvanet_tpu_torch.ops import emulate

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
    got = ck._run(ck.bind(lib, dtype, path), x, k, b, pads, None)
    err = _held(got, ck.conv_kxk_reference(x, k, b, pads), dname)
    print("emulated conv_kxk %s %s %dx%d -> %d pads %s (%s): max|d| %.3g"
          % (dname, shape, kh, kw, f, pads, path, err))


@pytest.mark.parametrize("dname", ["f32", "bf16"])
def test_conv_kxk_pixel_sums_ignore_tile_place_and_batch(lib, dname):
    """A pixel's bits depend on its neighbourhood only: the same image shifted
    by (3, 5) inside a larger zero canvas, and batched after another image,
    gives the same interior outputs bit for bit (the collapsed tail's probes
    subtract responses and the tilings must equal the full frame)."""
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


@pytest.mark.parametrize("dname,shape,f,splits_chunk", [
    ("f32", (1, 6, 8, 16), 48, None),     # the live tail's 5x5 conv, the wrapper's split
    ("bf16", (1, 6, 8, 16), 48, None),
    ("f32", (1, 6, 8, 16), 48, (3, 16)),  # three runs, the last one shorter
    ("f32", (1, 7, 6, 3), 48, (2, 32)),   # C = 3: rows of one tile, the db row inside it
])
def test_conv_kxk_wgrad_matches_plain_version(lib, dname, shape, f, splits_chunk):
    dtype = DTYPES[dname]
    rng = np.random.default_rng(sum(shape) + f)
    x = _t(rng.standard_normal(shape)).to(dtype)
    g = _t(rng.standard_normal(shape[:3] + (f,))).to(dtype)
    m = shape[0] * shape[1] * shape[2]
    splits, chunk = splits_chunk or ck.wgrad_splits(m, 25 * shape[3] + 1, f, 1)
    dw, db = ck._run_wgrad(ck.bind_wgrad(lib, dtype), x, g, 5, 5, (2, 2, 2, 2), splits, chunk,
                           None)
    want_w, want_b = ck.conv_kxk_wgrad_reference(x, g, 5, 5, (2, 2, 2, 2))
    assert dw.shape == want_w.shape and db.shape == want_b.shape
    rel_w = float((dw - want_w).abs().max() / want_w.abs().max())
    rel_b = float((db - want_b).abs().max() / want_b.abs().max())
    print("emulated conv_kxk_wgrad %s %s -> %d, %d runs of %d: %.3g / %.3g of max |dW| / |db|"
          % (dname, shape, f, splits, chunk, rel_w, rel_b))
    assert rel_w <= WGRAD_RTOL and rel_b <= WGRAD_RTOL


def test_conv_kxk_wgrad_is_the_same_on_every_run(lib):
    """No float atomics: two runs give the same bits."""
    rng = np.random.default_rng(9)
    x = _t(rng.standard_normal((1, 4, 6, 16)))
    g = _t(rng.standard_normal((1, 4, 6, 24)))
    fn = ck.bind_wgrad(lib, torch.float32)
    first = ck._run_wgrad(fn, x, g, 5, 5, (2, 2, 2, 2), 2, 16, None)
    again = ck._run_wgrad(fn, x, g, 5, 5, (2, 2, 2, 2), 2, 16, None)
    assert all(torch.equal(a, b) for a, b in zip(first, again))


def _call(lib, dtype, path, x, kernel, pads, f):
    kmat = ck.entry_weight(kernel, dtype)
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
        # 11x11 taps x 64 outputs: past a block's shared memory in both dtypes
        kernel, f, pads = torch.zeros((11, 11, c, 64)), 64, (5, 5, 5, 5)
    if case == "misaligned":
        # a view one element in: 2 bytes off a 4-byte boundary
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
