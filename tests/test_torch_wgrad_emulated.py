"""The port's CUDA source `csrc/conv3x3_wgrad.cu` (the weight gradient), built for the CPU
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

from larvanet_tpu_torch.ops import conv3x3_wgrad as wg
from torch_emulated import lib as _lib
from torch_emulated import t as _t

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give


@pytest.fixture(scope="module")
def wgrad_lib():
    return _lib(wg.SOURCE)


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


def _wgrad_case(lib, path, shape, f, splits, dtype=torch.float32):
    """The tiled entry of `path` with its pixel tiles cut into `splits`
    runs (the last one short where the tiles allow), against the plain
    version, and again, bit for bit."""
    rng = np.random.default_rng(sum(shape) * 7 + f + splits)
    x = _t(rng.standard_normal(shape)).to(dtype)
    g = _t(rng.standard_normal(shape[:3] + (f,))).to(dtype)
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


# the bf16 entry: products of two bf16 values, exact in f32, summed in f32 in
# another order than the plain version (which widens the same values to
# f32): the f32 entry's bar
@pytest.mark.parametrize("shape,f,splits", [
    ((5, 5, 9, 16), 16, 3),    # N = 5 tiles ending inside H and W; splits of 2, 2, 1
    ((1, 5, 7, 48), 16, 1),    # C = 48: a part-filled channel chunk
    ((1, 5, 7, 16), 48, 1),    # F = 48: a part-filled F tile
    ((1, 9, 7, 64), 24, 2),    # C = 64, F = 24 (three n8 tiles); two tile rows
])
def test_conv3x3_wgrad_bf16_tensor_core_entry_matches_plain_version(wgrad_lib, shape, f,
                                                                    splits):
    _wgrad_case(wgrad_lib, "tensor_core_bf16", shape, f, splits, torch.bfloat16)


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
