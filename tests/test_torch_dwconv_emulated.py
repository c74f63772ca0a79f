"""The port's depthwise 3x3 CUDA source (`csrc/dwconv3x3.cu`: the forward, the
input gradient on the same entry, the weight gradient), built for the CPU by
larvanet_tpu_torch/ops/emulate.py (a fiber per CUDA thread, a barrier for
__syncthreads, cp.async copies that land at the issuing thread's wait),
against its plain version.

The kernels run through the wrapper's own `bind` and `_run` / `_run_wgrad`,
so this checks the source's indexing, masking, tiling, ring and arithmetic;
what nvcc accepts and how fast the kernels run only the card shows
(chip_smoke.py). Inputs come from numpy with a seed. The stand-in's card
holds one block unless a test builds it with more SMs, so the forward's
one persistent block (a chunk's) walks every row of every strip through
the ring; with 6 SMs its runs start inside strips and cross them.
"""

import re

import numpy as np
import pytest
import torch

from larvanet_tpu_torch.ops import build
from larvanet_tpu_torch.ops import dwconv3x3 as dw
from torch_emulated import DTYPES
from torch_emulated import lib as _lib
from torch_emulated import t as _t

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

# the weight gradient sums the same f32 products as the plain version in
# another order: within 1e-5 of the largest |dk| (|db|), as conv3x3_wgrad is held
WGRAD_RTOL = 1e-5


@pytest.fixture(scope="module")
def dw_lib():
    return _lib(dw.SOURCE)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


# C and the vector it takes (4 channels where C allows: 16 bytes in f32, 8 in
# bf16): dwsr x4's 48 (12 vectors a block, 16-column tiles), MAMNet's 64 (16
# vectors), dwsr x2's 12 (3 vectors, 16-column tiles of 9 columns), an odd C
# (one channel a vector, as dwsr x3's 27 takes; bf16 copies its 2-byte
# vectors without cp.async); H and W past one tile and ragged, batch 2
DW_CASES = [(2, 9, 13, 48), (1, 5, 17, 64), (1, 10, 9, 12), (1, 3, 130, 5)]


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("shape", DW_CASES)
def test_dwconv3x3_matches_plain_version_bit_for_bit(dw_lib, shape, dname):
    rng = np.random.default_rng(sum(shape))
    dtype = DTYPES[dname]
    x = _t(rng.standard_normal(shape)).to(dtype)
    k = _t(rng.standard_normal((3, 3, 1, shape[3])))
    b = _t(rng.standard_normal(shape[3]))
    fn = dw.bind(dw_lib, "forward", dtype)
    got = dw._run(fn, x, k, b, None)
    want = dw.dwconv3x3_reference(x, k, b)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert torch.equal(_bits(got), _bits(want)), float((got.float() - want.float()).abs().max())
    # the input gradient: the same entry on the rotated taps, no bias
    zero = torch.zeros(shape[3])
    got = dw._run(fn, x, dw.dgrad_kernel(k), zero, None)
    assert torch.equal(_bits(got), _bits(dw.dwconv3x3_reference(x, dw.dgrad_kernel(k), zero)))


def _forward_and_dgrad_match(fn, x, k, b):
    """The forward and the input gradient (the rotated taps, no bias) of
    entry `fn` bit for bit with the plain version."""
    got, want = dw._run(fn, x, k, b, None), dw.dwconv3x3_reference(x, k, b)
    assert got.dtype == want.dtype and torch.equal(_bits(got), _bits(want)), \
        float((got.float() - want.float()).abs().max())
    zero = torch.zeros(x.shape[3])
    kr = dw.dgrad_kernel(k)
    got = dw._run(fn, x, kr, zero, None)
    assert torch.equal(_bits(got), _bits(dw.dwconv3x3_reference(x, kr, zero)))


def _inputs(shape, seed, dtype):
    rng = np.random.default_rng(seed)
    x = _t(rng.standard_normal(shape)).to(dtype)
    return x, _t(rng.standard_normal((3, 3, 1, shape[3]))), _t(rng.standard_normal(shape[3]))


def _plan(lib, x, dtype, entry="forward"):
    return dw.plan(lib, (x.data_ptr(),) * 3, dtype, x.shape, entry)


# The forward's tile by width: W = 48 (the train step's patches), 192 (the
# serving batch) and 510 (a 339x510 frame) pad no quarter of a tile's
# columns (at most an eighth), with G x TW / (columns a thread) <= 256
# threads, 4 columns a thread where that leaves 128 threads a block, else 2;
# W = 13 pads the least a power of two can; 12 and 5 channels (3 and 5
# vectors) take wide tiles
@pytest.mark.parametrize("w,c,tile_w,cols", [(48, 48, 16, 2), (192, 48, 64, 4),
                                             (510, 48, 64, 4), (48, 64, 16, 2),
                                             (192, 12, 64, 2), (13, 48, 16, 2),
                                             (510, 5, 128, 4)])
def test_dwconv3x3_plan_picks_the_tile_by_width(dw_lib, w, c, tile_w, cols):
    x = torch.zeros((1, 2, w, c))
    got = _plan(dw_lib, x, torch.float32)
    width = got["tiles_w"] * got["tile_w"]
    assert (got["tile_w"], got["cols_a_thread"]) == (tile_w, cols) and width >= w, got
    assert got["groups"] * got["tile_w"] // got["cols_a_thread"] <= 256
    assert got["groups"] * got["vector"] * got["chunks"] == c
    if w != 13:
        assert 8 * (width - w) <= width, got


# the forward and its input gradient at those widths, f32 and bf16: 48 and
# 192 whole tiles, 50 a ragged last tile of 2 columns
WIDTH_CASES = [(2, 4, 48, 48), (1, 3, 192, 48), (1, 5, 50, 48)]


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("shape", WIDTH_CASES)
def test_dwconv3x3_tiles_by_width_match_plain_version(dw_lib, shape, dname):
    dtype = DTYPES[dname]
    x, k, b = _inputs(shape, sum(shape), dtype)
    _forward_and_dgrad_match(dw.bind(dw_lib, "forward", dtype), x, k, b)


def test_dwconv3x3_cases_walk_more_rows_than_ring_slots(dw_lib):
    # the stand-in's one block walks every row: the width cases' rows (a
    # strip's H + 2 rows through the ring, each strip of each image) take
    # the forward's ring round more than once in both dtypes, and strips
    # start inside the block's run
    src = (build.CSRC / dw.SOURCE).read_text()
    depth = re.search(r"constexpr int kDepth = kGrad \? \(sizeof\(T\) == 4 \? (\d+) : (\d+)\)"
                      r" : \(sizeof\(T\) == 4 \? (\d+) : (\d+)\);", src).groups()
    for dtype in (torch.float32, torch.bfloat16):
        for n, h, w, c in WIDTH_CASES[:2]:
            x = torch.zeros((n, h, w, c), dtype=dtype)
            got = _plan(dw_lib, x, dtype)
            assert got["ring_slots"] == int(depth[2 + (dtype == torch.bfloat16)]) + 1
            assert _plan(dw_lib, x, dtype, "wgrad")["ring_slots"] == int(
                depth[dtype == torch.bfloat16]) + 1
            rows = n * got["tiles_w"] * (h + 2)
            assert got["tiles_w"] * n > 1 and rows > 2 * got["ring_slots"], (got, rows)


# every vector width in both dtypes: (C, pointer offset in elements, VT).
# f32: 16-byte (48, 64), 8-byte (6; 16 channels 2 elements off) and 4-byte
# (5) cp.async; bf16: 8-byte (12, 64), 4-byte (6; 16 channels 2 elements
# off) cp.async and 2-byte plain copies (5)
@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("c,offset,vector", [(48, 0, 4), (64, 0, 4), (12, 0, 4), (6, 0, 2),
                                             (16, 2, 2), (5, 0, 1)])
def test_dwconv3x3_every_vector_width_matches_plain_version(dw_lib, c, offset, vector, dname):
    dtype = DTYPES[dname]
    shape = (1, 7, 19, c)
    x0, k, b = _inputs(shape, c + offset, dtype)
    buf = torch.zeros(x0.numel() + offset, dtype=dtype)
    x = buf[offset:].view(shape)
    x.copy_(x0)
    assert _plan(dw_lib, x, dtype)["vector"] == vector
    _forward_and_dgrad_match(dw.bind(dw_lib, "forward", dtype), x, k, b)


# 4 columns a thread at the narrower vectors: 16 channels 2 elements off
# (f32 8-byte, bf16 4-byte vectors; 8 of them, 128-column tiles), 32
# channels 1 element off (one a vector, 32-column tiles)
@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("shape,offset,vector", [((1, 3, 128, 16), 2, 2), ((1, 4, 96, 32), 1, 1)])
def test_dwconv3x3_four_columns_a_thread_match_plain_version(dw_lib, shape, offset, vector,
                                                            dname):
    dtype = DTYPES[dname]
    x0, k, b = _inputs(shape, sum(shape), dtype)
    x = torch.zeros(x0.numel() + offset, dtype=dtype)[offset:].view(shape)
    x.copy_(x0)
    got = _plan(dw_lib, x, dtype)
    assert (got["vector"], got["cols_a_thread"]) == (vector, 4), got
    _forward_and_dgrad_match(dw.bind(dw_lib, "forward", dtype), x, k, b)


# the forward copies two 8-byte vectors of a pixel at once where that makes
# 16 aligned bytes: bf16 48 channels (12 vectors of 4), f32 16 channels whose
# taps lie 2 elements off (8-byte vectors, x aligned); not bf16 12 channels
# (3 vectors) nor f32's 16-byte vectors
@pytest.mark.parametrize("dname,c,k_offset,copy", [("bf16", 48, 0, 2), ("f32", 16, 2, 2),
                                                   ("bf16", 12, 0, 1), ("f32", 48, 0, 1)])
def test_dwconv3x3_copies_two_vectors_at_once_where_aligned(dw_lib, dname, c, k_offset, copy):
    dtype = DTYPES[dname]
    x, k0, b = _inputs((1, 5, 37, c), c + k_offset, dtype)
    k = torch.zeros(k0.numel() + k_offset)[k_offset:].view(k0.shape)
    k.copy_(k0)
    got = dw.plan(dw_lib, (x.data_ptr(), k.data_ptr(), x.data_ptr()), dtype, x.shape)
    assert got["copy_vectors"] == copy, got
    _forward_and_dgrad_match(dw.bind(dw_lib, "forward", dtype), x, k, b)


# C past 32 vectors: chunks of channels, each its own blocks (f32 264 = 3
# chunks of 22 vectors, 8-column tiles, 176 threads: a partial last warp);
# bf16 27 channels one a vector (27 x 8 = 216 threads)
@pytest.mark.parametrize("dname,c,chunks", [("f32", 264, 3), ("bf16", 27, 1)])
def test_dwconv3x3_channel_chunks_match_plain_version(dw_lib, dname, c, chunks):
    dtype = DTYPES[dname]
    x, k, b = _inputs((1, 4, 11, c), c, dtype)
    assert _plan(dw_lib, x, dtype)["chunks"] == chunks
    _forward_and_dgrad_match(dw.bind(dw_lib, "forward", dtype), x, k, b)


# A stand-in card of 6 SMs (a block each): the forward's persistent blocks
# cut a chunk's rows into several runs (2 a chunk at 3 chunks), which start
# inside a strip (their rim rows read from the image's rows above) and,
# where `crosses`, run on into the next strip; 2 and 4 columns a thread, 1-
# and 4-channel vectors, two-vector copies in bf16
@pytest.fixture(scope="module")
def dw_lib6():
    return _lib(dw.SOURCE, sms=6)


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("shape,crosses", [((3, 11, 16, 8), True), ((1, 10, 48, 48), True),
                                           ((1, 20, 192, 64), False), ((1, 17, 11, 264), False),
                                           ((2, 7, 50, 12), True), ((1, 30, 13, 5), False)])
def test_dwconv3x3_forward_runs_across_blocks_match_plain_version(dw_lib6, shape, crosses,
                                                                  dname):
    dtype = DTYPES[dname]
    x, k, b = _inputs(shape, sum(shape) + 7, dtype)
    got = _plan(dw_lib6, x, dtype)
    n, h = shape[:2]
    rows, runs = n * got["tiles_w"] * h, got["runs"]
    starts = [rows * j // runs for j in range(runs + 1)]
    assert runs > 1 and any(r % h for r in starts[:-1]), got
    assert any(a // h != (e - 1) // h for a, e in zip(starts, starts[1:])) == crosses, got
    _forward_and_dgrad_match(dw.bind(dw_lib6, "forward", dtype), x, k, b)


def test_dwconv3x3_takes_a_narrower_vector_where_the_pointers_are_misaligned(dw_lib):
    # x 4 bytes past a 16-byte boundary: the entry steps down to 1-channel
    # vectors and computes the same values
    rng = np.random.default_rng(5)
    shape = (1, 6, 7, 16)
    buf = torch.zeros(int(np.prod(shape)) + 1)
    x = buf[1:].view(shape)
    x.copy_(_t(rng.standard_normal(shape)))
    k, b = _t(rng.standard_normal((3, 3, 1, 16))), _t(rng.standard_normal(16))
    got = dw._run(dw.bind(dw_lib, "forward", torch.float32), x, k, b, None)
    assert torch.equal(got, dw.dwconv3x3_reference(x, k, b))


# the weight gradient's cases, `blocks` the most blocks over all channel
# chunks: runs of 17 rows, one for each of 5 strips of 16 columns (48
# channels), 64 channels in 2 runs of one strip (rows 0-3, then 4-8: a run
# that starts inside it), one block, 3 channels one a vector (one run over
# 2 images: it crosses into the second one's strip)
@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("shape,blocks", [((1, 17, 70, 48), 5), ((1, 9, 13, 64), 2),
                                          ((1, 5, 6, 12), 1), ((2, 3, 9, 3), 3)])
def test_dwconv3x3_wgrad_matches_plain_version(dw_lib, shape, blocks, dname):
    rng = np.random.default_rng(sum(shape) + blocks)
    dtype = DTYPES[dname]
    x = _t(rng.standard_normal(shape)).to(dtype)
    g = _t(rng.standard_normal(shape)).to(dtype)
    fn = dw.bind(dw_lib, "wgrad", dtype)
    dk, db = dw._run_wgrad(fn, x, g, None, blocks)
    want_k, want_b = dw.dwconv3x3_wgrad_reference(x, g)
    assert dk.shape == want_k.shape == (3, 3, 1, shape[3]) and db.shape == want_b.shape
    err_k = float((dk - want_k).abs().max() / want_k.abs().max())
    err_b = float((db - want_b).abs().max() / want_b.abs().max())
    print("emulated dwconv3x3_wgrad %s %s, %d blocks: max|d| / max|g| dk %.3g, db %.3g"
          % (dname, shape, blocks, err_k, err_b))
    assert torch.isfinite(dk).all() and err_k <= WGRAD_RTOL and err_b <= WGRAD_RTOL
    again = dw._run_wgrad(fn, x, g, None, blocks)
    assert torch.equal(again[0], dk) and torch.equal(again[1], db)  # deterministic


# the weight gradient's reduction at several block counts and tiles: runs
# that start inside a strip (4 runs of 85 rows; 5 of 40, the floor of 8
# rows a run capping 7 blocks), a vector's 128 columns over two warps (12
# channels, 3 vectors: the sum across warps in shared memory), channel
# chunks (264 channels: 3 chunks; 7 blocks give each 2 runs) with a partial
# last warp, bf16's 2-byte vectors
@pytest.mark.parametrize("dname,shape,blocks", [
    ("f32", (1, 17, 70, 48), 4), ("bf16", (1, 17, 70, 48), 4), ("f32", (2, 20, 128, 12), 7),
    ("bf16", (2, 20, 128, 12), 2), ("f32", (1, 17, 11, 264), 7), ("bf16", (1, 6, 9, 27), 3)])
def test_dwconv3x3_wgrad_block_counts_and_tiles_match_plain_version(dw_lib, dname, shape,
                                                                    blocks):
    dtype = DTYPES[dname]
    rng = np.random.default_rng(sum(shape) + blocks + 1)
    x = _t(rng.standard_normal(shape)).to(dtype)
    g = _t(rng.standard_normal(shape)).to(dtype)
    got = _plan(dw_lib, x, dtype, "wgrad")
    if shape[2] == 128:
        assert got["tile_w"] // got["cols_a_thread"] == 64  # two warps a vector
    fn = dw.bind(dw_lib, "wgrad", dtype)
    dk, db = dw._run_wgrad(fn, x, g, None, blocks)
    want_k, want_b = dw.dwconv3x3_wgrad_reference(x, g)
    err_k = float((dk - want_k).abs().max() / want_k.abs().max())
    err_b = float((db - want_b).abs().max() / want_b.abs().max())
    print("emulated dwconv3x3_wgrad %s %s, %d blocks, plan %s: dk %.3g, db %.3g"
          % (dname, shape, blocks, got, err_k, err_b))
    assert torch.isfinite(dk).all() and err_k <= WGRAD_RTOL and err_b <= WGRAD_RTOL
    again = dw._run_wgrad(fn, x, g, None, blocks)
    assert torch.equal(again[0], dk) and torch.equal(again[1], db)


@pytest.mark.parametrize("entry", ["forward", "wgrad"])
def test_dwconv3x3_entries_refuse_an_empty_shape(dw_lib, entry):
    x = torch.zeros((1, 0, 4, 8))
    fn = dw.bind(dw_lib, entry, torch.float32)
    with pytest.raises(RuntimeError, match="CUDA error 1$"):
        if entry == "forward":
            dw._run(fn, x, torch.zeros((3, 3, 1, 8)), torch.zeros(8), None)
        else:
            dw._run_wgrad(fn, x, x, None)


@pytest.mark.parametrize("entry", ["forward", "wgrad"])
def test_dwconv3x3_entries_refuse_rows_past_2_to_31(dw_lib, entry):
    # 64 images of 65536 rows in 512 strips each: 2^31 strip rows, past the
    # kernels' 32-bit cursor; refused before any pointer is read
    fn = dw.bind(dw_lib, entry, torch.float32)
    shape = (64, 65536, 65536, 4)
    if entry == "forward":
        err = fn(None, None, None, None, *shape, None)
    else:
        err = fn(None, None, None, None, None, *shape, 1, None)
    assert err == 1
