"""The port's depthwise 3x3 CUDA source (`csrc/dwconv3x3.cu`: the forward, the
input gradient on the same entry, the weight gradient), built for the CPU by
larvanet_tpu_torch/ops/emulate.py (a thread per CUDA thread, a barrier for
__syncthreads), against its plain version.

The kernels run through the wrapper's own `bind` and `_run` / `_run_wgrad`,
so this checks the source's indexing, masking, tiling and arithmetic; what
nvcc accepts and how fast the kernels run only the card shows
(chip_smoke.py). Inputs come from numpy with a seed.
"""

import numpy as np
import pytest
import torch

from larvanet_tpu_torch.ops import dwconv3x3 as dw
from torch_emulated import DTYPES
from torch_emulated import lib as _lib
from torch_emulated import t as _t

# the weight gradient sums the same f32 products as the plain version in
# another order: within 1e-5 of the largest |dk| (|db|), as conv3x3_wgrad is held
WGRAD_RTOL = 1e-5


@pytest.fixture(scope="module")
def dw_lib():
    return _lib(dw.SOURCE)


def _bits(t):
    return t.view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


# C and the vector it takes (f32: 4 channels, bf16: 8, where C allows): dwsr
# x4's 48 (f32: 12 vectors, 4 a block, 3 channel chunks; bf16: 6, 2 a block),
# MAMNet's 64, dwsr x2's 12 (bf16 4-channel vectors), an odd C (one channel a
# vector, as dwsr x3's 27 takes, 128-column tiles); H and W past one tile and
# ragged, batch 2
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
# chunks: runs of several tiles a block (48 channels: f32 9 tiles in 3
# chunks of 1 block, bf16 6 tiles in 3 chunks), 64 channels in 2 chunks of 1
# block, one block of one tile, the narrow vectors (3 chunks of 1 block)
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


@pytest.mark.parametrize("entry", ["forward", "wgrad"])
def test_dwconv3x3_entries_refuse_an_empty_shape(dw_lib, entry):
    x = torch.zeros((1, 0, 4, 8))
    fn = dw.bind(dw_lib, entry, torch.float32)
    with pytest.raises(RuntimeError, match="CUDA error 1$"):
        if entry == "forward":
            dw._run(fn, x, torch.zeros((3, 3, 1, 8)), torch.zeros(8), None)
        else:
            dw._run_wgrad(fn, x, x, None)
