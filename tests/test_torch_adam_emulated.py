"""The port's flat Adam CUDA source (`csrc/adam_flat.cu`), built for the CPU
by larvanet_tpu_torch/ops/emulate.py, against its plain version
(`ops/adam_flat.adam_flat_reference`), bit for bit.

The kernel runs through the wrapper's own `bind`, `chunk_table` and
`_run` on CPU tensors: every parameter's chunks, the 16-byte vector path
and the element tail, a parameter whose pointer breaks the vector
alignment, a parameter without a gradient (left as it is), Adam and
AdamW, over several steps. What nvcc accepts and how fast it runs only
the card shows (chip_smoke.py phase 21d).
"""

import pytest
import torch

from larvanet_tpu_torch.ops import adam_flat
from torch_emulated import lib as _lib

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

# more than one chunk, a tail of 13 after the vectors, single values
SHAPES = ((5,), (3, 3, 7), (4096 + 4096 + 13,), (8, 8, 3, 3), (1,), (48,))


@pytest.fixture(scope="module")
def entry():
    return adam_flat.bind(_lib(adam_flat.SOURCE))


def _params(seed, misaligned):
    g = torch.Generator().manual_seed(seed)
    params = [torch.randn(s, generator=g) * 0.1 for s in SHAPES]
    if misaligned:  # a view one float into its storage: no 16-byte vectors
        backing = torch.randn(params[2].numel() + 1, generator=g)
        params[2] = backing[1:]
    return params


def _kernel_step(entry, flat, grads, s):
    fn, chunk = entry
    rows = [[p.data_ptr(), 0 if g is None else g.data_ptr(), o, n]
            for p, g, o, n in zip(flat.params, grads, flat.offsets, flat.counts)]
    table = torch.tensor(rows, dtype=torch.int64)
    chunks = torch.tensor(adam_flat.chunk_table(flat.counts, chunk), dtype=torch.int32)
    adam_flat._run(fn, table, chunks.reshape(-1, 2), flat.m, flat.v, s, None)


@pytest.mark.parametrize("misaligned", [False, True], ids=["aligned", "misaligned"])
@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_kernel_matches_the_plain_version(entry, kind, misaligned):
    params = _params(0, misaligned)
    ref = [p.clone() for p in params]
    start = [p.clone() for p in params]
    mine, theirs = adam_flat.AdamFlat(params), adam_flat.AdamFlat(ref)
    g = torch.Generator().manual_seed(1)
    for step in range(1, 5):
        grads = [torch.randn(p.shape, generator=g) for p in params]
        grads[1] = None
        s = adam_flat.scalars(1e-2, (0.9, 0.999), 1e-8, step, weight_decay=0.01,
                              adamw=kind == "adamw")
        _kernel_step(entry, mine, grads, s)
        adam_flat.adam_flat_reference(ref, grads, theirs.m, theirs.v, theirs.offsets, s)
    for a, b in zip(params, ref):
        assert torch.equal(a, b)
    assert torch.equal(mine.m, theirs.m) and torch.equal(mine.v, theirs.v)
    assert torch.equal(params[1], start[1])  # no gradient: not updated
    assert not torch.equal(params[0], start[0])


def test_chunk_table_covers_every_element(entry):
    _, chunk = entry
    counts = [5, 2 * chunk + 1, chunk]
    table = adam_flat.chunk_table(counts, chunk)
    assert table == [(0, 0), (1, 0), (1, chunk), (1, 2 * chunk), (2, 0)]


def test_wrapper_refuses_what_the_kernel_does_not_take():
    with pytest.raises(TypeError, match="float32"):
        adam_flat.AdamFlat([torch.zeros(3, dtype=torch.bfloat16)])
    with pytest.raises(ValueError, match="contiguous"):
        adam_flat.AdamFlat([torch.zeros(4, 4).t()])
    flat = adam_flat.AdamFlat([torch.zeros(3)])
    with pytest.raises(ValueError, match="1 parameters"):
        flat.step([None, None], adam_flat.scalars(1e-3, (0.9, 0.999), 1e-8, 1))
