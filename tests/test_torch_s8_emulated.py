"""The port's CUDA source `csrc/conv3x3_s8.cu` (the int8 conv of the W8A8 pair), built for the CPU
by larvanet_tpu_torch/ops/emulate.py (a thread per CUDA thread, a barrier
for __syncthreads), against its plain version.

The kernels run through the wrapper's own `bind` and `_run`, so this checks
the source's indexing, masking, tiling and arithmetic and the wrapper's
operand preparation; what nvcc accepts and how fast the kernels run only
the card shows (chip_smoke.py). Inputs come from numpy with a seed.
"""

import re

import numpy as np
import pytest
import torch

from larvanet_tpu_torch.ops import build
from larvanet_tpu_torch.ops import conv3x3_s8 as s8
from torch_emulated import DTYPES
from torch_emulated import lib as _lib
from torch_emulated import t as _t

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give


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


# Widths past one code halo (324 pixels x (Kp + 16) bytes beside the staging
# rows in a block's 227 KB): the halo comes in chunks of Kc codes, the int32
# sums kept across them, so the result stays bit for bit. At F = 64: C =
# 1280 takes chunks in both entries (conv_a 4 x 288 codes + 128; conv_b f32
# 5 x 224 + 160, bf16 5 x 256); C = 520 chunks conv_b in f32 (2 x 224 + 96)
# and keeps the one-halo plan elsewhere; C = 1000 (Kp 1024) ends both
# entries on a partial chunk (conv_a 3 x 288 + 160, conv_b f32 4 x 224 + 128)
@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("entry", ["conv_a", "conv_b"])
@pytest.mark.parametrize("c", [1280, 520, 1000])
def test_conv3x3_s8_takes_widths_past_one_halo_bit_for_bit(s8_lib, c, entry, dname):
    rng = np.random.default_rng(c + len(entry))
    dtype = DTYPES[dname]
    f, hw = 64, (1, 4, 4)
    fn = s8.bind(s8_lib, entry, dtype)
    if entry == "conv_a":
        s_in = 0.25
        hin = _t(rng.integers(-300, 300, hw + (c,)) / 8.0).to(dtype)
        wt = _s8_weight(rng, c, f, s_in, dtype)
        t = s8._dequant(s8.conv_codes_reference(s8.quantize(hin, s_in), wt.codes), wt, dtype)
        s_mid = float(t.float().abs().max()) * 0.8 / 127.0
        got = s8._run_a(fn, hin, wt, s_in, s_mid, "relu", None)
        want = s8.conv_a_reference(hin, wt, s_in, s_mid, "relu")
        assert got.shape == want.shape and int((got != want).sum()) == 0
        return
    tq = torch.from_numpy(rng.integers(-127, 128, hw + (c,)).astype(np.int8))
    wt = _s8_weight(rng, c, f, 0.03 / c, dtype)
    res = _t(rng.standard_normal(hw + (f,))).to(dtype)
    for r, rw in ((res, 0.1), (None, 1.0)):
        got = s8._run_b(fn, tq, wt, dtype, r, rw, None)
        want = s8.conv_b_reference(tq, wt, dtype, r, rw)
        bits = torch.int16 if dname == "bf16" else torch.int32
        assert got.shape == want.shape and torch.equal(got.view(bits), want.view(bits)), \
            (c, r is None, float((got.float() - want.float()).abs().max()))


# act_2: leaky_relu with a slope that is not a finite number; act_4: no
# activation of the entry's
@pytest.mark.parametrize("case", ["misaligned_w", "act_2", "empty", "act_4"])
def test_conv3x3_s8_entry_refuses_what_it_cannot_take(s8_lib, case):
    rng = np.random.default_rng(3)
    c = 16
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
             {"act_2": 2, "act_4": 4}.get(case, 1), float("nan"), None)
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
