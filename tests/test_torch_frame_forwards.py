"""The port's full-frame forwards in pieces, strip-batched and tile-scan
(larvanet_tpu_torch/eval/tiling.py), and its 2-D Winograd EDSR forward
(larvanet_tpu_torch/ops/winograd.py), against the JAX package's
(larvanet_tpu/eval/tiling.py:34-247, larvanet_tpu/ops/winograd.py) and the
port's own full frame, on the CPU, at a tiny EDSR (8 features, 2 blocks),
with the kernels' plain versions.

The bars are JAX's own (tests/test_tiling.py:95-210: 2e-3 against the
full frame where the halo covers the receptive radius, and away from the
seams where it does not; tests/test_winograd.py: rtol 2e-5, atol 2e-3 for a
conv, rtol 2e-3, atol 0.15 for the EDSR forward). The port's windows run
its own module forward, whose kernels sum a pixel in an order that depends
on neither the batch nor the pixel's place, so against the port's own full
frame they are held bit for bit. The JAX side gets the port's weights
through its own converter (no flax init). Inputs come from numpy seeds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.eval import tiling as jax_tiling
from larvanet_tpu.ops import winograd as jax_winograd
from larvanet_tpu.utils import torch_convert as jax_convert
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.eval import tiling
from larvanet_tpu_torch.ops import winograd

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

TINY = ("--edsr_res_blocks", "2", "--edsr_conv_features", "8")
# receptive radius of the tiny EDSR's module graph: 2 ResBlocks (4 convs),
# first_conv, after_res_conv, the tail's 3 convs (2 on the LR side of the
# last shuffle): 7 LR pixels; halo 8 covers it (tests/test_tiling.py)
HALO = 8
FRAME_ATOL = 2e-3       # JAX's bar against its full frame
CONV_RTOL, CONV_ATOL = 2e-5, 2e-3
EDSR_RTOL, EDSR_ATOL = 2e-3, 0.15


@functools.lru_cache(maxsize=None)
def _models(flags=TINY):
    """(JAX model, port model) with the port's init as both's parameters."""
    pm = get_model("edsr")
    pm.parse_args(list(flags))
    pm.prepare([4], device="cpu")
    state = {k: v.numpy() for k, v in pm.module.state_dict().items()}
    jm = jax_get_model("edsr")
    jm.parse_args(list(flags))
    jm.params = jax_convert.convert_state_dict(state, "edsr")[0]
    jm.scale, jm.scale_list, jm.is_training = 4, [4], False
    jm.module = jm.build_module()
    return jm, pm


def _port_fwd(pm):
    @torch.no_grad()
    def fwd(x):
        return pm.module(x.contiguous())
    return fwd


def _lr(shape, seed):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


@pytest.fixture(scope="module")
def frame():
    """A (2, 48, 36) batch, the port's and JAX's full frames of it."""
    jm, pm = _models()
    x = _lr((2, 48, 36, 3), 0)
    full = _port_fwd(pm)(torch.from_numpy(x)).numpy()
    jfull = np.asarray(jax.jit(jm._forward_impl)(jm.params, jnp.asarray(x)))
    return x, full, jfull


@pytest.mark.parametrize("chunk", [1, 2, 4])
def test_strip_batched_forward_matches_the_full_frame_and_jax(frame, chunk):
    jm, pm = _models()
    x, full, jfull = frame
    fwd = tiling.make_strip_batched_forward(_port_fwd(pm), 4, 4, HALO, 48, 36, chunk)
    got = fwd(torch.from_numpy(x)).numpy()
    jfwd = jax_tiling.make_strip_batched_forward(jm._forward_impl, 4, 4, HALO, 48, 36, chunk)
    want = np.asarray(jax.jit(jfwd)(jm.params, jnp.asarray(x)))
    print("strips chunk %d: vs own full frame %.3g, vs JAX's strips %.3g" % (
        chunk, np.abs(got - full).max(), np.abs(got - want).max()))
    assert got.shape == want.shape == (2, 192, 144, 3)
    np.testing.assert_array_equal(got, full)
    np.testing.assert_allclose(got, want, atol=FRAME_ATOL)
    np.testing.assert_allclose(got, jfull, atol=FRAME_ATOL)


def test_strip_batched_forward_under_halo_is_exact_away_from_the_seam(frame):
    """halo 4 < radius 7: rows at least radius - halo LR rows from the seam
    (LR row 24) keep the full frame's values; JAX's strips at the same halo
    agree with the port's everywhere at JAX's bar."""
    jm, pm = _models()
    x, full, _ = frame
    got = tiling.make_strip_batched_forward(_port_fwd(pm), 4, 2, 4, 48, 36)(
        torch.from_numpy(x[:1])).numpy()
    jfwd = jax_tiling.make_strip_batched_forward(jm._forward_impl, 4, 2, 4, 48, 36)
    want = np.asarray(jax.jit(jfwd)(jm.params, jnp.asarray(x[:1])))
    for region in (np.s_[:, :(24 - 4) * 4], np.s_[:, (24 + 4) * 4:]):
        np.testing.assert_array_equal(got[region], full[:1][region])
    np.testing.assert_allclose(got, want, atol=FRAME_ATOL)


def test_tile_scan_forward_matches_the_full_frame_and_jax(frame):
    jm, pm = _models()
    x, full, jfull = frame
    got = tiling.make_tile_scan_forward(_port_fwd(pm), 4, 16, 12, HALO, 48, 36)(
        torch.from_numpy(x)).numpy()
    jfwd = jax_tiling.make_tile_scan_forward(jm._forward_impl, 4, 16, 12, HALO, 48, 36)
    want = np.asarray(jax.jit(jfwd)(jm.params, jnp.asarray(x)))
    print("tile scan: vs own full frame %.3g, vs JAX's %.3g" % (
        np.abs(got - full).max(), np.abs(got - want).max()))
    assert got.shape == (2, 192, 144, 3)
    np.testing.assert_array_equal(got, full)
    np.testing.assert_allclose(got, want, atol=FRAME_ATOL)
    np.testing.assert_allclose(got, jfull, atol=FRAME_ATOL)


@pytest.mark.parametrize("tile", [(48, 12), (16, 36)])
def test_tile_scan_forward_single_row_and_column(frame, tile):
    """Degenerate grids (one tile row, one tile column) cover the frame."""
    _, pm = _models()
    x, full, _ = frame
    got = tiling.make_tile_scan_forward(_port_fwd(pm), 4, *tile, HALO, 48, 36)(
        torch.from_numpy(x[:1])).numpy()
    np.testing.assert_array_equal(got, full[:1])


def test_tile_scan_forward_under_halo_seam_locality(frame):
    """halo 4 < radius 7: pixels at least 3 LR pixels from every seam (row
    24, column 18) keep the full frame's values."""
    _, pm = _models()
    x, full, _ = frame
    got = tiling.make_tile_scan_forward(_port_fwd(pm), 4, 24, 18, 4, 48, 36)(
        torch.from_numpy(x[:1])).numpy()
    r0, r1 = (24 - 4) * 4, (24 + 4) * 4
    c0, c1 = (18 - 4) * 4, (18 + 4) * 4
    np.testing.assert_array_equal(got[:, :r0, :c0], full[:1, :r0, :c0])
    np.testing.assert_array_equal(got[:, r1:, c1:], full[:1, r1:, c1:])


def test_strip_batched_forward_validates_geometry():
    """JAX's geometry errors (tests/test_tiling.py:135-151)."""
    ident = lambda x: x  # noqa: E731
    for kwargs in (dict(n_strips=5, halo=4), dict(n_strips=2, halo=16),
                   dict(n_strips=4, halo=4, chunk=3)):
        with pytest.raises(ValueError):
            tiling.make_strip_batched_forward(ident, 4, height=48, width=36, **kwargs)
        with pytest.raises(ValueError):
            jax_tiling.make_strip_batched_forward(lambda p, x: x, 4, height=48, width=36,
                                                  **kwargs)
    fwd = tiling.make_strip_batched_forward(ident, 1, 2, 4, 48, 36)
    with pytest.raises(ValueError, match="does not match"):
        fwd(torch.zeros((1, 40, 36, 3)))


def test_tile_scan_forward_validates_geometry():
    """JAX's geometry errors (tests/test_tiling.py:213-229); an oversized
    window clamps to the frame."""
    ident = lambda x: x  # noqa: E731
    for th, tw in ((5, 12), (16, 5)):
        with pytest.raises(ValueError, match="not divisible"):
            tiling.make_tile_scan_forward(ident, 4, th, tw, 4, 48, 36)
    tiling.make_tile_scan_forward(ident, 4, 16, 36, 16, 48, 36)
    fwd = tiling.make_tile_scan_forward(ident, 1, 16, 12, 4, 48, 36)
    with pytest.raises(ValueError, match="does not match"):
        fwd(torch.zeros((1, 40, 36, 3)))


def _direct(x, k, b):
    return torch.nn.functional.conv2d(
        torch.from_numpy(x).permute(0, 3, 1, 2).double(),
        torch.from_numpy(k).permute(3, 2, 0, 1).double(), torch.from_numpy(b).double(),
        padding=1).permute(0, 2, 3, 1).numpy()


@pytest.mark.parametrize("hw", [(8, 8), (7, 9), (5, 6), (1, 1), (2, 3)])
def test_wino_conv_matches_direct_and_jax(hw):
    """wino_conv3x3 against a float64 direct SAME conv and JAX's
    wino_conv3x3 on the same operands, JAX's bar
    (tests/test_winograd.py:26-38); the weight transforms agree too."""
    rng = np.random.default_rng(sum(hw))
    x = (rng.normal(size=(2,) + hw + (8,)) * 100).astype(np.float32)
    k = rng.normal(size=(3, 3, 8, 8)).astype(np.float32)
    b = rng.normal(size=(8,)).astype(np.float32)
    u = winograd.transform_weights(torch.from_numpy(k))
    ju = jax_winograd.transform_weights(jnp.asarray(k))
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=1e-6, atol=1e-6)
    got = winograd.wino_conv3x3(torch.from_numpy(x), u, torch.from_numpy(b),
                                torch.float32).numpy()
    want = np.asarray(jax_winograd.wino_conv3x3(jnp.asarray(x), ju, jnp.asarray(b),
                                                jnp.float32))
    np.testing.assert_allclose(got, _direct(x, k, b), rtol=CONV_RTOL, atol=CONV_ATOL)
    np.testing.assert_allclose(got, want, rtol=CONV_RTOL, atol=CONV_ATOL)


def test_wino_conv_zero_border_semantics():
    """The first row and last column of an odd frame (a partial last tile)
    equal the SAME zero-padded direct conv (tests/test_winograd.py:41-55)."""
    rng = np.random.default_rng(3)
    x = rng.normal(size=(1, 5, 5, 4)).astype(np.float32)
    k = rng.normal(size=(3, 3, 4, 4)).astype(np.float32)
    b = np.zeros((4,), np.float32)
    got = winograd.wino_conv3x3(torch.from_numpy(x), winograd.transform_weights(
        torch.from_numpy(k)), torch.from_numpy(b), torch.float32).numpy()
    want = _direct(x, k, b)
    np.testing.assert_allclose(got[:, 0], want[:, 0], rtol=CONV_RTOL, atol=1e-3)
    np.testing.assert_allclose(got[:, :, -1], want[:, :, -1], rtol=CONV_RTOL, atol=1e-3)


@pytest.mark.parametrize("flags", [TINY, ("--edsr_res_blocks", "1", "--edsr_conv_features",
                                          "8", "--edsr_res_weight", "0.1")])
def test_winograd_edsr_forward_matches_module_and_jax(flags):
    """The Winograd EDSR forward (collapsed tail) against the port's module
    forward and JAX's make_winograd_edsr_forward, at JAX's bar
    (tests/test_winograd.py:58-86), res_weight 1 and 0.1."""
    jm, pm = _models(flags)
    x = _lr((1, 10, 12, 3), 11)
    got = winograd.make_winograd_edsr_forward(pm)(torch.from_numpy(x)).numpy()
    with torch.no_grad():
        module = pm.module(torch.from_numpy(x)).numpy()
    want = np.asarray(jax.jit(jax_winograd.make_winograd_edsr_forward(jm))(
        jm.params, jnp.asarray(x)))
    print("winograd EDSR %s: vs module %.3g, vs JAX %.3g" % (
        flags[-1], np.abs(got - module).max(), np.abs(got - want).max()))
    np.testing.assert_allclose(got, module, rtol=EDSR_RTOL, atol=EDSR_ATOL)
    np.testing.assert_allclose(got, want, rtol=EDSR_RTOL, atol=EDSR_ATOL)
