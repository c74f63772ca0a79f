"""The port's fused Winograd ResBlock (larvanet_tpu_torch/ops/wino_resblock.py)
against the JAX package's Pallas kernels, on the CPU.

The JAX side runs `wino_packed_resblock` / `wino4_packed_resblock` in the
Pallas interpreter on the width-packed layout, as tests/test_wino_pallas.py
does, over the same H and tile matrix; the port's plain version takes the
unpacked NHWC tensor and the HWIO kernels. Inputs come from numpy with a
seed. The CUDA kernel itself runs only on the card (chip_smoke.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.ops import wino_pallas
from larvanet_tpu.ops.packed.core import (grid1_mask, pack_bias, pack_kernel_a,
                                          pack_kernel_b, pack_w, unpack_w)
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.ops import emulate
from larvanet_tpu_torch.ops import wino_resblock as wr
from larvanet_tpu_torch.ops.collapsed_tail import make_collapsed_edsr_forward
from larvanet_tpu_torch.ops.conv3x3 import conv3x3_bias_act_reference
from larvanet_tpu_torch.utils.torch_convert import state_dict_from_jax_params

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

# the JAX package's own bars for its kernels against the direct packed
# ResBlock (tests/test_wino_pallas.py): F(4,3)'s B^T / A^T entries up to 8
# amplify the f32 rounding of the transforms
ATOL = {2: 1e-4, 4: 5e-4}
# the EDSR forward on [0, 255] outputs, F(2,3) / F(4,3) (test_wino_pallas.py)
FWD_ATOL = {2: 2e-3, 4: 5e-3}
# JAX's Winograd EDSR forward runs the collapsed linear tail: the same
# function summed in another order, which the JAX package holds to its
# module graph at atol 0.1 (tests/test_collapsed_tail.py)
COLLAPSED_TAIL_ATOL = 0.1
TINY = ["--edsr_res_blocks", "2", "--edsr_conv_features", "8"]


def _block_inputs(seed, n, h, w, c, b_a=None):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, h, w, c)).astype(np.float32)
    k_a = (0.2 * rng.standard_normal((3, 3, c, c))).astype(np.float32)
    k_b = (0.2 * rng.standard_normal((3, 3, c, c))).astype(np.float32)
    b_a = (0.1 * rng.standard_normal(c)).astype(np.float32) if b_a is None \
        else np.full(c, b_a, np.float32)
    b_b = (0.1 * rng.standard_normal(c)).astype(np.float32)
    return x, k_a, b_a, k_b, b_b


def _jax_block(m, x, k_a, b_a, k_b, b_b, res_weight, tile_rows):
    block = wino_pallas.wino_packed_resblock if m == 2 else wino_pallas.wino4_packed_resblock
    w = x.shape[2]
    out = block(pack_w(jnp.asarray(x)), pack_kernel_a(jnp.asarray(k_a)),
                pack_bias(jnp.asarray(b_a)), pack_kernel_b(jnp.asarray(k_b)),
                pack_bias(jnp.asarray(b_b)), grid1_mask(w // 2 + 1, x.shape[3]),
                res_weight=res_weight, tile_rows=tile_rows, interpret=True)
    return np.asarray(unpack_w(out))


def _port_block(m, x, k_a, b_a, k_b, b_b, res_weight):
    t = [torch.from_numpy(a) for a in (x, k_a, b_a, k_b, b_b)]
    return wr.wino_resblock(*t, res_weight=res_weight, m=m).numpy()


def _check(name, got, want, atol):
    print("parity %s: max|d| %.3g" % (name, np.abs(got - want).max()))
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


def test_matrices_equal_jax():
    np.testing.assert_array_equal(wr._G4, wino_pallas._G4)
    np.testing.assert_array_equal(wr._G6, wino_pallas._G6)
    np.testing.assert_array_equal(wr._BT6, wino_pallas._BT6)
    np.testing.assert_array_equal(wr._AT46, wino_pallas._AT46)
    # F(2,3)'s B^T and A^T, which JAX writes out in `_bt` and `_stage`
    d = np.random.default_rng(1).standard_normal(4).astype(np.float32)
    np.testing.assert_array_equal(wr._BT4 @ d, np.array(wino_pallas._bt(*d)))
    mm = np.random.default_rng(2).standard_normal(4).astype(np.float32)
    np.testing.assert_allclose(wr._AT24 @ mm, [mm[0] + mm[1] + mm[2], mm[1] - mm[2] - mm[3]],
                               rtol=1e-6)


@pytest.mark.parametrize("m", [2, 4])
def test_transform_is_exact_correlation(m):
    g, bt, at = wr.MATRICES[m]
    rng = np.random.default_rng(3)
    d, k = rng.standard_normal(m + 2), rng.standard_normal(3)
    y = at.astype(np.float64) @ ((g.astype(np.float64) @ k) * (bt.astype(np.float64) @ d))
    np.testing.assert_allclose(y, [np.dot(d[i:i + 3], k) for i in range(m)], atol=1e-6)


@pytest.mark.parametrize("m", [2, 4])
def test_weight_transform_matches_jax(m):
    """U[p, kw] = sum_kh G[p, kh] k[kh, kw], the unpacked form of
    h_transform_kernel / h4_transform_kernel (an einsum over the kh axis
    with JAX's G)."""
    k = np.random.default_rng(4).standard_normal((3, 3, 8, 8)).astype(np.float32)
    got = wr.h_transform_kernel(torch.from_numpy(k), m).numpy()
    g = wino_pallas._G4 if m == 2 else wino_pallas._G6
    want = np.asarray(jnp.einsum("pk,kwij->pwij", jnp.asarray(g), jnp.asarray(k)))
    assert got.shape == (m + 2, 3, 8, 8)
    np.testing.assert_allclose(got, want, atol=1e-6)


@pytest.mark.parametrize("h,tile", [(16, 8), (20, 8), (13, 8), (8, 8), (30, 16)])
def test_f23_matches_jax_kernel(h, tile):
    """Tile boundaries, a ragged last tile, odd H, res_weight 0.7."""
    args = _block_inputs(h, 2, h, 12, 8)
    want = _jax_block(2, *args, res_weight=0.7, tile_rows=tile)
    _check("F(2,3) h=%d tile=%d" % (h, tile), _port_block(2, *args, 0.7), want, ATOL[2])


@pytest.mark.parametrize("h", [16, 20, 37, 48])
def test_f43_matches_jax_kernel(h):
    """F(4,3) with a big conv_a bias as the H-boundary leak trap."""
    args = _block_inputs(100 + h, 2, h, 12, 8, b_a=5.0)
    want = _jax_block(4, *args, res_weight=0.7, tile_rows=16)
    _check("F(4,3) h=%d" % h, _port_block(4, *args, 0.7), want, ATOL[4])


@pytest.mark.parametrize("m", [2, 4])
def test_boundary_rows_and_columns_are_zero_padded(m):
    """t must be zero outside the image, not ReLU(b_a): with b = 7.5 a leak
    would move the first and last rows and columns by a lot."""
    args = _block_inputs(5, 1, 8 if m == 2 else 16, 10, 8, b_a=7.5)
    args = args[:4] + (np.full(8, 7.5, np.float32),)
    want = _jax_block(m, *args, res_weight=1.0, tile_rows=8 if m == 2 else 16)
    _check("F(%d,3) b=7.5" % m, _port_block(m, *args, 1.0), want, ATOL[m])


@pytest.mark.parametrize("m", [2, 4])
@pytest.mark.parametrize("h,w", [(13, 12), (16, 9), (7, 7)])
def test_plain_version_matches_direct_resblock(m, h, w):
    """Against two direct convs (the port's conv3x3 plain version): odd H,
    odd W (the kernel takes any W) and a frame smaller than a tile."""
    x, k_a, b_a, k_b, b_b = (torch.from_numpy(a) for a in _block_inputs(6, 2, h, w, 8))
    want = x + 0.7 * conv3x3_bias_act_reference(
        conv3x3_bias_act_reference(x, k_a, b_a, "relu"), k_b, b_b)
    got = wr.wino_resblock_reference(x, k_a, b_a, k_b, b_b, 0.7, m)
    _check("plain F(%d,3) vs direct %dx%d" % (m, h, w), got.numpy(), want.numpy(), ATOL[m])


def test_bf16_rounds_operands_and_returns_bf16():
    x, k_a, b_a, k_b, b_b = (torch.from_numpy(a) for a in _block_inputs(7, 1, 9, 6, 8))
    got = wr.wino_resblock(x.bfloat16(), k_a, b_a, k_b, b_b, 1.0, 2)
    want = wr.wino_resblock(x, k_a, b_a, k_b, b_b, 1.0, 2)
    assert got.dtype == torch.bfloat16 and got.shape == x.shape
    # bf16 operands (8-bit mantissa) of sums over 3 x 8 x 4 products
    err = float((got.float() - want).abs().max())
    assert 0 < err < 0.1 * float(want.abs().max())


def test_cpu_tensor_takes_plain_version_and_counts_no_launch():
    wr.reset_launches()
    args = [torch.from_numpy(a) for a in _block_inputs(8, 1, 6, 4, 8)]
    wr.wino_resblock(*args, res_weight=1.0, m=4)
    assert wr.LAUNCHES == {2: 0, 4: 0}
    assert wr.LAUNCHES_BY_PATH == {"cuda_core": 0, "tensor_core": 0}


def test_wrapper_rejects_other_devices_and_sizes():
    args = [torch.from_numpy(a) for a in _block_inputs(9, 1, 6, 4, 8)]
    with pytest.raises(ValueError, match="CUDA or the CPU"):
        wr.wino_resblock_transformed(args[0].to("meta"), *args[1:], m=2)
    with pytest.raises(ValueError, match="m must be 2 or 4"):
        wr.wino_resblock(*args, m=3)


def test_path_for_dtype():
    assert wr.path_for(torch.bfloat16) == "tensor_core"
    assert wr.path_for(torch.float32) == "tensor_core"


@pytest.mark.parametrize("m", [2, 4])
def test_entry_basis_swaps_channel_axes_for_the_tensor_cores(m):
    """bf16: the basis with its channel axes swapped. f32: that basis, bit
    for bit, then its split-TF32 parts hi and lo, tf32 values (low 13 bits
    zero) whose sum is the basis to ~2^-22 of its values."""
    u = torch.from_numpy(np.random.default_rng(12).standard_normal((m + 2, 3, 8, 6))
                         .astype(np.float32))
    ut = u.numpy().transpose(0, 1, 3, 2)
    tc = wr.entry_basis(u.bfloat16(), "tensor_core")
    assert tc.shape == (m + 2, 3, 6, 8) and tc.is_contiguous()
    assert torch.equal(tc, u.bfloat16().transpose(2, 3))
    split = wr.entry_basis(u, "tensor_core")
    assert split.shape == (3, m + 2, 3, 6, 8) and split.is_contiguous()
    np.testing.assert_array_equal(split[0].numpy(), ut)
    for part in (split[1], split[2]):
        assert not bool((part.view(torch.int32) & 0x1fff).any())
    np.testing.assert_allclose((split[1] + split[2]).numpy(), ut, rtol=2.0 ** -21, atol=0)
    np.testing.assert_array_equal(wr.entry_basis(u, "cuda_core").numpy(), u.numpy())


@pytest.mark.parametrize("dname,path", [("bf16", "tensor_core"), ("f32", "tensor_core")])
def test_launch_takes_the_dtype_path_and_counts_it(monkeypatch, dname, path):
    """The launch step of the CUDA branch on the CPU build of the source
    (ops/emulate.py): both dtypes go to the tensor-core entry, bf16 with the
    swapped basis, f32 with its split, and LAUNCHES_BY_PATH counts each."""
    try:
        lib = emulate.load(wr.SOURCE)
    except RuntimeError as exc:
        pytest.skip(str(exc))
    taken = []

    def entry(m, dtype, p):
        taken.append(p)
        return wr.bind(lib, m, dtype, p)

    monkeypatch.setattr(wr, "_entry", entry)
    dtype = {"bf16": torch.bfloat16, "f32": torch.float32}[dname]
    x, k_a, b_a, k_b, b_b = _block_inputs(13, 1, 6, 9, wr.KERNEL_CHANNELS)
    x = torch.from_numpy(x).to(dtype)
    u_a, u_b = (wr.h_transform_kernel(torch.from_numpy(0.25 * k), 2).to(dtype)
                for k in (k_a, k_b))
    b_a, b_b = torch.from_numpy(b_a), torch.from_numpy(b_b)
    wr.reset_launches()
    got = wr._launch(x, u_a, b_a, u_b, b_b, 0.5, 2, False, None)
    assert taken == [path]
    assert wr.LAUNCHES_BY_PATH == {"cuda_core": int(path == "cuda_core"),
                                   "tensor_core": int(path == "tensor_core")}
    assert wr.LAUNCHES == {2: 1, 4: 0}
    want = wr.wino_resblock_transformed_reference(x, u_a, b_a, u_b, b_b, 0.5, 2)
    err = float((got.float() - want.float()).abs().max())
    assert err <= (2e-4 if dname == "f32" else 2.0 ** -6 * float(want.float().abs().max()))


@pytest.mark.parametrize("m", [2, 4])
def test_entry_layout_on_the_cpu_matches_the_public_layout(m):
    """A basis cached in the entry's layout (`entry_basis`) gives the same
    plain-version output as the public layout, in bf16 and f32."""
    x, k_a, b_a, k_b, b_b = (torch.from_numpy(a) for a in _block_inputs(14, 1, 7, 6, 8))
    for dtype in (torch.bfloat16, torch.float32):
        u_a, u_b = (wr.h_transform_kernel(k, m).to(dtype) for k in (k_a, k_b))
        path = wr.path_for(dtype)
        want = wr.wino_resblock_transformed(x.to(dtype), u_a, b_a, u_b, b_b, 0.7, m)
        got = wr.wino_resblock_transformed(x.to(dtype), wr.entry_basis(u_a, path), b_a,
                                           wr.entry_basis(u_b, path), b_b, 0.7, m,
                                           entry_layout=True)
        assert torch.equal(got, want)


def test_wino_forward_recomputes_the_f32_split_after_a_weight_write(monkeypatch):
    """The f32 forward hands every fused call the split basis of its block
    (`entry_basis`), and an in-place write to a weight refreshes it."""
    _, pm = _models()
    seen = []

    def spy(x, u_a, b_a, u_b, b_b, res_weight, m, entry_layout=False):
        seen.append((u_a, u_b))
        return wr.wino_resblock_transformed_reference(x, u_a, b_a, u_b, b_b, res_weight, m,
                                                      entry_layout)

    monkeypatch.setattr(wr, "wino_resblock_transformed", spy)
    fwd = wr.make_wino_edsr_forward(pm, 2)
    x = torch.from_numpy(np.random.default_rng(15).uniform(0, 255, (1, 6, 8, 3))
                         .astype(np.float32))
    block = pm.module.res_blocks[0]

    def want(weight):
        u = wr.h_transform_kernel(weight.permute(2, 3, 1, 0), 2)
        return wr.entry_basis(u, wr.path_for(torch.float32))

    fwd(x)
    first = seen[0][0]
    assert first.shape == (3, 4, 3, 8, 8) and torch.equal(first, want(block.body[0].weight))
    with torch.no_grad():
        block.body[0].weight.mul_(2.0)
    seen.clear()
    fwd(x)
    assert torch.equal(seen[0][0], want(block.body[0].weight))
    assert not torch.equal(seen[0][0][1], first[1])
    assert torch.equal(seen[0][1], want(block.body[2].weight))


def _models(m_name="edsr"):
    jm = jax_get_model(m_name)
    jm.parse_args(list(TINY))
    jm.prepare(is_training=False, scales=[4])
    pm = get_model(m_name)
    pm.parse_args(list(TINY))
    pm.prepare([4], device="cpu")
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    pm.load_state_dict(state_dict_from_jax_params(params, m_name))
    return jm, pm


@pytest.mark.parametrize("m", [2, 4])
def test_edsr_forward_matches_jax_wino_forward(m):
    jm, pm = _models()
    x = np.random.default_rng(10).uniform(0, 255, (1, 18, 16, 3)).astype(np.float32)
    want = np.asarray(wino_pallas.make_wino_pallas_edsr_forward(jm, interpret=True, m=m)(
        jm.params, x))
    fwd = wr.make_wino_edsr_forward(pm, m)
    got = fwd(torch.from_numpy(x)).numpy()
    _check("EDSR x4 F(%d,3) vs JAX wino forward" % m, got, want, COLLAPSED_TAIL_ATOL)
    # the port's standard route bakes the same tail (--collapsed_tail 1)
    standard = make_collapsed_edsr_forward(pm)(torch.from_numpy(x)).numpy()
    _check("EDSR x4 F(%d,3) vs port standard" % m, got, standard, FWD_ATOL[m])


def test_route_follows_restore_and_serving_dtype(tmp_path):
    _, pm = _models()
    x = torch.from_numpy(np.random.default_rng(11).uniform(0, 255, (1, 8, 10, 3))
                         .astype(np.float32))
    pm.set_route(wr.make_wino_edsr_forward(pm, 2))
    first = pm.fwd_runtime(x)
    path = str(tmp_path / "other.pth")
    other = get_model("edsr")
    other.parse_args(list(TINY))
    other.prepare([4], device="cpu", seed=5)
    torch.save(other.module.state_dict(), path)
    pm.restore(path)  # in-place copy: the cached weight transforms must refresh
    routed = pm.fwd_runtime(x)
    # the standard route (the collapsed tail, probed again for these weights)
    pm.set_route(make_collapsed_edsr_forward(pm))
    np.testing.assert_allclose(routed.numpy(), pm.fwd_runtime(x).numpy(), atol=FWD_ATOL[2])
    assert float((routed - first).abs().max()) > 1.0
    pm.set_route(wr.make_wino_edsr_forward(pm, 2))
    pm.set_serving_dtype("bf16")
    out = pm.fwd_runtime(x)
    assert out.dtype == torch.float32 and torch.isfinite(out).all()


def test_odd_width_raises_as_jax():
    _, pm = _models()
    fwd = wr.make_wino_edsr_forward(pm, 2)
    with pytest.raises(ValueError, match="even width"):
        fwd(torch.zeros((1, 8, 9, 3)))
