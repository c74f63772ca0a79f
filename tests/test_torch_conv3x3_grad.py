"""The conv's backward in the port (ops/conv3x3.py `Conv3x3Train`,
ops/conv3x3_wgrad.py) against the JAX package's conv3x3 under jax.grad, on
the CPU.

On a CPU tensor the Function runs the kernels' plain versions inside its
forward and backward, so these tests hold its backward formulas (the
activation's derivative from the saved output, dgrad as a SAME conv with
the rotated kernel, the weight and bias gradient as nine tap products), not
torch's autograd through the plain version. Inputs come from numpy with a
seed and go to both.
"""

from unittest import mock

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvanet_tpu.models.layers import conv3x3 as jax_conv3x3
from larvanet_tpu_torch.models.layers import Conv3x3
from larvanet_tpu_torch.ops import conv3x3
from larvanet_tpu_torch.ops import conv3x3_wgrad as wg

# f32 gradients that sum the same products in another order, each held
# relative to its tensor's largest |g| (as the train-step tests are)
GRAD_RTOL = 1e-5
ACTS = {None: lambda y: y, "relu": jax.nn.relu,
        "leaky_relu": lambda y: jax.nn.leaky_relu(y, 0.1)}
# EDSR-like C -> F at a tiny width: first_conv, the trunk, the upsample
# conv, its dgrad's 64 -> 16, final_conv
SHAPES = [(3, 16), (16, 16), (16, 64), (64, 16), (16, 3)]


def _np(rng, shape, scale=1.0):
    return (scale * rng.standard_normal(shape)).astype(np.float32)


def _rel_err(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


def _jax_grads(x, k, b, g, act):
    conv = jax_conv3x3(k.shape[-1], in_features=k.shape[2])

    def f(x, k, b):
        y = ACTS[act](conv.apply({"params": {"kernel": k, "bias": b}}, x))
        return jnp.sum(y * g)

    return [np.asarray(a) for a in jax.grad(f, argnums=(0, 1, 2))(x, k, b)]


@pytest.mark.parametrize("act", [None, "relu", "leaky_relu"])
@pytest.mark.parametrize("c,f", SHAPES)
def test_function_backward_matches_jax_grad(c, f, act):
    rng = np.random.default_rng(c * 100 + f)
    x, k, b = _np(rng, (2, 7, 9, c)), _np(rng, (3, 3, c, f), 0.2), _np(rng, (f,))
    g = _np(rng, (2, 7, 9, f))
    want = _jax_grads(x, k, b, g, act)
    tx, tk, tb = (torch.from_numpy(a).requires_grad_() for a in (x, k, b))
    out = conv3x3.Conv3x3Train.apply(tx, tk, tb, act)
    out.backward(torch.from_numpy(g))
    for name, got, ref in zip(("dx", "dW", "db"), (tx.grad, tk.grad, tb.grad), want):
        err = _rel_err(got.numpy(), ref)
        print("conv3x3 backward %d->%d %s %s: max|d| / max|g| %.3g" % (c, f, act, name, err))
        assert got.shape == ref.shape and err <= GRAD_RTOL


def test_function_backward_runs_its_own_formulas():
    """The backward calls dgrad (flagged) on the conv wrapper and the wgrad
    wrapper once each, and skips dgrad when x needs no gradient."""
    rng = np.random.default_rng(1)
    x, k, b = (torch.from_numpy(a) for a in (_np(rng, (1, 5, 6, 4)), _np(rng, (3, 3, 4, 8)),
                                             _np(rng, (8,))))
    k.requires_grad_()
    b.requires_grad_()
    calls = []

    def conv(x, kernel, bias, act=None, dgrad=False, slope=0.1):
        calls.append("dgrad" if dgrad else "forward")
        return conv3x3.conv3x3_bias_act_reference(x, kernel, bias, act, slope)

    def wgrad(x, g):
        calls.append("wgrad")
        return wg.conv3x3_wgrad_reference(x, g)

    with mock.patch.object(conv3x3, "conv3x3_bias_act", conv), \
            mock.patch.object(wg, "conv3x3_wgrad", wgrad):
        conv3x3.Conv3x3Train.apply(x, k, b, "relu").sum().backward()
        assert calls == ["forward", "wgrad"]  # x needs no gradient: no dgrad
        calls.clear()
        conv3x3.Conv3x3Train.apply(x.requires_grad_(), k, b, "relu").sum().backward()
    assert calls == ["forward", "dgrad", "wgrad"]


@pytest.mark.parametrize("case", ["no_grad", "frozen", "grad"])
def test_layer_takes_the_function_only_for_gradients(case):
    """Serving (no_grad, or nothing requiring grad) keeps the direct call;
    a forward whose parameters or input want gradients takes the Function."""
    layer = Conv3x3(4, 8, act="relu", generator=torch.Generator().manual_seed(0))
    x = torch.from_numpy(_np(np.random.default_rng(2), (1, 5, 6, 4)))
    if case == "frozen":
        layer.requires_grad_(False)
    with mock.patch.object(conv3x3.Conv3x3Train, "apply",
                           wraps=conv3x3.Conv3x3Train.apply) as apply:
        if case == "no_grad":
            with torch.no_grad():
                out = layer(x)
        else:
            out = layer(x)
    assert apply.call_count == (case == "grad")
    assert out.requires_grad == (case == "grad")
    np.testing.assert_array_equal(
        out.detach().numpy(),
        conv3x3.conv3x3_bias_act_reference(x, layer.weight.detach().permute(2, 3, 1, 0),
                                           layer.bias.detach(), "relu").numpy())


@pytest.mark.parametrize("c,f", SHAPES + [(64, 256), (64, 3)])
def test_plain_wgrad_matches_torch_conv2d_weight(c, f):
    rng = np.random.default_rng(c + f)
    x, g = _np(rng, (2, 6, 7, c)), _np(rng, (2, 6, 7, f))
    dw, db = wg.conv3x3_wgrad_reference(torch.from_numpy(x), torch.from_numpy(g))
    want = torch.nn.grad.conv2d_weight(
        torch.from_numpy(x).permute(0, 3, 1, 2), (f, c, 3, 3),
        torch.from_numpy(g).permute(0, 3, 1, 2), padding=1).permute(2, 3, 1, 0)
    assert dw.shape == (3, 3, c, f) and db.shape == (f,)
    assert _rel_err(dw.numpy(), want.numpy()) <= GRAD_RTOL
    assert _rel_err(db.numpy(), g.sum((0, 1, 2))) <= GRAD_RTOL


@pytest.mark.parametrize("c,f", [(64, 256), (64, 3), (16, 16)])
def test_dgrad_kernel_gives_torch_conv2d_input(c, f):
    """dgrad is a SAME conv of the output gradient with the kernel rotated by
    180 degrees and C, F swapped (EDSR's upsample 256 -> 64 and final_conv's
    3 -> 64 among them)."""
    rng = np.random.default_rng(c * f)
    k, g = _np(rng, (3, 3, c, f), 0.2), _np(rng, (2, 6, 7, f))
    tk, tg = torch.from_numpy(k), torch.from_numpy(g)
    got = conv3x3.conv3x3_bias_act_reference(tg, conv3x3.dgrad_kernel(tk), torch.zeros(c))
    want = torch.nn.grad.conv2d_input((2, c, 6, 7), tk.permute(3, 2, 0, 1),
                                      tg.permute(0, 3, 1, 2), padding=1).permute(0, 2, 3, 1)
    assert _rel_err(got.numpy(), want.numpy()) <= GRAD_RTOL


@pytest.mark.parametrize("m,c,f,sms", [(36864, 64, 64, 132), (589824, 64, 3, 132),
                                       (147456, 64, 256, 132), (36864, 3, 64, 132),
                                       (70, 16, 16, 1), (5000, 16, 4, 3)])
def test_wgrad_splits_cover_every_pixel_once(m, c, f, sms):
    splits, chunk = wg.splits_for(m, c, f, sms)
    assert chunk % 16 == 0 and splits >= 1
    assert (splits - 1) * chunk < m <= splits * chunk  # no split is empty
    assert splits == 1 or chunk >= wg.MIN_CHUNK


# a train step's weight-gradient shapes (chip_smoke.py TRAIN_WGRAD at batch
# 16 of 48x48 LR patches): (N, H, W, C, F) and the path each takes
TRAIN_WGRAD_PATHS = [
    ((16, 48, 48, 3, 64), "cuda_core"),      # first_conv: C = 3
    ((16, 48, 48, 64, 64), "tensor_core"),   # the trunk and after_res_conv
    ((16, 48, 48, 64, 256), "tensor_core"),  # upsample.body.0
    ((16, 96, 96, 64, 256), "tensor_core"),  # upsample.body.2
    ((16, 192, 192, 64, 3), "narrow"),       # final_conv
]


@pytest.mark.parametrize("shape,path", TRAIN_WGRAD_PATHS)
def test_wgrad_path_for_every_train_step_shape(shape, path):
    n, h, w, c, f = shape
    assert wg.path_for(c, f) == path
    assert wg.entry_for(path, f) == path  # none of them takes the 256 x 4 CUDA-core tile


@pytest.mark.parametrize("c,f,path", [(16, 4, "narrow"), (48, 1, "narrow"), (16, 8, "tensor_core"),
                                      (48, 48, "tensor_core"), (8, 3, "cuda_core"),
                                      (64, 12, "cuda_core"), (3, 16, "cuda_core")])
def test_wgrad_path_for_by_shape(c, f, path):
    """C % 16 == 0 with F <= 4 is narrow, with F % 8 == 0 the tensor cores;
    the CUDA-core path takes the rest, on its 256 x 4 tile for F <= 4."""
    assert wg.path_for(c, f) == path
    assert wg.entry_for(path, f) == ("cuda_core_narrow" if path == "cuda_core" and f <= 4
                                     else path)


@pytest.mark.parametrize("shape,sms", [(s, 132) for s, _ in TRAIN_WGRAD_PATHS[1:]]
                         + [((1, 5, 7, 16, 16), 132), ((3, 17, 33, 32, 64), 4),
                            ((2, 9, 40, 16, 3), 1), ((1, 8, 16, 128, 256), 132),
                            ((64, 96, 96, 64, 256), 132)])
def test_wgrad_tile_splits_cover_every_tile_once(shape, sms):
    """The tiled paths' splits count pixel tiles (the kernel's step): none is
    empty, together they cover every tile once, their blocks (one an output
    tile and channel chunk) fill at most the SMs once where the tiles allow
    it, and no tensor-core split is longer than MAX_TC_CHUNK tiles (batch 64
    of the upsample's 96x96 takes the cap)."""
    n, h, w, c, f = shape
    path = wg.path_for(c, f)
    splits, chunk = wg.tile_splits(path, n, h, w, c, f, sms)
    th, tw = wg.PIXEL_TILE[path]
    tiles = n * -(-h // th) * -(-w // tw)
    assert splits >= 1 and chunk >= 1
    assert (splits - 1) * chunk < tiles <= splits * chunk
    bc, bf = {"tensor_core": (64, 64), "narrow": (64, f)}[path]
    blocks = -(-c // bc) * -(-f // bf)
    if path == "tensor_core" and chunk == wg.MAX_TC_CHUNK:
        assert -(-tiles // wg.MAX_TC_CHUNK) == splits  # the cap, not the SMs, sets the splits
    else:
        assert splits * blocks <= max(sms, blocks)
    assert path != "tensor_core" or chunk <= wg.MAX_TC_CHUNK
    print("wgrad %s %s on %d SMs: %d splits of %d tiles (%d tiles, %d blocks a split)"
          % (path, shape, sms, splits, chunk, tiles, blocks))
