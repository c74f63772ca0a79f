"""The port's channel-sharded convs (larvanet_tpu_torch/parallel/tp.py)
against the JAX package's (tests/test_tp.py) on the same meshes, on the
CPU: JAX on conftest.py's 8 virtual CPU devices, the port on meshes that
repeat the CPU. The port's shards run the conv kernel's plain version here
(the hand-written kernel on the card)."""

import jax
import numpy as np
import torch

from larvanet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from larvanet_tpu.parallel.tp import make_tp_forward as jax_make_tp_forward
from larvanet_tpu.parallel.tp import make_tp_spatial_forward as jax_make_tp_spatial_forward
from larvanet_tpu.parallel.tp import tp_conv3x3 as jax_tp_conv3x3
from larvanet_tpu_torch.ops.conv3x3 import conv3x3_bias_act_reference
from larvanet_tpu_torch.parallel import mesh, tp

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

CPU = torch.device("cpu")
# JAX's bar (tests/test_tp.py:33, :80), borders included: both sides
# zero-fill the halo beyond the image
ATOL = 1e-4


def _t(a):
    return torch.from_numpy(np.asarray(a))


def test_tp_two_layer_conv_matches_jax(rng):
    """A conv-relu-conv with every conv's 32 outputs split over an 8-way
    'model' mesh (4 a shard: conv3x3's narrow path on the card)."""
    C, F = 16, 32
    x = rng.standard_normal((2, 8, 8, C)).astype(np.float32)
    params = {"k1": rng.standard_normal((3, 3, C, F)).astype(np.float32) * 0.1,
              "b1": rng.standard_normal((F,)).astype(np.float32),
              "k2": rng.standard_normal((3, 3, F, F)).astype(np.float32) * 0.1,
              "b2": rng.standard_normal((F,)).astype(np.float32)}

    def jax_local(p, v):
        h = jax.nn.relu(jax_tp_conv3x3(v, p["k1"], p["b1"]))
        return jax_tp_conv3x3(h, p["k2"], p["b2"])

    want = np.asarray(jax_make_tp_forward(jax_local, jax_make_mesh((8,), ("model",)))(
        jax.tree_util.tree_map(jax.numpy.asarray, params), x))

    def local(p, xs):
        h = tp.tp_conv3x3(xs, p["k1"], p["b1"], "relu")
        return tp.tp_conv3x3(h, p["k2"], p["b2"])

    f = tp.make_tp_forward(local, mesh.make_mesh((8,), ("model",), [CPU] * 8))
    got = f({k: _t(v) for k, v in params.items()}, _t(x)).numpy()
    plain = conv3x3_bias_act_reference(
        conv3x3_bias_act_reference(_t(x), _t(params["k1"]), _t(params["b1"]), "relu"),
        _t(params["k2"]), _t(params["b2"])).numpy()
    assert got.shape == want.shape == (2, 8, 8, F)
    np.testing.assert_allclose(got, want, atol=ATOL)
    np.testing.assert_allclose(got, plain, atol=ATOL)


def test_tp_spatial_2d_composition_matches_jax(rng):
    """4-way spatial x 2-way model: a 4-conv + PixelShuffle stack with H
    split over 'spatial' (the zero-filled halo exchange) and the output
    channels over 'model', against JAX's make_tp_spatial_forward on the
    same mesh, every row included."""
    C, scale, n_layers = 16, 4, 4
    chans = [3] + [C] * (n_layers - 1) + [3 * scale ** 2]
    params = {}
    for i in range(n_layers):
        params["conv%d" % i] = {
            "kernel": rng.standard_normal((3, 3, chans[i], chans[i + 1])).astype(np.float32) * 0.1,
            "bias": rng.standard_normal((chans[i + 1],)).astype(np.float32) * 0.1}
    x = rng.uniform(0, 1, (1, 32, 12, 3)).astype(np.float32)
    halo = n_layers  # the stack's receptive radius
    want = np.asarray(jax_make_tp_spatial_forward(
        jax_make_mesh((4, 2), ("spatial", "model")), halo=halo, scale=scale)(
        jax.tree_util.tree_map(jax.numpy.asarray, params), x))
    f = tp.make_tp_spatial_forward(mesh.make_mesh((4, 2), ("spatial", "model"), [CPU] * 8),
                                   halo=halo, scale=scale)
    got = f({k: {n: _t(a) for n, a in v.items()} for k, v in params.items()}, _t(x)).numpy()
    assert got.shape == want.shape == (1, 128, 48, 3)
    np.testing.assert_allclose(got, want, atol=ATOL)


def test_shard_params_splits_outputs_and_refuses_what_does_not_divide():
    devices = [CPU] * 4
    shards = tp.shard_params({"k": torch.arange(3 * 3 * 2 * 8.0).reshape(3, 3, 2, 8),
                              "b": torch.arange(8.0), "s": torch.tensor(2.0)}, devices)
    assert [tuple(k.shape) for k in shards["k"]] == [(3, 3, 2, 2)] * 4
    assert torch.equal(shards["b"][3], torch.tensor([6.0, 7.0]))
    assert len(shards["s"]) == 4
    gathered = tp.all_gather(shards["b"], devices, dim=0)
    assert len({id(g) for g in gathered}) == 1 and torch.equal(gathered[0], torch.arange(8.0))
    try:
        tp.shard_params({"k": torch.zeros(3, 3, 2, 6)}, devices)
    except ValueError as e:
        assert "6 output channels do not divide the 4-way 'model' axis" in str(e)
    else:
        raise AssertionError("an undividable kernel was split")
