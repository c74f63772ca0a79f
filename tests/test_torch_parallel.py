"""The port's parallel package (larvanet_tpu_torch/parallel/mesh.py,
halo.py) against the JAX package's (tests/test_parallel.py), on the CPU.

JAX runs on conftest.py's 8 virtual CPU devices; the port's meshes repeat
the CPU device, the counterpart of that trick (a card's run repeats
cuda:0 the same way). The weights cross from JAX's init into the port with
`state_dict_from_jax_params`; the inputs come from a numpy seed.
"""

import os

import jax
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding, PartitionSpec as P

from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.data import fixture
from larvanet_tpu.parallel.halo import spatial_sharded_forward as jax_spatial_forward
from larvanet_tpu.parallel.mesh import make_mesh as jax_make_mesh
from larvanet_tpu.parallel.mesh import shard_batch as jax_shard_batch
from larvanet_tpu.parallel.mesh import use_data_parallel as jax_use_data_parallel
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.data import io
from larvanet_tpu_torch.eval import metrics
from larvanet_tpu_torch.eval.tiling import TiledUpscaler
from larvanet_tpu_torch.ops.collapsed_tail import make_collapsed_edsr_forward
from larvanet_tpu_torch.parallel import halo, mesh
from larvanet_tpu_torch.utils.torch_convert import state_dict_from_jax_params

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

CPU = torch.device("cpu")
TINY = ["--edsr_res_blocks", "2", "--edsr_conv_features", "8", "--edsr_learning_rate", "1e-3",
        "--packed_trunk", "0"]
# JAX's bars (tests/test_parallel.py:50-55, :88)
LOSS_RTOL = 1e-5
PARAM_ATOL = 1e-5
FULL_FRAME_ATOL = 2e-3
# port against JAX on the same sharded forward, relative to the output's
# largest value (the port's module bar)
JAX_RTOL = 1e-4
# the tiny EDSR x4's receptive radius in LR rows: head 1, 2 ResBlocks 4,
# body end 1, the first upsample conv 1, the 2x and HR convs 1 together
TINY_RADIUS = 8


def _to_numpy(tree):
    if hasattr(tree, "items"):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.array(tree)


def _jax_edsr(training=True, seed=7):
    m = jax_get_model("edsr")
    m.parse_args(list(TINY))
    m.prepare(is_training=training, scales=[4], seed=seed)
    return m


def _port_edsr(params, training=True):
    m = get_model("edsr")
    m.parse_args(list(TINY))
    m.prepare([4], device="cpu", is_training=training)
    m.load_state_dict(state_dict_from_jax_params(params, "edsr"))
    return m


def _batch(seed=0):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0, 255, (8, 8, 8, 3)).astype(np.float32),
            rng.uniform(0, 255, (8, 32, 32, 3)).astype(np.float32))


def test_make_mesh_shapes_and_devices():
    m = mesh.make_mesh(None, ("data",), [CPU] * 8)
    assert dict(m.shape) == {"data": 8} and m.devices.size == 8
    m2 = mesh.make_mesh((4, 2), ("data", "spatial"), [CPU] * 8)
    assert dict(m2.shape) == {"data": 4, "spatial": 2}
    assert m2.axis_devices("spatial", data=3) == [CPU, CPU]
    assert "cpu x8 (virtual)" in repr(m2)
    with pytest.raises(ValueError, match="does not cover 8 devices"):
        mesh.make_mesh((3, 2), ("data", "spatial"), [CPU] * 8)
    # no card here: the default mesh is the CPU; a CLI's mesh repeats it
    assert mesh.default_devices() == [CPU]
    assert mesh.devices_for("cpu", 3) == [CPU] * 3
    shards = mesh.shard_batch(torch.arange(16.0).reshape(16, 1), m)
    assert [s.shape[0] for s in shards] == [2] * 8 and torch.equal(shards[3][:, 0],
                                                                    torch.tensor([6.0, 7.0]))
    module = torch.nn.Linear(2, 2)
    shared = mesh.replicate(module, m)
    assert all(c is module for c in shared.copies)
    own = mesh.replicate(module, m, share=False)
    assert len({id(c) for c in own.copies}) == 8 and all(
        c.weight.device == CPU and torch.equal(c.weight, module.weight) for c in own.copies)


@pytest.mark.parametrize("share", [True, False])
def test_dp_step_matches_jax_and_the_single_device_step(share):
    """One step on an 8-way 'data' mesh against JAX's use_data_parallel step
    from the same weights and batch, and against the port's own step on the
    whole batch. share=False gives each position its own replica module
    (the path of distinct cards): after the step each holds the model's
    parameters."""
    x, y = _batch()
    jm = _jax_edsr()
    params = _to_numpy(jm.params)
    jmesh = jax_make_mesh()
    jax_use_data_parallel(jm, jmesh)
    jm.params, jm.opt_state, jax_loss = jm._train_jit(
        jm.params, jm.opt_state, 1e-3, jax_shard_batch(x, jmesh), jax_shard_batch(y, jmesh))
    jax_state = state_dict_from_jax_params(_to_numpy(jm.params), "edsr")

    single = _port_edsr(params)
    single_loss = float(single._optimizer_step(torch.from_numpy(x), torch.from_numpy(y), 1e-3))
    pm = _port_edsr(params)
    step = mesh.make_dp_train_step(pm, mesh.make_mesh(None, ("data",), [CPU] * 8), share=share)
    loss = float(step(torch.from_numpy(x), torch.from_numpy(y), 1e-3))
    print("dp step: loss %.9g, JAX's %.9g, single-device %.9g"
          % (loss, float(jax_loss), single_loss))
    assert loss == pytest.approx(float(jax_loss), rel=LOSS_RTOL)
    assert loss == pytest.approx(single_loss, rel=LOSS_RTOL)
    for name, p in pm.module.named_parameters():
        assert float((p.detach() - jax_state[name]).abs().max()) <= PARAM_ATOL, name
    for a, b in zip(pm.module.parameters(), single.module.parameters()):
        assert float((a - b).detach().abs().max()) <= PARAM_ATOL
    assert pm.optimizer.state_dict()["state"][0]["step"] == 1  # one Adam step


def test_dp_replicas_hold_the_parameters_and_sit_on_their_devices():
    x, y = _batch(1)
    pm = _port_edsr(_to_numpy(_jax_edsr().params))
    mesh.use_data_parallel(pm, mesh.make_mesh(None, ("data",), [CPU] * 4), share=False)
    pm.train_step(x, 4, y)
    reps = pm.data_parallel.replicas
    assert len({id(r) for r in reps}) == 4 and pm not in reps
    for rep, d in zip(reps, pm.data_parallel.devices):
        assert rep.device == d and rep.optimizer is None
        for a, b in zip(rep.module.parameters(), pm.module.parameters()):
            assert a.device == d and a is not b and torch.equal(a, b)


def test_dp_steps_loss_falls():
    x, y = _batch(2)
    pm = _port_edsr(_to_numpy(_jax_edsr().params))
    mesh.use_data_parallel(pm, mesh.make_mesh(None, ("data",), [CPU] * 8))
    losses = [pm.train_step(x, 4, y) for _ in range(4)]
    assert losses[-1] < losses[0]


def _spatial_pair(halo_rows, rng):
    """(port's sharded output, JAX's, port's full frame) of the tiny EDSR on
    a (2 data, 4 spatial) mesh: JAX's halo test's configuration."""
    jm = _jax_edsr(training=False)
    pm = _port_edsr(_to_numpy(jm.params), training=False)
    x = rng.uniform(0, 255, (1, 64, 16, 3)).astype(np.float32)
    jmesh = jax_make_mesh((2, 4), ("data", "spatial"))
    jf = jax_spatial_forward(lambda p, v: jm.module.apply({"params": p}, v), jmesh,
                             halo=halo_rows, scale=4, axis_name="spatial", spatial_axis=1)
    xg = jax.device_put(x, NamedSharding(jmesh, P(None, "spatial", None, None)))
    want = np.asarray(jf(jm.params, xg))
    pmesh = mesh.make_mesh((2, 4), ("data", "spatial"), [CPU] * 8)
    f = halo.spatial_sharded_forward(lambda module, v: module(v), pmesh, halo=halo_rows,
                                     scale=4)
    with torch.no_grad():
        got = f(pm.module, torch.from_numpy(x)).numpy()
        full = pm.module(torch.from_numpy(x)).numpy()
    return got, want, full, pm


def test_spatial_halo_at_the_radius_matches_jax_and_the_full_frame(rng):
    got, want, full, pm = _spatial_pair(8, rng)
    with torch.no_grad():
        radius = halo.receptive_radius(pm.module, 4)
    assert radius == TINY_RADIUS <= 8
    err_jax = float(np.abs(got - want).max())
    err_full = float(np.abs(got - full).max())
    print("halo 8: |port - JAX| %.3g, |port - full frame| %.3g (max %.1f)"
          % (err_jax, err_full, float(np.abs(want).max())))
    assert got.shape == want.shape == full.shape == (1, 256, 64, 3)
    assert err_jax <= JAX_RTOL * float(np.abs(want).max())
    assert err_full <= FULL_FRAME_ATOL


def test_spatial_halo_below_the_radius_matches_jax(rng):
    """At halo 2, below the radius, the rows near the seams differ from the
    full frame, in JAX as in the port, by the same amounts."""
    got, want, full, _ = _spatial_pair(2, rng)
    assert float(np.abs(got - full).max()) > FULL_FRAME_ATOL
    assert float(np.abs(got - want).max()) <= JAX_RTOL * float(np.abs(want).max())


def test_spatial_halo_fixture_protocol_delta_is_zero(tmp_path):
    """LarvaNet --num_blocks 1,1 on the fixture frame, 2 spatial shards at
    halo 8: uint8 identical to the full-frame forward, the same PSNR."""
    root = str(tmp_path)
    fixture.generate(root, shapes=((32, 20, 0, 0),), scales=(4,))
    m = get_model("LarvaNet")
    m.parse_args(["--num_blocks", "1,1"])
    m.prepare([4], device="cpu")
    f = halo.spatial_sharded_forward(lambda module, v: module(v),
                                     mesh.make_mesh((2,), ("spatial",), [CPU] * 2),
                                     halo=8, scale=4)
    lr = io.load_image_u8(os.path.join(root, "x4", "input", "img000.png")).astype(np.float32)
    hr = io.load_image_u8(os.path.join(root, "x4", "truth", "img000.png"))
    x = torch.from_numpy(lr[None])
    with torch.no_grad():
        assert halo.receptive_radius(m.serving_module, 4) <= 8
        full = metrics.image_to_uint8(m.fwd_runtime(x)[0].numpy().transpose(2, 0, 1))
        shard = metrics.image_to_uint8(f(m.serving_module, x)[0].numpy().transpose(2, 0, 1))
    np.testing.assert_array_equal(full, shard)
    truth = metrics.image_to_uint8(hr.transpose(2, 0, 1))
    assert metrics.psnr_rgb(full, truth) == metrics.psnr_rgb(shard, truth)


@pytest.mark.parametrize("share", [True, False])
def test_dp_tiled_eval_matches_single_device(rng, share):
    """Tile batches of the collapsed route split over a 4-way mesh
    (TiledUpscaler(min_batch=4)) equal the single-device tiling. share=False
    rebuilds the route on every position's own model copy (the path of
    distinct cards): each copy's baked tail is its own, on its device."""
    pm = _port_edsr(_to_numpy(_jax_edsr(training=False).params), training=False)
    pm.set_route(make_collapsed_edsr_forward(pm))
    pm.route_remake = make_collapsed_edsr_forward
    x = rng.uniform(0, 255, (3, 40, 52)).astype(np.float32)
    ref = TiledUpscaler(pm.fwd_runtime, scale=4, tile_size=16, overlap=8).upscale_chw(x)
    mesh.use_data_parallel_eval(pm, mesh.make_mesh((4,), ("data",), [CPU] * 4), share=share)
    got = TiledUpscaler(pm.fwd_runtime, scale=4, tile_size=16, overlap=8,
                        min_batch=4).upscale_chw(x)
    np.testing.assert_allclose(got, ref, atol=FULL_FRAME_ATOL)
    reps = pm.route.replicas
    if share:
        assert all(r is pm for r in reps)
        return
    assert len({id(r) for r in reps}) == 4 and pm not in reps
    tails = [r._collapsed_tail[1] for r in reps]
    own = pm._collapsed_tail[1]
    for tail in tails:
        assert tail is not own and tail.device == CPU
        for a, b in zip(tail.operands(torch.float32)[0].kernels,
                        own.operands(torch.float32)[0].kernels):
            assert a.device == CPU and a is not b and torch.equal(a, b)


def test_refusals():
    """JAX's messages: a strip shorter than 2*halo, an axis its mesh axis
    does not divide, a dp batch the axis does not divide."""
    m4 = mesh.make_mesh((4,), ("spatial",), [CPU] * 4)
    ident = halo.spatial_sharded_forward(lambda p, v: v.repeat_interleave(2, 1), m4,
                                         halo=3, scale=2)
    with pytest.raises(ValueError, match=r"local strip \(4 rows\) must be >= 2\*halo \(6\)"):
        ident(None, torch.zeros(1, 16, 8, 3))
    with pytest.raises(ValueError, match="4 does not evenly divide 18"):
        ident(None, torch.zeros(1, 18, 8, 3))
    one = halo.spatial_sharded_forward(lambda p, v: v * 2,
                                       mesh.make_mesh((1,), ("spatial",), [CPU]),
                                       halo=3, scale=1)
    assert torch.equal(one(None, torch.ones(1, 5, 4, 3)), torch.full((1, 5, 4, 3), 2.0))
    pm = _port_edsr(_to_numpy(_jax_edsr(training=False).params), training=False)
    mesh.use_data_parallel_eval(pm, mesh.make_mesh((2,), ("data",), [CPU] * 2))
    with pytest.raises(ValueError, match="batch 3 does not divide the 2-way 'data' axis; "
                                         r"use TiledUpscaler\(min_batch=2\)"):
        pm.fwd_runtime(torch.zeros(3, 8, 8, 3))
    tm = _port_edsr(_to_numpy(_jax_edsr().params))
    mesh.use_data_parallel(tm, mesh.make_mesh((2,), ("data",), [CPU] * 2))
    x, y = _batch()
    with pytest.raises(ValueError, match="batch 3 does not divide"):
        tm.train_step(x[:3], 4, y[:3])


def test_halo_exchange_zero_fills_the_outer_edges():
    strips = [torch.full((1, 4, 2, 1), float(i + 1)) for i in range(3)]
    ext = halo.halo_exchange(strips, 2)
    assert [e.shape[1] for e in ext] == [8, 8, 8]
    assert ext[0][0, :2].eq(0).all() and ext[0][0, 6:].eq(2).all()
    assert ext[1][0, :2].eq(1).all() and ext[1][0, 6:].eq(3).all()
    assert ext[2][0, :2].eq(2).all() and ext[2][0, 6:].eq(0).all()
