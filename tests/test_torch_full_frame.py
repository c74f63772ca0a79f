"""The port's full-frame inference paths against the JAX package, on the
CPU: chop-forward and the tile engine (larvanet_tpu_torch/eval/tiling.py),
the x8 self-ensemble and the checkpoint ensemble (eval/ensemble.py), and
the CLIs that use them (validate, get_sr, serve) with --ema; the test CLI
is held in tests/test_torch_test_cli.py.

The library parts are held against JAX's module graph at the tiny models'
tolerances (EDSR ATOL, LarvaNet LARVA_ATOL). The CLIs are held against
JAX's CLIs with --collapsed_tail 0 (its module graph; the collapsed tail
sits up to 0.1 from it), the port's CLIs with --collapsed_tail 0 too, on a
tiny EDSR whose
final_conv is rescaled so its output spans the pixel range (as drawn, the
clamp to [0, 255] would hide any error).

Receptive radius of the tiny EDSR (2 ResBlocks): first_conv, 4 trunk
convs, after_res_conv and upsample.body.0 at the LR size (7 px), then
upsample.body.2 at 2x and final_conv at 4x (0.75 LR px): 7.75, so an
overlap of 18 (half 9) is exact. Tiny LarvaNet (2 modules of 1 ResBlock):
head, 4 trunk convs and the last leg's 2 convs, 7 LR px, and the bicubic
base's 2: 18 is exact too.
"""

import json
import os
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from larvanet_tpu.cli import get_sr as jax_get_sr
from larvanet_tpu.cli import validate as jax_validate
from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.data import fixture
from larvanet_tpu.eval import ensemble as jax_ensemble
from larvanet_tpu.eval import tiling as jax_tiling
from larvanet_tpu_torch.cli import get_sr, runtime, serve, validate
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.data import io, png
from larvanet_tpu_torch.eval import ensemble, tiling
from larvanet_tpu_torch.utils.torch_convert import state_dict_from_jax_params
from torch_edsr_fit import _fitted_pth

TINY = ["--edsr_res_blocks", "2", "--edsr_conv_features", "8"]
LARVA_TINY = ["--num_modules", "2", "--num_blocks", "1,1"]
# f32 on [0, 255] outputs: the two module graphs sum the same products in
# another order (tests/test_torch_edsr.py, test_torch_larvanet.py)
ATOL = 2e-4
LARVA_ATOL = 1e-3
# per-image PSNR of a port CLI against JAX's (tests/test_protocol_parity.py)
PSNR_TOL = 1e-3
EXACT_OVERLAP = 18
# LR frames (h, w, extra_h, extra_w) with odd and even sides: odd chop
# quadrants, ragged tiles
SHAPES = ((36, 50, 2, 3), (33, 47, 1, 2))
TILE_FLAGS = ["--tile_size", "16", "--tile_overlap", "4"]


def _to_numpy(tree):
    if hasattr(tree, "items"):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.array(tree)


def _louder(tree, rng):
    """Every kernel x2, every bias from N(0, 1): the LarvaNet trunk then moves
    the output well beyond its interpolated base."""
    if "kernel" in tree:
        return {"kernel": (2.0 * tree["kernel"]).astype(np.float32),
                "bias": rng.normal(0.0, 1.0, tree["bias"].shape).astype(np.float32)}
    return {k: _louder(v, rng) for k, v in tree.items()}


class _JaxGraph:
    """A JAX model's module graph behind the host contract `model.upscale`."""

    def __init__(self, jm, params):
        self.jm, self.params = jm, jax.tree_util.tree_map(jnp.asarray, params)

    def forward(self, x_nhwc):
        return np.asarray(self.jm.module.apply({"params": self.params}, jnp.asarray(x_nhwc)))

    def upscale(self, input_list, scale):
        x = np.stack(input_list).astype(np.float32).transpose(0, 2, 3, 1)
        return self.forward(x).transpose(0, 3, 1, 2)


@pytest.fixture(scope="module", params=["edsr", "LarvaNet"])
def pair(request):
    """(name, JAX module graph, port model with the same weights, atol)."""
    name = request.param
    flags = TINY if name == "edsr" else LARVA_TINY
    jm = jax_get_model(name)
    jm.parse_args(list(flags))
    jm.prepare(is_training=False, scales=[4])
    params = _to_numpy(jm.params)
    if name != "edsr":
        params = _louder(params, np.random.default_rng(2))
    pm = get_model(name)
    pm.parse_args(list(flags))
    pm.prepare([4], device="cpu")
    pm.load_state_dict(state_dict_from_jax_params(params, name))
    return name, _JaxGraph(jm, params), pm, ATOL if name == "edsr" else LARVA_ATOL


def _frame(h, w, seed=0):
    return np.random.default_rng(seed).uniform(0, 255, (3, h, w)).astype(np.float32)


def _close(label, got, want, atol):
    print("parity %s: max|d| %.3g" % (label, np.abs(got - want).max()))
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=atol, rtol=0)


# ---- the arithmetic, exactly JAX's --------------------------------------------------


@settings(max_examples=200, deadline=None)
@given(h=st.integers(1, 600), w=st.integers(1, 600), overlap=st.integers(0, 41))
def test_split_image_2x2_equals_jax(h, w, overlap):
    img = np.arange(3 * h * w, dtype=np.int32).reshape(3, h, w)
    got, want = tiling.split_image_2x2(img, overlap), jax_tiling.split_image_2x2(img, overlap)
    assert len(got) == len(want) == 4
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)


class _Nearest:
    """A model whose upscale repeats every pixel: chop-forward's paste
    arithmetic without a network."""

    def upscale(self, input_list, scale):
        return np.stack([im.repeat(scale, 1).repeat(scale, 2) for im in input_list])


@settings(max_examples=100, deadline=None)
@given(h=st.integers(2, 150), w=st.integers(2, 150), scale=st.integers(1, 4), data=st.data())
def test_combine_images_2x2_equals_jax(h, w, scale, data):
    overlap = data.draw(st.integers(0, 2 * (min(h, w) // 2)))  # odd ones included
    img = np.random.default_rng(h * w).integers(0, 256, (3, h, w)).astype(np.uint8)
    got = tiling.upscale_with_chop_forward(_Nearest(), img, scale, overlap)
    want = jax_tiling.upscale_with_chop_forward(_Nearest(), img, scale, overlap)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, img.repeat(scale, 1).repeat(scale, 2))


@settings(max_examples=400, deadline=None)
@given(extent=st.integers(1, 600), tile=st.integers(8, 256), data=st.data())
def test_tile_starts_and_owned_ranges_equal_jax(extent, tile, data):
    stride = tile - data.draw(st.integers(0, tile - 1))
    starts = tiling._tile_starts(extent, tile, stride)
    assert starts == jax_tiling._tile_starts(extent, tile, stride)
    if extent >= tile:
        ranges = tiling._owned_ranges(starts, tile, extent)
        assert ranges == jax_tiling._owned_ranges(starts, tile, extent)
        # every output pixel is owned once
        assert ranges[0][0] == 0 and ranges[-1][1] == extent
        assert all(a[1] == b[0] for a, b in zip(ranges, ranges[1:]))


# ---- the forwards against JAX's module graph ----------------------------------------


@pytest.mark.parametrize("overlap", [6, 7, 20])
def test_chop_forward_matches_jax(pair, overlap):
    name, jax_graph, pm, atol = pair
    img = _frame(23, 31)
    got = tiling.upscale_with_chop_forward(pm, img, 4, overlap)
    want = jax_tiling.upscale_with_chop_forward(jax_graph, img, 4, overlap)
    _close("%s chop overlap %d" % (name, overlap), got, want, atol)


@pytest.mark.parametrize("hw,tile,overlap", [
    ((20, 28), 32, 8),                   # smaller than a tile: one full-frame call
    ((24, 24), 24, 6),                   # exactly one tile
    ((45, 61), 16, 4),                   # ragged, the default's ratio (128 / 24)
    ((45, 61), 32, EXACT_OVERLAP),       # ragged, half the overlap past the radius
])
def test_tiled_upscaler_matches_jax(pair, hw, tile, overlap):
    name, jax_graph, pm, atol = pair
    img = _frame(*hw, seed=1)
    got = tiling.TiledUpscaler(pm.fwd_runtime, 4, tile, overlap).upscale_chw(img)
    want = jax_tiling.TiledUpscaler(jax_graph.forward, 4, tile, overlap).upscale_chw(img)
    _close("%s tiles %s %d/%d" % (name, hw, tile, overlap), got, want, atol)
    direct = pm.upscale([img], 4)[0]
    print("%s tiles %d/%d against the full frame: max|d| %.3g"
          % (name, tile, overlap, np.abs(got - direct).max()))
    if overlap == EXACT_OVERLAP or hw[0] <= tile:
        _close("%s tiles %d/%d vs full frame" % (name, tile, overlap), got, direct, atol)


def test_tile_output_does_not_depend_on_the_batch(pair):
    _, _, pm, _ = pair
    img = _frame(45, 61, seed=2)
    outs = [tiling.TiledUpscaler(pm.fwd_runtime, 4, 16, 4, max_batch=b).upscale_chw(img)
            for b in (1, 5, 64)]
    np.testing.assert_array_equal(outs[0], outs[1])
    np.testing.assert_array_equal(outs[0], outs[2])


def test_tiled_upscaler_refuses_an_overlap_as_wide_as_the_tile(pair):
    with pytest.raises(ValueError, match="overlap"):
        tiling.TiledUpscaler(pair[2].fwd_runtime, 4, 16, 16)


def test_self_ensemble_matches_jax(pair):
    name, jax_graph, pm, atol = pair
    x = np.random.default_rng(3).uniform(0, 255, (2, 9, 14, 3)).astype(np.float32)
    got = ensemble.self_ensemble_forward(pm.module)(torch.from_numpy(x)).numpy()
    want = np.asarray(jax_ensemble.self_ensemble_forward(
        lambda p, b: jax_graph.jm.module.apply({"params": p}, b))(jax_graph.params, x))
    _close("%s self-ensemble" % name, got, want, atol)
    # each orientation reaches the module contiguous (the kernel refuses views)
    seen = []
    ensemble.self_ensemble_forward(lambda b: seen.append(b.is_contiguous()) or pm.module(b))(
        torch.from_numpy(x))
    assert seen == [True] * 8


def test_ensemble_forward_matches_jax(pair):
    name, jax_graph, pm, atol = pair
    rng = np.random.default_rng(4)
    base = _to_numpy(jax_graph.params)
    trees = [jax.tree_util.tree_map(
        lambda a: (a * (1 + 0.1 * rng.normal(size=a.shape))).astype(np.float32), base)
        for _ in range(3)]
    port = ensemble.EnsembleForward(pm.module, [state_dict_from_jax_params(t, name)
                                                for t in trees])
    ref = jax_ensemble.EnsembleForward(
        lambda p, b: jax_graph.jm.module.apply({"params": p}, b),
        [jax.tree_util.tree_map(jnp.asarray, t) for t in trees])
    x = rng.uniform(0, 255, (2, 7, 9, 3)).astype(np.float32)
    got_all = port.all(torch.from_numpy(x)).numpy()
    assert port.k == 3 and got_all.shape == (3, 2, 28, 36, 3)
    _close("%s ensemble .all" % name, got_all, np.asarray(ref.all(x)), atol)
    _close("%s ensemble .mean" % name, port.mean(torch.from_numpy(x)).numpy(),
           np.asarray(ref.mean(x)), atol)


# ---- the CLIs against JAX's -----------------------------------------------------------


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("frames"))
    fixture.generate(root, shapes=SHAPES, scales=(4,), datasets=())
    lr, hr = os.path.join(root, "x4", "input"), os.path.join(root, "x4", "truth")
    name = io.list_pngs(lr)[0] + ".png"
    pth = _fitted_pth(os.path.join(root, "edsr.pth"), os.path.join(lr, name),
                      os.path.join(hr, name))
    return lr, hr, pth


def _validate_flags(data, ckpt, report, *extra):
    return ["--model", "edsr", "--scales", "4", "--dataloader", "basic_loader",
            "--data_input_path", data[0], "--data_truth_path", data[1],
            "--restore_path", ckpt, "--report_json", report, *extra, *TINY]


def _per_image(path):
    with open(path) as f:
        return json.load(f)["scales"]["4"]["per_image"]


def _port_validate(data, tmp_path, *extra, ckpt=None):
    report = str(tmp_path / ("port%d.json" % len(os.listdir(tmp_path))))
    validate.main(_validate_flags(data, ckpt or data[2], report, "--device", "cpu",
                                  "--collapsed_tail", "0", *extra))
    return _per_image(report)


def _jax_validate(data, tmp_path, *extra, ckpt=None):
    report = str(tmp_path / ("jax%d.json" % len(os.listdir(tmp_path))))
    jax_validate.main(_validate_flags(data, ckpt or data[2], report, "--collapsed_tail", "0",
                                      *extra))
    return _per_image(report)


def _same_psnrs(label, port, ref):
    assert sorted(port) == sorted(ref) and len(ref) == len(SHAPES)
    deltas = {k: abs(port[k] - ref[k]) for k in ref}
    print("parity %s: |dPSNR| %s dB (PSNRs %s)" % (
        label, {k: "%.2e" % v for k, v in deltas.items()},
        {k: "%.3f" % v for k, v in port.items()}))
    assert max(deltas.values()) <= PSNR_TOL
    assert min(port.values()) > 10.0  # well above an all-clamped output's ~6 dB


@pytest.mark.parametrize("mode", [
    ["--chop_forward"], ["--chop_forward", "--chop_overlap_size", "7"],
    ["--tile_forward"] + TILE_FLAGS,
    ["--tile_forward", "--tile_size", "32", "--tile_overlap", str(EXACT_OVERLAP)],
    ["--self_ensemble"], ["--self_ensemble", "--tile_forward"] + TILE_FLAGS])
def test_validate_full_frame_modes_match_jax(mode, data, tmp_path):
    port = _port_validate(data, tmp_path, *mode)
    _same_psnrs("validate %s" % " ".join(mode), port, _jax_validate(data, tmp_path, *mode))


def test_validate_counts_a_chop_as_four_forwards(data, tmp_path, monkeypatch):
    """Chop runs four forwards a frame, tiles ceil(tiles / max_batch)."""
    calls = []
    from larvanet_tpu_torch.models.base import SRModel

    real = SRModel.fwd_runtime
    monkeypatch.setattr(SRModel, "fwd_runtime",
                        lambda self, x: calls.append(tuple(x.shape)) or real(self, x))
    _port_validate(data, tmp_path, "--chop_forward")
    quadrants = [(1,) + q.shape[1:] + (3,) for name in io.list_pngs(data[0])
                 for q in tiling.split_image_2x2(
                     io.load_image_chw(os.path.join(data[0], name + ".png")), 20)]
    # 33x47 gives odd quadrants: 26 and 27 rows, 33 and 34 columns
    assert calls == quadrants and len(set(quadrants)) == 5
    calls.clear()
    _port_validate(data, tmp_path, "--tile_forward", *TILE_FLAGS)
    # 36x50: 3 x 4 tiles; 33x47: 3 x 4 tiles; one batch each
    assert calls == [(12, 16, 16, 3)] * 2


def test_self_ensemble_is_the_f32_module_function(data, tmp_path):
    """--self_ensemble runs the f32 module graph whatever --serving_dtype and
    --wino_trunk say, as JAX's runs _forward_impl."""
    want = _port_validate(data, tmp_path, "--self_ensemble")
    assert _port_validate(data, tmp_path, "--self_ensemble", "--serving_dtype", "bf16",
                          "--wino_trunk", "2") == want
    assert _port_validate(data, tmp_path, "--self_ensemble", "--tile_forward", *TILE_FLAGS,
                          "--serving_dtype", "bf16") == _port_validate(
        data, tmp_path, "--self_ensemble", "--tile_forward", *TILE_FLAGS)


@pytest.mark.parametrize("mode", [["--chop_forward"], ["--tile_forward"] + TILE_FLAGS])
def test_get_sr_full_frame_modes_match_jax(mode, data, tmp_path):
    """Each PNG within 1 uint8 level of JAX's get_sr; the port's equals its
    own library call (the CLI adds nothing to the forward)."""
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    get_sr.main(["--device", "cpu", "--input_path", data[0], "--output_path", port_dir,
                 "--restore_path", data[2], "--collapsed_tail", "0", *mode, *TINY])
    jax_get_sr.main(["--input_path", data[0], "--output_path", jax_dir, "--restore_path",
                     data[2], "--collapsed_tail", "0", *mode, *TINY])
    pm = get_model("edsr")
    pm.parse_args(list(TINY))
    pm.prepare([4], device="cpu")
    pm.restore(data[2])
    names = io.list_pngs(data[0])
    assert io.list_pngs(port_dir) == io.list_pngs(jax_dir) == names
    for name in names:
        lr = io.load_image_chw(os.path.join(data[0], name + ".png"))
        got = io.load_image_u8(os.path.join(port_dir, name + ".png"))
        if "--chop_forward" in mode:
            own = tiling.upscale_with_chop_forward(pm, lr, 4, 20)
        else:
            own = tiling.TiledUpscaler(pm.fwd_runtime, 4, 16, 4).upscale_chw(lr)
        np.testing.assert_array_equal(got, np.clip(np.round(own), 0, 255).astype(np.uint8)
                                      .transpose(1, 2, 0))
        ref = io.load_image_u8(os.path.join(jax_dir, name + ".png"))
        levels = int(np.abs(got.astype(np.int16) - ref.astype(np.int16)).max())
        print("parity get_sr %s %s vs JAX: max %d uint8 level(s)" % (mode[0], name, levels))
        assert levels <= 1


# ---- serve's modes ------------------------------------------------------------------


def _post(url, body):
    req = urllib.request.Request(url, data=body, method="POST")
    with urllib.request.urlopen(req, timeout=300) as r:
        return r.status, r.read()


@pytest.mark.parametrize("mode", [["--chop_forward"], ["--tile_forward"] + TILE_FLAGS])
def test_serve_modes_equal_get_sr(mode, data, tmp_path):
    """A frame POSTed to `serve` in chop or tile mode comes back as the PNG
    get_sr writes in the same mode; /info reports the mode."""
    out_dir = str(tmp_path / "sr")
    get_sr.main(["--device", "cpu", "--input_path", data[0], "--output_path", out_dir,
                 "--restore_path", data[2], *mode, *TINY])
    args, remaining = serve.build_parser().parse_known_args(
        ["--restore_path", data[2], "--device", "cpu", *mode, *TINY])
    service = serve.build_service(args, remaining)
    service.warmup(64, 64)
    httpd = serve.make_server(service, "127.0.0.1", 0)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = "http://127.0.0.1:%d" % httpd.server_address[1]
    try:
        for name in io.list_pngs(data[0]):
            with open(os.path.join(data[0], name + ".png"), "rb") as f:
                code, body = _post(url + "/upscale", f.read())
            assert code == 200
            want = io.load_image_u8(os.path.join(out_dir, name + ".png"))
            np.testing.assert_array_equal(png.decode(body, grey16="clip"), want)
        with urllib.request.urlopen(url + "/info", timeout=60) as r:
            info = json.loads(r.read())
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=60)
    assert not thread.is_alive()
    assert info["mode"] == mode[0][2:-len("_forward")]
    assert info["num_requests"] == info["num_forwards"] == len(SHAPES)


@pytest.mark.parametrize("mode", ["--chop_forward", "--tile_forward"])
def test_serve_refuses_dynamic_batch_with_a_mode(mode, data):
    args, remaining = serve.build_parser().parse_known_args(
        ["--restore_path", data[2], "--device", "cpu", "--dynamic_batch", "2", mode, *TINY])
    with pytest.raises(SystemExit, match="dynamic_batch"):
        serve.build_service(args, remaining)


# ---- --ema ---------------------------------------------------------------------------


@pytest.fixture(scope="module")
def ema_ckpts(data, tmp_path_factory):
    """(.pth whose .state.pt holds an average that differs from its weights,
    .pth of that average alone, JAX .ckpt trained with --ema_decay 0.9 from
    the fitted weights)."""
    root = tmp_path_factory.mktemp("ema")
    pm = get_model("edsr")
    pm.parse_args(list(TINY))
    pm.ema_decay = 0.9
    pm.prepare([4], device="cpu", is_training=True)
    pm.restore(data[2])
    rng = np.random.default_rng(5)
    average = [p.detach() * torch.from_numpy(
        (1 + 0.05 * rng.normal(size=p.shape)).astype(np.float32))
        for p in pm.module.parameters()]
    pm.ema.load(average)
    pth = pm.save(str(root / "with_state"))
    avg_state = pm.module.state_dict()
    for (name, _), a in zip(pm.module.named_parameters(), average):
        avg_state[name] = a
    avg_pth = str(root / "average.pth")
    torch.save(avg_state, avg_pth)

    jm = jax_get_model("edsr")
    jm.parse_args(TINY + ["--packed_trunk", "0", "--edsr_learning_rate", "3e-3"])
    jm.ema_decay = 0.9
    jm.prepare(is_training=True, scales=[4])
    jm.restore(data[2])
    jm.opt_state = jm.tx.init(jm.params)  # the average starts at the fitted weights
    lr = [io.load_image_chw(os.path.join(data[0], n + ".png"))[:, :32, :32]
          for n in io.list_pngs(data[0])]
    hr = [io.load_image_chw(os.path.join(data[1], n + ".png"))[:, :128, :128]
          for n in io.list_pngs(data[1])]
    for _ in range(2):
        jm.train_step(lr, 4, hr)
    return pth, avg_pth, jm.save(str(root / "jax"))


def test_validate_ema_of_a_jax_ckpt_matches_jax(data, ema_ckpts, tmp_path):
    ckpt = ema_ckpts[2]
    port = _port_validate(data, tmp_path, "--ema", "1", ckpt=ckpt)
    _same_psnrs("validate --ema (.ckpt)", port,
                _jax_validate(data, tmp_path, "--ema", "1", ckpt=ckpt))
    plain = _port_validate(data, tmp_path, ckpt=ckpt)
    _same_psnrs("validate (.ckpt)", plain, _jax_validate(data, tmp_path, ckpt=ckpt))
    assert port != plain


@pytest.mark.parametrize("extra", [[], ["--serving_dtype", "bf16"], ["--tile_forward"]
                                   + TILE_FLAGS, ["--chop_forward"]])
def test_validate_ema_serves_the_average(extra, data, ema_ckpts, tmp_path):
    """--ema on a .pth with its .state.pt scores exactly as the average
    saved as a .pth; under --serving_dtype bf16 the bf16 copy must be made
    from the average (an average swapped in after it would serve stale
    weights and fail here)."""
    pth, avg_pth, _ = ema_ckpts
    got = _port_validate(data, tmp_path, "--ema", "1", *extra, ckpt=pth)
    assert got == _port_validate(data, tmp_path, *extra, ckpt=avg_pth)
    assert got != _port_validate(data, tmp_path, *extra, ckpt=pth)


@pytest.fixture(scope="module")
def even_data(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("even"))
    fixture.generate(root, shapes=SHAPES[:1], scales=(4,), datasets=())
    return os.path.join(root, "x4", "input"), os.path.join(root, "x4", "truth")


@pytest.mark.parametrize("wino", ["2", "4"])
def test_validate_ema_under_wino_serves_the_average(wino, even_data, ema_ckpts, tmp_path):
    """The Winograd route reads the average: --ema then --wino_trunk equals
    the average's .pth under the same route."""
    pth, avg_pth, _ = ema_ckpts
    flags = ["--wino_trunk", wino, "--serving_dtype", "bf16"]
    got = _port_validate(even_data + (pth,), tmp_path, "--ema", "1", *flags, ckpt=pth)
    want = _port_validate(even_data + (pth,), tmp_path, *flags, ckpt=avg_pth)
    assert got == want
    assert got != _port_validate(even_data + (pth,), tmp_path, *flags, ckpt=pth)


def test_use_ema_params_after_bf16_recasts_the_copy(ema_ckpts):
    """use_ema_params casts the serving copy again, so the library call
    serves the average in bf16 whichever order it is called in."""
    pth, avg_pth, _ = ema_ckpts
    models = []
    for path, ema in ((pth, True), (avg_pth, False)):
        m = get_model("edsr")
        m.parse_args(list(TINY))
        m.prepare([4], device="cpu")
        m.restore(path)
        m.set_serving_dtype("bf16")
        if ema:
            m.use_ema_params()
        models.append(m)
    x = torch.from_numpy(_frame(12, 10).transpose(1, 2, 0)[None].copy())
    assert torch.equal(models[0].fwd_runtime(x), models[1].fwd_runtime(x))


def test_get_sr_runtime_and_serve_take_ema(data, ema_ckpts, tmp_path, capsys):
    pth, avg_pth, _ = ema_ckpts
    for ckpt, extra, sub in ((pth, ["--ema", "1"], "ema"), (avg_pth, [], "avg")):
        get_sr.main(["--device", "cpu", "--input_path", data[0], "--output_path",
                     str(tmp_path / sub), "--restore_path", ckpt, *extra, *TINY])
    for name in io.list_pngs(data[0]):
        np.testing.assert_array_equal(io.load_image_u8(str(tmp_path / "ema" / (name + ".png"))),
                                      io.load_image_u8(str(tmp_path / "avg" / (name + ".png"))))
    runtime.main(["--device", "cpu", "--input_height", "8", "--input_width", "8",
                  "--num_warmup", "1", "--num_iters", "1", "--restore_path", pth, "--ema", "1",
                  *TINY])
    args, remaining = serve.build_parser().parse_known_args(
        ["--restore_path", pth, "--device", "cpu", "--ema", "1", *TINY])
    serve.build_service(args, remaining)
    assert capsys.readouterr().out.count("serving the EMA weights (--ema)") == 3


def test_ema_without_an_average_is_refused(data, tmp_path):
    with pytest.raises(ValueError, match="checkpoint has no EMA weights"):
        _port_validate(data, tmp_path, "--ema", "1")
