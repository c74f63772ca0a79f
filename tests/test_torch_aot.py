"""The port's serving artifacts (larvanet_tpu_torch/utils/aot.py,
ops/library.py, cli/export.py, serve --artifact, validate --artifact) on
the CPU, at a tiny EDSR (8 features, 2 blocks), with the kernels' plain
versions as the registered ops' CPU bodies.

An artifact's graph holds the hand-written kernels as `larvanet.*` op
nodes, one per launch of the live route, and none of their plain
versions' products; loaded back, in this process after the model is gone
or in a fresh one that never imports the model zoo, it equals the live
route bit for bit in f32, bf16 and int8 (the same bodies on the same
operands). The `.pth` export from a JAX `.ckpt` equals the JAX package's
`save_pth` tensor by tensor. Errors and refusals follow JAX's
(larvanet_tpu/utils/aot.py, cli/export.py, cli/serve.py:768-801,
cli/validate.py:107-133). The artifacts against JAX's own StableHLO
artifacts are in test_torch_aot_jax.py. Inputs come from numpy seeds.
"""

import gc
import json
import os
import subprocess
import sys
from collections import Counter
from unittest import mock

import numpy as np
import pytest
import torch
from flax import serialization

from larvanet_tpu.utils import torch_convert as jax_convert
from larvanet_tpu_torch.cli import export, serve, validate
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.data import io
from larvanet_tpu_torch.models import layers
from larvanet_tpu_torch.ops import collapsed_tail as pct
from larvanet_tpu_torch.ops import conv3x3_s8 as s8
from larvanet_tpu_torch.ops import conv_kxk as ck
from larvanet_tpu_torch.ops import dwconv3x3 as dw
from larvanet_tpu_torch.ops import library
from larvanet_tpu_torch.utils import aot

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--edsr_conv_features", "8", "--edsr_res_blocks", "2"]
SHAPE = (2, 12, 14, 3)
# the artifacts of the fixture: name -> (export dtype, --int8_trunk)
ROUTES = {"f32": ("float32", False), "bf16": ("bfloat16", False), "int8": ("float32", True)}
PSNR_TOL = 1e-4  # dB: validate --artifact against validate --restore_path


def _lr(shape, seed):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


def _edsr(seed=0):
    model = get_model("edsr")
    model.parse_args(list(TINY))
    model.prepare([4], device="cpu", seed=seed)
    return model


def _counting():
    """A context that counts the live route's kernel calls, as they would be
    launched on the card: conv3x3 (by its layers' name), conv_kxk single and
    grouped, the s8 entries and the depthwise conv."""
    counts = Counter()
    stack = []

    def wrap(owner, name, key):
        real = getattr(owner, name)

        def counted(*args, **kwargs):
            counts[key] += 1
            return real(*args, **kwargs)

        stack.append(mock.patch.object(owner, name, counted))

    wrap(layers, "conv3x3_bias_act", "conv3x3_bias_act")
    wrap(ck, "conv_kxk", "conv_kxk")
    wrap(pct, "conv_kxk_group", "conv_kxk_group")
    wrap(s8, "conv_a", "conv3x3_s8_a")
    wrap(s8, "conv_b", "conv3x3_s8_b")
    wrap(layers, "dwconv3x3_op", "dwconv3x3")
    return counts, stack


def _op_nodes(program):
    return Counter(str(n.target).split(".")[1] for n in program.graph.nodes
                   if n.op == "call_function" and str(n.target).startswith("larvanet."))


@pytest.fixture(scope="module")
def artifacts(tmp_path_factory):
    """{route: (path, x, the live route's output, its kernel calls, the
    traced program)} for ROUTES, each exported from the tiny EDSR, and the
    model's .pth; the model is deleted before any test loads an artifact."""
    root = tmp_path_factory.mktemp("aot")
    model = _edsr()
    pth = str(root / "edsr.pth")
    torch.save(model.module.state_dict(), pth)
    x = _lr(SHAPE, 1)
    out = {}
    for route, (dtype, int8) in ROUTES.items():
        fwd, desc = aot.serving_forward(model, dtype, int8_trunk=int8,
                                        calib=_lr(SHAPE, 2) if int8 else None)
        counts, patches = _counting()
        for p in patches:
            p.start()
        try:
            live = fwd(torch.from_numpy(x)).numpy()
        finally:
            for p in patches:
                p.stop()
        program, header = aot.trace_serving(model, fwd, desc, SHAPE, dtype, ("cpu",))
        path = str(root / ("%s.lvt" % route))
        aot.save_artifact(path, program, header)
        out[route] = (path, x, live, dict(counts), program)
    del model, fwd
    gc.collect()
    return out, pth, root


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_graph_holds_one_op_node_per_kernel_call(artifacts, route):
    """The traced graph holds a `larvanet.*` node for each kernel call of
    the live route (f32 and bf16: 6 conv3x3, the tail's main conv_kxk and 3
    grouped border convs; int8: first_conv and after_res_conv, 2 pairs of s8
    entries) and no plain version: no convolution, and its only matmul the
    MeanShift's 3 x 3 colour matrix."""
    path, _, _, counts, program = artifacts[0][route]
    nodes = _op_nodes(program)
    print("%s: op nodes %s, live kernel calls %s" % (route, dict(nodes), counts))
    assert dict(nodes) == {k: v for k, v in counts.items() if v}
    want = {"conv3x3_bias_act": 2 if route == "int8" else 6, "conv_kxk": 1,
            "conv_kxk_group": 3}
    if route == "int8":
        want.update(conv3x3_s8_a=2, conv3x3_s8_b=2)
    assert dict(nodes) == want
    targets = [n for n in program.graph.nodes if n.op == "call_function"]
    assert not any("convolution" in str(n.target) for n in targets)
    for n in targets:
        if str(n.target).startswith("aten.matmul"):
            assert tuple(n.args[1].meta["val"].shape) == (3, 3)


@pytest.mark.parametrize("route", sorted(ROUTES))
def test_artifact_equals_the_live_route_bit_for_bit(artifacts, route):
    """Loaded after the model is deleted, the artifact's output equals the
    live route's exactly; the header keeps JAX's keys."""
    path, x, live, _, _ = artifacts[0][route]
    serve_fn, header = aot.load_artifact(path, "cpu")
    got = serve_fn(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32 and got.shape == (2, 48, 56, 3)
    np.testing.assert_array_equal(got, live)
    assert set(header) == {"model", "scale", "input_shape", "dtype", "platforms",
                           "path_desc", "framework"}
    assert (header["model"], header["scale"], header["input_shape"]) == ("edsr", 4,
                                                                          list(SHAPE))
    assert header["platforms"] == ["cpu"] and header["framework"] == "larvanet_tpu_torch"
    assert header["path_desc"] == ("int8 (W8A8) trunk + collapsed tail" if route == "int8"
                                   else "collapsed linear tail")
    assert header["dtype"] == ROUTES[route][0]


def test_a_fresh_process_runs_the_artifact_without_the_model_zoo(artifacts, tmp_path):
    path, x, live, _, _ = artifacts[0]["int8"]
    np.save(str(tmp_path / "x.npy"), x)
    script = (
        "import json, sys, numpy as np, torch\n"
        "from larvanet_tpu_torch.utils import aot\n"
        "serve, header = aot.load_artifact(sys.argv[1], 'cpu')\n"
        "y = serve(torch.from_numpy(np.load(sys.argv[2]))).numpy()\n"
        "np.save(sys.argv[3], y)\n"
        "print(json.dumps({'models': 'larvanet_tpu_torch.models' in sys.modules,\n"
        "                  'jax': 'jax' in sys.modules}))\n")
    proc = subprocess.run([sys.executable, "-c", script, path, str(tmp_path / "x.npy"),
                           str(tmp_path / "y.npy")], cwd=REPO, capture_output=True,
                          text=True, timeout=300,
                          env=dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1"))
    assert proc.returncode == 0, proc.stderr
    loaded = json.loads(proc.stdout.strip().splitlines()[-1])
    assert loaded == {"models": False, "jax": False}
    np.testing.assert_array_equal(np.load(str(tmp_path / "y.npy")), live)


def test_artifact_model_chunks_pads_and_refuses_other_geometries(artifacts):
    """ArtifactModel runs any batch in chunks of the exported N (the last
    zero-padded) and raises JAX's errors on another geometry or scale."""
    path, x, live, _, _ = artifacts[0]["f32"]
    model = aot.ArtifactModel(path, "cpu")
    assert (model.batch, model.height, model.width, model.scale) == (2, 12, 14, 4)
    frames = np.concatenate([x, x[:1]])
    got = model.fwd_runtime(torch.from_numpy(frames)).numpy()
    np.testing.assert_array_equal(got, np.concatenate([live, live[:1]]))
    chw = [f.transpose(2, 0, 1) for f in x]
    np.testing.assert_array_equal(model.upscale(chw, 4), live.transpose(0, 3, 1, 2))
    want_u8 = np.clip(np.round(live), 0, 255).astype(np.uint8).transpose(0, 3, 1, 2)
    np.testing.assert_array_equal(model.upscale_uint8(chw, 4), want_u8)
    with pytest.raises(ValueError, match="exported for 12x14 inputs, got 12x16"):
        model.fwd_runtime(torch.zeros((1, 12, 16, 3)))
    with pytest.raises(ValueError, match="artifact is x4, requested x2"):
        model.upscale(chw, 2)


def test_load_refusals(artifacts, tmp_path):
    """A wrong input shape, a file with another magic, a JAX StableHLO
    artifact (its magic) and a device the artifact was not exported for
    are refused by name."""
    path, x, _, _, _ = artifacts[0]["f32"]
    serve_fn, _ = aot.load_artifact(path, "cpu")
    with pytest.raises(ValueError, match="exported for input shape"):
        serve_fn(torch.zeros((1, 12, 14, 3)))
    bad = tmp_path / "bad.lvt"
    bad.write_bytes(b"NOTANART" + b"\0" * 16)
    with pytest.raises(ValueError, match="bad magic"):
        aot.load_artifact(str(bad), "cpu")
    jax_file = tmp_path / "jax.lvt"
    jax_file.write_bytes(aot.JAX_MAGIC + b"\0" * 16)
    with pytest.raises(ValueError, match="JAX StableHLO serving artifact"):
        aot.load_artifact(str(jax_file), "cpu")
    with pytest.raises(ValueError, match="exported for cpu, not cuda"):
        aot.load_artifact(path, "cuda")
    with pytest.raises(ValueError, match="NHWC with 3 channels"):
        aot.export_serving(_edsr(), (1, 8, 8))
    with pytest.raises(ValueError, match="not tpu"):
        aot.export_serving(_edsr(), (1, 8, 8, 3), platforms=("tpu",))


@pytest.mark.parametrize("op,args", [
    ("_conv3x3_op", lambda r: (r((1, 5, 6, 4)), r((3, 3, 4, 8)), r((8,)), 1, 0.1)),
    ("_conv_kxk_op", lambda r: (r((1, 5, 6, 4)), r((5, 5, 4, 3)), r((3,)), [2, 2, 2, 2])),
    ("_conv_kxk_group_op", lambda r: (r((2, 1, 5, 6, 4)), [r((3, 3, 4, 2)), r((3, 3, 4, 2))],
                                      [r((2,)), None], [0, 0, 1, 1])),
    ("_s8_a_op", lambda r: (r((1, 4, 6, 8)), torch.randint(-127, 128, (3, 3, 8, 4),
                                                           dtype=torch.int8),
                            r((4,)).abs() + 0.01, r((4,)), 1.5, 0.5, 1, 0.1)),
    ("_s8_b_op", lambda r: (torch.randint(-127, 128, (1, 4, 6, 8), dtype=torch.int8),
                            torch.randint(-127, 128, (3, 3, 8, 4), dtype=torch.int8),
                            r((4,)).abs() + 0.01, r((4,)), "bfloat16",
                            r((1, 4, 6, 4)).to(torch.bfloat16), 0.5)),
    ("_dw_op", lambda r: (r((1, 5, 6, 4)), r((3, 3, 1, 4)), r((4,)))),
])
def test_registered_ops_pass_opcheck(op, args):
    """Each op's schema, fake body and CPU body agree (torch.library.opcheck:
    the fake body's shapes and dtypes against the CPU body's, the schema's
    mutation and aliasing claims)."""
    gen = torch.Generator().manual_seed(0)
    operands = args(lambda shape: torch.randn(shape, generator=gen))
    torch.library.opcheck(getattr(library, op), operands,
                          test_utils=("test_schema", "test_faketensor"))


def test_fake_bodies_keep_the_wrappers_checks():
    """Traced with a kernel of the wrong shape, an op raises the wrapper's
    error at export, not at run time."""
    def bad(x):
        return layers.conv3x3_bias_act(x, torch.zeros(3, 3, 4, 8), torch.zeros(7))

    with pytest.raises(Exception, match=r"bias must be \(8,\)"):
        torch.export.export(aot._Program(bad), (torch.zeros(1, 5, 5, 4),))


@pytest.fixture(scope="module")
def cli_data(artifacts):
    """A DIV2K-layout set of 3 frames (LR 12x14 twice, 20x30) under the
    fixture's root."""
    root = artifacts[2]
    rng = np.random.default_rng(3)
    for i, (h, w) in enumerate(((12, 14), (12, 14), (20, 30))):
        hr = rng.integers(0, 256, (3, 4 * h, 4 * w)).astype(np.uint8)
        lr = np.round(hr.reshape(3, h, 4, w, 4).mean((2, 4))).astype(np.uint8)
        io.save_image_chw(hr, str(root / "HR" / ("%04d.png" % i)))
        io.save_image_chw(lr, str(root / "LR" / "X4" / ("%04dx4.png" % i)))
    return str(root / "LR"), str(root / "HR")


def test_export_cli_then_validate_artifact_equals_validate_restore(artifacts, cli_data,
                                                                   tmp_path, capsys):
    """export --stablehlo (a square 12x12 artifact of 4 tiles) and --output
    from the .pth; validate --artifact --tile_forward against validate
    --restore_path --tile_forward at the same tiles (the tile size is the
    artifact's), within PSNR_TOL dB; the exported .pth equals the input's
    state_dict."""
    pth = artifacts[1]
    art, out_pth = str(tmp_path / "e.lvt"), str(tmp_path / "e.pth")
    export.main(["--device", "cpu", "--model", "edsr", *TINY, "--restore_path", pth,
                 "--output", out_pth, "--stablehlo", art, "--export_batch", "4",
                 "--export_height", "12", "--export_width", "12", "--packed_trunk", "1"])
    text = capsys.readouterr().out
    assert "exported serving artifact" in text and "ignored here" in text
    want = torch.load(pth, weights_only=True)
    got = torch.load(out_pth, weights_only=True)
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    data = ["--device", "cpu", "--data_input_path", cli_data[0],
            "--data_truth_path", cli_data[1]]
    a = validate.main(data + ["--artifact", art, "--tile_forward", "--tile_overlap", "4",
                              "--wino_trunk", "2"])
    b = validate.main(data + ["--model", "edsr", *TINY, "--restore_path", pth,
                              "--tile_forward", "--tile_size", "12", "--tile_overlap", "4"])
    print("validate --artifact %s, --restore_path %s" % (a, b))
    assert abs(a[4] - b[4]) <= PSNR_TOL
    assert "validating serving artifact" in capsys.readouterr().out


def test_validate_artifact_direct_frames(artifacts, tmp_path, capsys):
    """validate --artifact without tiles: frames of the exported geometry
    pass, another one raises JAX's geometry error."""
    path = artifacts[0]["f32"][0]
    root = tmp_path
    rng = np.random.default_rng(4)
    for i, hw in enumerate(((12, 14), (12, 16))):
        hr = rng.integers(0, 256, (3, 4 * hw[0], 4 * hw[1])).astype(np.uint8)
        io.save_image_chw(hr, str(root / "HR" / ("%04d.png" % i)))
        io.save_image_chw(hr[:, ::4, ::4], str(root / "LR" / "X4" / ("%04dx4.png" % i)))
    data = ["--device", "cpu", "--data_input_path", str(root / "LR"),
            "--data_truth_path", str(root / "HR"), "--artifact", path]
    with pytest.raises(ValueError, match="exported for 12x14 inputs, got 12x16"):
        validate.main(data)
    with pytest.raises(SystemExit, match="artifact is x4; pass --scales 4"):
        validate.main(data + ["--scales", "2"])


def test_export_cli_refusals(artifacts, tmp_path):
    pth = artifacts[1]
    base = ["--device", "cpu", "--model", "edsr", *TINY, "--restore_path", pth]
    with pytest.raises(SystemExit, match="nothing to do"):
        export.main(base)
    with pytest.raises(SystemExit, match="--platforms tpu"):
        export.main(base + ["--stablehlo", str(tmp_path / "a.lvt"), "--platforms", "tpu"])
    with pytest.raises(SystemExit, match="requires --calib_path"):
        export.main(base + ["--stablehlo", str(tmp_path / "a.lvt"), "--int8_trunk", "1"])


def test_export_int8_artifact_from_calib_dir(artifacts, cli_data, tmp_path):
    """--int8_trunk with --calib_path: the first PNGs centre-cropped to the
    export geometry calibrate the pairs (JAX's _calib_from_dir); an LR frame
    smaller than the geometry is refused."""
    pth = artifacts[1]
    base = ["--device", "cpu", "--model", "edsr", *TINY, "--restore_path", pth,
            "--int8_trunk", "1", "--calib_path", os.path.join(cli_data[0], "X4")]
    export.main(base + ["--stablehlo", str(tmp_path / "i.lvt"), "--export_height", "12",
                        "--export_width", "12", "--platforms", "cpu,cuda"])
    header, _ = aot.read_artifact(str(tmp_path / "i.lvt"))
    assert header["path_desc"] == "int8 (W8A8) trunk + collapsed tail"
    assert header["platforms"] == ["cpu", "cuda"]
    with pytest.raises(SystemExit, match="smaller than the export geometry"):
        export.main(base + ["--stablehlo", str(tmp_path / "j.lvt"), "--export_height", "16",
                            "--export_width", "16"])


# name -> flags of the .pth export's families
PTH_FAMILIES = {
    "edsr": TINY,
    "LarvaNet": ["--num_modules", "2", "--num_blocks", "1,1"],
    "mamnet": ["--mamnet_conv_features", "16", "--mamnet_res_blocks", "2"],
    "ebrn": ["--num_filters", "8", "--num_brms", "2"],
}


@pytest.mark.parametrize("name", sorted(PTH_FAMILIES))
def test_pth_export_from_a_jax_ckpt_equals_jax_save_pth(name, tmp_path):
    """export --output from a JAX .ckpt (msgpack of JAX's parameter tree)
    writes, tensor by tensor, what JAX's `save_pth` writes for those
    parameters (EBRN: the dead last BRM as zeros, its PReLUs 0.25)."""
    pm = get_model(name)
    pm.parse_args(list(PTH_FAMILIES[name]))
    pm.prepare([4], device="cpu", seed=5)
    state = {k: v.numpy() for k, v in pm.module.state_dict().items()}
    params = jax_convert.convert_state_dict(state, name)[0]
    ckpt = str(tmp_path / "model_7.ckpt")
    with open(ckpt, "wb") as f:
        f.write(serialization.msgpack_serialize(
            {"params": serialization.to_state_dict(params), "global_step": 7}))
    out = str(tmp_path / "port.pth")
    export.main(["--device", "cpu", "--model", name, *PTH_FAMILIES[name], "--restore_path",
                 ckpt, "--output", out])
    jax_convert.save_pth(serialization.to_state_dict(params), name, str(tmp_path / "jax.pth"))
    got = torch.load(out, weights_only=True)
    want = torch.load(str(tmp_path / "jax.pth"), weights_only=True)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype and torch.equal(got[k], want[k]), k


def _service_args(*argv):
    return serve.build_parser().parse_known_args(list(argv))


def test_artifact_service_serves_the_live_servers_pixels(artifacts):
    """ArtifactService, direct (the batch-2 artifact: dynamic batch 2) and
    tiled (tiles of 12 from a square artifact on a 20x30 frame), answers
    each frame with the live server's bytes; /info reports its artifact
    mode, path and input shape (the model zoo's absence is the fresh
    process's test: this one imports it)."""
    path, x, _, _, _ = artifacts[0]["f32"]
    pth = artifacts[1]
    root = artifacts[2]
    square = str(root / "square.lvt")
    export.main(["--device", "cpu", "--model", "edsr", *TINY, "--restore_path", pth,
                 "--stablehlo", square, "--export_batch", "3", "--export_height", "12",
                 "--export_width", "12"])
    rng = np.random.default_rng(6)
    for mode, art, frames, extra in (
            ("direct", path, [rng.integers(0, 256, (3, 12, 14)).astype(np.uint8)
                              for _ in range(3)], []),
            ("tile", square, [rng.integers(0, 256, (3, 20, 30)).astype(np.uint8)],
             ["--tile_forward", "--tile_size", "12", "--tile_overlap", "4"])):
        service = serve.ArtifactService(art, tile=mode == "tile", tile_overlap=4,
                                        device="cpu")
        service.warmup(8, 8)
        live = serve.build_service(*_service_args("--device", "cpu", "--model", "edsr", *TINY,
                                                  "--restore_path", pth, *extra))
        for img in frames:
            np.testing.assert_array_equal(service.upscale_chw(img), live.upscale_chw(img))
        info = service.info()
        assert info["mode"] == "artifact-" + mode
        assert info["path_desc"] == "collapsed linear tail"
        assert info["dynamic_batch"] == (2 if mode == "direct" else 1)
        assert info["input_shape"] == ([2, 12, 14, 3] if mode == "direct" else [3, 12, 12, 3])
        assert info["num_requests"] == len(frames)


@pytest.mark.parametrize("flag,message", [
    (["--dynamic_batch", "2"], "--dynamic_batch does not apply"),
    (["--chop_forward"], "--chop_forward does not apply"),
    (["--int8_trunk", "1"], "--int8_trunk does not apply"),
    (["--ema", "1"], "--ema does not apply"),
    (["--dp_devices", "2"], "--dp_devices does not apply"),
    (["--spatial_shard", "2"], "--spatial_shard does not apply"),
    (["--serving_dtype", "bf16"], "--serving_dtype does not apply"),
    (["--restore_path", "m.pth"], "not both"),
])
def test_serve_artifact_refusals(artifacts, flag, message):
    """JAX's --artifact conflicts (cli/serve.py:768-796), refused before
    the artifact is read."""
    with pytest.raises(SystemExit, match=message) as exc:
        serve.main(["--device", "cpu", "--artifact", "missing.lvt", *flag])
    assert exc.value.code not in (0, None)
