"""The port's frame-to-score path (larvanet_tpu_torch/cli/{validate,runtime,
get_sr}.py) against the JAX package's CLIs, on the CPU.

Both validate CLIs score the same fixture (larvanet_tpu.data.fixture) with
the same `.pth`, written by the JAX package's `save_pth` from a tiny EDSR
whose final_conv is rescaled so the output spans 0..255 (left as drawn,
the clamp would hide every error). With --wino_trunk 2|4 the JAX side runs
its Pallas kernels in the interpreter (LVT_WINO_INTERPRET, as
tests/test_wino_cli.py does) and the port its kernels' plain versions.

JAX's default forward and its Winograd forward end in the collapsed
linear tail, which on this model sits up to 0.3 from its own module graph
with a mean offset of ~0.02 (the port: 9e-5 and 1e-7). A constant offset
d moves the MSE by 2 d mean(output - truth), so the fit also sets the
output's mean to the truth's: then the offset drops out to first order.
The standard path is held against JAX's module graph (--collapsed_tail 0,
a TPU rewrite of the same function, which the port ignores).
"""

import json
import os

import numpy as np
import pytest
import torch

from larvanet_tpu.cli import get_sr as jax_get_sr
from larvanet_tpu.cli import validate as jax_validate
from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.data import fixture
from larvanet_tpu.utils.torch_convert import save_pth
from larvanet_tpu_torch.cli import get_sr, runtime, validate
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.data import io
from larvanet_tpu_torch.ops.collapsed_tail import make_collapsed_edsr_forward
from larvanet_tpu_torch.utils.torch_convert import state_dict_from_jax_params

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

TINY = ["--edsr_res_blocks", "2", "--edsr_conv_features", "8"]
# the bar of tests/test_protocol_parity.py
PSNR_TOL = 1e-3
# LR shapes (h, w, extra_h, extra_w), with truth-crop extras: an even width
# for --wino_trunk, and an odd width beside it for the standard path
EVEN_SHAPES = ((32, 40, 2, 3),)
ODD_SHAPES = ((32, 40, 2, 3), (30, 33, 1, 2))


def _to_numpy(tree):
    if hasattr(tree, "items"):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.array(tree)


def _fixture(tmp_path_factory, name, shapes):
    root = str(tmp_path_factory.mktemp(name))
    fixture.generate(root, shapes=shapes, scales=(4,), datasets=())
    return os.path.join(root, "x4", "input"), os.path.join(root, "x4", "truth")


@pytest.fixture(scope="module")
def even_data(tmp_path_factory):
    return _fixture(tmp_path_factory, "even", EVEN_SHAPES)


@pytest.fixture(scope="module")
def odd_data(tmp_path_factory):
    return _fixture(tmp_path_factory, "odd", ODD_SHAPES)


@pytest.fixture(scope="module")
def pth(tmp_path_factory, even_data):
    """A tiny JAX EDSR x4 with final_conv rescaled (through the port's
    forward on the even fixture image) to that image's truth mean and a
    std of 40, written by the JAX package's save_pth."""
    jm = jax_get_model("edsr")
    jm.parse_args(list(TINY))
    jm.prepare(is_training=False, scales=[4])
    params = _to_numpy(jm.params)
    pm = get_model("edsr")
    pm.parse_args(list(TINY))
    pm.prepare([4], device="cpu")
    pm.load_state_dict(state_dict_from_jax_params(params, "edsr"))
    name = io.list_pngs(even_data[0])[0] + ".png"
    lr = io.load_image_chw(os.path.join(even_data[0], name))
    target = io.load_image_chw(os.path.join(even_data[1], name)).mean((1, 2))
    shift = pm.module.mean_inverse_shift.bias.numpy()
    f = pm.upscale([lr], 4) - shift[None, :, None, None]
    a = 40.0 / float(f.std())
    final = params["final_conv"]
    final["kernel"] = (final["kernel"] * a).astype(np.float32)
    final["bias"] = (a * (final["bias"] - f.mean((0, 2, 3))) + target - shift).astype(np.float32)
    path = str(tmp_path_factory.mktemp("ckpt") / "edsr_tiny.pth")
    return save_pth(params, "edsr", path)


def _flags(data, pth, *extra):
    return ["--model", "edsr", "--scales", "4", "--dataloader", "basic_loader",
            "--data_input_path", data[0], "--data_truth_path", data[1],
            "--restore_path", pth, *extra, *TINY]


def _per_image(path):
    with open(path) as f:
        return json.load(f)["scales"]["4"]["per_image"]


@pytest.mark.parametrize("wino", [0, 2, 4])
def test_validate_matches_jax_validate(wino, even_data, odd_data, pth, tmp_path, monkeypatch,
                                       capsys):
    data = odd_data if wino == 0 else even_data
    extra = ["--wino_trunk", str(wino)]
    got = validate.main(_flags(data, pth, "--device", "cpu", "--report_json",
                               str(tmp_path / "port.json"), *extra))
    if wino:
        monkeypatch.setenv("LVT_WINO_INTERPRET", "1")
        assert "fused Winograd F(%d,3)" % wino in capsys.readouterr().out
    else:
        extra += ["--collapsed_tail", "0"]
    want = jax_validate.main(_flags(data, pth, "--report_json", str(tmp_path / "jax.json"),
                                    *extra))
    port, ref = _per_image(tmp_path / "port.json"), _per_image(tmp_path / "jax.json")
    assert sorted(port) == sorted(ref) == io.list_pngs(data[1])
    deltas = {k: abs(port[k] - ref[k]) for k in ref}
    print("parity validate --wino_trunk %d: |dPSNR| %s dB (PSNRs %s)"
          % (wino, {k: "%.2e" % v for k, v in deltas.items()},
             {k: "%.3f" % v for k, v in port.items()}))
    assert max(deltas.values()) <= PSNR_TOL
    assert abs(got[4] - want[4]) <= PSNR_TOL
    # the clamp hides nothing: a range-fitted model scores well above the
    # ~6 dB of an all-zero output
    assert min(port.values()) > 10.0


def test_validate_paths_agree_and_save_what_they_score(odd_data, pth, tmp_path):
    """Pipelined uint8 pull, serial uint8 pull and serial f32 pull give the
    same PSNRs; --save_path writes the frames upscale_uint8 gives."""
    runs = []
    for extra in (["--pipeline_depth", "2"], ["--pipeline_depth", "1"],
                  ["--device_uint8", "0"]):
        report = str(tmp_path / ("r%d.json" % len(runs)))
        validate.main(_flags(odd_data, pth, "--device", "cpu", "--report_json", report,
                             "--save_path", str(tmp_path / "sr"), *extra))
        runs.append(_per_image(report))
    assert runs[0] == runs[1] == runs[2] and len(runs[0]) == 2
    model = get_model("edsr")
    model.parse_args(list(TINY))
    model.prepare([4], device="cpu")
    model.restore(pth)
    model.set_route(make_collapsed_edsr_forward(model))  # the CLI's default route
    for name in io.list_pngs(odd_data[0]):
        lr = io.load_image_u8(os.path.join(odd_data[0], name + ".png")).transpose(2, 0, 1)
        saved = io.load_image_u8(str(tmp_path / "sr" / "x4" / (name + ".png")))
        np.testing.assert_array_equal(saved.transpose(2, 0, 1), model.upscale_uint8([lr], 4)[0])


def test_wino_trunk_3_is_refused(even_data, pth):
    with pytest.raises(SystemExit, match="wino_trunk"):
        validate.main(_flags(even_data, pth, "--device", "cpu", "--wino_trunk", "3"))


def test_odd_width_under_wino_raises_as_jax(odd_data, pth, monkeypatch):
    with pytest.raises(ValueError, match="even width"):
        validate.main(_flags(odd_data, pth, "--device", "cpu", "--wino_trunk", "2"))
    monkeypatch.setenv("LVT_WINO_INTERPRET", "1")
    with pytest.raises(ValueError, match="even width"):
        jax_validate.main(_flags(odd_data, pth, "--wino_trunk", "2"))


def test_wino_trunk_refuses_larvanet(capsys, monkeypatch):
    """The fused kernel is built for 64 channels: under --wino_trunk a
    48-channel LarvaNet keeps its ResBlocks on the direct convs with JAX's
    notice (larvanet_tpu/cli/common.py:420-424), and gives the default
    route's output."""
    from larvanet_tpu_torch.cli import common
    from larvanet_tpu_torch.ops import wino_resblock

    model = get_model("LarvaNet")
    model.parse_args(list(LARVA_TINY))
    model.prepare([4], device="cpu")
    x = torch.from_numpy(np.random.default_rng(4).uniform(0, 255, (1, 6, 8, 3))
                         .astype(np.float32))
    want = model.fwd_runtime(x)
    args = validate.build_parser().parse_known_args(["--model", "LarvaNet", "--wino_trunk",
                                                     "2"])[0]
    common.maybe_wino_trunk(model, args)
    assert "'LarvaNet' trunk is 48 channels" in capsys.readouterr().out
    monkeypatch.setattr(wino_resblock, "wino_resblock_transformed",
                        lambda *a, **k: pytest.fail("fused ResBlock on a 48-channel trunk"))
    assert torch.equal(model.fwd_runtime(x), want)


LARVA_TINY = ["--num_modules", "2", "--num_blocks", "1,1"]


def _louder(tree, rng):
    """Every kernel x2, every bias from N(0, 1): the trunk then moves the
    output by tens of levels over its interpolated base (as drawn, by less
    than one, and PSNR would score the base alone)."""
    if "kernel" in tree:
        return {"kernel": (2.0 * tree["kernel"]).astype(np.float32),
                "bias": rng.normal(0.0, 1.0, tree["bias"].shape).astype(np.float32)}
    return {k: _louder(v, rng) for k, v in tree.items()}


@pytest.fixture(scope="module")
def larva_ckpts(tmp_path_factory):
    """{name: (port .pth, JAX checkpoint)} of tiny LarvaNet and LarvaNet_w64
    x4 models with louder weights. LarvaNet's .pth is written by the JAX
    package's save_pth and read by both; the JAX package has no .pth rules
    for LarvaNet_w64, so JAX reads its own msgpack checkpoint of the same
    parameters and the port a .pth of the port's export."""
    import jax
    import jax.numpy as jnp

    out = {}
    for name in ("LarvaNet", "LarvaNet_w64"):
        root = tmp_path_factory.mktemp(name)
        jm = jax_get_model(name)
        jm.parse_args(list(LARVA_TINY))
        jm.prepare(is_training=False, scales=[4])
        params = _louder(_to_numpy(jm.params), np.random.default_rng(2))
        if name == "LarvaNet":
            path = save_pth(params, name, str(root / "larvanet.pth"))
            out[name] = (path, path)
            continue
        port = str(root / "larvanet_w64.pth")
        torch.save(state_dict_from_jax_params(params, name), port)
        jm.params = jax.tree_util.tree_map(jnp.asarray, params)
        out[name] = (port, jm.save(str(root)))
    return out


@pytest.mark.parametrize("name,wino", [("LarvaNet", 0), ("LarvaNet_w64", 0),
                                       ("LarvaNet_w64", 2)])
def test_validate_larvanet_matches_jax_validate(name, wino, even_data, larva_ckpts, tmp_path,
                                                monkeypatch):
    """Per-image PSNR of the port's validate within PSNR_TOL of JAX's, on
    its default route (JAX's packed trunk) and, for the 64-channel trunk,
    with every body ResBlock in the fused kernel (JAX's Pallas kernels in
    the interpreter)."""
    port_pth, jax_ckpt = larva_ckpts[name]

    def flags(ckpt, report):
        return ["--model", name, "--scales", "4", "--dataloader", "basic_loader",
                "--data_input_path", even_data[0], "--data_truth_path", even_data[1],
                "--restore_path", ckpt, "--report_json", str(tmp_path / report),
                "--wino_trunk", str(wino), *LARVA_TINY]

    validate.main(flags(port_pth, "port.json") + ["--device", "cpu"])
    if wino:
        monkeypatch.setenv("LVT_WINO_INTERPRET", "1")
    jax_validate.main(flags(jax_ckpt, "jax.json"))
    port, ref = _per_image(tmp_path / "port.json"), _per_image(tmp_path / "jax.json")
    assert sorted(port) == sorted(ref) == io.list_pngs(even_data[1])
    deltas = {k: abs(port[k] - ref[k]) for k in ref}
    print("parity validate %s --wino_trunk %d: |dPSNR| %s dB (PSNRs %s)"
          % (name, wino, {k: "%.2e" % v for k, v in deltas.items()},
             {k: "%.3f" % v for k, v in port.items()}))
    assert max(deltas.values()) <= PSNR_TOL


@pytest.mark.parametrize("cli,flag", [(validate, f) for f in validate.REFUSED]
                         + [(runtime, f) for f in runtime.REFUSED]
                         + [(get_sr, f) for f in get_sr.REFUSED])
def test_unported_flags_exit_nonzero(cli, flag, even_data, pth, tmp_path):
    argv = {validate: _flags(even_data, pth, "--device", "cpu"),
            runtime: ["--device", "cpu", "--input_height", "8", "--input_width", "8", *TINY],
            get_sr: ["--device", "cpu", "--input_path", even_data[0], "--output_path",
                     str(tmp_path), "--restore_path", pth, *TINY]}[cli]
    with pytest.raises(SystemExit, match="ROADMAP") as exc:
        cli.main(argv + ["--%s=1" % flag])
    assert exc.value.code not in (0, None)


@pytest.mark.parametrize("extra,message", [
    (["--chop_forward"], "--chop_forward does not apply"),
    (["--self_ensemble"], "--self_ensemble does not apply"),
    (["--int8_trunk", "1"], "--int8_trunk does not apply"),
    (["--ema", "1"], "--ema does not apply"),
    (["--serving_dtype", "bf16"], "--serving_dtype does not apply"),
    (["--restore_path", "m.pth"], "not both"),
])
def test_artifact_conflicts_exit_nonzero(extra, message, even_data):
    """validate --artifact refuses JAX's conflicting flags
    (larvanet_tpu/cli/validate.py:109-121) before it reads the artifact."""
    argv = ["--device", "cpu", "--data_input_path", even_data[0], "--data_truth_path",
            even_data[1], "--artifact", "missing.lvt"]
    with pytest.raises(SystemExit, match=message) as exc:
        validate.main(argv + extra)
    assert exc.value.code not in (0, None)


def test_tpu_layout_flags_are_accepted_and_ignored(even_data, pth, tmp_path, capsys):
    validate.main(_flags(even_data, pth, "--device", "cpu", "--collapsed_tail", "1",
                         "--packed_trunk", "0"))
    assert "ignored here" in capsys.readouterr().out


def test_no_cuda_without_device_cpu_exits_nonzero(even_data, pth, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for main, argv in ((validate.main, _flags(even_data, pth)),
                       (runtime.main, ["--input_height", "8", "--input_width", "8", *TINY])):
        with pytest.raises(SystemExit) as exc:
            main(argv)
        assert exc.value.code not in (0, None)


@pytest.mark.parametrize("wino", [0, 2, 4])
def test_runtime_on_cpu(wino, even_data, pth, capsys):
    fixed = runtime.main(["--device", "cpu", "--input_height", "12", "--input_width", "10",
                          "--num_warmup", "1", "--num_iters", "2", "--wino_trunk", str(wino),
                          *TINY])
    from_loader = runtime.main(["--device", "cpu", "--dataloader", "basic_loader",
                                "--data_input_path", even_data[0], "--data_truth_path",
                                even_data[1], "--restore_path", pth, "--num_warmup", "1",
                                "--num_iters", "1", "--wino_trunk", str(wino), *TINY])
    for mean_s, mps in (fixed, from_loader):
        assert mean_s > 0 and mps > 0
    assert "LR megapixels/sec" in capsys.readouterr().out


def test_get_sr_on_cpu_matches_jax_get_sr(even_data, pth, tmp_path):
    """Every written frame equals the port model's upscale_uint8 on the
    CLI's default route (the collapsed tail) and lies within 1 uint8 level
    of the JAX CLI's frame (JAX's default path runs its collapsed tail, the
    same function probed and summed in another order)."""
    port_dir, jax_dir = str(tmp_path / "port"), str(tmp_path / "jax")
    get_sr.main(["--device", "cpu", "--input_path", even_data[0], "--output_path", port_dir,
                 "--restore_path", pth, *TINY])
    jax_get_sr.main(["--input_path", even_data[0], "--output_path", jax_dir,
                     "--restore_path", pth, *TINY])
    model = get_model("edsr")
    model.parse_args(list(TINY))
    model.prepare([4], device="cpu")
    model.restore(pth)
    model.set_route(make_collapsed_edsr_forward(model))
    names = io.list_pngs(even_data[0])
    assert io.list_pngs(port_dir) == io.list_pngs(jax_dir) == names
    for name in names:
        got = io.load_image_u8(os.path.join(port_dir, name + ".png"))
        lr = io.load_image_u8(os.path.join(even_data[0], name + ".png")).transpose(2, 0, 1)
        np.testing.assert_array_equal(got.transpose(2, 0, 1), model.upscale_uint8([lr], 4)[0])
        ref = io.load_image_u8(os.path.join(jax_dir, name + ".png"))
        levels = int(np.abs(got.astype(np.int16) - ref.astype(np.int16)).max())
        print("parity get_sr %s vs JAX: max %d uint8 level(s)" % (name, levels))
        assert levels <= 1
