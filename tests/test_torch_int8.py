"""The port's W8A8 int8 path (larvanet_tpu_torch/ops/pairs.py,
ops/int8_forward.py, the conv3x3_s8 kernel's plain version, the CLIs'
--int8_trunk) against the JAX package's (larvanet_tpu/ops/packed/pairs.py
make_pair_runner, make_int8_edsr_forward, make_int8_larvanet_forward), on
the CPU, at tiny widths.

The integer sums are exact in any order, so given JAX's quantized records
(carried across by `load_jax_records`) the port's pair equals JAX's
`pair_int8` bit for bit, in f32 and bf16. The forwards calibrate on their
own (the exact convs sum in another order, so a few codes may flip) and
are held by PSNR. Inputs come from numpy seeds.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.ops.packed import pairs as jpairs
from larvanet_tpu.ops.packed.core import grid1_mask, pack_w, unpack_w
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.models.layers import Conv3x3
from larvanet_tpu_torch.ops import conv3x3_s8 as s8
from larvanet_tpu_torch.ops import pairs
from larvanet_tpu_torch.utils.torch_convert import state_dict_from_jax_params

DTYPES = {"f32": (torch.float32, jnp.float32), "bf16": (torch.bfloat16, jnp.bfloat16)}


def _to_numpy(tree):
    if hasattr(tree, "items"):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.array(tree)


def _closure(fn, name):
    return fn.__closure__[fn.__code__.co_freevars.index(name)].cell_contents


def _convs(rng, c, f):
    """Two Conv3x3 modules (c -> c relu, c -> f) with random weights, and
    their JAX parameter dicts (HWIO kernels)."""
    g = torch.Generator().manual_seed(int(rng.integers(1 << 30)))
    conv1 = Conv3x3(c, c, act="relu", generator=g)
    conv2 = Conv3x3(c, f, generator=g)
    with torch.no_grad():
        for conv in (conv1, conv2):
            conv.bias.copy_(torch.from_numpy(rng.standard_normal(conv.bias.shape[0])
                                             .astype(np.float32)))
    p = [{"kernel": conv.weight.detach().permute(2, 3, 1, 0).numpy(),
          "bias": conv.bias.detach().numpy()} for conv in (conv1, conv2)]
    return conv1, conv2, p[0], p[1]


@pytest.mark.parametrize("c,f", [(16, 16), (8, 16), (48, 48)])
def test_weight_quantization_equals_jax_packed(c, f):
    """JAX takes each channel's scale over the width-packed kernel; both
    column offsets of a packed column hold every original tap of the
    channel, so the scales and codes are those of the HWIO kernel."""
    rng = np.random.default_rng(c + f)
    conv1, conv2, p1, p2 = _convs(rng, c, f)
    want = jpairs._quantize_pair_weights(p1, p2, jnp.float32)
    got = pairs.quantize_pair_weights(conv1, conv2, torch.float32)
    from larvanet_tpu_torch.utils.torch_convert import unpack_jax_pair_record
    unpacked = unpack_jax_pair_record(dict({k: np.asarray(v) for k, v in want.items()},
                                           s_in=1.0, s_mid=1.0))
    for k in ("ka", "kb", "sa", "sb"):
        assert unpacked[k].dtype == got[k].dtype and np.array_equal(unpacked[k], got[k]), k
    for k in ("ba", "bb"):
        assert np.array_equal(unpacked[k], got[k].numpy()), k


def _jax_runner(p1, p2, hin_nhwc, jdt, kind, act_rw):
    """JAX's make_pair_runner on one pair: calibration on `hin_nhwc`, then
    (the records, the packed int8 pair's output unpacked, the maxima)."""
    pair_cal, pair_int8, finish = jpairs.make_pair_runner(jdt)
    h = pack_w(jnp.asarray(hin_nhwc, jdt))
    mask1 = grid1_mask(h.shape[2] + 1, hin_nhwc.shape[3], jdt)
    pair_cal(0, h, p1, p2, mask1, kind=kind, res_weight=act_rw)
    finish([(p1, p2)])
    out = pair_int8(0, h, p1, p2, mask1, kind=kind, res_weight=act_rw)
    record = _closure(pair_cal, "record")
    quant = [{k: (np.asarray(v) if not isinstance(v, float) else v) for k, v in q.items()}
             for q in _closure(pair_int8, "quant")]
    if kind == "both":
        out = tuple(np.asarray(unpack_w(o)) for o in out)
    else:
        out = np.asarray(unpack_w(out))
    return quant, out, record[0]


def _differing(got, want) -> int:
    """The number of values whose bits differ: both as f32 (a bf16 value
    widens exactly, its sign and every bit kept)."""
    g = got.float().numpy().view(np.uint32)
    w = np.asarray(want, np.float32).view(np.uint32)
    assert g.shape == w.shape
    return int((g != w).sum())


@pytest.mark.parametrize("dname", ["f32", "bf16"])
@pytest.mark.parametrize("kind,res_weight,c,f", [
    ("res", 1.0, 16, 16), ("res", 0.1, 16, 16), ("none", 1.0, 16, 8), ("both", 1.0, 8, 8),
    ("both", 0.1, 16, 16),
])
def test_pair_equals_jax_pair_int8_bit_for_bit(kind, res_weight, c, f, dname):
    """The port's int8 pair (the s8 kernel's plain version) against JAX's
    pair_int8 with JAX's records carried across: every output bit equal.
    JAX's kind 'both' returns (t, hin + t): the port's 'none' pair and the
    skip add in the dtype (no port family walks a 'both' pair yet)."""
    tdt, jdt = DTYPES[dname]
    rng = np.random.default_rng(len(kind) + c + f + int(res_weight * 10))
    if kind != "none":
        f = c
    conv1, conv2, p1, p2 = _convs(rng, c, f)
    hin = (rng.standard_normal((2, 7, 10, c)) * 4).astype(np.float32)
    quant, want, _ = _jax_runner(p1, p2, hin, jdt, kind, res_weight)
    q = pairs.load_jax_records(quant, tdt, "cpu")[0]
    x = torch.from_numpy(hin).to(tdt)
    if kind == "both":
        t = pairs.int8_pair(q, x, "none", res_weight)
        got = (t, x + t)
    else:
        got, want = (pairs.int8_pair(q, x, kind, res_weight),), (want,)
    for g, w in zip(got, want):
        differ = _differing(g, w)
        print("pair %s %s rw %s %d->%d: %d of %d values differ"
              % (dname, kind, res_weight, c, f, differ, w.size))
        assert differ == 0


@pytest.mark.parametrize("c", [16, 48])
def test_calibration_maxima_match_jax(c):
    """The calibrating pair's maxima (max|hin|, max|relu(conv_a)|) within
    1e-6 relative of JAX's, in f32."""
    rng = np.random.default_rng(c)
    conv1, conv2, p1, p2 = _convs(rng, c, c)
    hin = (rng.standard_normal((2, 9, 12, c)) * 3).astype(np.float32)
    _, _, (m_in, m_mid) = _jax_runner(p1, p2, hin, jnp.float32, "res", 1.0)
    runner = pairs.PairRunner(torch.float32)
    with torch.no_grad():
        runner.calib(0, torch.from_numpy(hin), conv1, conv2)
    got_in, got_mid = (float(v) for v in runner.record[0])
    assert abs(got_in - float(m_in)) <= 1e-6 * float(m_in)
    assert abs(got_mid - float(m_mid)) <= 1e-6 * float(m_mid)
    with pytest.raises(ValueError, match="calibrated twice"):
        runner.calib(0, torch.from_numpy(hin), conv1, conv2)
    with pytest.raises(ValueError, match="finish"):
        runner.finish([(conv1, conv2), (conv1, conv2)])


def test_even_calib_refuses_odd_width():
    with pytest.raises(ValueError, match="even width"):
        pairs.even_calib(np.zeros((1, 4, 5, 3), np.float32), "cpu")


# ---- the forwards ----

EDSR_FLAGS = ("--edsr_res_blocks", "4", "--edsr_conv_features", "16")
LARVA_BLOCKS = ("--num_blocks", "1,2")
LARVA_PRESETS = {
    "LarvaNet": (), "LarvaNet_skip": (), "LarvaNet_1c": (), "LarvaNet_0c": (),
    "LarvaLeg": ("--leg", "1"), "LarvaLeg_leg0": ("--leg", "0"), "LarvaNetV2": (),
}
FWD_PSNR_DB = 80.0  # f32: the port's forward against JAX's int8 walk


def _psnr(a, b) -> float:
    mse = float(np.mean((np.asarray(a, np.float64) - np.asarray(b, np.float64)) ** 2))
    return float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def _louder(tree, rng):
    """The LarvaNet family's 0.1 init leaves the trunk under a level of the
    base: every kernel x2 and every bias from N(0, 1), as
    tests/test_torch_larvanet.py does, so the int8 trunk shows."""
    if "kernel" in tree:
        return {"kernel": (tree["kernel"] * 2.0).astype(np.float32),
                "bias": rng.normal(0.0, 1.0, tree["bias"].shape).astype(np.float32)}
    return {k: _louder(v, rng) for k, v in tree.items()}


@functools.lru_cache(maxsize=None)
def _models(name):
    """(JAX model, port model) with the same parameters, f32, on the CPU."""
    reg = "LarvaLeg" if name == "LarvaLeg_leg0" else name
    flags = (list(EDSR_FLAGS) if name == "edsr"
             else list(LARVA_BLOCKS) + list(LARVA_PRESETS[name]))
    jm = jax_get_model(reg)
    jm.parse_args(list(flags))
    jm.prepare(is_training=False, scales=[4])
    params = _to_numpy(jm.params)
    if name != "edsr":
        params = _louder(params, np.random.default_rng(1))
        from flax.core import freeze
        jm.params = freeze(jax.tree_util.tree_map(jnp.asarray, params)) \
            if not isinstance(jm.params, dict) else jax.tree_util.tree_map(jnp.asarray, params)
    pm = get_model(reg)
    pm.parse_args(list(flags))
    pm.prepare([4], device="cpu")
    pm.load_state_dict(state_dict_from_jax_params(params, reg))
    return jm, pm


def _lr(shape, seed):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


def _jax_int8(name, jm, calib):
    """JAX's int8 forward in f32: EDSR through the live plain tail
    (tests/test_qat.py:60-66), the LarvaNet family through
    make_int8_larvanet_forward."""
    if name == "edsr":
        from flax import serialization
        from larvanet_tpu.ops.packed.edsr import _edsr_walk
        sp0 = serialization.to_state_dict(jm.params)
        jp = [(sp0["res_block_%d" % i]["conv1"], sp0["res_block_%d" % i]["conv2"])
              for i in range(4)]
        return jpairs._make_int8(jm, calib, jnp.float32,
                                 _edsr_walk(jm, jnp.float32, "live_plain"), jp)
    from larvanet_tpu.ops.packed.larvanet import make_int8_larvanet_forward
    return make_int8_larvanet_forward(jm, calib, dtype=jnp.float32)


def _port_int8(name, pm, calib):
    from larvanet_tpu_torch.ops import int8_forward
    if name == "edsr":
        return int8_forward.make_int8_edsr_forward(pm, calib, torch.float32)
    return int8_forward.make_int8_larvanet_forward(pm, calib, torch.float32)


def _same_records_run(jfwd, fwd, jm, x):
    """The port's forward with JAX's records in its runner, and the input
    codes that differ between the two walks: each pair's input (captured on
    both sides) quantized with the same s_in."""
    jin, pin = {}, {}
    jwalk, jpair = _closure(jfwd, "walk"), _closure(jfwd, "pair_int8")

    def jcap(idx, hin, *a, **k):
        jin[idx] = np.array(unpack_w(hin))
        return jpair(idx, hin, *a, **k)

    jwalk(jm.params, jnp.asarray(x), jcap)
    runner = fwd.runner
    real = runner.int8

    def pcap(idx, hin, *a, **k):
        pin[idx] = hin
        return real(idx, hin, *a, **k)

    runner.int8 = pcap
    try:
        same = fwd(torch.from_numpy(x)).float().numpy()
    finally:
        del runner.int8
    flips = codes = 0
    for idx, q in enumerate(runner.quant):
        a = s8.quantize(pin[idx], q.s_in)
        b = s8.quantize(torch.from_numpy(jin[idx]), q.s_in)
        flips += int((a != b).sum())
        codes += a.numel()
    return same, flips, codes


@pytest.mark.parametrize("name", ["edsr"] + sorted(LARVA_PRESETS))
def test_int8_forward_matches_jax(name):
    """The port's int8 forward, calibrated on its own, against JAX's, f32:
    PSNR >= 80 dB. Then with JAX's records carried into the port's runner:
    the codes of every pair's input that flip (the exact convs sum in
    another order) are counted and printed."""
    jm, pm = _models(name)
    calib = _lr((2, 12, 14, 3), seed=5)
    x = _lr((1, 10, 12, 3), seed=6)
    jfwd = _jax_int8(name, jm, calib)
    want = np.asarray(jfwd(jm.params, jnp.asarray(x)))
    fwd = _port_int8(name, pm, calib)
    got = fwd(torch.from_numpy(x)).float().numpy()
    assert got.shape == want.shape
    psnr = _psnr(got, want)
    line = "int8 %s vs JAX: max|d| %.3g, PSNR %.1f dB" % (name, float(np.abs(got - want).max()),
                                                         psnr)
    if hasattr(fwd, "runner"):
        quant = [{k: (np.asarray(v) if not isinstance(v, float) else v) for k, v in q.items()}
                 for q in _closure(_closure(jfwd, "pair_int8"), "quant")]
        assert len(quant) == len(fwd.runner.quant)
        fwd.runner.quant[:] = pairs.load_jax_records(quant, torch.float32, "cpu")
        same, flips, codes = _same_records_run(jfwd, fwd, jm, x)
        line += ("; with JAX's records: max|d| %.3g, PSNR %.1f dB, %d of %d input codes "
                 "flipped" % (float(np.abs(same - want).max()), _psnr(same, want), flips, codes))
        assert _psnr(same, want) >= FWD_PSNR_DB
        exact = pm.fwd_runtime(torch.from_numpy(x)).numpy()
        line += "; int8 vs exact: PSNR %.1f dB" % _psnr(got, exact)
        assert float(np.abs(got - exact).max()) > 1e-3  # it does quantize
    print(line)
    assert psnr >= FWD_PSNR_DB
    with pytest.raises(ValueError, match="even width"):
        fwd(torch.from_numpy(_lr((1, 10, 11, 3), seed=7))) if hasattr(fwd, "runner") \
            else (_ for _ in ()).throw(ValueError("even width"))


# ---- the CLIs ----

CLI_TINY = ["--edsr_res_blocks", "2", "--edsr_conv_features", "8"]
CLI_PSNR_TOL = 0.01  # dB: JAX's EDSR serves the collapsed tail, the port the plain one


@pytest.fixture(scope="module")
def cli_data(tmp_path_factory):
    """A fixture set (an even-width and an odd-width frame) and a tiny EDSR
    .pth, written by the JAX package, whose final_conv is rescaled so that
    the output spans 0..255 (left as drawn, the clamp would hide errors)."""
    import os

    from larvanet_tpu.data import fixture
    from larvanet_tpu.utils.torch_convert import save_pth
    from larvanet_tpu_torch.data import io

    root = str(tmp_path_factory.mktemp("int8_cli"))
    fixture.generate(root, shapes=((24, 32, 2, 3), (22, 27, 1, 2)), scales=(4,), datasets=())
    lr_dir, hr_dir = os.path.join(root, "x4", "input"), os.path.join(root, "x4", "truth")
    jm = jax_get_model("edsr")
    jm.parse_args(list(CLI_TINY))
    jm.prepare(is_training=False, scales=[4])
    params = _to_numpy(jm.params)
    pm = get_model("edsr")
    pm.parse_args(list(CLI_TINY))
    pm.prepare([4], device="cpu")
    pm.load_state_dict(state_dict_from_jax_params(params, "edsr"))
    name = io.list_pngs(lr_dir)[0] + ".png"
    lr = io.load_image_chw(os.path.join(lr_dir, name))
    target = io.load_image_chw(os.path.join(hr_dir, name)).mean((1, 2))
    shift = pm.module.mean_inverse_shift.bias.numpy()
    f = pm.upscale([lr], 4) - shift[None, :, None, None]
    a = 40.0 / float(f.std())
    final = params["final_conv"]
    final["kernel"] = (final["kernel"] * a).astype(np.float32)
    final["bias"] = (a * (final["bias"] - f.mean((0, 2, 3))) + target - shift).astype(np.float32)
    pth = save_pth(params, "edsr", str(tmp_path_factory.mktemp("ckpt") / "edsr_tiny.pth"))
    return lr_dir, hr_dir, pth


def _validate_flags(data, *extra):
    return ["--model", "edsr", "--scales", "4", "--dataloader", "basic_loader",
            "--data_input_path", data[0], "--data_truth_path", data[1],
            "--restore_path", data[2], *extra, *CLI_TINY]


@pytest.fixture
def int8_calls(monkeypatch):
    """Counts the int8 pairs the port runs (pairs.int8_pair)."""
    calls = []
    real = pairs.int8_pair

    def counting(*a, **k):
        calls.append(a[1].shape)
        return real(*a, **k)

    monkeypatch.setattr(pairs, "int8_pair", counting)
    return calls


def test_validate_int8_report_matches_jax_validate(cli_data, tmp_path, int8_calls, capsys):
    """validate --int8_trunk 1 --int8_report: per-image PSNR and the
    int8-vs-exact deltas within 0.01 dB of JAX's validate with the same
    flags; the odd-width frame takes the exact route in both."""
    import json

    from larvanet_tpu.cli import validate as jax_validate
    from larvanet_tpu_torch.cli import validate

    flags = ["--int8_trunk", "1", "--int8_report", "--int8_max_drop", "100"]
    validate.main(_validate_flags(cli_data, "--device", "cpu", "--report_json",
                                  str(tmp_path / "port.json"), *flags))
    out = capsys.readouterr().out
    assert "int8 (W8A8) trunk enabled" in out and "int8-vs-exact: mean delta" in out
    assert "int8 OK" in out
    # 2 pairs, one even-width frame (the odd one takes the exact route)
    assert len(int8_calls) == 2 and all(s[2] % 2 == 0 for s in int8_calls)
    jax_validate.main(_validate_flags(cli_data, "--report_json", str(tmp_path / "jax.json"),
                                      *flags))
    port = json.load(open(tmp_path / "port.json"))["scales"]["4"]
    ref = json.load(open(tmp_path / "jax.json"))["scales"]["4"]
    for key in ("per_image", ):
        d = {k: abs(port[key][k] - ref[key][k]) for k in ref[key]}
        print("int8 validate vs JAX, PSNR |d| %s" % d)
        assert max(d.values()) <= CLI_PSNR_TOL
    d = {k: abs(port["int8_vs_exact"]["per_image_delta"][k]
                - ref["int8_vs_exact"]["per_image_delta"][k]) for k in ref["per_image"]}
    print("int8 validate vs JAX, int8-vs-exact delta |d| %s" % d)
    assert max(d.values()) <= CLI_PSNR_TOL


def test_validate_int8_report_refuses_past_max_drop(cli_data, tmp_path, capsys):
    """A mean int8-vs-exact delta below -max_drop exits with code 3; the
    report is written first. The threshold sits just above this model's
    mean delta, so the refusal is the gate's own arithmetic."""
    import json

    from larvanet_tpu_torch.cli import validate

    report = str(tmp_path / "r.json")
    validate.main(_validate_flags(cli_data, "--device", "cpu", "--int8_trunk", "1",
                                  "--int8_report", "--report_json", report))
    mean = json.load(open(report))["scales"]["4"]["int8_vs_exact"]["mean_delta_db"]
    with pytest.raises(SystemExit) as exc:
        validate.main(_validate_flags(cli_data, "--device", "cpu", "--int8_trunk", "1",
                                      "--int8_report", "--int8_max_drop",
                                      repr(-mean - 1e-3), "--report_json", report))
    assert exc.value.code == 3 and "int8 REFUSED" in capsys.readouterr().out
    if mean < 0:  # --int8_max_drop 0 refuses too where this model drops
        with pytest.raises(SystemExit) as exc:
            validate.main(_validate_flags(cli_data, "--device", "cpu", "--int8_trunk", "1",
                                          "--int8_report", "--int8_max_drop", "0"))
        assert exc.value.code == 3


def test_int8_report_without_int8_trunk_reports_nothing(cli_data, capsys):
    from larvanet_tpu_torch.cli import validate

    validate.main(_validate_flags(cli_data, "--device", "cpu", "--int8_report"))
    assert "int8 trunk is not active; nothing to report" in capsys.readouterr().out
    with pytest.raises(SystemExit, match="direct"):
        validate.main(_validate_flags(cli_data, "--device", "cpu", "--int8_trunk", "1",
                                      "--int8_report", "--chop_forward"))


def test_serve_int8_routes_even_frames_through_the_pairs(cli_data, int8_calls, capsys):
    """serve --int8_trunk 1: calibrated on --int8_calib_path's PNGs (or on
    noise with JAX's warning); an even frame runs the int8 pairs, an odd one
    the exact forward."""
    from larvanet_tpu_torch.cli import serve

    args = serve.build_parser().parse_known_args(
        ["--restore_path", cli_data[2], "--device", "cpu", "--int8_trunk", "1",
         "--int8_calib_path", cli_data[0], *CLI_TINY])
    service = serve.build_service(*args)
    assert "int8 (W8A8) trunk enabled" in capsys.readouterr().out
    rng = np.random.default_rng(3)
    even = rng.integers(0, 256, (3, 10, 12)).astype(np.uint8)
    odd = rng.integers(0, 256, (3, 10, 13)).astype(np.uint8)
    service.model.upscale_uint8([even], 4)
    assert len(int8_calls) == 2
    service.model.upscale_uint8([odd], 4)
    assert len(int8_calls) == 2
    args = serve.build_parser().parse_known_args(
        ["--restore_path", cli_data[2], "--device", "cpu", "--int8_trunk", "1", *CLI_TINY])
    serve.build_service(*args)
    assert "calibrates on noise" in capsys.readouterr().out


def test_get_sr_runtime_and_test_accept_int8_trunk(cli_data, tmp_path, int8_calls, capsys):
    """get_sr (calibrated on the first input PNG), runtime (on noise of its
    size) and test (on the first dataset's LR images) take --int8_trunk 1
    and run the int8 pairs."""
    import os

    from larvanet_tpu_torch.cli import get_sr, runtime
    from larvanet_tpu_torch.cli import test as port_test
    from larvanet_tpu_torch.data import io

    get_sr.main(["--device", "cpu", "--input_path", cli_data[0], "--output_path",
                 str(tmp_path / "sr"), "--restore_path", cli_data[2], "--int8_trunk", "1",
                 *CLI_TINY])
    assert len(int8_calls) == 2  # the even frame; the odd one is exact
    runtime.main(["--device", "cpu", "--input_height", "8", "--input_width", "10",
                  "--num_warmup", "1", "--num_iters", "1", "--int8_trunk", "1", *CLI_TINY])
    assert len(int8_calls) == 2 + 2 * 2
    lr_root, hr_root = tmp_path / "LR" / "SetA", tmp_path / "HR" / "SetA"
    rng = np.random.default_rng(4)
    for i in range(2):
        hr = rng.integers(0, 256, (3, 48, 64)).astype(np.uint8)
        io.save_image_chw(hr, os.path.join(str(hr_root), "im%d.png" % i))
        io.save_image_chw(hr[:, ::4, ::4], os.path.join(str(lr_root), "im%d.png" % i))
    port_test.main(["--device", "cpu", "--restore_path", cli_data[2], "--input_root_path",
                    str(tmp_path / "LR"), "--truth_root_path", str(tmp_path / "HR"),
                    "--output_root_path", str(tmp_path / "out"), "--datasets", "SetA",
                    "--int8_trunk", "1", *CLI_TINY])
    assert len(int8_calls) == 6 + 2 * 2
    assert capsys.readouterr().out.count("int8 (W8A8) trunk enabled") == 3


def test_int8_refusals(capsys):
    """LarvaNet_res has no int8 path: the maker raises, and the CLI prints
    JAX's ignoring line and keeps the exact route; --leg 4 over 2 modules
    is refused at prepare."""
    from types import SimpleNamespace

    from larvanet_tpu_torch.cli import common
    from larvanet_tpu_torch.ops import int8_forward

    m = get_model("LarvaNet_res")
    m.parse_args(["--num_blocks", "1,1"])
    m.prepare([4], device="cpu")
    calib = _lr((1, 8, 10, 3), seed=1)
    with pytest.raises(ValueError, match="plain-body"):
        int8_forward.make_int8_larvanet_forward(m, calib)
    common.maybe_int8_trunk(m, SimpleNamespace(int8_trunk=1, model="LarvaNet_res"),
                            lambda: calib)
    assert "--int8_trunk: int8 path supports plain-body configs; ignoring" in \
        capsys.readouterr().out
    assert m.route is None and not hasattr(m, "int8_exact_forward")
    leg = get_model("LarvaLeg")
    leg.parse_args(["--num_blocks", "1,1"])
    with pytest.raises(ValueError):
        leg.prepare([4], device="cpu")


def test_odd_calibration_width_is_cropped_and_odd_inputs_take_the_exact_route(int8_calls):
    from types import SimpleNamespace

    from larvanet_tpu_torch.cli import common

    jm, pm = _models("LarvaNet")
    common.maybe_int8_trunk(pm, SimpleNamespace(int8_trunk=1, model="LarvaNet"),
                            lambda: _lr((1, 8, 11, 3), seed=2))
    try:
        odd = _lr((1, 8, 9, 3), seed=3)
        got = pm.fwd_runtime(torch.from_numpy(odd))
        assert not int8_calls
        with torch.no_grad():
            want = pm.module(torch.from_numpy(odd))
        assert torch.equal(got, want)
        pm.fwd_runtime(torch.from_numpy(_lr((1, 8, 10, 3), seed=4)))
        assert len(int8_calls) == 4  # 3 body pairs + the leg
    finally:
        pm.set_route(None)
        del pm.int8_exact_forward
