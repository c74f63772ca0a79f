"""The port's offline CLIs summarize and figures
(larvanet_tpu_torch/cli/summarize.py, cli/figures.py) against the JAX
package's (larvanet_tpu/cli/summarize.py, cli/figures.py), on the CPU.

summarize: the rows (name, kernel shape [in, out, kh, kw], NCHW output
shape, parameters, torchsummaryX's MACs) of JAX's `per_layer_table` for
the same configuration, its names carried to the port's (the reference's
state_dict stems) by the port's export rules (utils/torch_convert.py),
equal to the port's rows: in order for EDSR, whose names sort alike on
both sides, as the same rows for the other families (each side sorts its
own names); and the EDSR-baseline x4 totals that
tests/test_cli_integration.py:121-148 pins (1,517,571 parameters, the MAC
sum at 96x96). figures: every command's PNGs pixel for pixel equal to
JAX's `figures.main` on the same inputs.
"""

import functools
import os

import numpy as np
import pytest
import torch

from larvanet_tpu.cli import figures as jax_figures
from larvanet_tpu.cli import summarize as jax_summarize
from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.utils import torch_convert as jax_convert
from larvanet_tpu_torch.cli import figures, summarize
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.data import io
from larvanet_tpu_torch.utils.torch_convert import EXPORT_RULES

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

# name -> flags of a tiny configuration of each family summarized
FAMILIES = {
    "edsr": ("--edsr_conv_features", "8", "--edsr_res_blocks", "2"),
    "LarvaNet": ("--num_modules", "2", "--num_blocks", "1,1"),
    "mamnet": ("--mamnet_conv_features", "16", "--mamnet_res_blocks", "2"),
    "msrr_reduced": ("--num_features", "16", "--num_blocks", "2"),
}


@functools.lru_cache(maxsize=None)
def _models(name):
    """(JAX model, port model) on the port's init, crossed to JAX's
    parameters by the JAX package's converter (no flax init)."""
    pm = get_model(name)
    pm.parse_args(list(FAMILIES[name]))
    pm.prepare([4], device="cpu")
    state = {k: v.numpy() for k, v in pm.module.state_dict().items()}
    jm = jax_get_model(name)
    jm.parse_args(list(FAMILIES[name]))
    jm.params = jax_convert.convert_state_dict(state, name)[0]
    jm.scale, jm.scale_list, jm.is_training = 4, [4], False
    jm.module = jm.build_module()
    return jm, pm


def _port_name(model_name, jax_path):
    spec = EXPORT_RULES[model_name](jax_path)
    return spec[0] if isinstance(spec, tuple) else spec


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_summarize_rows_equal_jax_per_layer_table(name):
    jm, pm = _models(name)
    want = [(_port_name(name, r[0]),) + tuple(r[1:])
            for r in jax_summarize.per_layer_table(jm, 20, 24)]
    got = [(r[0], list(r[1]), r[2], r[3], r[4]) for r in summarize.per_layer_table(pm, 20, 24)]
    want = [(r[0], list(r[1]), list(r[2]) if r[2] is not None else None, int(r[3]), int(r[4]))
            for r in want]
    print("%s: %d rows, MACs %d" % (name, len(got), sum(r[4] for r in got)))
    if name == "edsr":
        assert got == want  # in order
    else:
        assert sorted(got, key=lambda r: r[0]) == sorted(want, key=lambda r: r[0])
    assert sum(r[3] for r in got) == pm.num_parameters()


def test_summarize_edsr_b_totals(capsys):
    """EDSR-baseline x4 at 96x96: 1,517,571 parameters and torchsummaryX's
    MAC sum, as tests/test_cli_integration.py:121-148 pins them for JAX; the
    FLOP line is FlopCounterMode's count of the plain forward's products."""
    n_params, flops, rows = summarize.main(["--device", "cpu", "--model", "edsr",
                                            "--input_width", "96", "--input_height", "96"])
    assert n_params == 1_517_571
    assert sum(r[3] for r in rows) == 1_517_571
    s = 96 * 96
    expected_macs = (3 * 64 * 9 * s + 16 * 2 * 64 * 64 * 9 * s + 64 * 64 * 9 * s
                     + 64 * 256 * 9 * s + 64 * 256 * 9 * (192 * 192)
                     + 64 * 3 * 9 * (384 * 384))
    assert sum(r[4] for r in rows) == expected_macs
    by_name = {r[0]: r for r in rows}
    assert by_name["first_conv"][1] == [3, 64, 3, 3]
    assert by_name["first_conv"][4] == 3 * 64 * 9 * s
    assert by_name["res_blocks.0.body.0"][3] == 36_928
    assert by_name["upsample.body.2"][2] == [1, 256, 192, 192]  # NCHW print
    assert by_name["final_conv"][4] == 64 * 3 * 9 * 384 * 384
    # the products of the plain forward: the convs' 2 MACs each, and the
    # mean shifts' 3 x 3 colour matmuls on the LR and HR frames
    assert flops == 2 * expected_macs + 2 * 9 * (s + 384 * 384)
    out = capsys.readouterr().out
    assert "===== total =====" in out and "- params: 1517571" in out
    assert "FlopCounterMode" in out


@pytest.fixture(scope="module")
def figure_inputs(tmp_path_factory):
    root = tmp_path_factory.mktemp("figures")
    rng = np.random.default_rng(0)
    for i, (h, w) in enumerate(((64, 80), (72, 60))):
        io.save_image_hwc(rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
                          str(root / "in" / ("%04d.png" % i)))
    return root


@pytest.mark.parametrize("command,extra", [
    ("crop_patch", []), ("crop_LR_patch", ["--scale", "2"]),
    ("draw_rect", ["--thickness", "3", "--color", "0,255,10"])])
def test_figures_equal_jax(figure_inputs, command, extra):
    argv = [command, "--input_path", str(figure_inputs / "in"), "--x", "8", "--y", "12",
            "--size", "32", *extra]
    figures.main(argv + ["--output_path", str(figure_inputs / ("port_" + command))])
    jax_figures.main(argv + ["--output_path", str(figure_inputs / ("jax_" + command))])
    names = io.list_pngs(str(figure_inputs / "in"))
    assert io.list_pngs(str(figure_inputs / ("port_" + command))) == names
    for name in names:
        got = io.load_image_u8(str(figure_inputs / ("port_" + command) / (name + ".png")))
        want = io.load_image_u8(str(figure_inputs / ("jax_" + command) / (name + ".png")))
        assert got.shape == want.shape
        np.testing.assert_array_equal(got, want)


def test_figures_single_file_and_helpers(tmp_path):
    img = np.arange(20 * 24 * 3, dtype=np.uint8).reshape(20, 24, 3)
    np.testing.assert_array_equal(figures.crop_patch(img, 3, 4, 5),
                                  jax_figures.crop_patch(img, 3, 4, 5))
    np.testing.assert_array_equal(figures.draw_rect(img, 2, 3, 10, (1, 2, 3), 2),
                                  jax_figures.draw_rect(img, 2, 3, 10, (1, 2, 3), 2))
    path = str(tmp_path / "one.png")
    io.save_image_hwc(img, path)
    figures.main(["crop_patch", "--input_path", path, "--output_path",
                  str(tmp_path / "out"), "--x", "0", "--y", "0", "--size", "8"])
    np.testing.assert_array_equal(io.load_image_u8(str(tmp_path / "out" / "one.png")),
                                  img[:8, :8])
    assert os.path.exists(str(tmp_path / "out" / "one.png"))
