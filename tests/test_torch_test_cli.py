"""The port's `test` CLI (the paper protocol, larvanet_tpu_torch/cli/test.py)
against the JAX package's on its realistic fixture, on the CPU, with a
tiny EDSR whose final_conv is rescaled so its output spans the pixel range;
both CLIs run with --collapsed_tail 0 (JAX's module graph). Split from
tests/test_torch_full_frame.py so that pytest-xdist's --dist loadfile
spreads the two files over two workers.
"""

import json
import os

import pytest
import torch

from larvanet_tpu.cli import test as jax_test
from larvanet_tpu.data import fixture
from larvanet_tpu_torch.cli import test as port_test
from larvanet_tpu_torch.data import io
from torch_edsr_fit import TINY, _fitted_pth

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

PSNR_TOL = 1e-3
SSIM_TOL = 1e-5


@pytest.fixture(scope="module")
def fixture_real(tmp_path_factory):
    """The JAX package's realistic fixture, data/fixture_real (generated from
    its seed, not committed), written here so that no other test's copy is
    read while it is being written."""
    root = str(tmp_path_factory.mktemp("fixture_real"))
    fixture.generate_realistic(root)
    return root


@pytest.fixture(scope="module")
def real_pth(fixture_real, tmp_path_factory):
    lr = os.path.join(fixture_real, "test_LR", "SynSetReal", "real000.png")
    hr = os.path.join(fixture_real, "test_HR", "SynSetReal", "real000.png")
    return _fitted_pth(str(tmp_path_factory.mktemp("real") / "edsr.pth"), lr, hr)


@pytest.fixture(scope="module")
def jax_test_report(fixture_real, real_pth, tmp_path_factory):
    out = tmp_path_factory.mktemp("jax_test")
    jax_test.main(["--restore_path", real_pth, "--input_root_path",
                   os.path.join(fixture_real, "test_LR"), "--truth_root_path",
                   os.path.join(fixture_real, "test_HR"), "--output_root_path", str(out),
                   "--datasets", "SynSetReal,DIV2K_val", "--collapsed_tail", "0",
                   "--report_json", str(out / "report.json"), *TINY])
    with open(out / "report.json") as f:
        return json.load(f)


@pytest.mark.parametrize("extra", [[], ["--chop_forward"], ["--pipeline_depth", "1"],
                                   ["--device_uint8", "0"]])
def test_test_cli_matches_jax_on_fixture_real(extra, fixture_real, real_pth, jax_test_report,
                                              tmp_path):
    """The paper protocol (Y-PSNR and SSIM, shaved; RGB for DIV2K_val) per
    image within PSNR_TOL / SSIM_TOL of JAX's test CLI, which takes
    --chop_forward and runs the whole frame: the chop's overlap (half 10)
    exceeds the tiny model's radius, so both score the same frames."""
    out = tmp_path / "sr"
    results = port_test.main(["--device", "cpu", "--restore_path", real_pth,
                              "--input_root_path", os.path.join(fixture_real, "test_LR"),
                              "--truth_root_path", os.path.join(fixture_real, "test_HR"),
                              "--output_root_path", str(out), "--datasets",
                              "SynSetReal,DIV2K_val", "--collapsed_tail", "0",
                              "--report_json", str(tmp_path / "r.json"), *extra, *TINY])
    with open(tmp_path / "r.json") as f:
        port = json.load(f)
    assert sorted(port) == sorted(jax_test_report) == ["DIV2K_val", "SynSetReal"]
    for dataset, ref in jax_test_report.items():
        assert sorted(port[dataset]["per_image"]) == sorted(ref["per_image"])
        assert len(ref["per_image"]) == 12
        dp = max(abs(port[dataset]["per_image"][k]["psnr"] - v["psnr"])
                 for k, v in ref["per_image"].items())
        ds = max(abs(port[dataset]["per_image"][k]["ssim"] - v["ssim"])
                 for k, v in ref["per_image"].items())
        print("parity test %s %s: max |dPSNR| %.2e dB, max |dSSIM| %.2e (mean PSNR %.3f)"
              % (" ".join(extra), dataset, dp, ds, port[dataset]["mean_psnr"]))
        assert dp <= PSNR_TOL and ds <= SSIM_TOL
        assert port[dataset]["mean_psnr"] > 10.0
    assert [r[0] for r in results] == ["SynSetReal", "DIV2K_val"]
    log = (out / "edsr" / "log.txt").read_text()
    assert "SynSetReal: 12 images are prepared" in log and "DIV2K_val, psnr=" in log
    assert io.list_pngs(str(out / "edsr" / "DIV2K_val")) == sorted(ref["per_image"])
    saved = io.load_image_u8(str(out / "edsr" / "SynSetReal" / "real000.png"))
    lr = io.load_image_u8(os.path.join(fixture_real, "test_LR", "SynSetReal", "real000.png"))
    assert saved.shape == (4 * lr.shape[0], 4 * lr.shape[1], 3)


# a model family the port does not have yet (msrr_test, refused here before
# its family was ported, now runs: tests/test_torch_msrr.py)
@pytest.mark.parametrize("argv,match", [
    (["--model", "TreeNet"], "ROADMAP"),
])
def test_test_cli_refusals(argv, match, real_pth, tmp_path):
    with pytest.raises(SystemExit, match=match) as exc:
        port_test.main(["--device", "cpu", "--restore_path", real_pth, "--output_root_path",
                        str(tmp_path), *argv, *TINY])
    assert exc.value.code not in (0, None)
