"""The port's psnr, psnr_trend, validate_interpol and train_squid CLIs
(larvanet_tpu_torch/cli/) against the JAX package's `main`s on the same PNG
trees and checkpoints, on the CPU: psnr's per-image Y-PSNR and SSIM over two
SR trees (a file found by its stem, one missing); psnr_trend's sweep of JAX
`.ckpt` files of a tiny MAMNet, serial and dispatched ahead, and the same
sweep over the port's `model_<step>.pth` files; validate_interpol's PSNRs
for each method at x2 and x4; train_squid's error.

The PSNRs are held equal to PSNR_DB, where the two sides' uint8 frames are
the same; validate_interpol's frames may differ at a rounding tie (see
FLIP_SHARE), and are then held level for level.
"""

import os

import numpy as np
import pytest
import torch
from flax import serialization

from larvanet_tpu.cli import psnr as jax_psnr
from larvanet_tpu.cli import psnr_trend as jax_psnr_trend
from larvanet_tpu.cli import train_squid as jax_train_squid
from larvanet_tpu.cli import validate_interpol as jax_validate_interpol
from larvanet_tpu.utils import torch_convert as jax_convert
from larvanet_tpu_torch.cli import psnr, psnr_trend, train_squid, validate_interpol
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.data import io
from larvanet_tpu_torch.utils.torch_convert import state_dict_from_jax_params

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

PSNR_DB = 1e-6
SSIM_TOL = 1e-9
MAMNET = ["--model", "mamnet", "--mamnet_conv_features", "16", "--mamnet_res_blocks", "1"]
# validate_interpol: the JAX package's resampler (ops/resize.py, a phase-wise
# sum of edge-padded slices) is within 2 f32 steps of F.interpolate, which the
# port and the reference run; a value that lands that close to a half rounds
# to the neighbouring level. Such frames are held level for level instead.
FLIP_SHARE = 1e-3
FLIP_PSNR_DB = 1e-3


def _photo(rng, h, w):
    """A smooth frame with noise (so that interpolation and SR are scored on
    more than noise), CHW uint8."""
    yy, xx = np.mgrid[0:h, 0:w]
    base = np.stack([128 + 90 * np.sin(xx / 5.0 + c) * np.cos(yy / 7.0 - c) for c in range(3)])
    return np.clip(base + rng.normal(0, 12, base.shape), 0, 255).astype(np.uint8)


def _div2k(root, rng, n, scales, lr_hw=(10, 12)):
    """A DIV2K-layout val set: HR/<i>.png and LR/X<s>/<i>x<s>.png (box-filtered)."""
    h, w = lr_hw
    for i in range(n):
        hr = _photo(rng, 4 * h, 4 * w)
        io.save_image_chw(hr, os.path.join(root, "HR", "%04d.png" % i))
        for s in scales:
            lr = hr[:, :4 * h // s * s, :4 * w // s * s].reshape(
                3, 4 * h // s, s, 4 * w // s, s).mean((2, 4))
            io.save_image_chw(np.round(lr).astype(np.uint8),
                              os.path.join(root, "LR", "X%d" % s, "%04dx%d.png" % (i, s)))
    return ["--data_input_path", os.path.join(root, "LR"),
            "--data_truth_path", os.path.join(root, "HR")]


def test_psnr_matches_jax(tmp_path):
    """Two SR trees against one HR tree: the second model's files carry a
    suffix (found by their stem) and miss one frame; every Y-PSNR and SSIM
    equal to JAX's, the same images scored."""
    rng = np.random.default_rng(1)
    hr_dir, a_dir, b_dir = (str(tmp_path / d) for d in ("HR", "a", "b"))
    for i in range(3):
        hr = _photo(rng, 40, 44)
        io.save_image_chw(hr, os.path.join(hr_dir, "%04d.png" % i))
        noisy = np.clip(hr + rng.normal(0, 6, hr.shape), 0, 255).astype(np.uint8)
        io.save_image_chw(noisy[:, :36], os.path.join(a_dir, "%04d.png" % i))  # truth cropped
        if i != 1:
            io.save_image_chw(np.roll(hr, 1, axis=2), os.path.join(b_dir, "%04d_x4_SR.png" % i))
    argv = ["--sr_paths", a_dir + "," + b_dir, "--truth_path", hr_dir]
    want = jax_psnr.main(argv)
    got = psnr.main(argv)
    assert sorted(got) == sorted(want) == ["a", "b"]
    for model in got:
        assert sorted(got[model]) == sorted(want[model])
        for img, (p, s) in got[model].items():
            wp, ws = want[model][img]
            print("psnr %s %s: port %.6f / %.8f, JAX %.6f / %.8f" % (model, img, p, s, wp, ws))
            assert abs(p - wp) <= PSNR_DB and abs(s - ws) <= SSIM_TOL
    assert len(got["b"]) == 2


@pytest.fixture(scope="module")
def trend_set(tmp_path_factory):
    """A val set, and two directories of the same two MAMNet checkpoints: JAX
    `.ckpt` files (steps 20 and 100, written with flax's msgpack as JAX's
    save writes them) and the port's `model_<step>.pth`."""
    root = tmp_path_factory.mktemp("trend")
    data = _div2k(str(root), np.random.default_rng(2), 2, (4,))
    ckpt_dir, pth_dir = str(root / "ckpt"), str(root / "pth")
    os.makedirs(ckpt_dir)
    os.makedirs(pth_dir)
    for step, seed in ((100, 1), (20, 2)):
        pm = get_model("mamnet")
        pm.parse_args(MAMNET[2:])
        pm.prepare([4], device="cpu", seed=seed)
        with torch.no_grad():  # frames around mid-grey
            pm.module.final_conv.bias.add_(torch.tensor([242.4, 239.5, 231.0]))
        state = {k: v.numpy() for k, v in pm.module.state_dict().items()}
        params = jax_convert.convert_state_dict(state, "mamnet")[0]
        with open(os.path.join(ckpt_dir, "model_%d.ckpt" % step), "wb") as f:
            f.write(serialization.msgpack_serialize(
                {"params": params, "global_step": step, "total_volume": 0.0}))
        pm.load_state_dict(state_dict_from_jax_params(params, "mamnet"))
        pm.global_step = step
        pm.save(pth_dir)
    return data, ckpt_dir, pth_dir


@pytest.mark.parametrize("depth", [1, 2])
def test_psnr_trend_matches_jax(depth, trend_set):
    """The sweep of the `.ckpt` files, ordered by step, against JAX's
    psnr_trend; the same sweep over the port's `.pth` files gives the same
    PSNRs."""
    data, ckpt_dir, pth_dir = trend_set
    argv = MAMNET + ["--scales", "4", "--pipeline_depth", str(depth)] + data
    want = jax_psnr_trend.main(argv + ["--restore_dir", ckpt_dir, "--data_native", "0"])
    got = psnr_trend.main(argv + ["--restore_dir", ckpt_dir, "--device", "cpu"])
    pths = psnr_trend.main(argv + ["--restore_dir", pth_dir, "--device", "cpu"])
    print("psnr_trend depth %d: port %s, JAX %s, the .pth sweep %s" % (depth, got, want, pths))
    assert [n for n, _ in got] == [n for n, _ in want] == ["model_20.ckpt", "model_100.ckpt"]
    assert [n for n, _ in pths] == ["model_20.pth", "model_100.pth"]
    for (_, p), (_, w), (_, q) in zip(got, want, pths):
        assert abs(p - w) <= PSNR_DB and p == q
    assert got[0][1] != got[1][1]


@pytest.mark.parametrize("method", ["bilinear", "bicubic", "nearest"])
def test_validate_interpol_matches_jax(method, tmp_path):
    """Each interpolation method at x2 and x4: every frame's PSNR equal to
    JAX's validate_interpol's where the two uint8 frames are equal; where
    they are not, they differ by one level on at most FLIP_SHARE of the
    values and the PSNRs by at most FLIP_PSNR_DB."""
    import jax.numpy as jnp

    from larvanet_tpu.ops.resize import upsample
    from larvanet_tpu_torch.core.registry import get_loader
    from larvanet_tpu_torch.eval import metrics
    from larvanet_tpu_torch.models.layers import interpolated_base

    data = _div2k(str(tmp_path), np.random.default_rng(3), 2, (2, 4))
    argv = ["--scales", "2,4", "--interpolate", method] + data
    want = jax_validate_interpol.main(argv + ["--data_native", "0"])
    got = validate_interpol.main(argv + ["--device", "cpu"])
    loader = get_loader("div2k_val_loader")
    loader.parse_args(list(data))
    loader.prepare([2, 4])
    assert sorted(got) == sorted(want) == [2, 4]
    for scale in got:
        assert sorted(got[scale]["per_image"]) == sorted(want[scale]["per_image"])
        for idx in range(loader.get_num_images()):
            inp, _, name = loader.get_image_pair(image_index=idx, scale=scale)
            ours = metrics.image_to_uint8(interpolated_base(
                torch.from_numpy(inp.transpose(1, 2, 0).copy())[None], scale, method)[0]
                .numpy().transpose(2, 0, 1)).astype(np.int16)
            theirs = metrics.image_to_uint8(np.asarray(
                upsample(jnp.asarray(inp), scale, method, axes=(-2, -1)))).astype(np.int16)
            flips = int((ours != theirs).sum())
            p, w = got[scale]["per_image"][name], want[scale]["per_image"][name]
            print("validate_interpol %s x%d %s: port %.6f, JAX %.6f dB; %d of %d values a "
                  "level apart" % (method, scale, name, p, w, flips, ours.size))
            assert int(np.abs(ours - theirs).max()) <= 1 and flips <= FLIP_SHARE * ours.size
            assert abs(p - w) <= (PSNR_DB if flips == 0 else FLIP_PSNR_DB)


def test_train_squid_raises_jax_error(tmp_path):
    """No model defines train_step_squid: the JAX package's AttributeError,
    word for word, before any step."""
    data = _div2k(str(tmp_path / "set"), np.random.default_rng(4), 1, (4,))
    argv = ["--train_path", str(tmp_path / "run"), "--max_steps", "1",
            "--val_data_input_path", data[1], "--val_data_truth_path", data[3],
            "--data_cached", "--num_blocks", "1,1"] + data
    with pytest.raises(AttributeError) as jax_err:
        jax_train_squid.main(argv + ["--data_native", "0"])
    with pytest.raises(AttributeError) as port_err:
        train_squid.main(argv + ["--device", "cpu"])
    assert str(port_err.value) == str(jax_err.value)
    assert "does not define train_step_squid" in str(port_err.value)
