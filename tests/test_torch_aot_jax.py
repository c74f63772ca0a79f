"""The port's serving artifacts (larvanet_tpu_torch/utils/aot.py) against
the JAX package's StableHLO artifacts (larvanet_tpu/utils/aot.py
`export_serving`, `save_artifact`, `load_artifact`) for the same weights,
on the CPU, one name of each family at a tiny size.

Each side exports its serving route, saves and loads the file, and runs
it on the same input: JAX its fast path (the width-packed trunk, with the
collapsed tail for EDSR and MAMNet), the port its CLIs' route (the
collapsed tail for EDSR and MAMNet, the module graph for the others: the
packed trunk is an exact rewrite of it). The bars are those the existing
tests hold each route to: the collapsed tail's 0.1 (independent probes,
tests/test_torch_collapsed_tail.py), the module graph's 1e-4 of the
output's largest value (tests/test_torch_msrr.py), bf16 1.5e-2 of it
(tests/test_torch_mamnet.py), int8 a PSNR of 80 dB
(tests/test_torch_int8.py). The JAX models get the port's weights through
the JAX package's own converter (no flax init). Inputs come from numpy
seeds.
"""

import functools

import numpy as np
import pytest
import torch

from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.utils import aot as jax_aot
from larvanet_tpu.utils import torch_convert as jax_convert
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.utils import aot

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

# one name a family, its tiny flags
FAMILIES = {
    "edsr": ["--edsr_conv_features", "8", "--edsr_res_blocks", "2"],
    "LarvaNet": ["--num_modules", "2", "--num_blocks", "1,1"],
    "mamnet": ["--mamnet_conv_features", "16", "--mamnet_res_blocks", "2"],
    "msrr_reduced": ["--num_blocks", "2"],
    "TreeNet": ["--num_common_blocks", "2", "--num_branches", "2", "--num_branch_blocks", "1"],
    "REGO-Net": ["--len_side", "3", "--num_filters", "16"],
    "ebrn_rm": ["--num_filters", "8", "--num_brms", "2"],
    "hrsr": ["--num_lr_blocks", "2", "--num_hr_blocks", "1"],
    "imdn_aim2019": ["--num_filters", "16", "--num_blocks", "2"],
}
COLLAPSED = ("edsr", "mamnet")
SHAPE = (1, 12, 16, 3)
COLLAPSED_ATOL = 0.1
F32_RTOL = 1e-4
BF16_RTOL = 1.5e-2
INT8_PSNR_DB = 80.0


def _lr(shape, seed):
    return np.random.default_rng(seed).uniform(0, 255, shape).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _models(name):
    pm = get_model(name)
    pm.parse_args(list(FAMILIES[name]))
    pm.prepare([4], device="cpu", seed=3)
    state = {k: v.numpy() for k, v in pm.module.state_dict().items()}
    jm = jax_get_model(name)
    jm.parse_args(list(FAMILIES[name]))
    jm.params = jax_convert.convert_state_dict(state, name)[0]
    jm.scale, jm.scale_list, jm.is_training = 4, [4], False
    jm.module = jm.build_module()
    return jm, pm


def _both(name, tmp_path, x, **kwargs):
    """(the port's artifact's output, JAX's artifact's, their headers) for
    `name` exported with `kwargs` (export_serving's)."""
    jm, pm = _models(name)
    exported, jheader = jax_aot.export_serving(jm, SHAPE, **kwargs)
    jax_aot.save_artifact(str(tmp_path / "jax.lvt"), exported, jheader)
    jserve, _ = jax_aot.load_artifact(str(tmp_path / "jax.lvt"))
    want = np.asarray(jserve(x))
    program, header = aot.export_serving(pm, SHAPE, **kwargs)
    aot.save_artifact(str(tmp_path / "port.lvt"), program, header)
    serve, _ = aot.load_artifact(str(tmp_path / "port.lvt"), "cpu")
    got = serve(torch.from_numpy(x)).numpy()
    pm.set_serving_dtype("f32")
    return got, want, header, jheader


@pytest.mark.parametrize("name", sorted(FAMILIES))
def test_f32_artifact_matches_jax(name, tmp_path):
    x = _lr(SHAPE, 1)
    got, want, header, jheader = _both(name, tmp_path, x)
    err = float(np.abs(got - want).max())
    scale = float(np.abs(want).max())
    print("%s f32: port %r vs JAX %r: max|d| %.3g of max %.3g" % (
        name, header["path_desc"], jheader["path_desc"], err, scale))
    assert got.shape == want.shape == (1, 48, 64, 3)
    assert (header["model"], header["scale"], header["input_shape"]) == (
        jheader["model"], jheader["scale"], jheader["input_shape"])
    assert err <= (COLLAPSED_ATOL if name in COLLAPSED else F32_RTOL * scale)


def test_bf16_artifact_matches_jax(tmp_path):
    x = _lr(SHAPE, 2)
    got, want, header, _ = _both("edsr", tmp_path, x, dtype="bfloat16")
    err = float(np.abs(got - want).max())
    print("edsr bf16: max|d| %.3g of max %.3g" % (err, np.abs(want).max()))
    assert header["dtype"] == "bfloat16"
    assert err <= BF16_RTOL * float(np.abs(want).max())


@pytest.mark.parametrize("name", ["edsr", "LarvaNet"])
def test_int8_artifact_matches_jax(name, tmp_path):
    """--int8_trunk artifacts, each side calibrated on the same batch, in
    f32 (JAX's export builds the int8 forward in the export dtype)."""
    x = _lr(SHAPE, 3)
    calib = _lr((2,) + SHAPE[1:], 4)
    got, want, header, jheader = _both(name, tmp_path, x, int8_trunk=True, calib=calib)
    mse = float(np.mean((got.astype(np.float64) - want) ** 2))
    psnr = float("inf") if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)
    print("%s int8: port %r vs JAX %r: PSNR %.1f dB" % (name, header["path_desc"],
                                                       jheader["path_desc"], psnr))
    assert header["path_desc"].startswith("int8 (W8A8) trunk")
    assert psnr >= INT8_PSNR_DB
