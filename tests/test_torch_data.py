"""The port's image IO, loaders, metrics and dispatch-ahead loop
(larvanet_tpu_torch/data/{io,dataset,loaders}.py, eval/{metrics,pipeline}.py)
against the JAX package's, on the CPU.

The images come from `larvanet_tpu.data.fixture.generate` (written by
Pillow) and from numpy with a seed; the port decodes them with its own
PNG codec.
"""

import os
import subprocess

import numpy as np
import pytest
import torch

from larvanet_tpu.core.registry import get_loader as jax_get_loader
from larvanet_tpu.data import fixture
from larvanet_tpu.data import io as jax_io
from larvanet_tpu.data import native as jax_native
from larvanet_tpu.eval import metrics as jax_metrics
from larvanet_tpu_torch.core.registry import get_loader
from larvanet_tpu_torch.data import io
from larvanet_tpu_torch.data.dataset import PairDataset
from larvanet_tpu_torch.data.loaders import BaseLoader
from larvanet_tpu_torch.eval import metrics
from larvanet_tpu_torch.eval.pipeline import pipelined_upscale
from torch_png_cases import CASES, case_png

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

# float64 arithmetic in the same order on both sides
METRIC_TOL = 1e-12
SHAPES = ((32, 40, 0, 0), (30, 33, 1, 2), (25, 25, 0, 1))


@pytest.fixture(scope="module")
def flat_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("flat"))
    fixture.generate(root, shapes=SHAPES, scales=(2, 4), datasets=())
    return root


@pytest.fixture(scope="module")
def div2k_root(tmp_path_factory, flat_root):
    """The flat fixture rewritten in the DIV2K scheme by the JAX package."""
    root = str(tmp_path_factory.mktemp("div2k"))
    for scale in (2, 4):
        src = os.path.join(flat_root, "x%d" % scale)
        for name in jax_io.list_pngs(os.path.join(src, "truth")):
            lr = jax_io.load_image_u8(os.path.join(src, "input", name + ".png"))
            jax_io.save_image_hwc(lr, os.path.join(root, "LR", "X%d" % scale,
                                                   "%sx%d.png" % (name, scale)))
            if scale == 4:
                hr = jax_io.load_image_u8(os.path.join(src, "truth", name + ".png"))
                jax_io.save_image_hwc(hr, os.path.join(root, "HR", name + ".png"))
    return root


def _loaders(name, inp, tru, scales, extra=()):
    out = []
    for get in (get_loader, jax_get_loader):
        loader = get(name)
        _, remaining = loader.parse_args(["--data_input_path", inp, "--data_truth_path", tru,
                                          *extra])
        assert remaining == []
        loader.prepare(scales)
        out.append(loader)
    return out


def _same_pairs(port, jax_loader, scale):
    assert port.get_num_images() == jax_loader.get_num_images() == len(SHAPES)
    for i in range(port.get_num_images()):
        got, want = port.get_image_pair(i, scale), jax_loader.get_image_pair(i, scale)
        assert got[2] == want[2]
        for g, w in zip(got[:2], want[:2]):
            assert g.dtype == w.dtype == np.float32 and g.shape == w.shape
            assert g.tobytes() == w.tobytes()


def test_basic_loader_pairs_are_byte_identical(flat_root):
    inp, tru = (os.path.join(flat_root, "x4", d) for d in ("input", "truth"))
    port, jax_loader = _loaders("basic_loader", inp, tru, [4], ["--data_native", "0"])
    _same_pairs(port, jax_loader, 4)


def test_div2k_val_loader_pairs_are_byte_identical(div2k_root):
    inp, tru = (os.path.join(div2k_root, d) for d in ("LR", "HR"))
    port, jax_loader = _loaders("div2k_val_loader", inp, tru, [2, 4])
    assert port.dataset.cached  # the val loader always caches
    for scale in (2, 4):
        _same_pairs(port, jax_loader, scale)
        # a second read comes from the cache, unchanged
        _same_pairs(port, jax_loader, scale)


def test_png_io_round_trip_with_pillow(tmp_path):
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (13, 17, 3), dtype=np.uint8)
    jax_io.save_image_hwc(img, str(tmp_path / "pil.png"))
    np.testing.assert_array_equal(io.load_image_u8(str(tmp_path / "pil.png")), img)
    np.testing.assert_array_equal(io.load_image_chw(str(tmp_path / "pil.png")),
                                  jax_io.load_image_chw(str(tmp_path / "pil.png")))
    chw = rng.uniform(-20, 280, (3, 13, 17)).astype(np.float32)
    io.save_image_chw(chw, str(tmp_path / "sub" / "port.png"))
    jax_io.save_image_chw(chw, str(tmp_path / "pil2.png"))
    np.testing.assert_array_equal(jax_io.load_image_u8(str(tmp_path / "sub" / "port.png")),
                                  jax_io.load_image_u8(str(tmp_path / "pil2.png")))
    assert io.list_pngs(str(tmp_path)) == jax_io.list_pngs(str(tmp_path)) == ["pil", "pil2"]


@pytest.fixture(scope="module")
def jax_libpng(tmp_path_factory):
    """The JAX loader with its libpng decoder, as it runs when the native
    library is built. Where the shared build is missing, the same source is
    compiled into a private directory, so that no other test's build of it
    is raced."""
    if jax_native.available():
        yield
        return
    out = tmp_path_factory.mktemp("native") / "liblvtdata.so"
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(jax_native.__file__))))
    src = os.path.join(repo, "native", "lvt_data.cpp")
    proc = subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-o", str(out), src,
                           "-lpng", "-lz", "-pthread"], capture_output=True, text=True)
    if proc.returncode != 0:
        pytest.skip("no libpng toolchain to build the JAX loader's decoder:\n" + proc.stderr)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB_PATH", str(out))
        mp.setattr(jax_native, "_lib", None)
        assert jax_native.available()
        yield


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("case", CASES)
def test_load_image_u8_matches_jax_loader_on_every_png_kind(jax_libpng, tmp_path, case,
                                                             interlace):
    """The loaders' decode against the JAX loader's libpng path, exactly:
    palettes, grey + alpha, packed grey, 16-bit RGB(A), and 16-bit grey,
    which libpng takes by its high byte (the port's "high" rule)."""
    path = str(tmp_path / "img.png")
    with open(path, "wb") as f:
        f.write(case_png(case, seed=3, interlace=interlace))
    want = jax_io.load_image_u8(path)
    got = io.load_image_u8(path)
    assert got.shape == want.shape == (13, 17, 3) and got.dtype == want.dtype == np.uint8
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(io.load_image_chw(path), jax_io.load_image_chw(path))


def test_dataset_rejects_unknown_scheme_and_training_methods_raise():
    with pytest.raises(ValueError, match="scheme"):
        PairDataset("a", "b", scheme="zip")
    with pytest.raises(NotImplementedError):
        BaseLoader().get_patch_batch(2, 4, 8)
    # the queue-runner trio is the threaded loaders' (tests/test_torch_larva_train.py)
    with pytest.raises(NotImplementedError):
        BaseLoader().start_training_queue_runner(2, 8)


def _images(seed, shape=(24, 30, 3)):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 256, shape, dtype=np.uint8),
            rng.integers(0, 256, shape, dtype=np.uint8))


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_paper_protocol_metrics_match_jax(seed):
    out, tru = _images(seed)
    pairs = [
        (metrics.psnr_y(out, tru), jax_metrics.psnr_y(out, tru)),
        (metrics.ssim(out, tru), jax_metrics.ssim(out, tru)),
        (metrics.ssim(out[..., 0], tru[..., 0]), jax_metrics.ssim(out[..., 0], tru[..., 0])),
        (metrics.psnr_rgb(out, tru), jax_metrics.psnr_rgb(out, tru)),
    ]
    for got, want in pairs:
        assert abs(got - want) <= METRIC_TOL, (got, want)
    np.testing.assert_allclose(metrics.rgb_to_y(out), jax_metrics.rgb_to_y(out),
                               atol=METRIC_TOL, rtol=0)
    np.testing.assert_array_equal(metrics.shave(out, 4), jax_metrics.shave(out, 4))
    assert metrics.psnr_y(out, out) == float("inf") == jax_metrics.psnr_y(out, out)


def test_fit_truth_to_output_matches_jax():
    out, _ = _images(3, (20, 28, 3))
    _, tru = _images(4, (23, 31, 3))
    for o, t in ((out, tru), (out.transpose(2, 0, 1), tru.transpose(2, 0, 1))):
        got = metrics.fit_truth_to_output(o, t)
        np.testing.assert_array_equal(got, jax_metrics.fit_truth_to_output(o, t))
        assert got.shape == o.shape
    with pytest.raises(ValueError, match="rank"):
        metrics.fit_truth_to_output(out, tru[..., 0])


class _RecordingModel:
    """upscale_device of a x2 nearest-neighbour model that records the
    order of launches and pulls."""

    def __init__(self):
        self.events = []

    def upscale_device(self, input_list, scale, uint8=True):
        assert uint8
        x = torch.from_numpy(np.stack(input_list)).permute(0, 2, 3, 1)
        self.events.append("launch %d" % int(x[0, 0, 0, 0]))
        return x.repeat_interleave(scale, 1).repeat_interleave(scale, 2)


@pytest.mark.parametrize("depth", [1, 2, 3])
def test_pipelined_upscale_keeps_order_and_dispatches_ahead(depth):
    model = _RecordingModel()
    frames = [np.full((3, 2, 3), i, np.uint8) for i in range(5)]
    results = []
    for payload, out, dt in pipelined_upscale(model, ((i, f) for i, f in enumerate(frames)),
                                              2, depth=depth):
        model.events.append("pull %d" % payload)
        results.append((payload, out))
        assert dt >= 0
    assert [p for p, _ in results] == list(range(5))
    for i, out in results:
        np.testing.assert_array_equal(out, np.full((3, 4, 6), i, np.uint8))
    # frame depth-1 is launched before frame 0 is pulled
    assert model.events.index("launch %d" % (depth - 1)) < model.events.index("pull 0")
