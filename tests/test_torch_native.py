"""The port's native host data path (larvanet_tpu_torch/data/native.py on
csrc/host/lvt_data.cpp) against the JAX package's (larvanet_tpu/data/
native.py on native/lvt_data.cpp and libpng), on the CPU.

* `lvt_patch_batch`: the port's batcher and its plain version
  (`patch_batch_plain`, the splitmix64 stream in numpy) bit for bit with
  JAX's `NativeBatcher` over seeds, thread counts and seeks, and the same
  error on an image not larger than the patch.
* `lvt_unfilter`: the PNG rows undone in C equal the numpy rows for all
  five filters, and the port's decode equals JAX's libpng `decode_png` for
  every colour type and depth `data/png.py` takes, plain and Adam7.
* `--data_native 1` (the default): every loader path that takes JAX's
  native stream gives JAX's batches with the same flags, bit for bit
  (`div2k_train_loader_tensor`, `train_larva`'s unthreaded
  `get_patch_batch_nhwc`, a queue runner's stream, cached or not by
  `--data_native`), where the port drew the numpy stream before; a set
  whose HR is not LR x scale, and `--data_native 0`, give the numpy stream.

JAX's library is compiled into a private directory where the shared build
is missing, as tests/test_torch_data.py does.
"""

import os
import subprocess
import zlib
from unittest import mock

import numpy as np
import pytest
import torch

from larvanet_tpu.core.registry import get_loader as jax_get_loader
from larvanet_tpu.data import native as jax_native
from larvanet_tpu_torch.core.registry import get_loader
from larvanet_tpu_torch.data import io, native, png
from larvanet_tpu_torch.data.dataset import PairDataset
from torch_png_cases import CASES, build_png, case_png

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

SCALE = 4
BATCH, PATCH = 5, 6


@pytest.fixture(scope="module")
def jax_lib(tmp_path_factory):
    """JAX's native library: the shared build, or the same source compiled
    into a private directory."""
    if jax_native.available():
        yield
        return
    out = tmp_path_factory.mktemp("native") / "liblvtdata.so"
    repo = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(jax_native.__file__))))
    src = os.path.join(repo, "native", "lvt_data.cpp")
    proc = subprocess.run(["g++", "-O3", "-fPIC", "-shared", "-std=c++17", "-o", str(out), src,
                           "-lpng", "-lz", "-pthread"], capture_output=True, text=True)
    if proc.returncode != 0:
        pytest.skip("no libpng toolchain to build the JAX package's native library:\n"
                    + proc.stderr)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(jax_native, "_LIB_PATH", str(out))
        mp.setattr(jax_native, "_lib", None)
        assert jax_native.available()
        yield


def _pairs(seed, n=3, extra=(0, 0)):
    """n random uint8 LR images of assorted sizes and their HR images (LR x
    SCALE plus `extra` rows and columns)."""
    rng = np.random.default_rng(seed)
    lr, hr = [], []
    for _ in range(n):
        h, w = int(rng.integers(PATCH + 2, 20)), int(rng.integers(PATCH + 2, 20))
        lr.append(rng.integers(0, 256, (h, w, 3), dtype=np.uint8))
        hr.append(rng.integers(0, 256, (h * SCALE + extra[0], w * SCALE + extra[1], 3),
                               dtype=np.uint8))
    return lr, hr


# ---- lvt_patch_batch --------------------------------------------------------------------


@pytest.mark.parametrize("threads", [1, 8])
@pytest.mark.parametrize("seed", [0, 7, 2 ** 63 + 5])
def test_patch_batch_matches_jax_batcher(jax_lib, seed, threads):
    """Four batches and a seek: the port's batcher, its plain version and
    JAX's, bit for bit; the thread count changes no sample."""
    lr, hr = _pairs(seed % 1000)
    mine = native.NativeBatcher(lr, hr, scale=SCALE, seed=seed, num_threads=threads)
    theirs = jax_native.NativeBatcher(lr, hr, scale=SCALE, seed=seed, num_threads=threads)
    for step in range(4):
        if step == 2:
            mine.seek(40)
            theirs.seek(40)
        got, want = mine.batch(BATCH, PATCH), theirs.batch(BATCH, PATCH)
        plain = native.patch_batch_plain(lr, hr, SCALE, seed + mine.step, BATCH, PATCH)
        assert got[0].shape == (BATCH, PATCH, PATCH, 3)
        assert got[1].shape == (BATCH, PATCH * SCALE, PATCH * SCALE, 3)
        for g, w, p in zip(got, want, plain):
            assert g.dtype == w.dtype == p.dtype == np.float32
            assert np.array_equal(g, w) and np.array_equal(g, p)
    one = native.NativeBatcher(lr, hr, scale=SCALE, seed=seed, num_threads=1)
    one.seek(40)
    assert all(np.array_equal(a, b) for a, b in zip(one.batch(BATCH, PATCH),
                                                     native.patch_batch_plain(
                                                         lr, hr, SCALE, seed + 41, BATCH, PATCH)))


def test_patch_batch_refuses_what_jax_refuses(jax_lib):
    """An image not larger than the patch: RuntimeError code -2 on both
    sides (and from the plain version); HR not LR x scale: ValueError."""
    rng = np.random.default_rng(3)
    lr = [rng.integers(0, 256, (8, 8, 3), dtype=np.uint8)]
    hr = [np.repeat(np.repeat(lr[0], SCALE, 0), SCALE, 1)]
    for make in (native.NativeBatcher, jax_native.NativeBatcher):
        with pytest.raises(RuntimeError, match="-2"):
            make(lr, hr, scale=SCALE, seed=0).batch(2, 8)
        with pytest.raises(ValueError, match="LR dims"):
            make(lr, [hr[0][1:]], scale=SCALE, seed=0)
    with pytest.raises(RuntimeError, match="-2"):
        native.patch_batch_plain(lr, hr, SCALE, 1, 2, 8)


def test_splitmix64_is_the_c_stream():
    """The numpy splitmix64's first output from state 0 is the generator's
    well-known first value (x += the golden gamma, then the mix)."""
    with np.errstate(over="ignore"):
        assert int(native.splitmix64(np.uint64(0))) == 0xE220A8397B1DCDAF


# ---- lvt_unfilter and the decode ------------------------------------------------------------


@pytest.mark.parametrize("bpp", [1, 2, 3, 4, 6, 8])
@pytest.mark.parametrize("kinds", [(0,), (1,), (2,), (3,), (4,), (4, 3, 1, 0, 2)],
                         ids=["none", "sub", "up", "average", "paeth", "mixed"])
def test_unfilter_matches_the_numpy_rows(kinds, bpp):
    rng = np.random.default_rng(bpp)
    height, stride = 9, bpp * 7
    raw = rng.integers(0, 256, (height, stride + 1), dtype=np.uint8)
    raw[:, 0] = [kinds[y % len(kinds)] for y in range(height)]
    got = native.unfilter(raw, height, stride, bpp)
    assert got.dtype == np.uint8 and np.array_equal(got, native.unfilter_plain(raw, height,
                                                                               stride, bpp))


def test_unfilter_refuses_an_unknown_filter_type():
    raw = np.zeros((3, 7), np.uint8)
    raw[1, 0] = 5
    for fn in (native.unfilter, native.unfilter_plain):
        with pytest.raises(ValueError, match="filter type 5"):
            fn(raw, 3, 6, 3)


@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("case", CASES + ["RGB_8", "RGBA_8", "L_8"])
def test_decode_matches_jax_libpng_and_the_numpy_rows(jax_lib, tmp_path, case, interlace):
    """Every colour type and depth, plain and Adam7, each row's filter in
    turn: the port's decode (C rows) equals JAX's libpng decode_png and the
    same decoder with the numpy rows."""
    path = str(tmp_path / "case.png")
    with open(path, "wb") as f:
        f.write(case_png(case, seed=len(case), shape=(11, 14), interlace=interlace))
    got = native.decode_png(path)
    assert got.dtype == np.uint8 and got.shape == (11, 14, 3)
    assert np.array_equal(got, jax_native.decode_png(path))
    with mock.patch.object(native, "unfilter", native.unfilter_plain):
        assert np.array_equal(native.decode_png(path), got)


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4])
def test_encoder_filters_decode_in_jax_libpng(jax_lib, tmp_path, kind):
    """png.encode with each row filter: JAX's libpng and the port's decode
    read the frame back."""
    frame = np.random.default_rng(kind).integers(0, 256, (13, 17, 3), dtype=np.uint8)
    path = str(tmp_path / ("f%d.png" % kind))
    with open(path, "wb") as f:
        f.write(png.encode(frame, filter_type=kind))
    assert np.array_equal(jax_native.decode_png(path), frame)
    assert np.array_equal(io.load_image_u8(path), frame)


def test_decode_png_raises_ioerror(tmp_path):
    with pytest.raises(IOError):
        native.decode_png(str(tmp_path / "missing.png"))
    bad = build_png(np.zeros((2, 2, 3), np.int64), 8, 2, kinds=(5,))
    (tmp_path / "bad.png").write_bytes(bad)
    with pytest.raises(IOError, match="filter type 5"):
        native.decode_png(str(tmp_path / "bad.png"))
    (tmp_path / "short.png").write_bytes(png.SIGNATURE + zlib.compress(b"x"))
    with pytest.raises(IOError):
        io.load_image_u8(str(tmp_path / "short.png"))


# ---- fault 6: the loaders' native stream ------------------------------------------------------


def _write_set(root, extra=(0, 0), n=3):
    """A DIV2K-layout set by the port's encoder: HR is LR x SCALE plus
    `extra` rows and columns."""
    rng = np.random.default_rng(17)
    for i in range(n):
        h, w = 12 + 2 * i, 14 + i
        lr = rng.integers(0, 256, (h, w, 3), dtype=np.uint8)
        hr = rng.integers(0, 256, (h * SCALE + extra[0], w * SCALE + extra[1], 3), dtype=np.uint8)
        io.save_image_hwc(hr, os.path.join(root, "HR", "%04d.png" % i))
        io.save_image_hwc(lr, os.path.join(root, "LR", "X4", "%04dx4.png" % i))
    return ["--data_input_path", os.path.join(root, "LR"),
            "--data_truth_path", os.path.join(root, "HR")]


@pytest.fixture(scope="module")
def exact_set(tmp_path_factory):
    return _write_set(str(tmp_path_factory.mktemp("exact")))


@pytest.fixture(scope="module")
def extra_set(tmp_path_factory):
    return _write_set(str(tmp_path_factory.mktemp("extra")), extra=(1, 2))


def _pair(name, flags, port_flags=()):
    """The port's loader and JAX's, `flags` on both (and `port_flags` on the
    port's only), prepared at SCALE."""
    out = []
    for get, extra in ((get_loader, port_flags), (jax_get_loader, ())):
        loader = get(name)
        _, left = loader.parse_args(list(flags) + list(extra))
        assert left == []
        loader.prepare([SCALE])
        out.append(loader)
    return out


def _batches(loader, method, steps=3):
    """`steps` re-seeded batches of `method` (a loader method name), as the
    train loops draw them."""
    out = []
    for step in range(steps):
        loader.reseed_for_step(step)
        out.append([np.asarray(a) for a in getattr(loader, method)(BATCH, SCALE, PATCH)])
    return out


def _same(a, b):
    return all(np.array_equal(x, y) for u, v in zip(a, b) for x, y in zip(u, v))


@pytest.mark.parametrize("name, method, cached", [
    ("div2k_train_loader_tensor", "get_patch_batch", []),
    ("div2k_train_loader", "get_patch_batch_nhwc", ["--data_cached"]),
], ids=["tensor_loader", "train_larva_unthreaded"])
def test_native_loader_batches_equal_jax_with_the_same_flags(jax_lib, exact_set, name, method,
                                                            cached):
    """--data_native at its default: the port's batches are JAX's native
    stream, bit for bit; the numpy stream the port drew before (its
    --data_native 0) is another."""
    flags = exact_set + cached + ["--data_seed", "5"]
    port, jax_loader = _pair(name, flags)
    got, want = _batches(port, method), _batches(jax_loader, method)
    assert port.dataset._native_batchers and jax_loader.dataset._native_batchers
    assert _same(got, want)
    before, _ = _pair(name, flags, port_flags=["--data_native", "0"])
    assert not _same(_batches(before, method), want)


@pytest.mark.parametrize("native_flag", ["1", "0"])
def test_queue_runner_stream_equals_jax(jax_lib, exact_set, native_flag):
    """One runner thread over a cached set: the port's queue gives JAX's
    batches in order, bit for bit. Its dataset takes the native stream
    under either --data_native, as JAX's runner dataset does."""
    flags = exact_set + ["--data_cached", "--data_seed", "9", "--data_num_queue_runners", "1",
                         "--data_native", native_flag]
    port, jax_loader = _pair("div2k_train_loader_queue", flags)
    got, want = [], []
    for loader, out in ((port, got), (jax_loader, want)):
        loader.start_training_queue_runner(BATCH, PATCH)
        try:
            for _ in range(3):
                out.append([np.asarray(a) for a in loader.get_queue_data(SCALE)])
        finally:
            loader.stop_queue_runners()
    assert _same(got, want)
    lr = [port.dataset.input_u8(SCALE, i) for i in range(len(port.dataset))]
    hr = [port.dataset.truth_u8(i) for i in range(len(port.dataset))]
    # the worker's batcher: seeded data_seed + worker 0 + scale, from step 1
    first = native.patch_batch_plain(lr, hr, SCALE, 9 + 0 + SCALE + 1, BATCH, PATCH)
    assert all(np.array_equal(a, b) for a, b in zip(got[0], first))


@pytest.mark.parametrize("name, method, cached", [
    ("div2k_train_loader_tensor", "get_patch_batch", []),
    ("div2k_train_loader", "get_patch_batch_nhwc", ["--data_cached"]),
], ids=["tensor_loader", "train_larva_unthreaded"])
def test_numpy_stream_where_jax_takes_it(jax_lib, extra_set, exact_set, name, method, cached,
                                         capsys):
    """HR not LR x scale: both packages fall back to the numpy stream (the
    port says why, once); --data_native 0 takes it on an exact set."""
    flags = extra_set + cached + ["--data_seed", "5"]
    port, jax_loader = _pair(name, flags)
    got = _batches(port, method)
    assert "does not apply" in capsys.readouterr().out
    assert not port.dataset.use_native and not port.dataset._native_batchers
    assert _same(got, _batches(jax_loader, method))
    flags = exact_set + cached + ["--data_seed", "5", "--data_native", "0"]
    port, jax_loader = _pair(name, flags)
    assert _same(_batches(port, method), _batches(jax_loader, method))
    assert not port.dataset._native_batchers


def test_batcher_made_after_a_reseed_starts_at_that_step(exact_set):
    """A resumed run's first batch: the dataset reseeded to step 3 before its
    batcher exists draws what an uninterrupted run draws at step 3."""
    def dataset():
        ds = PairDataset(exact_set[1], exact_set[3], cached=True, seed=11)
        ds.prepare([SCALE])
        return ds

    straight, resumed = dataset(), dataset()
    for step in range(4):
        straight.reseed_for_step(step)
        want = straight.patch_batch_nhwc(BATCH, SCALE, PATCH)
    resumed.reseed_for_step(3)
    got = resumed.patch_batch_nhwc(BATCH, SCALE, PATCH)
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    assert resumed._native_batchers[SCALE].step == 4
