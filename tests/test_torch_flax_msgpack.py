"""The port's reader of flax msgpack checkpoints
(larvanet_tpu_torch/utils/flax_msgpack.py) and `SRModel.restore` of a JAX
`.ckpt`, against flax itself, on the CPU.

The reader must return exactly what `flax.serialization.msgpack_restore`
returns: the same tree, types and values, every array's dtype, shape and
bytes (a bfloat16 array, which numpy cannot hold, as a torch.bfloat16
tensor with the same bits). It is checked on the JAX package's own `.ckpt`
files (tiny EDSR, LarvaNet and LarvaNetV2 after 2 train steps with
--ema_decay 0.9), on hypothesis trees of every leaf type flax writes, on
chunked arrays, and in a process where `msgpack` and `flax` cannot be
imported.
"""

import os
import struct
import subprocess
import sys

import jax
import ml_dtypes
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.models.base import find_ema
from larvanet_tpu.utils.torch_convert import save_pth
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.utils import flax_msgpack
from larvanet_tpu_torch.utils.torch_convert import load_pth, state_dict_from_jax_params

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LARVA_TINY = ["--num_modules", "2", "--num_blocks", "1,1"]
MODELS = {"edsr": ["--edsr_res_blocks", "2", "--edsr_conv_features", "8"],
          "LarvaNet": LARVA_TINY, "LarvaNetV2": LARVA_TINY}


def assert_same(got, want, path="root"):
    """`got` (the port's reader) is exactly `want` (flax's)."""
    if isinstance(want, np.ndarray) and want.dtype == ml_dtypes.bfloat16:
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16, path
        assert list(got.shape) == list(want.shape), path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16), err_msg=path)
        return
    if isinstance(want, ml_dtypes.bfloat16):  # a bfloat16 numpy scalar
        assert isinstance(got, torch.Tensor) and got.dtype == torch.bfloat16 and got.dim() == 0
        assert int(got.view(torch.int16)) == int(np.asarray(want).view(np.int16)), path
        return
    assert type(got) is type(want), "%s: %s vs %s" % (path, type(got), type(want))
    if isinstance(want, dict):
        assert list(got) == list(want), path
        for k in want:
            assert_same(got[k], want[k], "%s/%s" % (path, k))
    elif isinstance(want, list):
        assert len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            assert_same(g, w, "%s[%d]" % (path, i))
    elif isinstance(want, (np.ndarray, np.generic)):
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    elif isinstance(want, float):
        assert struct.pack(">d", got) == struct.pack(">d", want), path
    elif isinstance(want, complex):
        assert struct.pack(">dd", got.real, got.imag) == struct.pack(
            ">dd", want.real, want.imag), path
    else:
        assert got == want, path


def _batch(rng, n=2, size=8):
    lr = [rng.uniform(0, 255, (3, size, size)).astype(np.float32) for _ in range(n)]
    hr = [rng.uniform(0, 255, (3, 4 * size, 4 * size)).astype(np.float32) for _ in range(n)]
    return lr, hr


@pytest.fixture(scope="module")
def jax_ckpts(tmp_path_factory):
    """{name: (JAX model, .ckpt path)} after 2 train steps with --ema_decay
    0.9 (the average then differs from the weights), with a volume set so
    that it is restored too."""
    out = {}
    rng = np.random.default_rng(0)
    for name, flags in MODELS.items():
        jm = jax_get_model(name)
        jm.parse_args(list(flags) + ["--packed_trunk", "0"])
        jm.ema_decay = 0.9
        jm.prepare(is_training=True, scales=[4])
        for _ in range(2):
            lr, hr = _batch(rng)
            jm.train_step(lr, 4, hr)
        jm.total_volume = 123456.75
        out[name] = (jm, jm.save(str(tmp_path_factory.mktemp(name))))
    return out


@pytest.mark.parametrize("name", sorted(MODELS))
def test_reader_matches_flax_on_jax_checkpoints(name, jax_ckpts):
    with open(jax_ckpts[name][1], "rb") as f:
        data = f.read()
    want = serialization.msgpack_restore(data)
    assert "params" in want and "opt_state" in want
    assert_same(flax_msgpack.restore(data), want)


def _leaves():
    """Every leaf kind flax's msgpack_serialize writes."""
    dtypes = [np.float32, np.float16, np.float64, np.int8, np.int32, np.int64, np.uint8,
              np.uint16, np.bool_, ml_dtypes.bfloat16]
    shapes = st.lists(st.integers(0, 4), max_size=3)

    def array(args):
        dtype, shape, seed = args
        raw = np.random.default_rng(seed).normal(0, 100, shape)
        return raw.astype(dtype) if dtype is not np.bool_ else raw > 0

    arrays = st.tuples(st.sampled_from(dtypes), shapes, st.integers(0, 2**16)).map(array)
    scalars = st.tuples(st.sampled_from(dtypes), st.just([]), st.integers(0, 2**16)).map(
        lambda a: array(a)[()])
    return st.one_of(
        arrays, scalars,
        st.integers(-2**63, 2**64 - 1), st.floats(allow_nan=True), st.booleans(),
        st.text(max_size=20), st.binary(max_size=20), st.none(),
        st.complex_numbers(allow_nan=False, allow_infinity=False))


TREES = st.recursive(
    _leaves(),
    lambda children: st.one_of(st.lists(children, max_size=4),
                               st.dictionaries(st.text(max_size=8), children, max_size=4)),
    max_leaves=12)


@settings(max_examples=150, deadline=None)
@given(tree=st.dictionaries(st.text(max_size=8), TREES, max_size=5))
def test_reader_matches_flax_on_any_tree(tree):
    data = serialization.msgpack_serialize(tree)
    assert_same(flax_msgpack.restore(data), serialization.msgpack_restore(data))


@pytest.mark.parametrize("dtype", [np.float32, np.int16, ml_dtypes.bfloat16])
def test_reader_puts_chunked_arrays_back_together(dtype, monkeypatch):
    """flax writes an array above MAX_CHUNK_SIZE bytes as a chunked dict; a
    lowered limit gives the layout at a small size. Chunked arrays at the
    top level and in nested dicts come back whole; one inside a list stays
    the dict flax leaves it."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    big = np.arange(3 * 5 * 7).reshape(3, 5, 7).astype(dtype)
    tree = {"a": big, "b": {"c": big[:2], "d": np.ones(4, np.float32)},
            "e": [serialization._chunk(big)]}
    data = serialization.msgpack_serialize(tree)
    want = serialization.msgpack_restore(data)
    assert isinstance(want["a"], np.ndarray) and isinstance(want["e"][0], dict)
    assert_same(flax_msgpack.restore(data), want)
    top = serialization.msgpack_serialize(big)
    assert_same(flax_msgpack.restore(top), serialization.msgpack_restore(top))


def test_reader_needs_neither_msgpack_nor_flax(jax_ckpts, tmp_path):
    """In a fresh process where `msgpack` and `flax` cannot be imported, the
    port restores the JAX LarvaNet .ckpt with its average."""
    jm, path = jax_ckpts["LarvaNet"]
    out = str(tmp_path / "restored.pt")
    code = (
        "import sys\n"
        "sys.modules['msgpack'] = None\n"
        "sys.modules['flax'] = None\n"
        "import torch\n"
        "from larvanet_tpu_torch.core.registry import get_model\n"
        "m = get_model('LarvaNet')\n"
        "m.parse_args(%r)\n"
        "m.prepare([4], device='cpu')\n"
        "m.restore(%r)\n"
        "weights = {k: v.clone() for k, v in m.module.state_dict().items()}\n"
        "m.use_ema_params()\n"
        "torch.save({'weights': weights, 'ema': m.module.state_dict(),\n"
        "            'step': m.global_step, 'volume': m.total_volume}, %r)\n"
        "assert not any(k == 'msgpack' or k.startswith('flax') for k, v in sys.modules.items()\n"
        "               if v is not None)\n" % (LARVA_TINY, path, out))
    subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True, timeout=300,
                   env=dict(os.environ, PYTHONPATH=ROOT))
    got = torch.load(out, weights_only=True)
    weights = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params),
                                         "LarvaNet")
    ema = state_dict_from_jax_params(
        jax.tree_util.tree_map(np.asarray, find_ema(jm.opt_state)), "LarvaNet")
    assert (got["step"], got["volume"]) == (2, 123456.75)
    for k in weights:
        assert torch.equal(got["weights"][k], weights[k]), k
        assert torch.equal(got["ema"][k], ema[k]), k
    assert any(not torch.equal(ema[k], weights[k]) for k in ema)


@pytest.mark.parametrize("data,match", [
    (b"\x81\xa1a", "truncated msgpack data: 1 bytes wanted at byte 3"),
    (b"\xc1", "unknown msgpack type byte 0xc1 at byte 0"),
    (b"\x91\xd4\x07\x00", "ext type 7 at byte 1"),
    (b"\x90\x90", "extra data after the object, at byte 1"),
    (b"\x81\x01\xc0", "map key of type int at byte 1"),
    (b"\x81\xa1a\xa2\xff\xfe", "not utf-8 at byte 3"),
    (b"\xc7\x05\x01\x93\x90\xa1x\x01", "malformed ndarray ext at byte 3"),
    (b"\xc7\x0d\x01\x93\x91\x02\xa7float32\xc4\x00", "with 0 bytes at byte 3"),
])
def test_reader_refuses_what_flax_did_not_write(data, match):
    with pytest.raises(ValueError, match=match):
        flax_msgpack.restore(data)


def test_reader_refuses_a_malformed_chunked_array():
    data = serialization.msgpack_serialize(
        {"a": {"__msgpack_chunked_array__": True, "shape": {"0": 5},
               "chunks": {"0": np.zeros(3, np.float32)}}})
    with pytest.raises(ValueError, match="chunked array at byte 3 of shape"):
        flax_msgpack.restore(data)


# ---- SRModel.restore of a .ckpt --------------------------------------------------------


def _port(name, **prepare):
    pm = get_model(name)
    pm.parse_args(list(MODELS[name]))
    pm.prepare([4], device="cpu", **prepare)
    return pm


@pytest.mark.parametrize("name", sorted(MODELS))
def test_ckpt_restore_equals_the_jax_pth_export(name, jax_ckpts, tmp_path):
    """A .ckpt restores the state_dict that the JAX package's `.pth` export
    of the same params loads, key for key and bit for bit, with the step
    and the volume; use_ema_params then serves the exported average."""
    jm, path = jax_ckpts[name]
    pm = _port(name)
    pm.restore(path)
    params = jax.tree_util.tree_map(np.asarray, jm.params)
    want = load_pth(save_pth(params, name, str(tmp_path / "params.pth")))
    got = pm.module.state_dict()
    assert sorted(got) == sorted(want)
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert (pm.global_step, pm.total_volume) == (2, 123456.75)
    ema = jax.tree_util.tree_map(np.asarray, find_ema(jm.opt_state))
    want_ema = load_pth(save_pth(ema, name, str(tmp_path / "ema.pth")))
    pm.use_ema_params()
    got = pm.module.state_dict()
    for k in want_ema:
        assert torch.equal(got[k], want_ema[k]), k
    assert any(not torch.equal(want_ema[k], want[k]) for k in want)


def test_ckpt_restore_of_v2_is_partial_as_in_jax(jax_ckpts):
    """LarvaNetV2's partial restore of a LarvaNet .ckpt: the keys both have
    come from the checkpoint, the tail keeps its init. A LarvaNet restore of
    the V2 .ckpt stays strict."""
    jm, path = jax_ckpts["LarvaNet"]
    pm = _port("LarvaNetV2")
    init = {k: v.clone() for k, v in pm.module.state_dict().items()}
    pm.restore(path)
    params = state_dict_from_jax_params(jax.tree_util.tree_map(np.asarray, jm.params),
                                        "LarvaNet")
    got = pm.module.state_dict()
    shared = set(params) & set(got)
    assert shared and set(got) - shared
    for k in got:
        assert torch.equal(got[k], params[k] if k in shared else init[k]), k
    with pytest.raises(ValueError, match="unexpected"):
        _port("LarvaNet").restore(jax_ckpts["LarvaNetV2"][1])


def test_ckpt_without_ema_and_training_restore_are_refused(tmp_path):
    jm = jax_get_model("edsr")
    jm.parse_args(list(MODELS["edsr"]))
    jm.prepare(is_training=False, scales=[4])
    path = jm.save(str(tmp_path))
    pm = _port("edsr")
    pm.restore(path)
    with pytest.raises(ValueError, match="checkpoint has no EMA weights — train with "
                                         "--ema_decay"):
        pm.use_ema_params()
    # saved without training: no optimizer state to resume from
    trainer = _port("edsr", is_training=True)
    with pytest.raises(ValueError, match="no optimizer state"):
        trainer.restore(path)


def test_orbax_directory_is_refused(tmp_path):
    (tmp_path / "model_5.ckpt").mkdir()
    with pytest.raises(ValueError, match="orbax directory.*save_pth"):
        _port("edsr").restore(str(tmp_path / "model_5.ckpt"))

