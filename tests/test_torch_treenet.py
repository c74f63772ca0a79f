"""The port's TreeNet (larvanet_tpu_torch/models/treenet.py) against the JAX
package's (larvanet_tpu/models/treenet.py, ops/packed/branchy.py), on the
CPU, at --num_common_blocks 2 --num_branches 2 --num_branch_blocks 1: each
branch's forward and "all" against JAX's module and its
`make_packed_treenet_forward` at x4 (its 48 channels shuffle to RGB only at
x4, in JAX as in the reference), odd and even widths, in f32 and bf16; the
LR-domain training forward; the converter against JAX's `export_state_dict`
into a strict load; the partial restore.

JAX parameters cross over through the port's own
`state_dict_from_jax_params`, louder than drawn (tests/test_torch_msrr.py's
`_louder`: every kernel times KERNEL_GAIN, every bias from N(0, 1)), and
errors are held relative to the largest value of the residual over the
bicubic base. The training, int8 and CLI parity is in
tests/test_torch_branchy_train.py.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.ops.packed.branchy import make_packed_treenet_forward
from larvanet_tpu.ops.resize import upsample
from larvanet_tpu.utils.torch_convert import export_state_dict
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.utils.torch_convert import state_dict_from_jax_params
from test_torch_msrr import BF16_RTOL, F32_RTOL, _hold, _louder, _lr, _to_numpy

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

FLAGS = ["--num_common_blocks", "2", "--num_branches", "2", "--num_branch_blocks", "1"]
SHAPES = ((2, 7, 9, 3), (1, 6, 10, 3))  # an odd and an even width


@functools.lru_cache(maxsize=None)
def _models(scale=4):
    """(JAX model with its louder parameters, those parameters as numpy,
    the port's model with them), f32, on the CPU."""
    jm = jax_get_model("TreeNet")
    jm.parse_args(list(FLAGS))
    jm.prepare(is_training=False, scales=[scale])
    params = _louder(_to_numpy(jm.params), np.random.default_rng(scale))
    jm.params = jax.tree_util.tree_map(jnp.asarray, params)
    pm = get_model("TreeNet")
    pm.parse_args(list(FLAGS))
    pm.prepare([scale], device="cpu")
    pm.load_state_dict(state_dict_from_jax_params(params, "TreeNet"), strict=True)
    return jm, params, pm


def _outputs(out):
    return [np.asarray(o) for o in out] if isinstance(out, list) else [np.asarray(out)]


@pytest.mark.parametrize("branches", [0, 1, "all"])
def test_forward_matches_jax_module_and_packed_forward(branches, scale=4):
    """Each branch and "all" in f32 against JAX's module and
    make_packed_treenet_forward, at an odd and an even width."""
    jm, params, pm = _models(scale)
    fwd = make_packed_treenet_forward(jm, dtype=jnp.float32)
    for shape in SHAPES:
        x = _lr(shape, seed=shape[2] + scale)
        base = np.asarray(upsample(jnp.asarray(x), scale, "bicubic"))
        want = _outputs(jm.module.apply({"params": params}, jnp.asarray(x), branches=branches))
        packed = _outputs(fwd(params, jnp.asarray(x), branches=branches))
        with torch.no_grad():
            got = _outputs(pm.module.walk(torch.from_numpy(x), branches=branches))
        assert len(got) == len(want) == (2 if branches == "all" else 1)
        for b, (g, w, p) in enumerate(zip(got, want, packed)):
            label = "TreeNet x%d %s branch %s/%d" % (scale, shape, branches, b)
            _hold(label + " vs module", g, w, w - base, F32_RTOL)
            _hold(label + " vs packed", g, p, w - base, F32_RTOL)


@pytest.mark.parametrize("branch", [0, 1])
def test_bf16_forward_matches_jax(branch):
    """The bf16 serving module against JAX's bf16 packed forward at x4 (an
    even width): within BF16_RTOL of the residual's largest value; branch 0
    is the served forward (fwd_runtime), branch 1 `upscale_branch`'s."""
    jm, params, pm = _models()
    x = _lr((1, 6, 10, 3), seed=3)
    want = np.asarray(make_packed_treenet_forward(jm, dtype=jnp.bfloat16)(
        params, jnp.asarray(x), branches=branch)).astype(np.float32)
    base = np.asarray(upsample(jnp.asarray(x), 4, "bicubic"))
    pm.set_serving_dtype("bf16")
    try:
        if branch == 0:
            got = pm.fwd_runtime(torch.from_numpy(x)).numpy()
        else:
            got = pm.upscale_branch(list(x.transpose(0, 3, 1, 2)), 4, branch).transpose(
                0, 2, 3, 1)
    finally:
        pm.set_serving_dtype("f32")
    _hold("TreeNet bf16 branch %d" % branch, got, want, want - base, BF16_RTOL)


def test_lr_domain_forward_matches_jax():
    """The training forward before the shuffle (--lr_domain_loss 1), every
    branch with the base unshuffled once, against JAX's
    make_packed_treenet_forward(lr_domain=True)."""
    jm, params, pm = _models()
    x = _lr((2, 6, 10, 3), seed=4)
    want = _outputs(make_packed_treenet_forward(jm, dtype=jnp.float32, lr_domain=True)(
        params, jnp.asarray(x), branches="all"))
    full = _outputs(jm.module.apply({"params": params}, jnp.asarray(x), branches="all"))
    base = np.asarray(upsample(jnp.asarray(x), 4, "bicubic"))
    with torch.no_grad():
        got = _outputs(pm.module.walk(torch.from_numpy(x), branches="all", lr_domain=True))
    for b, (g, w, f) in enumerate(zip(got, want, full)):
        _hold("TreeNet lr domain branch %d" % b, g, w, f - base, F32_RTOL)


def test_converter_matches_jax_export_and_restore_is_partial(tmp_path, capsys):
    """`state_dict_from_jax_params` gives JAX's `export_state_dict` key for
    key and value for value (the reference's common_parts / branch_<b>
    keys, no MeanShift), which `_models` loads strictly; `restore` is
    partial whatever it is asked, as JAX's: a one-branch checkpoint leaves
    branch 1 at its init."""
    _, params, pm = _models()
    want = export_state_dict(params, "TreeNet")
    got = state_dict_from_jax_params(params, "TreeNet")
    assert sorted(got) == sorted(want) == sorted(pm.module.state_dict())
    assert "common_parts.2.1.body.2.weight" in got and "branch_1.0.body.0.bias" in got
    for key, value in want.items():
        assert np.array_equal(got[key].numpy(), np.asarray(value, np.float32)), key
    one = {k: v for k, v in got.items() if not k.startswith("branch_1.")}
    path = str(tmp_path / "one_branch.pth")
    torch.save(one, path)
    fresh = get_model("TreeNet")
    fresh.parse_args(list(FLAGS))
    fresh.prepare([4], device="cpu", seed=7)
    init = fresh.module.state_dict()["branch_1.0.body.0.weight"].clone()
    fresh.restore(path, strict=True)
    state = fresh.module.state_dict()
    assert torch.equal(state["branch_0.0.body.0.weight"], got["branch_0.0.body.0.weight"])
    assert torch.equal(state["branch_1.0.body.0.weight"], init)
    assert "4 parameters are not in the checkpoint" in capsys.readouterr().out
