"""The port's directory checkpoints (`--orbax_checkpoint`: models/base.py
`_save_dir` / `_restore_dir` on torch.distributed.checkpoint), the three
checks of tests/test_orbax_checkpoint.py: the round trip (weights,
optimizer state, step), the scheduler's state with a `latest` resume, and
the asynchronous save with an overwrite. A JAX orbax directory stays
refused. Everything is written under tmp_path."""

import os

import numpy as np
import pytest
import torch

from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.utils.checkpoints import find_latest, is_dir_checkpoint

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give


def _tiny(dirs=True, async_on=False, name="edsr", ema=0.0):
    m = get_model(name)
    if name == "edsr":
        m.parse_args(["--edsr_res_blocks", "1", "--edsr_conv_features", "8"])
    else:
        m.parse_args(["--num_blocks", "1,1"])
    m.ema_decay = ema
    m.prepare([4], device="cpu", is_training=True)
    m.orbax_checkpoints = dirs
    m.async_checkpoints = async_on
    return m


def _step(m, rng):
    x = list(rng.uniform(0, 255, (2, 3, 8, 8)).astype(np.float32))
    t = list(rng.uniform(0, 255, (2, 3, 32, 32)).astype(np.float32))
    if m.registry_name.startswith("LarvaNet"):
        m.volume_per_step = 1
        m.train_step_larva(None, None, x, t)
    else:
        m.train_step(x, 4, t)


def _same(a, b):
    return all(torch.equal(p, q) for p, q in zip(a, b))


def test_dir_roundtrip_identity(tmp_path):
    rng = np.random.default_rng(0)
    m = _tiny(ema=0.9)
    _step(m, rng)
    path = m.save(str(tmp_path))
    assert os.path.isdir(path) and is_dir_checkpoint(path)
    assert path.endswith("model_1.pth")  # the name a file checkpoint takes

    m2 = _tiny(dirs=False, ema=0.9)
    m2.restore(path)  # recognised by its metadata: no flag on the read side
    assert _same(m2.module.parameters(), m.module.parameters())
    s1, s2 = m.optimizer.state_dict(), m2.optimizer.state_dict()
    assert s1["param_groups"] == s2["param_groups"] and s1["state"].keys() == s2["state"].keys()
    for i in s1["state"]:
        assert all(torch.equal(s1["state"][i][k], s2["state"][i][k]) for k in s1["state"][i])
    assert _same(m2.ema.average, m.ema.average)
    assert m2.global_step == 1
    _step(m2, rng)  # the restored model keeps training

    ev = get_model("edsr")  # an evaluation restore keeps the average for --ema
    ev.parse_args(["--edsr_res_blocks", "1", "--edsr_conv_features", "8"])
    ev.prepare([4], device="cpu")
    ev.restore(path)
    ev.use_ema_params()
    assert _same(ev.module.parameters(), m.ema.average)


def test_dir_scheduler_state_and_latest_resume(tmp_path):
    rng = np.random.default_rng(1)
    m = _tiny(name="LarvaNet")
    _step(m, rng)
    m.scheduler.step(30.0)
    m.scheduler.step(10.0)  # one bad epoch recorded
    p1 = m.save(str(tmp_path))
    _step(m, rng)
    p2 = m.save(str(tmp_path))
    assert p1 != p2
    assert find_latest(str(tmp_path)) == p2  # directories are found like files

    m2 = _tiny(name="LarvaNet")
    m2.restore(find_latest(str(tmp_path)))
    assert m2.global_step == 2
    assert m2.scheduler.state_dict() == m.scheduler.state_dict()


def test_dir_async_and_overwrite(tmp_path):
    rng = np.random.default_rng(2)
    m = _tiny(async_on=True)
    _step(m, rng)
    saved = [p.detach().clone() for p in m.module.parameters()]
    path = m.save(str(tmp_path))
    _step(m, rng)  # updates the weights in place behind the pending write
    m.wait_for_checkpoints()

    m2 = _tiny(dirs=False)
    m2.restore(path)
    assert _same(m2.module.parameters(), saved)

    # saving the same step again replaces the directory, in both modes
    for async_on in (False, True):
        m3 = _tiny(async_on=async_on)
        _step(m3, rng)
        m3.save(str(tmp_path))
        p = m3.save(str(tmp_path))
        m3.wait_for_checkpoints()
        assert os.path.isdir(p) and not os.path.exists(p + ".tmp-new")
        m4 = _tiny(dirs=False)
        m4.restore(p)
        assert _same(m4.module.parameters(), m3.module.parameters())


def test_a_jax_orbax_directory_stays_refused(tmp_path):
    jm = jax_get_model("edsr")
    jm.parse_args(["--edsr_res_blocks", "1", "--edsr_conv_features", "8"])
    jm.prepare(is_training=True, scales=[4])
    jm.orbax_checkpoints = True
    path = jm.save(str(tmp_path))
    assert os.path.isdir(path) and not is_dir_checkpoint(path)
    with pytest.raises(ValueError, match="orbax directory.*save_pth"):
        _tiny(dirs=False).restore(path)
