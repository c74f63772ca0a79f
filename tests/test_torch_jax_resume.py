"""Resuming training from a JAX `.ckpt` in the port (SRModel.restore of a
flax msgpack file while training) against the JAX package, on the CPU, at
tiny sizes.

JAX trains a few steps and saves; the port restores the file and takes one
step; JAX takes the same step from the same state. optax's `mu`, `nu` and
`count` must come over as torch's `exp_avg`, `exp_avg_sq` and `step`, the
EMA node as the port's average, the plateau schedule, the step and the
volume as they were; the step after the restore must then agree. JAX trains
at --packed_trunk 0, the graph the port trains. The restored moments equal
JAX's bit for bit (the same values, transposed); the parameters and the
average after the next step are held at tests/test_torch_train.py's bar for
parameters after Adam steps (1e-5 absolute).
"""

import numpy as np
import pytest
import torch

from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.models.base import find_ema
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.utils.torch_convert import state_dict_from_jax_params

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

SCALE = 4
PARAM_ATOL = 1e-5
CASES = {
    # name: (model, flags, --ema_decay, JAX's --fused_opt)
    "edsr_adam_ema": ("edsr", ["--edsr_conv_features", "8", "--edsr_res_blocks", "1"], 0.9, 0),
    "edsr_fused_opt": ("edsr", ["--edsr_conv_features", "8", "--edsr_res_blocks", "1"], 0.0,
                       1),
    "larvanet_adamw": ("LarvaNet", ["--num_blocks", "1,1"], 0.0, 0),
}


def _to_numpy(tree):
    if hasattr(tree, "items"):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _batch(seed, patch=8):
    rng = np.random.default_rng(seed)
    lr = rng.uniform(0, 255, (2, 3, patch, patch)).astype(np.float32)
    hr = np.repeat(np.repeat(lr, SCALE, 2), SCALE, 3)
    return list(lr), list(np.clip(hr + rng.normal(0, 8, hr.shape), 0, 255).astype(np.float32))


def _adam_node(opt_state):
    """JAX's ScaleByAdamState in the live optimizer state."""
    if hasattr(opt_state, "mu") and hasattr(opt_state, "nu"):
        return opt_state
    for attr in ("inner_state",):
        if hasattr(opt_state, attr):
            return _adam_node(getattr(opt_state, attr))
    if isinstance(opt_state, tuple):
        for el in opt_state:
            found = _adam_node(el)
            if found is not None:
                return found
    return None


@pytest.fixture(scope="module", params=sorted(CASES))
def resumed(request, tmp_path_factory):
    name, flags, ema, fused = CASES[request.param]
    jm = jax_get_model(name)
    jm.parse_args(flags + ["--packed_trunk", "0"])
    jm.ema_decay, jm.fused_opt = ema, fused
    jm.prepare(is_training=True, scales=[SCALE])
    for step in range(2):
        jm.train_step(*_batch(step)[:1], SCALE, _batch(step)[1])
    if name == "LarvaNet":
        jm.total_volume = 12345.0
        for psnr in (20.0, 19.0, 18.0, 17.0, 16.0):  # bad epochs past patience: lr halves
            jm.scheduler.step(psnr)
    path = jm.save(str(tmp_path_factory.mktemp(request.param)))
    pm = get_model(name)
    pm.parse_args(flags)
    pm.ema_decay = ema
    pm.prepare([SCALE], device="cpu", is_training=True, seed=1)
    pm.restore(path)
    restored = {"global_step": pm.global_step, "total_volume": pm.total_volume,
                "lr": pm.get_learning_rate(),
                "step": [float(s["step"]) for s in pm.optimizer.state.values()],
                "exp_avg": {n: pm.optimizer.state[p]["exp_avg"].clone()
                            for n, p in pm.module.named_parameters()},
                "exp_avg_sq": {n: pm.optimizer.state[p]["exp_avg_sq"].clone()
                               for n, p in pm.module.named_parameters()}}
    want = {"global_step": jm.global_step, "total_volume": jm.total_volume,
            "lr": jm.get_learning_rate()}
    adam = _adam_node(jm.opt_state)
    want["count"] = int(np.asarray(adam.count))
    if fused:
        from jax.flatten_util import ravel_pytree

        _, unravel = ravel_pytree(jm.params)
        want["mu"], want["nu"] = unravel(adam.mu), unravel(adam.nu)
    else:
        want["mu"], want["nu"] = adam.mu, adam.nu
    want["mu"], want["nu"] = (state_dict_from_jax_params(_to_numpy(t), name)
                              for t in (want["mu"], want["nu"]))
    x, t = _batch(5)
    pm.train_step(x, SCALE, t)
    jm.train_step(x, SCALE, t)
    names = [n for n, _ in pm.module.named_parameters()]
    after = state_dict_from_jax_params(_to_numpy(jm.params), name)
    jema = find_ema(jm.opt_state)
    return {"name": name, "ema": ema, "restored": restored, "want": want, "pm": pm,
            "jax_params": after, "names": names,
            "jax_ema": None if jema is None else state_dict_from_jax_params(
                _to_numpy(jema), name),
            "scheduler": (pm.scheduler.state_dict() if name == "LarvaNet" else None,
                          jm.scheduler.state_dict() if name == "LarvaNet" else None)}


def test_jax_ckpt_restores_the_optimizer_state(resumed):
    got, want = resumed["restored"], resumed["want"]
    assert got["global_step"] == want["global_step"] == 2
    assert got["total_volume"] == want["total_volume"]
    assert got["lr"] == want["lr"]
    assert got["step"] == [float(want["count"])] * len(resumed["names"])
    for key, jkey in (("exp_avg", "mu"), ("exp_avg_sq", "nu")):
        for n in resumed["names"]:
            assert torch.equal(got[key][n], want[jkey][n]), (key, n)


def test_step_after_a_jax_ckpt_restore_matches_jax(resumed):
    pm = resumed["pm"]
    assert pm.global_step == 3
    for n, p in pm.module.named_parameters():
        err = float((p.detach() - resumed["jax_params"][n]).abs().max())
        assert err <= PARAM_ATOL, (n, err)
    for p in pm.module.parameters():
        assert float(pm.optimizer.state[p]["step"]) == 3.0
    if resumed["ema"]:
        for n, a in zip(resumed["names"], pm.ema.average):
            assert float((a - resumed["jax_ema"][n]).abs().max()) <= PARAM_ATOL, n
    if resumed["name"] == "LarvaNet":
        mine, theirs = resumed["scheduler"]
        assert mine == {k: (v.item() if hasattr(v, "item") else v)
                        for k, v in theirs.items()}
        assert mine["lr"] < 4e-4  # the plateau halved it before the save


def test_jax_ckpt_without_the_runs_ema_is_refused(tmp_path):
    """--ema_decay must be consistent across a resumed run, as for a .pth."""
    jm = jax_get_model("edsr")
    jm.parse_args(["--edsr_conv_features", "8", "--edsr_res_blocks", "1"])
    jm.prepare(is_training=True, scales=[SCALE])
    path = jm.save(str(tmp_path))
    pm = get_model("edsr")
    pm.parse_args(["--edsr_conv_features", "8", "--edsr_res_blocks", "1"])
    pm.ema_decay = 0.9
    pm.prepare([SCALE], device="cpu", is_training=True)
    with pytest.raises(ValueError, match="--ema_decay must be consistent"):
        pm.restore(path)
