"""`--fused_opt` in the port (models/base.make_optimizer(..., fused=True):
torch's Adam / AdamW stepping through ops/adam_flat over flat moment
buffers) against the JAX package's optax.flatten Adam, on the CPU, where
the step is the kernel's plain version.

* The plain version against JAX's make_optimizer(kind, fused=True) over 5
  steps, both kinds, at tests/test_torch_jax_resume.py's bar for
  parameters after Adam steps (1e-5 absolute), the flat first moment
  against JAX's flat mu.
* The flat buffers in JAX's ravel_pytree order, for every family.
* train and train_larva under --fused_opt 1 against --fused_opt 0 over 5
  steps.
* Checkpoints across the packages and the settings: a port checkpoint
  written under --fused_opt 1 restores in JAX under both settings, a JAX
  fused .ckpt resumes in the port's fused run, and a state file moves
  between the port's two optimizers.
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.models.base import make_optimizer as jax_make_optimizer
from larvanet_tpu_torch.cli import train, train_larva
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.data import io
from larvanet_tpu_torch.models.base import FlatAdam, FlatAdamW, make_optimizer
from larvanet_tpu_torch.ops import adam_flat
from larvanet_tpu_torch.utils.torch_convert import jax_leaf, state_dict_from_jax_params

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

SCALE = 4
PARAM_ATOL = 1e-5
LOSS_RTOL = 1e-5
TINY = ["--edsr_conv_features", "8", "--edsr_res_blocks", "1"]


def _to_numpy(tree):
    if hasattr(tree, "items"):
        return {k: _to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _adam_node(state):
    if hasattr(state, "mu") and hasattr(state, "nu"):
        return state
    for child in (getattr(state, "inner_state", None),) + (
            tuple(state) if isinstance(state, tuple) else ()):
        if child is not None and not isinstance(child, (int, float)):
            found = _adam_node(child)
            if found is not None:
                return found
    return None


# ---- the plain version against optax.flatten ----------------------------------------------


@pytest.mark.parametrize("kind", ["adam", "adamw"])
def test_plain_version_matches_jax_fused_optimizer(kind):
    rng = np.random.default_rng(4)
    tree = {"b": {"kernel": rng.normal(0, 0.1, (3, 3, 4, 5)).astype(np.float32),
                  "bias": rng.normal(0, 0.1, (5,)).astype(np.float32)},
            "a": {"kernel": rng.normal(0, 0.1, (7,)).astype(np.float32)}}
    tx = jax_make_optimizer(kind, fused=True)
    jparams = jax.tree_util.tree_map(jnp.asarray, tree)
    state = tx.init(jparams)
    leaves = jax.tree_util.tree_leaves(tree)  # ravel_pytree's order
    params = [torch.from_numpy(leaf.copy()) for leaf in leaves]
    flat = adam_flat.AdamFlat(params)
    lr = 3e-3
    for step in range(1, 6):
        grads = jax.tree_util.tree_map(
            lambda a: rng.normal(0, 1, a.shape).astype(np.float32), tree)
        state.hyperparams["learning_rate"] = jnp.asarray(lr, jnp.float32)
        updates, state = tx.update(jax.tree_util.tree_map(jnp.asarray, grads), state, jparams)
        jparams = optax.apply_updates(jparams, updates)
        flat.step([torch.from_numpy(g) for g in jax.tree_util.tree_leaves(grads)],
                  adam_flat.scalars(lr, (0.9, 0.999), 1e-8, step, weight_decay=0.01,
                                    adamw=kind == "adamw"))
    for got, want in zip(params, jax.tree_util.tree_leaves(jparams)):
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= PARAM_ATOL
    mu = np.asarray(_adam_node(state).mu)
    assert mu.shape == (sum(p.numel() for p in params),)  # the one flat vector
    mine = torch.cat([flat.view(flat.m, i).reshape(-1) for i in range(len(params))]).numpy()
    assert float(np.abs(mine - mu).max()) <= 1e-6 * float(np.abs(mu).max())


# ---- JAX's ravel_pytree order ---------------------------------------------------------------

LARVA = ["--num_modules", "2", "--num_blocks", "2,2"]
ORDER_MODELS = {"edsr": TINY, "LarvaNet": LARVA, "LarvaNetV2": LARVA, "LarvaNet_1c": LARVA,
                "mamnet": [], "imdn_aim2019": [], "msrr": [], "msrr_reduced": [],
                "msrr_test": [], "dwsr_reduced": [], "TreeNet": [], "REGO-Net": [],
                "REGO-serial": [], "ebrn": [], "ebrn_rm": [], "hrsr_c3": []}


@pytest.mark.parametrize("name", sorted(ORDER_MODELS))
def test_flat_order_is_jax_ravel_order(name):
    """The port model's `jax_ravel_order` names JAX's parameter leaves in
    ravel_pytree's order (the parameters JAX does not have, full EBRN's dead
    last BRM, aside)."""
    jm = jax_get_model(name)
    jm.parse_args(list(ORDER_MODELS[name]))
    jm.prepare(is_training=False, scales=[SCALE])
    pm = get_model(name)
    pm.parse_args(list(ORDER_MODELS[name]))
    pm.prepare([SCALE], device="cpu")
    paths = [tuple(k.key for k in path)
             for path, _ in jax.tree_util.tree_flatten_with_path(jm.params)[0]]
    names = [n for n, _ in pm.module.named_parameters()]
    order = pm.jax_ravel_order()
    assert sorted(order) == list(range(len(names)))
    mine = [jax_leaf(names[i], name) for i in order]
    assert [m for m in mine if m in set(paths)] == paths
    sizes = {jax_leaf(n, name): p.numel() for n, p in pm.module.named_parameters()}
    assert sum(sizes[p] for p in paths) == ravel_pytree(jm.params)[0].size


# ---- the optimizer ----------------------------------------------------------------------


def _edsr(fused, seed=0):
    m = get_model("edsr")
    m.parse_args(list(TINY))
    m.fused_opt = fused
    m.prepare([SCALE], device="cpu", is_training=True, seed=seed)
    return m


def _batch(seed, patch=8):
    rng = np.random.default_rng(seed)
    lr = rng.uniform(0, 255, (2, patch, patch, 3)).astype(np.float32)
    hr = np.repeat(np.repeat(lr, SCALE, 1), SCALE, 2)
    return lr, np.clip(hr + rng.normal(0, 8, hr.shape), 0, 255).astype(np.float32)


def test_fused_state_is_views_into_the_flat_buffers():
    m = _edsr(True)
    opt = m.optimizer
    assert isinstance(opt, FlatAdam) and isinstance(opt, torch.optim.Adam)
    m.train_step(*_batch(0)[:1], SCALE, _batch(0)[1])
    for i, p in enumerate(opt._flat_params):
        assert opt.state[p]["exp_avg"].data_ptr() == opt.flat.view(opt.flat.m, i).data_ptr()
        assert opt.state[p]["exp_avg_sq"].data_ptr() == opt.flat.view(opt.flat.v, i).data_ptr()
        assert float(opt.state[p]["step"]) == 1.0
    # a per-tensor optimizer's state loads into the views, and back
    per_tensor = make_optimizer("adam", list(m.module.parameters()))
    per_tensor.load_state_dict(opt.state_dict())
    fresh = make_optimizer("adam", list(m.module.parameters()), fused=True,
                           order=m.jax_ravel_order())
    fresh.load_state_dict(per_tensor.state_dict())
    for i, p in enumerate(fresh._flat_params):
        assert fresh.state[p]["exp_avg"].data_ptr() == fresh.flat.view(fresh.flat.m, i).data_ptr()
        assert torch.equal(fresh.state[p]["exp_avg"], opt.state[p]["exp_avg"])
    assert isinstance(make_optimizer("adamw", [torch.zeros(2, requires_grad=True)], fused=True),
                      FlatAdamW)


def test_flat_adam_skips_a_parameter_without_a_gradient():
    used = torch.nn.Parameter(torch.ones(6))
    unused = torch.nn.Parameter(torch.ones(4))
    opt = make_optimizer("adamw", [used, unused], fused=True)
    for group in opt.param_groups:
        group["lr"] = 1e-2
    used.grad = torch.full((6,), 0.5)
    opt.step()
    assert torch.equal(unused.detach(), torch.ones(4))
    assert float(opt.state[unused]["step"]) == 0.0 and float(opt.state[used]["step"]) == 1.0
    assert not torch.equal(used.detach(), torch.ones(6))
    with pytest.raises(ValueError, match="amsgrad"):
        FlatAdam([used], amsgrad=True)
    with pytest.raises(ValueError, match="every parameter once"):
        FlatAdam([used, unused], order=[0, 0])


def test_fused_steps_match_the_per_tensor_optimizer():
    a, b = _edsr(False), _edsr(True)
    for step in range(5):
        x, t = _batch(step)
        la, lb = a.train_step(x, SCALE, t), b.train_step(x, SCALE, t)
        assert abs(la - lb) <= LOSS_RTOL * abs(la)
    for p, q in zip(a.module.parameters(), b.module.parameters()):
        assert float((p - q).detach().abs().max()) <= PARAM_ATOL


# ---- the CLIs ------------------------------------------------------------------------------


@pytest.fixture(scope="module")
def train_root(tmp_path_factory):
    """A DIV2K-layout set (HR exactly LR x 4) by the port's encoder."""
    root = str(tmp_path_factory.mktemp("fused_set"))
    rng = np.random.default_rng(13)
    for i in range(2):
        hr = rng.integers(0, 256, (3, 64, 80), dtype=np.uint8)
        lr = np.round(hr.reshape(3, 16, 4, 20, 4).mean((2, 4))).astype(np.uint8)
        io.save_image_chw(hr, os.path.join(root, "HR", "%04d.png" % i))
        io.save_image_chw(lr, os.path.join(root, "LR", "X4", "%04dx4.png" % i))
    return root


@pytest.mark.parametrize("cli", ["train", "train_larva"])
def test_cli_fused_opt_matches_fused_opt_0(train_root, tmp_path, cli):
    data = ["--data_input_path", os.path.join(train_root, "LR"),
            "--data_truth_path", os.path.join(train_root, "HR"), "--data_cached",
            "--data_seed", "3", "--device", "cpu", "--batch_size", "2",
            "--input_patch_size", "8", "--max_steps", "5", "--dataloader", "div2k_train_loader"]
    if cli == "train":
        main, flags = train.main, data + ["--model", "edsr", "--scales", "4"] + TINY
    else:
        main = train_larva.main
        flags = data + ["--num_blocks", "1,1", "--val_volume", "100000000",
                        "--val_data_input_path", os.path.join(train_root, "LR"),
                        "--val_data_truth_path", os.path.join(train_root, "HR")]
    runs = {f: main(flags + ["--fused_opt", f, "--train_path", str(tmp_path / f)])
            for f in ("1", "0")}
    (fused, lf), (plain, lp) = runs["1"], runs["0"]
    assert type(fused.optimizer).__name__ == ("FlatAdam" if cli == "train" else "FlatAdamW")
    assert isinstance(fused.optimizer, type(plain.optimizer))
    assert sorted(lf) == sorted(lp) == [1, 2, 3, 4, 5]
    for s in lp:
        assert abs(lf[s] - lp[s]) <= LOSS_RTOL * abs(lp[s]), (s, lf[s], lp[s])
    for p, q in zip(fused.module.parameters(), plain.module.parameters()):
        assert float((p - q).detach().abs().max()) <= PARAM_ATOL


# ---- checkpoints across the packages ----------------------------------------------------------


@pytest.mark.parametrize("jax_fused", [0, 1])
def test_port_fused_checkpoint_restores_in_jax(tmp_path, jax_fused):
    """The port's .pth written under --fused_opt 1 restores into a JAX
    training run under either --fused_opt (a .pth carries no moments, so
    JAX's restart them, as for any .pth) and JAX's next step runs."""
    pm = _edsr(True)
    for step in range(2):
        pm.train_step(*_batch(step)[:1], SCALE, _batch(step)[1])
    path = pm.save(str(tmp_path))
    jm = jax_get_model("edsr")
    jm.parse_args(list(TINY))
    jm.fused_opt = jax_fused
    jm.prepare(is_training=True, scales=[SCALE])
    jm.restore(path)
    got = state_dict_from_jax_params(_to_numpy(jm.params), "edsr")
    for n, p in pm.module.named_parameters():
        assert torch.equal(got[n], p.detach())
    x, t = _batch(7)
    assert np.isfinite(jm.train_step(list(x.transpose(0, 3, 1, 2)), SCALE,
                                     list(t.transpose(0, 3, 1, 2))))


def test_jax_fused_ckpt_resumes_in_the_port_fused_run(tmp_path):
    """JAX trains 2 steps under --fused_opt 1 and saves; the port's fused run
    restores the flat mu / nu into its views (JAX's values, transposed) and
    its next step is JAX's."""
    jm = jax_get_model("edsr")
    jm.parse_args(list(TINY) + ["--packed_trunk", "0"])
    jm.fused_opt = 1
    jm.prepare(is_training=True, scales=[SCALE])
    for step in range(2):
        x, t = _batch(step)
        jm.train_step(list(x.transpose(0, 3, 1, 2)), SCALE, list(t.transpose(0, 3, 1, 2)))
    path = jm.save(str(tmp_path))
    pm = _edsr(True, seed=1)
    pm.restore(path)
    adam = _adam_node(jm.opt_state)
    _, unravel = ravel_pytree(jm.params)
    mu = state_dict_from_jax_params(_to_numpy(unravel(adam.mu)), "edsr")
    opt = pm.optimizer
    for i, (n, p) in enumerate(pm.module.named_parameters()):
        assert torch.equal(opt.state[p]["exp_avg"], mu[n])
        assert float(opt.state[p]["step"]) == 2.0
    for i, p in enumerate(opt._flat_params):
        assert opt.state[p]["exp_avg"].data_ptr() == opt.flat.view(opt.flat.m, i).data_ptr()
    x, t = _batch(5)
    pm.train_step(x, SCALE, t)
    jm.train_step(list(x.transpose(0, 3, 1, 2)), SCALE, list(t.transpose(0, 3, 1, 2)))
    want = state_dict_from_jax_params(_to_numpy(jm.params), "edsr")
    for n, p in pm.module.named_parameters():
        assert float((p.detach() - want[n]).abs().max()) <= PARAM_ATOL, n


@pytest.mark.parametrize("resume_fused", [True, False])
def test_state_file_moves_between_the_two_optimizers(tmp_path, resume_fused):
    """A fused run's checkpoint resumes under either setting; the next step
    is the uninterrupted fused run's."""
    straight = _edsr(True)
    for step in range(2):
        straight.train_step(*_batch(step)[:1], SCALE, _batch(step)[1])
    path = straight.save(str(tmp_path))
    resumed = _edsr(resume_fused, seed=3)
    resumed.restore(path)
    x, t = _batch(9)
    assert abs(resumed.train_step(x, SCALE, t) - straight.train_step(x, SCALE, t)) == 0.0
    for p, q in zip(resumed.module.parameters(), straight.module.parameters()):
        assert float((p - q).detach().abs().max()) <= PARAM_ATOL


def test_directory_checkpoint_of_a_fused_run_resumes_under_either_setting(tmp_path):
    """--orbax_checkpoint 1: the DCP directory of a fused run (its state
    entries views into the flat buffers) restores into a fused and a
    per-tensor run, whose next steps are the straight run's."""
    straight = _edsr(True)
    straight.orbax_checkpoints = True
    for step in range(2):
        straight.train_step(*_batch(step)[:1], SCALE, _batch(step)[1])
    path = straight.save(str(tmp_path))
    x, t = _batch(7)
    resumed = [_edsr(fused, seed=5) for fused in (True, False)]
    for model in resumed:
        model.restore(path)
    want = straight.train_step(x, SCALE, t)
    for model in resumed:
        assert model.train_step(x, SCALE, t) == want
        for p, q in zip(model.module.parameters(), straight.module.parameters()):
            assert float((p - q).detach().abs().max()) <= PARAM_ATOL


def test_data_parallel_step_takes_the_flat_optimizer():
    """parallel/mesh.use_data_parallel on a mesh that repeats the CPU: the
    shards' mean gradients step the flat Adam once, as the single run."""
    from larvanet_tpu_torch.parallel import mesh

    single, dp = _edsr(True), _edsr(True)
    mesh.use_data_parallel(dp, mesh.make_mesh((2,), devices=[torch.device("cpu")] * 2))
    for step in range(3):
        rng = np.random.default_rng(step)
        x = rng.uniform(0, 255, (4, 8, 8, 3)).astype(np.float32)
        t = np.repeat(np.repeat(x, SCALE, 1), SCALE, 2)
        a, b = single.train_step(x, SCALE, t), dp.train_step(x, SCALE, t)
        assert abs(a - b) <= LOSS_RTOL * abs(a)
    assert all(float(dp.optimizer.state[p]["step"]) == 3.0 for p in dp.module.parameters())
    for p, q in zip(single.module.parameters(), dp.module.parameters()):
        assert float((p - q).detach().abs().max()) <= PARAM_ATOL
