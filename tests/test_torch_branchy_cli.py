"""TreeNet and the REGOs served W8A8, and the TreeNet CLIs, against the JAX
package, on the CPU, at tests/test_torch_treenet.py's and
tests/test_torch_rego.py's sizes: `make_int8_treenet_forward` and
`make_int8_rego_forward`, calibrated on their own and replaying JAX's
records, against JAX's int8 forwards; validate_tree (serial and
--pipeline_depth 2) and state_dict_tree against JAX's CLIs on one `.pth`.
"""

import functools
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from larvanet_tpu.cli import state_dict_tree as jax_state_dict_tree
from larvanet_tpu.cli import validate_tree as jax_validate_tree
from larvanet_tpu.core.registry import get_model as jax_get_model
from larvanet_tpu.ops.packed.branchy import make_int8_rego_forward as jax_int8_rego
from larvanet_tpu.ops.packed.branchy import make_int8_treenet_forward as jax_int8_treenet
from larvanet_tpu.utils.torch_convert import save_pth
from larvanet_tpu_torch.cli import state_dict_tree, validate_tree
from larvanet_tpu_torch.ops import pairs
from larvanet_tpu_torch.ops.int8_forward import make_int8_rego_forward, make_int8_treenet_forward
from test_torch_branchy_train import REGO, TREE, div2k_root  # noqa: F401 (a fixture)
from test_torch_msrr import _lr, _to_numpy
from test_torch_msrr_train import FWD_PSNR_DB, _closure, _psnr, _train_models

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

SELF_CALIB_MARGIN_DB = 10.0


@pytest.mark.parametrize("name,flags", [("TreeNet", TREE), ("REGO-Net", REGO)])
def test_int8_forward_matches_jax(name, flags):
    """make_int8_{treenet,rego}_forward in f32, calibrated on its own and
    then with JAX's records in its runner, against JAX's int8 forward: the
    pairs are JAX's bit for bit (tests/test_torch_rego.py), the exact convs
    sum in another order, so the forwards are held by PSNR, with JAX's
    records at FWD_PSNR_DB. The own calibration's activation scales lie
    within 1e-5 of JAX's, and where a last-bit change of a scale flips
    codes (REGO-Net's louder trunk reaches ~1e3), its forward stays
    SELF_CALIB_MARGIN_DB closer to JAX's than to the exact forward."""
    jm, pm = _train_models(name, tuple(flags))
    calib, x = _lr((2, 12, 14, 3), seed=5), _lr((1, 10, 12, 3), seed=6)
    jmaker, maker = {"TreeNet": (jax_int8_treenet, make_int8_treenet_forward)}.get(
        name, (jax_int8_rego, make_int8_rego_forward))
    jfwd = jmaker(jm, calib, dtype=jnp.float32)
    want = np.asarray(jfwd(jm.params, jnp.asarray(x)))
    fwd = maker(pm, calib, torch.float32)
    got = fwd(torch.from_numpy(x)).numpy()
    quant = [{k: (np.asarray(v) if not isinstance(v, float) else v) for k, v in q.items()}
             for q in _closure(_closure(jfwd, "pair_int8"), "quant")]
    act = "leaky_relu" if name.startswith("REGO") else "relu"
    assert len(quant) == len(fwd.runner.quant) and all(q.act == act for q in fwd.runner.quant)
    scales = max(abs(getattr(p, k) - q[k]) / q[k] for p, q in zip(fwd.runner.quant, quant)
                 for k in ("s_in", "s_mid"))
    fwd.runner.quant[:] = pairs.load_jax_records(quant, torch.float32, "cpu", act, 0.1)
    same = fwd(torch.from_numpy(x)).numpy()
    with torch.no_grad():
        exact = pm.module(torch.from_numpy(x)).numpy()
    print("int8 %s vs JAX: PSNR %.1f dB, with JAX's records %.1f dB; int8 vs exact %.1f dB; "
          "activation scales within %.3g of JAX's"
          % (name, _psnr(got, want), _psnr(same, want), _psnr(got, exact), scales))
    assert _psnr(same, want) >= FWD_PSNR_DB and scales <= 1e-5
    assert _psnr(got, want) >= min(FWD_PSNR_DB, _psnr(got, exact) + SELF_CALIB_MARGIN_DB)
    assert float(np.abs(got - exact).max()) > 1e-3  # it does quantize


# ---- the TreeNet CLIs ----

@functools.lru_cache(maxsize=None)
def _tree_pth(root):
    jm = jax_get_model("TreeNet")
    jm.parse_args(list(TREE))
    jm.prepare(is_training=False, scales=[4])
    params = _to_numpy(jm.params)
    rng = np.random.default_rng(12)  # branch 1 apart from branch 0, the trunk louder
    params = jax.tree_util.tree_map(lambda v: v * rng.uniform(1.5, 3.0), params)
    return save_pth(params, "TreeNet", os.path.join(root, "tree.pth"))


def _argv(root, pth):
    return ["--restore_path", pth, "--data_input_path", os.path.join(root, "LR"),
            "--data_truth_path", os.path.join(root, "HR"), *TREE]


def test_validate_tree_matches_jax(div2k_root):
    """validate_tree's per-branch PSNRs: the port's serial and
    --pipeline_depth 2 loops equal each other exactly and JAX's within
    1e-3 dB, per image and in the mean."""
    pth = _tree_pth(div2k_root)
    argv = _argv(div2k_root, pth)
    want = jax_validate_tree.main(argv + ["--data_native", "0"])
    serial = validate_tree.main(argv + ["--device", "cpu"])
    piped = validate_tree.main(argv + ["--device", "cpu", "--pipeline_depth", "2"])
    assert serial == piped
    for b in (0, 1):
        print("validate_tree branch %d: port %.4f dB, JAX %.4f dB"
              % (b, serial[b]["mean_psnr"], want[b]["mean_psnr"]))
        assert abs(serial[b]["mean_psnr"] - want[b]["mean_psnr"]) <= 1e-3
        assert sorted(serial[b]["per_image"]) == sorted(want[b]["per_image"])
        for name, psnr in want[b]["per_image"].items():
            assert abs(serial[b]["per_image"][name] - psnr) <= 1e-3
    assert abs(serial[0]["mean_psnr"] - serial[1]["mean_psnr"]) > 1e-3  # two branches


def test_state_dict_tree_matches_jax(div2k_root, capsys):
    """state_dict_tree's two lines (branch 0, then branches 0 and 1 averaged
    into branch 0) against JAX's on the same `.pth`."""
    pth = _tree_pth(div2k_root)
    argv = _argv(div2k_root, pth)

    def lines(main, extra):
        capsys.readouterr()
        main(argv + extra)
        found = re.findall(r"^(original \(branch_0\)|averaged \(mean of branch_0, branch_1\)): "
                           r"mean psnr=([0-9.]+)$", capsys.readouterr().out, re.M)
        return [(tag, float(v)) for tag, v in found]

    want = lines(jax_state_dict_tree.main, ["--data_native", "0"])
    got = lines(state_dict_tree.main, ["--device", "cpu"])
    print("state_dict_tree: port %s, JAX %s" % (got, want))
    assert [t for t, _ in got] == [t for t, _ in want] and len(got) == 2
    assert all(abs(a - b) <= 1e-3 for (_, a), (_, b) in zip(got, want))
    assert abs(got[0][1] - got[1][1]) > 1e-2  # the average changed the function
