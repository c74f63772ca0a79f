"""The port's package boundary: `larvanet_tpu_torch` and the root-level
scripts the port added import torch, never JAX, flax, optax, msgpack or
the JAX package."""

import json
import pathlib
import re
import subprocess
import sys

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "larvanet_tpu_torch"
# every root-level script of the port, named one by one (a new one is added
# here by hand, so no pattern can miss it)
PORT_SCRIPTS = ("chip_smoke.py", "chip_wino_phases.py", "chip_wgrad_variants.py",
                "chip_s8_variants.py", "chip_kxk_variants.py", "chip_epilogue_ab.py")
# `larvanet_tpu` is a prefix of `larvanet_tpu_torch`: match it only whole
FORBIDDEN = re.compile(r"^(jax|jaxlib|flax|optax|orbax|msgpack|larvanet_tpu(?!_torch))(\.|$)")
IMPORT_LINE = re.compile(
    r"^\s*(?:from\s+(\S+)\s+import|import\s+([\w.]+(?:\s*,\s*[\w.]+)*))", re.M)


def _modules():
    for path in sorted(PACKAGE.rglob("*.py")):
        rel = path.relative_to(ROOT).with_suffix("")
        parts = rel.parts[:-1] if rel.name == "__init__" else rel.parts
        yield ".".join(parts)


def test_importing_every_module_loads_no_jax():
    code = (
        "import importlib, json, sys\n"
        "for name in %r:\n"
        "    importlib.import_module(name)\n"
        "print(json.dumps(sorted(sys.modules)))\n" % (list(_modules()),))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "larvanet_tpu_torch.cli.serve" in loaded
    for name in ("ops.conv3x3_s8", "ops.pairs", "ops.int8_forward"):
        assert "larvanet_tpu_torch." + name in loaded
    assert [m for m in loaded if FORBIDDEN.match(m)] == []


def test_int8_serving_and_qat_on_the_cpu_load_no_jax():
    """An int8 forward (calibration, the s8 pairs' plain versions) and a QAT
    loss with its backward, in a fresh process: no JAX module loads."""
    code = (
        "import json, sys, numpy as np, torch\n"
        "from larvanet_tpu_torch.core.registry import get_model\n"
        "from larvanet_tpu_torch.ops import int8_forward\n"
        "m = get_model('edsr')\n"
        "m.parse_args(['--edsr_res_blocks', '1', '--edsr_conv_features', '8', '--qat', '1'])\n"
        "m.prepare([4], device='cpu', is_training=True)\n"
        "x = np.random.default_rng(0).uniform(0, 255, (1, 6, 8, 3)).astype(np.float32)\n"
        "fwd = int8_forward.make_int8_edsr_forward(m, x)\n"
        "assert fwd(torch.from_numpy(x)).shape == (1, 24, 32, 3)\n"
        "m._compute_loss(torch.from_numpy(x), torch.zeros(1, 24, 32, 3)).backward()\n"
        "print(json.dumps(sorted(sys.modules)))\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "larvanet_tpu_torch.ops.pairs" in loaded
    assert [m for m in loaded if FORBIDDEN.match(m)] == []


def test_no_source_file_imports_jax():
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / name for name in PORT_SCRIPTS]
    assert len(files) > 10
    bad = []
    for path in files:
        for m in IMPORT_LINE.finditer(path.read_text()):
            names = [m.group(1)] if m.group(1) else re.split(r"\s*,\s*", m.group(2))
            bad += ["%s: %s" % (path.name, n) for n in names if FORBIDDEN.match(n)]
    assert bad == []


def test_forbidden_pattern_spares_the_port_itself():
    assert FORBIDDEN.match("larvanet_tpu.ops") and FORBIDDEN.match("jax")
    assert FORBIDDEN.match("msgpack") and FORBIDDEN.match("flax.serialization")
    assert FORBIDDEN.match("larvanet_tpu")
    assert not FORBIDDEN.match("larvanet_tpu_torch.ops")


@pytest.mark.parametrize("name", PORT_SCRIPTS)
def test_each_port_script_exists_and_imports_no_jax(name):
    path = ROOT / name
    assert path.is_file()
    names = []
    for m in IMPORT_LINE.finditer(path.read_text()):
        names += [m.group(1)] if m.group(1) else re.split(r"\s*,\s*", m.group(2))
    assert "torch" in names or any(n.startswith("larvanet_tpu_torch") for n in names)
    assert [n for n in names if FORBIDDEN.match(n)] == []


def test_training_on_the_cpu_loads_no_jax(tmp_path):
    """A few steps of the train CLI, checkpoints included, in a fresh
    process: no JAX module is loaded along the way (no summary is due, so
    no TensorBoard writer is made)."""
    code = (
        "import json, os, sys\n"
        "import numpy as np\n"
        "from larvanet_tpu_torch.cli import train\n"
        "from larvanet_tpu_torch.data import io\n"
        "root = %r\n"
        "rng = np.random.default_rng(0)\n"
        "for i in range(2):\n"
        "    hr = rng.integers(0, 256, (3, 48, 48), dtype=np.uint8)\n"
        "    io.save_image_chw(hr, os.path.join(root, 'HR', '%%04d.png' %% i))\n"
        "    io.save_image_chw(hr[:, ::4, ::4], os.path.join(root, 'LR', 'X4', '%%04dx4.png' %% i))\n"
        "train.main(['--device', 'cpu', '--train_path', os.path.join(root, 'run'),\n"
        "            '--data_input_path', os.path.join(root, 'LR'),\n"
        "            '--data_truth_path', os.path.join(root, 'HR'), '--batch_size', '2',\n"
        "            '--input_patch_size', '8', '--edsr_conv_features', '8',\n"
        "            '--edsr_res_blocks', '1', '--max_steps', '3', '--save_freq', '2'])\n"
        "assert os.path.isfile(os.path.join(root, 'run', 'model_2.pth'))\n"
        "print(json.dumps(sorted(sys.modules)))\n" % (str(tmp_path),))
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT, check=True,
                         capture_output=True, text=True, timeout=300)
    loaded = json.loads(out.stdout.strip().splitlines()[-1])
    assert "larvanet_tpu_torch.cli.train" in loaded
    assert [m for m in loaded if FORBIDDEN.match(m)] == []
