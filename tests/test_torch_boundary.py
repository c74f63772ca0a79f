"""The port's package boundary: `larvanet_tpu_torch` and the root-level
scripts the port added import torch, never JAX, flax, optax or the JAX
package."""

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
PORT_SCRIPTS = ("chip_smoke.py", "chip_wino_phases.py")
# `larvanet_tpu` is a prefix of `larvanet_tpu_torch`: match it only whole
FORBIDDEN = re.compile(r"^(jax|jaxlib|flax|optax|orbax|larvanet_tpu(?!_torch))(\.|$)")
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
