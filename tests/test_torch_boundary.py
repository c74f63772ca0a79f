"""The port's package boundary: `larvanet_tpu_torch` and chip_smoke.py
import torch, never JAX, flax, optax or the JAX package."""

import json
import pathlib
import re
import subprocess
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]
PACKAGE = ROOT / "larvanet_tpu_torch"
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
    files = sorted(PACKAGE.rglob("*.py")) + [ROOT / "chip_smoke.py"]
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
