"""Build the port's CUDA sources into shared libraries at first use.

Each `csrc/*.cu` file has a plain C interface and is compiled by `nvcc`
for Hopper (`sm_90a`) into `build/kernels/<stem>-<hash>.so` at the repo
root, then loaded with `ctypes`. The hash covers the source and the
flags, so an edited `.cu` rebuilds and an unchanged one is reused. The
compiler's output (with `-Xptxas -v`: registers, shared memory, spills
per kernel) is kept beside the library as `<stem>-<hash>.log`.

The host entry (`build_host`, `load_host`) does the same for the port's
host C++ (`csrc/host/*.cpp`, no CUDA: the data path's PNG row filters and
batch assembly): `g++ -O3 -fPIC -shared -std=c++17 -pthread`, with the
compiler `ops/emulate.compiler()` finds, into `build/host/<stem>-<hash>.so`.
Both write under a temporary name and rename, so that processes building
the same source at once each see a whole library; a failed build raises
with the compiler's output.

Nothing here runs at import: the CPU tests import every module, and this
machine may have no `nvcc`.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Sequence

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
HOST_BUILD_DIR = BUILD_DIR.parent / "host"
SOURCES = ("conv3x3_bias_act.cu", "wino_resblock.cu", "conv3x3_wgrad.cu", "conv3x3_s8.cu",
           "conv_kxk.cu", "dwconv3x3.cu", "adam_flat.cu")
HOST_FLAGS = ("-O3", "-fPIC", "-shared", "-std=c++17", "-pthread")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_LIBS: Dict[str, ctypes.CDLL] = {}
_HOST_LIBS: Dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def nvcc() -> str:
    found = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(found):
        raise RuntimeError("nvcc not found: building the CUDA kernels needs "
                           "the CUDA toolkit (on PATH or in /usr/local/cuda)")
    return found


def library_path(source: str) -> Path:
    digest = hashlib.sha256((CSRC / source).read_bytes())
    digest.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / ("%s-%s.so" % (Path(source).stem, digest.hexdigest()[:16]))


def build(sources: Sequence[str] = SOURCES) -> Dict[str, float]:
    """Compile every source whose library is missing: one `nvcc` per
    source, all started together. Returns {source: seconds} for the ones
    built; raises with the compiler's output if any failed."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    running = []
    for source in sources:
        out = library_path(source)
        if out.exists():
            continue
        tmp = out.with_name("%s.%d.tmp" % (out.name, os.getpid()))
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / source)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        running.append((source, out, tmp, proc, time.perf_counter()))
    seconds, failures = {}, []
    for source, out, tmp, proc, t0 in running:
        log, _ = proc.communicate()
        seconds[source] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append("nvcc failed on %s (exit %d):\n%s"
                            % (source, proc.returncode, log))
            continue
        out.with_suffix(".log").write_text(log)
        os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def build_log(source: str) -> str:
    path = library_path(source).with_suffix(".log")
    return path.read_text() if path.exists() else ""


def load(source: str) -> ctypes.CDLL:
    """The loaded library of `source`, built first if needed."""
    with _LOCK:
        if source not in _LIBS:
            build([source])
            _LIBS[source] = ctypes.CDLL(str(library_path(source)))
        return _LIBS[source]


def host_library_path(source: str) -> Path:
    """The host library of `csrc/<source>` (e.g. "host/lvt_data.cpp")."""
    digest = hashlib.sha256((CSRC / source).read_bytes())
    digest.update(" ".join(HOST_FLAGS).encode())
    return HOST_BUILD_DIR / ("%s-%s.so" % (Path(source).stem, digest.hexdigest()[:16]))


def build_host(source: str) -> float:
    """Compile `csrc/<source>` with the host C++ compiler if its library is
    missing. Returns the seconds it took (0.0 when it was there); raises
    with the compiler's output if it failed."""
    from larvanet_tpu_torch.ops.emulate import compiler

    out = host_library_path(source)
    if out.exists():
        return 0.0
    HOST_BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name("%s.%d.tmp" % (out.name, os.getpid()))
    t0 = time.perf_counter()
    proc = subprocess.run([compiler(), *HOST_FLAGS, "-o", str(tmp), str(CSRC / source)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("host build of %s failed (exit %d):\n%s%s"
                           % (source, proc.returncode, proc.stdout, proc.stderr))
    os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
    return time.perf_counter() - t0


def load_host(source: str) -> ctypes.CDLL:
    """The loaded host library of `source`, built first if needed."""
    with _LOCK:
        if source not in _HOST_LIBS:
            build_host(source)
            _HOST_LIBS[source] = ctypes.CDLL(str(host_library_path(source)))
        return _HOST_LIBS[source]
