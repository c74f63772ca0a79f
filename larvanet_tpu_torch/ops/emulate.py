"""Build the port's CUDA sources for the CPU, to test their logic without a card.

`load(source)` compiles `csrc/<source>` with the host C++ compiler (C++20)
against the stand-in headers of `csrc/emu/` (one fiber per CUDA thread
on the calling thread, a barrier for `__syncthreads`, cp.async copies that
land at the issuing thread's wait, NaN-filled dynamic shared memory)
into `build/emu/<stem>-<hash>.so` and loads it with ctypes. The entry
points keep their plain C interface, so a test calls them on CPU tensors
exactly as the wrapper calls them on CUDA tensors, with stream 0, and
holds the result against the plain version. Before compiling, the
source's `kernel<<<grid, block, smem, stream>>>(args)` launches become
`emu_launch(kernel, grid, block, smem, stream, args)` and its `extern
__shared__` array a pointer to the block's shared memory.

This checks indexing, masking, tiling and arithmetic order; it says
nothing about what nvcc accepts, about speed, or about races that a
real warp scheduler would expose and this one does not.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Tuple

from larvanet_tpu_torch.ops.build import CSRC

EMU_DIR = CSRC / "emu"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "emu"
CXX_FLAGS = ("-std=c++20", "-O2", "-fPIC", "-shared", "-pthread")

_LIBS: Dict[Tuple[str, int], ctypes.CDLL] = {}
_LOCK = threading.Lock()


def compiler() -> str:
    found = shutil.which("g++") or shutil.which("c++")
    if not found:
        raise RuntimeError("no host C++ compiler (g++ or c++) on PATH")
    return found


def translate(src: str) -> str:
    """CUDA launch syntax and `extern __shared__` -> the stand-in's calls."""
    src = re.sub(r"extern\s+__shared__\s+(?:__align__\(\d+\)\s+)?(\w+)\s+(\w+)\[\];",
                 r"\1* \2 = reinterpret_cast<\1*>(emu_smem());", src)
    return re.sub(r"(?m)^(\s*)([^\n;]*?)<<<([^\n]*?)>>>\(", r"\1emu_launch(\2, \3, ", src)


def _flags(sms: int):
    return (*CXX_FLAGS, "-DEMU_SMS=%d" % sms)


def library_path(source: str, sms: int = 1) -> Path:
    digest = hashlib.sha256((CSRC / source).read_bytes())
    for header in sorted(EMU_DIR.glob("*.h")):
        digest.update(header.read_bytes())
    digest.update(" ".join(_flags(sms)).encode())
    return BUILD_DIR / ("%s-%s.so" % (Path(source).stem, digest.hexdigest()[:16]))


def load(source: str, sms: int = 1) -> ctypes.CDLL:
    """The CPU build of `source` for a stand-in card of `sms` SMs (each
    holds one block), compiled first if needed."""
    with _LOCK:
        if (source, sms) in _LIBS:
            return _LIBS[(source, sms)]
        out = library_path(source, sms)
        if not out.exists():
            BUILD_DIR.mkdir(parents=True, exist_ok=True)
            cpp = out.with_name("%s.%d.cpp" % (out.stem, os.getpid()))
            cpp.write_text(translate((CSRC / source).read_text()))
            tmp = out.with_name("%s.%d.tmp" % (out.name, os.getpid()))
            proc = subprocess.run([compiler(), *_flags(sms), "-I", str(EMU_DIR), "-o", str(tmp),
                                   str(cpp)], capture_output=True, text=True)
            cpp.unlink()
            if proc.returncode != 0:
                raise RuntimeError("CPU build of %s failed:\n%s" % (source, proc.stderr))
            os.replace(tmp, out)  # atomic: a concurrent loader sees all or nothing
        _LIBS[(source, sms)] = ctypes.CDLL(str(out))
        return _LIBS[(source, sms)]
