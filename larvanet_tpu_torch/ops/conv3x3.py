"""Fused SAME 3x3 conv + bias + activation: the hand-written CUDA kernel
and its plain PyTorch version.

Counterpart of larvanet_tpu/ops/pallas_conv.py. The public layout is the
JAX one: x is NHWC (N, H, W, C), the kernel HWIO (3, 3, C, F), the bias
(F,); act is None, "relu" or "leaky_relu" (slope 0.1). The sum is taken
in f32 and the result is stored in x's dtype (f32 or bf16); the kernel
is cast to x's dtype and the bias to f32 first, as the Pallas kernel
does (pallas_conv.py:76-77).

`conv3x3_bias_act` launches `csrc/conv3x3_bias_act.cu` for a CUDA
tensor and raises on anything that kernel does not take; only a CPU
tensor goes to `conv3x3_bias_act_reference`. The source has two paths,
chosen by shape (`path_for`), never by retrying after a failure:
"tensor_core" (bf16 with C and F multiples of 16, WMMA over a halo tile in
shared memory) and "cuda_core" (everything else). `LAUNCHES` counts the
kernel's launches and `LAUNCHES_BY_PATH` each path's, so a run can show
that its path went through them.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional

import torch
import torch.nn.functional as F

from larvanet_tpu_torch.ops import build

SOURCE = "conv3x3_bias_act.cu"
ACTS = {None: 0, "relu": 1, "leaky_relu": 2}
_ENTRY = {("cuda_core", torch.float32): "conv3x3_bias_act_f32",
          ("cuda_core", torch.bfloat16): "conv3x3_bias_act_bf16",
          ("tensor_core", torch.bfloat16): "conv3x3_bias_act_bf16_tc"}

LAUNCHES = 0
LAUNCHES_BY_PATH: Dict[str, int] = {"cuda_core": 0, "tensor_core": 0}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for path in LAUNCHES_BY_PATH:
        LAUNCHES_BY_PATH[path] = 0


def path_for(c: int, f: int, dtype: torch.dtype) -> str:
    """The kernel path for a C -> F conv in `dtype`: the tensor cores take
    bf16 with C and F multiples of 16 (WMMA's 16-deep bf16 fragments),
    the CUDA cores the rest."""
    if dtype == torch.bfloat16 and c % 16 == 0 and f % 16 == 0:
        return "tensor_core"
    return "cuda_core"


def _apply_act(out: torch.Tensor, act: Optional[str]) -> torch.Tensor:
    if act == "relu":
        return torch.relu(out)
    if act == "leaky_relu":
        return torch.where(out >= 0, out, out * 0.1)
    return out


def conv3x3_bias_act_reference(x: torch.Tensor, kernel: torch.Tensor,
                               bias: torch.Tensor,
                               act: Optional[str] = None) -> torch.Tensor:
    """The plain version: nine shifted (M, C) x (C, F) products summed in
    f32, as the Pallas kernel's `dots` mode does (pallas_conv.py:94-100)."""
    if act not in ACTS:
        raise ValueError("unknown activation %r" % (act,))
    n, h, w, c = x.shape
    f = kernel.shape[-1]
    k = kernel.to(x.dtype).float()
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))  # SAME halo on W and H
    acc = torch.zeros(n * h * w, f, dtype=torch.float32, device=x.device)
    for dy in range(3):
        for dx in range(3):
            tap = xp[:, dy:dy + h, dx:dx + w, :].reshape(n * h * w, c)
            acc = acc + tap @ k[dy, dx]
    acc = _apply_act(acc + bias.float(), act)
    return acc.reshape(n, h, w, f).to(x.dtype)


def bind(lib: ctypes.CDLL, dtype: torch.dtype, path: str = "cuda_core"):
    """The entry point of `lib` for (`path`, `dtype`), with its C signature."""
    fn = getattr(lib, _ENTRY[(path, dtype)])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype, path: str):
    return bind(build.load(SOURCE), dtype, path)


def _run(fn, x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
         act: Optional[str], stream) -> torch.Tensor:
    """Call entry point `fn` on checked operands; returns the output."""
    n, h, w, c = x.shape
    f = kernel.shape[3]
    kmat = kernel.reshape(9 * c, f).to(x.dtype).contiguous()
    b = bias.to(torch.float32).contiguous()
    out = torch.empty((n, h, w, f), dtype=x.dtype, device=x.device)
    err = fn(x.data_ptr(), kmat.data_ptr(), b.data_ptr(), out.data_ptr(), n, h, w, c, f,
             ACTS[act], stream)
    if err != 0:
        raise RuntimeError("conv3x3_bias_act kernel launch failed: CUDA error %d" % err)
    return out


def conv3x3_bias_act(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                     act: Optional[str] = None) -> torch.Tensor:
    """SAME 3x3 conv + bias + act. CUDA tensor: the hand-written kernel;
    CPU tensor: the plain version."""
    if x.device.type == "cpu":
        return conv3x3_bias_act_reference(x, kernel, bias, act)
    if x.device.type != "cuda":
        raise ValueError("conv3x3_bias_act runs on CUDA or the CPU, not %s"
                         % (x.device,))
    if act not in ACTS:
        raise ValueError("unknown activation %r" % (act,))
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("conv3x3_bias_act takes float32 or bfloat16, got %s"
                        % (x.dtype,))
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor, got shape %s"
                         % (tuple(x.shape),))
    n, h, w, c = x.shape
    if kernel.dim() != 4 or kernel.shape[:3] != (3, 3, c):
        raise ValueError("kernel must be HWIO (3, 3, %d, F), got %s"
                         % (c, tuple(kernel.shape)))
    f = kernel.shape[3]
    if bias.shape != (f,):
        raise ValueError("bias must be (%d,), got %s" % (f, tuple(bias.shape)))
    if n * h * w == 0 or f == 0:
        raise ValueError("empty conv: x %s, F %d" % (tuple(x.shape), f))
    if kernel.device != x.device or bias.device != x.device:
        raise ValueError("x, kernel and bias must be on one device")
    path = path_for(c, f, x.dtype)
    with torch.cuda.device(x.device):
        out = _run(_entry(x.dtype, path), x, kernel, bias, act,
                   torch.cuda.current_stream().cuda_stream)
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_PATH[path] += 1
    return out
