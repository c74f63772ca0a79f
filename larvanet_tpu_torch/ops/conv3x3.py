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
tensor goes to `conv3x3_bias_act_reference`. The source has three paths,
chosen by shape (`path_for`), never by retrying after a failure:
"narrow" (F <= 8 with C a multiple of 16 up to 64, both dtypes: EDSR's
64->3 final_conv; a streaming kernel over a double-buffered halo, bf16 on
mma.sync and f32 on the CUDA cores), "tensor_core" (C and F multiples of
16, both dtypes, over a halo tile in shared memory: bf16 on WMMA, f32 on
mma.sync in split TF32, three TF32 products an f32 product, with the
weights split into hi and lo parts here, once per weight:
`split_weight`) and "cuda_core" (everything else). `LAUNCHES` counts the
kernel's launches and `LAUNCHES_BY_PATH` each path's, so a run can show
that its path went through them.
"""

from __future__ import annotations

import collections
import ctypes
import functools
import threading
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from larvanet_tpu_torch.ops import build

SOURCE = "conv3x3_bias_act.cu"
ACTS = {None: 0, "relu": 1, "leaky_relu": 2}
_ENTRY = {("cuda_core", torch.float32): "conv3x3_bias_act_f32",
          ("cuda_core", torch.bfloat16): "conv3x3_bias_act_bf16",
          ("tensor_core", torch.bfloat16): "conv3x3_bias_act_bf16_tc",
          ("tensor_core", torch.float32): "conv3x3_bias_act_f32_tc",
          ("narrow", torch.float32): "conv3x3_bias_act_f32_narrow",
          ("narrow", torch.bfloat16): "conv3x3_bias_act_bf16_narrow"}
# the narrow path's shapes: its bf16 products pad F to mma.sync's n = 8, and
# its bf16 kernel keeps the whole 9 x 64 x 8 weight in registers
NARROW_MAX_F = 8
NARROW_MAX_C = 64

LAUNCHES = 0
LAUNCHES_BY_PATH: Dict[str, int] = {"cuda_core": 0, "tensor_core": 0, "narrow": 0}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for path in LAUNCHES_BY_PATH:
        LAUNCHES_BY_PATH[path] = 0


def path_for(c: int, f: int, dtype: torch.dtype) -> str:
    """The kernel path for a C -> F conv in `dtype` (f32 or bf16): the
    narrow path takes F <= 8 with C a multiple of 16 up to 64, the tensor
    cores C and F multiples of 16 (bf16 WMMA's 16-deep fragments; f32's
    16-byte copies of 4-channel groups and n8 tile pairs), the CUDA cores
    the rest."""
    if f <= NARROW_MAX_F and c % 16 == 0 and c <= NARROW_MAX_C:
        return "narrow"
    if c % 16 == 0 and f % 16 == 0:
        return "tensor_core"
    return "cuda_core"


def tf32_round(t: torch.Tensor) -> torch.Tensor:
    """f32 `t` rounded as `cvt.rna.tf32.f32` rounds, bit for bit: to 10
    explicit mantissa bits, ties away from zero, the low 13 bits zero (add
    0x1000 to the magnitude's bit pattern, then clear those bits; a carry
    moves into the exponent). NaN stays NaN."""
    t = t.to(torch.float32).contiguous()
    bits = (t.view(torch.int32) + 0x1000) & -0x2000
    return torch.where(torch.isnan(t), t, bits.view(torch.float32))


def split_tf32(t: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(hi, lo), both tf32 values (low 13 bits zero), with hi + lo = t to
    about 2^-22 of |t|: hi = rna(t), lo = rna(t - hi)."""
    hi = tf32_round(t)
    return hi, tf32_round(t.to(torch.float32) - hi)


# the split weights of the f32 tensor-core entry, by weight: key ->
# (the weight, its split). Holding the weight keeps its storage alive, so a
# live entry's data_ptr names no other tensor; `_version` changes with any
# in-place write. Least recently used first; a model's convs fit many times.
_SPLIT_CACHE: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
_SPLIT_CACHE_SIZE = 256
_SPLIT_LOCK = threading.Lock()


def split_weight(kernel: torch.Tensor) -> torch.Tensor:
    """The f32 tensor-core entry's weight operand for an HWIO kernel (3, 3,
    C, F): (2, 9, F, C) f32 contiguous, hi then lo (`split_tf32` of the
    kernel in f32), each tap's rows the output channels with the C inputs
    contiguous. Split once per weight and cached until the weight changes
    (by its data_ptr, _version, dtype, device, shape and strides)."""
    key = (kernel.data_ptr(), kernel._version, kernel.dtype, kernel.device,
           tuple(kernel.shape), kernel.stride())
    with _SPLIT_LOCK:
        hit = _SPLIT_CACHE.get(key)
        if hit is not None:
            _SPLIT_CACHE.move_to_end(key)
            return hit[1]
    c, f = kernel.shape[2], kernel.shape[3]
    k = kernel.detach().to(torch.float32).reshape(9, c, f).transpose(1, 2)
    split = torch.stack(split_tf32(k)).contiguous()
    with _SPLIT_LOCK:
        _SPLIT_CACHE[key] = (kernel, split)
        while len(_SPLIT_CACHE) > _SPLIT_CACHE_SIZE:
            _SPLIT_CACHE.popitem(last=False)
    return split


def entry_weight(kernel: torch.Tensor, dtype: torch.dtype, path: str) -> torch.Tensor:
    """The weight operand of the (`path`, `dtype`) entry: the split weight
    for f32 on the tensor cores, else the kernel as (9 C, F) in `dtype`."""
    if (path, dtype) == ("tensor_core", torch.float32):
        return split_weight(kernel)
    c, f = kernel.shape[2], kernel.shape[3]
    return kernel.reshape(9 * c, f).to(dtype).contiguous()


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
         act: Optional[str], stream, path: str = "cuda_core") -> torch.Tensor:
    """Call entry point `fn`, the (`path`, x.dtype) entry, on checked
    operands; returns the output."""
    n, h, w, c = x.shape
    f = kernel.shape[3]
    kmat = entry_weight(kernel, x.dtype, path)
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
                   torch.cuda.current_stream().cuda_stream, path)
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_PATH[path] += 1
    return out
