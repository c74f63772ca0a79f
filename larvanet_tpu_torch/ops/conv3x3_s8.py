"""The int8 conv of the W8A8 conv pair: the hand-written CUDA kernel
(`csrc/conv3x3_s8.cu`, s8 x s8 -> s32 on the tensor cores) and its plain
version.

A SAME 3x3 conv of int8 codes, NHWC x HWIO, with exact integer sums, and
the pair's epilogues (larvanet_tpu/ops/packed/pairs.py:229-256,
`pair_int8`), T the residual stream's dtype (f32 or bf16):

  conv_a(hin, wa, s_in, s_mid): xq = clip(rint(f32(hin) / s_in), -127,
      127); t = act(T(T(f32(conv(xq, ka)) * sca) + ba)); returns the int8
      codes clip(rint(f32(t) / s_mid), -127, 127). act: None, relu, relu6
      (clip to [0, 6]) or leaky_relu, t >= 0 ? t : T(T(slope) * t), as
      jax.nn.leaky_relu computes it in T (its weak-typed slope is T's)
  conv_b(tq, wb, dtype, res, res_weight): t = T(T(f32(conv(tq, kb)) * scb)
      + bb), times T(res_weight) when it is not 1, plus `res` when given

with sca = f32(s_in) * sa and scb = f32(s_mid) * sb (`S8Weight.scale`, f32
products taken once on the host). Every step is one IEEE operation, so the
kernel equals the plain version bit for bit.

`conv_a` and `conv_b` launch the kernel for a CUDA tensor and raise on
anything it does not take; only a CPU tensor goes to the plain version
(`conv_a_reference`, `conv_b_reference`: the conv of the codes in float64,
exact below 2^53, then the epilogue in torch ops). `LAUNCHES` counts the
kernel's launches and `LAUNCHES_BY_ENTRY` each entry's.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from larvanet_tpu_torch.ops import build

SOURCE = "conv3x3_s8.cu"
ACTS = {None: 0, "relu": 1, "leaky_relu": 2, "relu6": 3}
_ENTRY = {("conv_a", torch.float32): "conv3x3_s8_a_f32",
          ("conv_a", torch.bfloat16): "conv3x3_s8_a_bf16",
          ("conv_b", torch.float32): "conv3x3_s8_b_f32",
          ("conv_b", torch.bfloat16): "conv3x3_s8_b_bf16"}
BLOCK_N = 16  # the products' N: the entry weight pads F to it
CHUNK_K = 32  # input codes of a k32 step: the entry weight pads C to it

LAUNCHES = 0
LAUNCHES_BY_ENTRY: Dict[str, int] = {"conv_a": 0, "conv_b": 0}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for entry in LAUNCHES_BY_ENTRY:
        LAUNCHES_BY_ENTRY[entry] = 0


def quantize_weight(kernel) -> tuple:
    """Per-output-channel symmetric int8 codes of an HWIO kernel (3, 3, C,
    F), as JAX's `_quantize_pair_weights` (pairs.py:169-182) takes them, in
    numpy f32: sa = max|k[..., f]| / 127 + 1e-12 and codes rint(k / sa).
    Returns (codes int8 (3, 3, C, F), sa f32 (F,))."""
    k = np.asarray(kernel, np.float32)
    sa = np.abs(k).max(axis=(0, 1, 2)) / 127.0 + 1e-12
    return np.rint(k / sa).astype(np.int8), sa.astype(np.float32)


@dataclass
class S8Weight:
    """One conv of a quantized pair: its int8 HWIO codes, the per-channel f32
    `scale` (f32(s) * sa for the conv's input scale s) and the bias as the
    dtype holds it, on one device. `entry` is the kernel's weight operand,
    made on first use: the codes with F padded to Fp (a multiple of
    BLOCK_N) and C to Cp (of CHUNK_K) with zeros, as [9][Cp/32][Fp/8][2][8]
    [16] int8 (tap, k32 step, 8-output group, 16-code half, output, code):
    each 8 outputs x 16 codes a contiguous 128-byte core matrix, which the
    kernel's ldmatrix reads as it lies."""

    codes: torch.Tensor
    scale: torch.Tensor
    bias: torch.Tensor
    _entry: Optional[torch.Tensor] = None

    @property
    def entry(self) -> torch.Tensor:
        if self._entry is None:
            c, f = self.codes.shape[2], self.codes.shape[3]
            cp = -(-c // CHUNK_K) * CHUNK_K
            fp = -(-f // BLOCK_N) * BLOCK_N
            w = torch.zeros((9, cp, fp), dtype=torch.int8, device=self.codes.device)
            w[:, :c, :f] = self.codes.reshape(9, c, f)
            # (tap, step, half, code, group, output) -> (tap, step, group, half, output, code)
            w = w.reshape(9, cp // 32, 2, 16, fp // 8, 8).permute(0, 1, 4, 2, 5, 3)
            self._entry = w.contiguous()
        return self._entry


def make_weight(codes: np.ndarray, sa: np.ndarray, s: float, bias: torch.Tensor,
                dtype: torch.dtype, device) -> S8Weight:
    """The S8Weight of one conv: `codes` and `sa` from `quantize_weight`,
    `s` its input's scale (a float; the product is taken as JAX takes it,
    f32(s) * sa in f32), `bias` rounded to `dtype`."""
    scale = np.float32(s) * np.asarray(sa, np.float32)
    return S8Weight(torch.from_numpy(np.ascontiguousarray(codes)).to(device),
                    torch.from_numpy(scale.astype(np.float32)).to(device),
                    bias.detach().to(device=device, dtype=dtype).float())


def _scalar(v: float, like: torch.Tensor) -> torch.Tensor:
    # a one-element tensor on x's device: a division by it is a true IEEE
    # division (a CPU scalar divisor may become a multiply by its reciprocal)
    return torch.tensor([np.float32(v)], dtype=torch.float32, device=like.device)


def quantize(x: torch.Tensor, s: float) -> torch.Tensor:
    """clip(rint(f32(x) / s), -127, 127) as int8, s taken as f32."""
    q = torch.round(x.float() / _scalar(s, x))
    return torch.clamp(q, -127, 127).to(torch.int8)


def conv_codes_reference(xq: torch.Tensor, codes: torch.Tensor) -> torch.Tensor:
    """The SAME 3x3 conv of int8 codes (N, H, W, C) with int8 HWIO codes, in
    float64 (every sum is an integer below 2^53: exact), as f32 (the integer
    rounded to nearest even, as an int32 -> f32 conversion rounds)."""
    n, h, w, c = xq.shape
    f = codes.shape[-1]
    k = codes.to(torch.float64)
    xp = F.pad(xq.to(torch.float64), (0, 0, 1, 1, 1, 1))
    acc = torch.zeros(n * h * w, f, dtype=torch.float64, device=xq.device)
    for dy in range(3):
        for dx in range(3):
            acc = acc + xp[:, dy:dy + h, dx:dx + w, :].reshape(n * h * w, c) @ k[dy, dx]
    return acc.reshape(n, h, w, f).to(torch.float32)


def _dequant(acc: torch.Tensor, wt: S8Weight, dtype: torch.dtype) -> torch.Tensor:
    """T(T(acc * scale) + bias), each step rounded to `dtype`."""
    return (acc * wt.scale).to(dtype) + wt.bias.to(dtype)


def activate(t: torch.Tensor, act: Optional[str], slope: float = 0.1) -> torch.Tensor:
    """conv_a's activation on T-typed values, one IEEE operation in T where it
    computes (leaky_relu's product of two T values, rounded once)."""
    if act == "relu":
        return torch.relu(t)
    if act == "relu6":
        return torch.clamp(t, 0.0, 6.0)
    if act == "leaky_relu":
        return torch.where(t >= 0, t, t * torch.tensor(slope, dtype=t.dtype, device=t.device))
    return t


def conv_a_reference(hin: torch.Tensor, wt: S8Weight, s_in: float, s_mid: float,
                     act: Optional[str] = "relu", slope: float = 0.1) -> torch.Tensor:
    """The plain version of the conv_a entry (the module docstring)."""
    t = _dequant(conv_codes_reference(quantize(hin, s_in), wt.codes), wt, hin.dtype)
    return quantize(activate(t, act, slope), s_mid)


def conv_b_reference(tq: torch.Tensor, wt: S8Weight, dtype: torch.dtype,
                     res: Optional[torch.Tensor] = None,
                     res_weight: float = 1.0) -> torch.Tensor:
    """The plain version of the conv_b entry (the module docstring)."""
    t = _dequant(conv_codes_reference(tq, wt.codes), wt, dtype)
    if res_weight != 1.0:
        t = t * torch.tensor(res_weight, dtype=dtype, device=t.device)
    return t if res is None else res + t


def bind(lib: ctypes.CDLL, entry: str, dtype: torch.dtype):
    """The (`entry`, `dtype`) entry point of `lib` with its C signature."""
    fn = getattr(lib, _ENTRY[(entry, dtype)])
    if entry == "conv_a":
        fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5
                       + [ctypes.c_float] * 2 + [ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    else:
        fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                       + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _entry(entry: str, dtype: torch.dtype):
    return bind(build.load(SOURCE), entry, dtype)


def _check(x: torch.Tensor, wt: S8Weight, dtypes, name: str) -> None:
    if x.dtype not in dtypes:
        raise TypeError("%s takes %s, got %s" % (name, " or ".join(map(str, dtypes)), x.dtype))
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("%s: x must be a contiguous NHWC tensor, got shape %s"
                         % (name, tuple(x.shape)))
    if wt.codes.dim() != 4 or tuple(wt.codes.shape[:3]) != (3, 3, x.shape[3]):
        raise ValueError("%s: codes must be HWIO (3, 3, %d, F), got %s"
                         % (name, x.shape[3], tuple(wt.codes.shape)))
    f = wt.codes.shape[3]
    if tuple(wt.scale.shape) != (f,) or tuple(wt.bias.shape) != (f,):
        raise ValueError("%s: scale and bias must be (%d,), got %s and %s"
                         % (name, f, tuple(wt.scale.shape), tuple(wt.bias.shape)))
    if x.numel() == 0:
        raise ValueError("%s: empty input %s" % (name, tuple(x.shape)))
    for t in (wt.codes, wt.scale, wt.bias):
        if t.device != x.device:
            raise ValueError("%s: x and the weight must be on one device" % (name,))


def _run_a(fn, hin, wt, s_in, s_mid, act, stream, slope: float = 0.1) -> torch.Tensor:
    n, h, w, c = hin.shape
    f = wt.codes.shape[3]
    out = torch.empty((n, h, w, f), dtype=torch.int8, device=hin.device)
    err = fn(hin.data_ptr(), wt.entry.data_ptr(), wt.scale.data_ptr(), wt.bias.data_ptr(),
             out.data_ptr(), n, h, w, c, f, float(np.float32(s_in)), float(np.float32(s_mid)),
             ACTS[act], float(slope), stream)
    if err != 0:
        raise RuntimeError("conv3x3_s8 conv_a launch failed: CUDA error %d" % err)
    return out


def _run_b(fn, tq, wt, dtype, res, res_weight, stream) -> torch.Tensor:
    n, h, w, c = tq.shape
    f = wt.codes.shape[3]
    out = torch.empty((n, h, w, f), dtype=dtype, device=tq.device)
    err = fn(tq.data_ptr(), wt.entry.data_ptr(), wt.scale.data_ptr(), wt.bias.data_ptr(),
             None if res is None else res.data_ptr(), out.data_ptr(), n, h, w, c, f,
             float(res_weight), int(res_weight != 1.0), stream)
    if err != 0:
        raise RuntimeError("conv3x3_s8 conv_b launch failed: CUDA error %d" % err)
    return out


def _count(entry: str) -> None:
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_ENTRY[entry] += 1


def check_a(hin: torch.Tensor, wt: S8Weight, act: Optional[str]) -> None:
    """conv_a's checks on shapes, dtypes and devices: the wrapper's and the
    registered op's fake body's (ops/library.py)."""
    if act not in ACTS:
        raise ValueError("conv3x3_s8 takes act %s, got %r" % (sorted(map(str, ACTS)), act))
    _check(hin, wt, (torch.float32, torch.bfloat16), "conv_a")


def check_b(tq: torch.Tensor, wt: S8Weight, dtype: torch.dtype,
            res: Optional[torch.Tensor]) -> None:
    """conv_b's checks on shapes, dtypes and devices: the wrapper's and the
    registered op's fake body's."""
    _check(tq, wt, (torch.int8,), "conv_b")
    if dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("conv_b writes float32 or bfloat16, got %s" % (dtype,))
    if res is not None:
        f = wt.codes.shape[3]
        if (res.dtype != dtype or not res.is_contiguous() or res.device != tq.device
                or tuple(res.shape) != tuple(tq.shape[:3]) + (f,)):
            raise ValueError("conv_b: res must be a contiguous %s tensor of shape %s on %s"
                             % (dtype, tuple(tq.shape[:3]) + (f,), tq.device))


def conv_a_cuda(hin: torch.Tensor, wt: S8Weight, s_in: float, s_mid: float,
                act: Optional[str] = "relu", slope: float = 0.1) -> torch.Tensor:
    """conv_a's launch on checked CUDA operands, counted: the wrapper's CUDA
    route and the registered op's CUDA body."""
    with torch.cuda.device(hin.device):
        out = _run_a(_entry("conv_a", hin.dtype), hin, wt, s_in, s_mid, act,
                     torch.cuda.current_stream().cuda_stream, slope)
    _count("conv_a")
    return out


def conv_b_cuda(tq: torch.Tensor, wt: S8Weight, dtype: torch.dtype,
                res: Optional[torch.Tensor] = None, res_weight: float = 1.0) -> torch.Tensor:
    """conv_b's launch on checked CUDA operands, counted: the wrapper's CUDA
    route and the registered op's CUDA body."""
    with torch.cuda.device(tq.device):
        out = _run_b(_entry("conv_b", dtype), tq, wt, dtype, res, res_weight,
                     torch.cuda.current_stream().cuda_stream)
    _count("conv_b")
    return out


def conv_a(hin: torch.Tensor, wt: S8Weight, s_in: float, s_mid: float,
           act: Optional[str] = "relu", slope: float = 0.1) -> torch.Tensor:
    """The pair's first conv: hin (f32 or bf16 NHWC) -> int8 codes of its
    requantized output (leaky_relu at `slope`). CUDA tensor: the kernel;
    CPU tensor: the plain version; under torch.export, the registered op
    `larvanet.conv3x3_s8_a` (ops/library.py), which runs the same two."""
    if act not in ACTS:
        raise ValueError("conv3x3_s8 takes act %s, got %r" % (sorted(map(str, ACTS)), act))
    if torch.compiler.is_exporting():
        from larvanet_tpu_torch.ops import library

        return library.conv3x3_s8_a(hin, wt, s_in, s_mid, act, slope)
    if hin.device.type == "cpu":
        return conv_a_reference(hin, wt, s_in, s_mid, act, slope)
    if hin.device.type != "cuda":
        raise ValueError("conv3x3_s8 runs on CUDA or the CPU, not %s" % (hin.device,))
    check_a(hin, wt, act)
    return conv_a_cuda(hin, wt, s_in, s_mid, act, slope)


def conv_b(tq: torch.Tensor, wt: S8Weight, dtype: torch.dtype,
           res: Optional[torch.Tensor] = None, res_weight: float = 1.0) -> torch.Tensor:
    """The pair's second conv: int8 codes (NHWC) -> `dtype`, times
    res_weight, plus `res` (in `dtype`, the output's shape) when given.
    CUDA tensor: the kernel; CPU tensor: the plain version; under
    torch.export, the registered op `larvanet.conv3x3_s8_b`."""
    if torch.compiler.is_exporting():
        from larvanet_tpu_torch.ops import library

        return library.conv3x3_s8_b(tq, wt, dtype, res, res_weight)
    if tq.device.type == "cpu":
        return conv_b_reference(tq, wt, dtype, res, res_weight)
    if tq.device.type != "cuda":
        raise ValueError("conv3x3_s8 runs on CUDA or the CPU, not %s" % (tq.device,))
    check_b(tq, wt, dtype, res)
    return conv_b_cuda(tq, wt, dtype, res, res_weight)
