"""KxK convolution with explicit zero pads and its weight gradient: the
hand-written CUDA kernels and their plain PyTorch versions.

The convolutions of the collapsed linear tail (ops/collapsed_tail.py),
which the JAX package leaves to XLA (larvanet_tpu/ops/collapsed_tail.py
`apply_collapsed_tail`): EDSR's tail folded into one 5x5 conv, its border
operators (4x5 and 5x4 on 4-pixel strips, and the corners as 4x4 convs of
a 4x4 patch), the input gradient of the live training tail and the
collapsed interpolated base. The public layout is the JAX one: x NHWC (N,
H, W, C), the kernel HWIO (kh, kw, C, F), the bias (F,) or None, `pads`
(top, bottom, left, right) of zeros, stride 1; the output is (N, H + top +
bottom - kh + 1, W + left + right - kw + 1, F). The sum is taken in f32 and
the result stored in x's dtype (f32 or bf16); the kernel is cast to x's
dtype and the bias to f32 first, as ops/conv3x3.py does.

`conv_kxk` launches `csrc/conv_kxk.cu` for a CUDA tensor and raises on
anything that kernel does not take; only a CPU tensor goes to
`conv_kxk_reference`. Two paths, chosen by shape (`path_for`), never by
retrying after a failure: "tensor_core" (C a multiple of 16; bf16 on
mma.sync m16n8k16, f32 in split TF32 on m16n8k8, F padded inside the
kernel) and "cuda_core" (any other C). `conv_kxk_wgrad` is the weight and
bias gradient (deterministic: the pixel sum cut into runs whose partial
sums a second kernel adds in order). `ConvKxKTrain` is the conv as a
`torch.autograd.Function`: its backward runs the input gradient as
`conv_kxk` on the kernel rotated by 180 degrees with C and F swapped and
the pads mirrored (`dgrad_kernel`, `dgrad_pads`), and dW and db on
`conv_kxk_wgrad`. `LAUNCHES` counts the forward kernel's launches,
`LAUNCHES_BY_PATH` each path's, `DGRAD_LAUNCHES_BY_PATH` those of them that
were input gradients, and `WGRAD_LAUNCHES` the weight gradient's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from larvanet_tpu_torch.ops import build

SOURCE = "conv_kxk.cu"
_ENTRY = {("cuda_core", torch.float32): "conv_kxk_f32",
          ("cuda_core", torch.bfloat16): "conv_kxk_bf16",
          ("tensor_core", torch.float32): "conv_kxk_f32_tc",
          ("tensor_core", torch.bfloat16): "conv_kxk_bf16_tc"}
_WGRAD_ENTRY = {torch.float32: "conv_kxk_wgrad_f32", torch.bfloat16: "conv_kxk_wgrad_bf16"}
# the weight gradient's tiles (rows of kh kw C + 1 by outputs) and the
# pixels a block takes a step, as in the source
WGRAD_TILE = (64, 64)
WGRAD_STEP = 16
# blocks per SM its split aims at, and the fewest pixels worth a split
BLOCKS_PER_SM = 4
MIN_CHUNK = 256

Pads = Tuple[int, int, int, int]

LAUNCHES = 0
LAUNCHES_BY_PATH: Dict[str, int] = {"cuda_core": 0, "tensor_core": 0}
DGRAD_LAUNCHES_BY_PATH: Dict[str, int] = {"cuda_core": 0, "tensor_core": 0}
WGRAD_LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES, WGRAD_LAUNCHES
    LAUNCHES = WGRAD_LAUNCHES = 0
    for counts in (LAUNCHES_BY_PATH, DGRAD_LAUNCHES_BY_PATH):
        for path in counts:
            counts[path] = 0


def path_for(c: int) -> str:
    """The kernel's path for C input channels: the tensor cores take C a
    multiple of 16 (a chunk of 16 bf16 or 8 f32 channels is one k-step of
    the products), the CUDA cores the rest."""
    return "tensor_core" if c % 16 == 0 else "cuda_core"


def same_pads(kh: int, kw: int) -> Pads:
    """The pads of a SAME conv of an odd kh x kw kernel."""
    return kh // 2, kh // 2, kw // 2, kw // 2


def out_size(h: int, w: int, kh: int, kw: int, pads: Sequence[int]) -> Tuple[int, int]:
    pt, pb, pl, pr = pads
    return h + pt + pb - kh + 1, w + pl + pr - kw + 1


def conv_kxk_reference(x: torch.Tensor, kernel: torch.Tensor,
                       bias: Optional[torch.Tensor] = None,
                       pads: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The plain version: one (M, C) x (C, F) product a tap of the padded
    x, summed in f32, plus the bias, stored in x's dtype."""
    kh, kw, c, f = kernel.shape
    pads = tuple(pads) if pads is not None else same_pads(kh, kw)
    n, h, w, _ = x.shape
    ho, wo = out_size(h, w, kh, kw, pads)
    k = kernel.to(x.dtype).float()
    pt, pb, pl, pr = pads
    xp = F.pad(x.float(), (0, 0, pl, pr, pt, pb))
    # built 4-D, so that the result is no view (ConvKxKTrain's output may be
    # written in place)
    acc = torch.zeros(n, ho, wo, f, dtype=torch.float32, device=x.device)
    for dy in range(kh):
        for dx in range(kw):
            tap = xp[:, dy:dy + ho, dx:dx + wo, :].reshape(n * ho * wo, c)
            acc = acc + (tap @ k[dy, dx]).reshape(n, ho, wo, f)
    if bias is not None:
        acc = acc + bias.float()
    return acc.to(x.dtype)


def conv_kxk_wgrad_reference(x: torch.Tensor, g: torch.Tensor, kh: int, kw: int,
                             pads: Optional[Sequence[int]] = None
                             ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the weight and bias gradient: per tap the
    shifted padded x transposed times g, and g summed over the pixels, in
    f32 (bf16 widened first, which is exact)."""
    pads = tuple(pads) if pads is not None else same_pads(kh, kw)
    n, h, w, c = x.shape
    ho, wo, f = g.shape[1], g.shape[2], g.shape[3]
    pt, pb, pl, pr = pads
    xp = F.pad(x.float(), (0, 0, pl, pr, pt, pb))
    g2 = g.float().reshape(n * ho * wo, f)
    taps = [xp[:, dy:dy + ho, dx:dx + wo, :].reshape(n * ho * wo, c).t() @ g2
            for dy in range(kh) for dx in range(kw)]
    return torch.stack(taps).reshape(kh, kw, c, f), g2.sum(0)


def entry_weight(kernel: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The entries' weight operand for an HWIO kernel (kh, kw, C, F): [kh
    kw][F][C] contiguous in `dtype`, so that a row of one output's channels
    is contiguous."""
    kh, kw, c, f = kernel.shape
    return kernel.to(dtype).reshape(kh * kw, c, f).transpose(1, 2).contiguous()


def bind(lib: ctypes.CDLL, dtype: torch.dtype, path: str = "tensor_core"):
    """The forward entry point of `lib` for (`path`, `dtype`), with its C
    signature."""
    fn = getattr(lib, _ENTRY[(path, dtype)])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 11 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bind_wgrad(lib: ctypes.CDLL, dtype: torch.dtype):
    """The weight-gradient entry point of `lib` for `dtype`."""
    fn = getattr(lib, _WGRAD_ENTRY[dtype])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype, path: str):
    return bind(build.load(SOURCE), dtype, path)


@functools.lru_cache(maxsize=None)
def _wgrad_entry(dtype: torch.dtype):
    return bind_wgrad(build.load(SOURCE), dtype)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _run(fn, x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
         pads: Sequence[int], stream) -> torch.Tensor:
    """Call forward entry point `fn` on checked operands; returns the
    output."""
    n, h, w, c = x.shape
    kh, kw, _, f = kernel.shape
    ho, wo = out_size(h, w, kh, kw, pads)
    kmat = entry_weight(kernel, x.dtype)
    b = (torch.zeros(f, dtype=torch.float32, device=x.device) if bias is None
         else bias.to(torch.float32).contiguous())
    out = torch.empty((n, ho, wo, f), dtype=x.dtype, device=x.device)
    err = fn(x.data_ptr(), kmat.data_ptr(), b.data_ptr(), out.data_ptr(), n, h, w, c, kh, kw,
             f, *pads, stream)
    if err != 0:
        raise RuntimeError("conv_kxk kernel launch failed: CUDA error %d" % err)
    return out


def wgrad_splits(m: int, rows: int, f: int, sms: int) -> Tuple[int, int]:
    """(splits, chunk): the pixel sum of M output pixels cut into `splits`
    runs of `chunk` pixels (a multiple of the kernel's step; the last run
    may be shorter, none is empty), enough for BLOCKS_PER_SM blocks on each
    of `sms` SMs together with the output tiles, none shorter than
    MIN_CHUNK pixels unless M is."""
    br, bf = WGRAD_TILE
    tiles = -(-rows // br) * -(-f // bf)
    splits = max(1, min(-(-BLOCKS_PER_SM * sms // tiles), m // MIN_CHUNK))
    chunk = -(-(-(-m // splits)) // WGRAD_STEP) * WGRAD_STEP
    return -(-m // chunk), chunk


def _run_wgrad(fn, x: torch.Tensor, g: torch.Tensor, kh: int, kw: int, pads: Sequence[int],
               splits: int, chunk: int, stream) -> Tuple[torch.Tensor, torch.Tensor]:
    """Call weight-gradient entry point `fn` with the pixel sum cut into
    `splits` runs of `chunk`; returns (dW HWIO, db), f32."""
    n, h, w, c = x.shape
    f = g.shape[3]
    rows = kh * kw * c + 1
    ws = torch.empty((splits, rows, f), dtype=torch.float32, device=x.device)
    out = torch.empty((rows, f), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), g.data_ptr(), ws.data_ptr(), out.data_ptr(), n, h, w, c, kh, kw, f,
             *pads, splits, chunk, stream)
    if err != 0:
        raise RuntimeError("conv_kxk_wgrad kernel launch failed: CUDA error %d" % err)
    return out[:rows - 1].view(kh, kw, c, f), out[rows - 1]


def _check(x: torch.Tensor, name: str) -> None:
    if x.device.type != "cuda":
        raise ValueError("%s runs on CUDA or the CPU, not %s" % (name, x.device))
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("%s takes float32 or bfloat16, got %s" % (name, x.dtype))
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("%s takes contiguous NHWC tensors, got shape %s"
                         % (name, tuple(x.shape)))


def _check_pads(pads: Sequence[int], kh: int, kw: int, h: int, w: int) -> Pads:
    pads = tuple(int(p) for p in pads)
    if len(pads) != 4 or min(pads) < 0:
        raise ValueError("pads must be 4 values >= 0 (top, bottom, left, right), got %s"
                         % (pads,))
    ho, wo = out_size(h, w, kh, kw, pads)
    if ho <= 0 or wo <= 0:
        raise ValueError("a %dx%d kernel with pads %s leaves no output of a %dx%d input"
                         % (kh, kw, pads, h, w))
    return pads


def conv_kxk(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None,
             pads: Optional[Sequence[int]] = None, dgrad: bool = False) -> torch.Tensor:
    """KxK conv + bias with explicit zero pads (default: SAME for an odd
    kernel). CUDA tensor: the hand-written kernel; CPU tensor: the plain
    version. `dgrad` marks an input gradient (`ConvKxKTrain.backward`),
    counted in DGRAD_LAUNCHES_BY_PATH as well."""
    if kernel.dim() != 4:
        raise ValueError("kernel must be HWIO (kh, kw, C, F), got %s" % (tuple(kernel.shape),))
    kh, kw = kernel.shape[:2]
    pads = tuple(pads) if pads is not None else same_pads(kh, kw)
    if x.device.type == "cpu":
        return conv_kxk_reference(x, kernel, bias, pads)
    _check(x, "conv_kxk")
    n, h, w, c = x.shape
    if kernel.shape[2] != c:
        raise ValueError("kernel must be HWIO (kh, kw, %d, F), got %s"
                         % (c, tuple(kernel.shape)))
    f = kernel.shape[3]
    if bias is not None and bias.shape != (f,):
        raise ValueError("bias must be (%d,), got %s" % (f, tuple(bias.shape)))
    if n * h * w == 0 or f == 0:
        raise ValueError("empty conv: x %s, F %d" % (tuple(x.shape), f))
    if kernel.device != x.device or (bias is not None and bias.device != x.device):
        raise ValueError("x, kernel and bias must be on one device")
    pads = _check_pads(pads, kh, kw, h, w)
    path = path_for(c)
    with torch.cuda.device(x.device):
        out = _run(_entry(x.dtype, path), x, kernel, bias, pads,
                   torch.cuda.current_stream().cuda_stream)
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_PATH[path] += 1
    if dgrad:
        DGRAD_LAUNCHES_BY_PATH[path] += 1
    return out


def conv_kxk_wgrad(x: torch.Tensor, g: torch.Tensor, kh: int, kw: int,
                   pads: Optional[Sequence[int]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dW HWIO (kh, kw, C, F), db (F,)), both f32, of the conv of x with
    `pads` whose output gradient (before the bias) is g; x and g f32 or
    bf16, of one dtype. CUDA tensors: the hand-written kernel; CPU
    tensors: the plain version."""
    pads = tuple(pads) if pads is not None else same_pads(kh, kw)
    if x.device.type == "cpu":
        return conv_kxk_wgrad_reference(x, g, kh, kw, pads)
    _check(x, "conv_kxk_wgrad")
    _check(g, "conv_kxk_wgrad")
    if x.dtype != g.dtype or g.device != x.device:
        raise TypeError("x and g must share a dtype and a device, got %s on %s and %s on %s"
                        % (x.dtype, x.device, g.dtype, g.device))
    n, h, w, c = x.shape
    pads = _check_pads(pads, kh, kw, h, w)
    ho, wo = out_size(h, w, kh, kw, pads)
    if g.shape[:3] != (n, ho, wo):
        raise ValueError("g must be (%d, %d, %d, F) for x %s, got %s"
                         % (n, ho, wo, tuple(x.shape), tuple(g.shape)))
    f = g.shape[3]
    if n * h * w == 0 or c == 0 or f == 0:
        raise ValueError("empty conv: x %s, F %d" % (tuple(x.shape), f))
    with torch.cuda.device(x.device):
        splits, chunk = wgrad_splits(n * ho * wo, kh * kw * c + 1, f,
                                     _sm_count(torch.cuda.current_device()))
        out = _run_wgrad(_wgrad_entry(x.dtype), x, g, kh, kw, pads, splits, chunk,
                         torch.cuda.current_stream().cuda_stream)
    global WGRAD_LAUNCHES
    WGRAD_LAUNCHES += 1
    return out


def dgrad_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """The HWIO kernel of the input gradient of a conv with HWIO `kernel`
    (kh, kw, C, F): rotated by 180 degrees, C and F swapped, (kh, kw, F,
    C)."""
    return kernel.flip(0, 1).transpose(2, 3).contiguous()


def dgrad_pads(kh: int, kw: int, pads: Sequence[int]) -> Pads:
    """The pads of the input gradient's conv: each side's pad mirrored, k -
    1 - pad, so that its output is the input's size (pads <= k - 1)."""
    pt, pb, pl, pr = pads
    out = (kh - 1 - pt, kh - 1 - pb, kw - 1 - pl, kw - 1 - pr)
    if min(out) < 0:
        raise ValueError("the input gradient needs pads <= k - 1, got %s for %dx%d"
                         % (tuple(pads), kh, kw))
    return out


class ConvKxKTrain(torch.autograd.Function):
    """`conv_kxk` with a backward: dgrad on the same conv kernel (the
    rotated kernel, mirrored pads), dW and db on `conv_kxk_wgrad`. Inputs x
    NHWC, the HWIO kernel, the bias or None, the pads; the gradients come
    back in their dtypes (a bf16 kernel's: the f32 sums rounded to bf16)."""

    @staticmethod
    def forward(ctx, x, kernel, bias, pads):
        ctx.pads = tuple(pads)
        ctx.bias_dtype = None if bias is None else bias.dtype
        ctx.save_for_backward(x, kernel)
        return conv_kxk(x, kernel, bias, pads)

    @staticmethod
    def backward(ctx, grad_out):
        x, kernel = ctx.saved_tensors
        g = grad_out.contiguous()
        kh, kw = kernel.shape[:2]
        grad_x = grad_k = grad_b = None
        if ctx.needs_input_grad[0]:
            grad_x = conv_kxk(g, dgrad_kernel(kernel).to(g.dtype), None,
                              dgrad_pads(kh, kw, ctx.pads), dgrad=True)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            dw, db = conv_kxk_wgrad(x, g.to(x.dtype), kh, kw, ctx.pads)
            grad_k = dw.to(kernel.dtype)
            grad_b = None if ctx.bias_dtype is None else db.to(ctx.bias_dtype)
        return grad_x, grad_k, grad_b, None


def conv_kxk_op(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor] = None,
                pads: Optional[Sequence[int]] = None) -> torch.Tensor:
    """`conv_kxk`, through `ConvKxKTrain` where autograd wants a gradient
    of x, the kernel or the bias."""
    kh, kw = kernel.shape[:2]
    pads = tuple(pads) if pads is not None else same_pads(kh, kw)
    x = x.contiguous()
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, kernel, bias)):
        return ConvKxKTrain.apply(x, kernel, bias, pads)
    return conv_kxk(x, kernel, bias, pads)
