"""Depthwise SAME 3x3 conv (groups = C), its input gradient and its weight
gradient: the hand-written CUDA kernel and its plain PyTorch version.

The conv of DWSR's depthwise-separable ResBlock (larvanet_tpu/models/
layers.py:199-227, `DepthwiseSeparableResBlock`), which the JAX package runs
as XLA's `feature_group_count` conv. The public layout is the JAX one: x
NHWC (N, H, W, C), flax's HWIO kernel (3, 3, 1, C), the bias (C,):

    y[n, h, w, c] = sum_{dy, dx} x[n, h + dy - 1, w + dx - 1, c] k[dy, dx, 0, c] + b[c]

with zeros outside the image, the nine products summed in f32 in one fixed
order (tap (dy, dx) row-major, from 0) and the bias added last, stored in
x's dtype (f32 or bf16); the kernel is cast to x's dtype and the bias to f32
first, as ops/conv3x3.py does. The kernel (`csrc/dwconv3x3.cu`) takes the
same steps as the plain version, so the two agree bit for bit.

`dwconv3x3` launches the kernel for a CUDA tensor and raises on anything it
does not take; only a CPU tensor goes to `dwconv3x3_reference`. The input
gradient is the same entry with the taps rotated by 180 degrees and no bias
(`dgrad=True`). `dwconv3x3_wgrad` gives dk (3, 3, 1, C) and db (C,) in f32
(per-block partial sums over runs of rows, added in a fixed order by a
second kernel: the same bits on every run); `dwconv3x3_wgrad_reference` is
its plain version. `plan` reads the tile an entry picks for a shape.
`DWConv3x3Train` is the conv as a `torch.autograd.Function` whose forward,
dgrad and wgrad run on the kernels.
`LAUNCHES_BY_ENTRY` counts the wrapper's launches by entry ("forward",
"dgrad", "wgrad").

MAMNet's CSD (larvanet_tpu/models/mamnet.py:44-45) is the same depthwise
3x3 conv at 64 channels.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from larvanet_tpu_torch.ops import build

SOURCE = "dwconv3x3.cu"
_ENTRY = {("forward", torch.float32): "dwconv3x3_f32",
          ("forward", torch.bfloat16): "dwconv3x3_bf16",
          ("wgrad", torch.float32): "dwconv3x3_wgrad_f32",
          ("wgrad", torch.bfloat16): "dwconv3x3_wgrad_bf16"}
# the most blocks the weight gradient takes, over all its channel chunks
# (each writes 10 C partial sums): two to each of the H100's 132 SMs, all in
# one wave (the kernel also keeps each block's run to 8 rows at least)
WGRAD_BLOCKS = 264
# what `plan` reports, in the entry's order
PLAN_KEYS = ("vector", "groups", "chunks", "tile_w", "tiles_w", "ring_slots",
             "cols_a_thread", "copy_vectors", "runs")

LAUNCHES = 0
LAUNCHES_BY_ENTRY: Dict[str, int] = {"forward": 0, "dgrad": 0, "wgrad": 0}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for entry in LAUNCHES_BY_ENTRY:
        LAUNCHES_BY_ENTRY[entry] = 0


def _taps(x: torch.Tensor):
    """The nine SAME taps of NHWC x in f32, (dy, dx) row-major."""
    n, h, w, _ = x.shape
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    return [xp[:, dy:dy + h, dx:dx + w, :] for dy in range(3) for dx in range(3)]


def dwconv3x3_reference(x: torch.Tensor, kernel: torch.Tensor,
                        bias: torch.Tensor) -> torch.Tensor:
    """The plain version: nine shifted multiply-adds in f32, from 0, then the
    bias, rounded to x's dtype once."""
    k = kernel.to(x.dtype).float().reshape(9, -1)
    acc = torch.zeros(x.shape, dtype=torch.float32, device=x.device)
    for t, tap in enumerate(_taps(x)):
        acc = acc + tap * k[t]
    return (acc + bias.float()).to(x.dtype)


def dwconv3x3_wgrad_reference(x: torch.Tensor, g: torch.Tensor
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version of the weight gradient: (dk (3, 3, 1, C), db (C,)),
    each tap's products of x and g summed over the pixels in f32."""
    gf = g.float()
    dk = torch.stack([(tap * gf).sum(dim=(0, 1, 2)) for tap in _taps(x)])
    return dk.reshape(3, 3, 1, -1), gf.sum(dim=(0, 1, 2))


def dgrad_kernel(kernel: torch.Tensor) -> torch.Tensor:
    """The taps of the input gradient: `kernel` rotated by 180 degrees."""
    return kernel.flip(0, 1).contiguous()


def bind(lib: ctypes.CDLL, entry: str, dtype: torch.dtype):
    """The (`entry`, `dtype`) entry point of `lib` ("forward" or "wgrad")
    with its C signature."""
    fn = getattr(lib, _ENTRY[(entry, dtype)])
    if entry == "forward":
        fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [ctypes.c_void_p]
    else:
        fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def plan(lib: ctypes.CDLL, ptrs, dtype: torch.dtype, shape, entry: str = "forward",
         max_blocks: int = WGRAD_BLOCKS) -> Dict[str, int]:
    """The tile `lib`'s `entry` ("forward" or "wgrad", the latter at most
    `max_blocks` blocks) takes for an NHWC `shape` of `dtype` whose operands
    lie at the three data pointers `ptrs` (the forward's x, k, y; the
    wgrad's x, g, g), as the entry's own launch path works it out:
    {PLAN_KEYS: ...}."""
    fn = lib.dwconv3x3_plan
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    out = (ctypes.c_int * len(PLAN_KEYS))()
    item = 4 if dtype == torch.float32 else 2
    if fn(*ptrs, item, *shape, int(entry == "wgrad"), max_blocks, out) != 0:
        raise ValueError("dwconv3x3 has no plan for %s %s" % (tuple(shape), dtype))
    return dict(zip(PLAN_KEYS, out))


@functools.lru_cache(maxsize=None)
def _entry(entry: str, dtype: torch.dtype):
    return bind(build.load(SOURCE), entry, dtype)


def _check(x: torch.Tensor, name: str) -> None:
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("%s takes float32 or bfloat16, got %s" % (name, x.dtype))
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("%s: x must be a contiguous NHWC tensor, got shape %s"
                         % (name, tuple(x.shape)))
    if x.numel() == 0:
        raise ValueError("%s: empty input %s" % (name, tuple(x.shape)))


def _run(fn, x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
         stream) -> torch.Tensor:
    """Call the forward entry `fn` (of x's dtype) on checked operands."""
    n, h, w, c = x.shape
    k = kernel.to(x.dtype).contiguous()
    b = bias.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    err = fn(x.data_ptr(), k.data_ptr(), b.data_ptr(), out.data_ptr(), n, h, w, c, stream)
    if err != 0:
        raise RuntimeError("dwconv3x3 kernel launch failed: CUDA error %d" % err)
    return out


def _run_wgrad(fn, x: torch.Tensor, g: torch.Tensor, stream,
               blocks: int = WGRAD_BLOCKS) -> Tuple[torch.Tensor, torch.Tensor]:
    """Call the weight-gradient entry `fn` on checked operands, with a
    workspace of `blocks` rows."""
    n, h, w, c = x.shape
    part = torch.empty((blocks, 10, c), dtype=torch.float32, device=x.device)
    dk = torch.empty((3, 3, 1, c), dtype=torch.float32, device=x.device)
    db = torch.empty((c,), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), g.data_ptr(), part.data_ptr(), dk.data_ptr(), db.data_ptr(),
             n, h, w, c, blocks, stream)
    if err != 0:
        raise RuntimeError("dwconv3x3_wgrad kernel launch failed: CUDA error %d" % err)
    return dk, db


def _count(entry: str) -> None:
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_ENTRY[entry] += 1


def check_operands(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> None:
    """The forward's checks on shapes, dtypes and devices: the wrapper's
    and the registered op's fake body's (ops/library.py)."""
    _check(x, "dwconv3x3")
    c = x.shape[3]
    if tuple(kernel.shape) != (3, 3, 1, c) or tuple(bias.shape) != (c,):
        raise ValueError("dwconv3x3: kernel must be (3, 3, 1, %d) and bias (%d,), got %s "
                         "and %s" % (c, c, tuple(kernel.shape), tuple(bias.shape)))
    if kernel.device != x.device or bias.device != x.device:
        raise ValueError("dwconv3x3: x, kernel and bias must be on one device")


def dwconv3x3_cuda(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                   dgrad: bool = False) -> torch.Tensor:
    """The forward entry's launch on checked CUDA operands, counted (as an
    input gradient where `dgrad`): the wrapper's CUDA route and the
    registered op's CUDA body."""
    with torch.cuda.device(x.device):
        out = _run(_entry("forward", x.dtype), x, kernel, bias,
                   torch.cuda.current_stream().cuda_stream)
    _count("dgrad" if dgrad else "forward")
    return out


def dwconv3x3(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
              dgrad: bool = False) -> torch.Tensor:
    """The depthwise SAME 3x3 conv + bias. CUDA tensor: the hand-written
    kernel; CPU tensor: the plain version; under torch.export, the
    registered op `larvanet.dwconv3x3` (ops/library.py), which runs the
    same two. `dgrad` marks an input gradient
    (`DWConv3x3Train.backward`), counted as such."""
    if torch.compiler.is_exporting():
        from larvanet_tpu_torch.ops import library

        return library.dwconv3x3(x, kernel, bias)
    if x.device.type == "cpu":
        return dwconv3x3_reference(x, kernel, bias)
    if x.device.type != "cuda":
        raise ValueError("dwconv3x3 runs on CUDA or the CPU, not %s" % (x.device,))
    check_operands(x, kernel, bias)
    return dwconv3x3_cuda(x, kernel, bias, dgrad)


def dwconv3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk (3, 3, 1, C), db (C,)), f32, of the depthwise conv of x whose
    output's gradient (before the bias) is g; x and g of one dtype. CUDA
    tensors: the hand-written kernel; CPU tensors: the plain version."""
    if x.device.type == "cpu":
        return dwconv3x3_wgrad_reference(x, g)
    if x.device.type != "cuda":
        raise ValueError("dwconv3x3_wgrad runs on CUDA or the CPU, not %s" % (x.device,))
    _check(x, "dwconv3x3_wgrad")
    if g.dtype != x.dtype or tuple(g.shape) != tuple(x.shape) or not g.is_contiguous():
        raise ValueError("dwconv3x3_wgrad: g must be a contiguous %s tensor of shape %s"
                         % (x.dtype, tuple(x.shape)))
    if g.device != x.device:
        raise ValueError("dwconv3x3_wgrad: x and g must be on one device")
    with torch.cuda.device(x.device):
        out = _run_wgrad(_entry("wgrad", x.dtype), x, g,
                         torch.cuda.current_stream().cuda_stream)
    _count("wgrad")
    return out


class DWConv3x3Train(torch.autograd.Function):
    """`dwconv3x3` with a backward on the same kernels: the input gradient
    on the forward entry with the rotated taps and a zero bias, the weight
    and bias gradient on `dwconv3x3_wgrad`; the gradients come back in the
    kernel's and bias's dtypes (a bf16 step's: the f32 sums rounded)."""

    @staticmethod
    def forward(ctx, x, kernel, bias):
        ctx.bias_dtype = bias.dtype
        ctx.save_for_backward(x, kernel)
        return dwconv3x3(x, kernel, bias)

    @staticmethod
    def backward(ctx, grad_out):
        x, kernel = ctx.saved_tensors
        g = grad_out.contiguous()
        grad_x = grad_k = grad_b = None
        if ctx.needs_input_grad[0]:
            zero = torch.zeros(kernel.shape[3], dtype=torch.float32, device=g.device)
            grad_x = dwconv3x3(g, dgrad_kernel(kernel), zero, dgrad=True)
        if ctx.needs_input_grad[1] or ctx.needs_input_grad[2]:
            grad_k, grad_b = dwconv3x3_wgrad(x, g)
            grad_k, grad_b = grad_k.to(kernel.dtype), grad_b.to(ctx.bias_dtype)
        return grad_x, grad_k, grad_b


def dwconv3x3_op(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """`dwconv3x3`, through `DWConv3x3Train` where autograd wants a gradient
    of x, the kernel or the bias."""
    if torch.is_grad_enabled() and (x.requires_grad or kernel.requires_grad
                                    or bias.requires_grad):
        return DWConv3x3Train.apply(x, kernel, bias)
    return dwconv3x3(x, kernel, bias)
