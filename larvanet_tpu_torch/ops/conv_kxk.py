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
mma.sync m16n8k16, f32 in split TF32 on m16n8k8, over the `chunked_weight`
operand) and "cuda_core" (any other C, over `entry_weight`).
`conv_kxk_group` runs G convs of one shape (the border operators of the
collapsed tail: top + bottom, left + right, the four corners) in one launch,
without a gradient. `conv_kxk_wgrad` is the weight and bias gradient
(deterministic: the pixel sum cut into runs whose partial sums a second
kernel adds in order), on the tensor cores where C % 16 == 0 and kh kw <= 25
(`wgrad_path_for`), else on the CUDA cores. `ConvKxKTrain` is the conv as
a `torch.autograd.Function`: its backward runs the input gradient as
`conv_kxk` on the kernel rotated by 180 degrees with C and F swapped and
the pads mirrored (`dgrad_kernel`, `dgrad_pads`), and dW and db on
`conv_kxk_wgrad`. `LAUNCHES` counts the forward kernel's single launches,
`LAUNCHES_BY_PATH` each path's, `DGRAD_LAUNCHES_BY_PATH` those of them that
were input gradients, `GROUP_LAUNCHES_BY_PATH` the grouped launches, and
`WGRAD_LAUNCHES` (`WGRAD_LAUNCHES_BY_PATH`) the weight gradient's.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, List, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from larvanet_tpu_torch.ops import build
from larvanet_tpu_torch.ops.conv3x3 import split_tf32

SOURCE = "conv_kxk.cu"
_ENTRY = {("cuda_core", torch.float32): "conv_kxk_f32",
          ("cuda_core", torch.bfloat16): "conv_kxk_bf16",
          ("tensor_core", torch.float32): "conv_kxk_f32_tc",
          ("tensor_core", torch.bfloat16): "conv_kxk_bf16_tc"}
_GROUP_ENTRY = {("cuda_core", torch.float32): "conv_kxk_group_f32",
                ("cuda_core", torch.bfloat16): "conv_kxk_group_bf16",
                ("tensor_core", torch.float32): "conv_kxk_group_f32_tc",
                ("tensor_core", torch.bfloat16): "conv_kxk_group_bf16_tc"}
_WGRAD_ENTRY = {("cuda_core", torch.float32): "conv_kxk_wgrad_f32",
                ("cuda_core", torch.bfloat16): "conv_kxk_wgrad_bf16",
                ("tensor_core", torch.float32): "conv_kxk_wgrad_f32_tc",
                ("tensor_core", torch.bfloat16): "conv_kxk_wgrad_bf16_tc"}
# the tensor-core forward's weight chunk: 128 bytes of channels a row
CHUNK_BYTES = 128
# the tensor-core weight gradient: its pixel tiles (rows, columns of the
# output), the channels and most outputs of a block, the taps it takes;
# blocks per SM its split aims at; the most pixels of an f32 run (the tensor
# core's f32 sums round toward zero, so the error's bias grows with a run:
# ops/conv3x3_wgrad.py's cap of 48 tiles of 8 x 16)
WGRAD_TILE = (8, 16)
WGRAD_BLOCK = (16, 48)
WGRAD_MAX_TAPS = 25
WGRAD_BLOCKS_PER_SM = 2
MAX_TC_PIXELS = 48 * 128
# the CUDA-core weight gradient's tiles (rows of kh kw C + 1 by outputs)
# and the pixels a block takes a step, as in the source
CC_WGRAD_TILE = (64, 64)
WGRAD_STEP = 16
# blocks per SM the CUDA-core split aims at, and the fewest pixels worth a split
BLOCKS_PER_SM = 4
MIN_CHUNK = 256

Pads = Tuple[int, int, int, int]

LAUNCHES = 0
LAUNCHES_BY_PATH: Dict[str, int] = {"cuda_core": 0, "tensor_core": 0}
DGRAD_LAUNCHES_BY_PATH: Dict[str, int] = {"cuda_core": 0, "tensor_core": 0}
GROUP_LAUNCHES_BY_PATH: Dict[str, int] = {"cuda_core": 0, "tensor_core": 0}
WGRAD_LAUNCHES = 0
WGRAD_LAUNCHES_BY_PATH: Dict[str, int] = {"cuda_core": 0, "tensor_core": 0}


def reset_launches() -> None:
    global LAUNCHES, WGRAD_LAUNCHES
    LAUNCHES = WGRAD_LAUNCHES = 0
    for counts in (LAUNCHES_BY_PATH, DGRAD_LAUNCHES_BY_PATH, GROUP_LAUNCHES_BY_PATH,
                   WGRAD_LAUNCHES_BY_PATH):
        for path in counts:
            counts[path] = 0


def path_for(c: int) -> str:
    """The kernel's path for C input channels: the tensor cores take C a
    multiple of 16 (a k-step of 16 bf16 or 8 f32 channels, two to a 32-byte
    step), the CUDA cores the rest."""
    return "tensor_core" if c % 16 == 0 else "cuda_core"


def wgrad_path_for(c: int, kh: int, kw: int) -> str:
    """The weight gradient's path: the tensor cores take C a multiple of 16
    and at most WGRAD_MAX_TAPS taps (one m16 tile a tap and 16 channels,
    five to a warp), the CUDA cores the rest."""
    return "tensor_core" if c % 16 == 0 and kh * kw <= WGRAD_MAX_TAPS else "cuda_core"


def same_pads(kh: int, kw: int) -> Pads:
    """The pads of a SAME conv of an odd kh x kw kernel."""
    return kh // 2, kh // 2, kw // 2, kw // 2


def out_size(h: int, w: int, kh: int, kw: int, pads: Sequence[int]) -> Tuple[int, int]:
    pt, pb, pl, pr = pads
    return h + pt + pb - kh + 1, w + pl + pr - kw + 1


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


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
    """The CUDA-core entries' weight operand for an HWIO kernel (kh, kw, C,
    F): [kh kw][F][C] contiguous in `dtype`, so that a row of one output's
    channels is contiguous."""
    kh, kw, c, f = kernel.shape
    return kernel.to(dtype).reshape(kh * kw, c, f).transpose(1, 2).contiguous()


def chunked_weight(kernels: Sequence[torch.Tensor], dtype: torch.dtype) -> torch.Tensor:
    """The tensor-core entries' weight operand for G HWIO kernels of one
    shape (kh, kw, C, F): (G, chunks, kh kw, planes, F, CHUNK_BYTES / elem)
    in `dtype`, C cut into chunks of 128 bytes (64 bf16 or 32 f32 channels;
    the last padded with zeros); bf16 one plane (the kernel cast), f32 two
    (`split_tf32` of the kernel: hi, then lo). Each 128-byte row's 16-byte
    granules are swizzled by the row: logical granule q of output n sits at
    q ^ (n % 8), as the kernel reads it."""
    k = torch.stack([kk.detach().to(dtype).float() for kk in kernels])
    g, kh, kw, c, f = k.shape
    per = CHUNK_BYTES // torch.tensor([], dtype=dtype).element_size()
    chunks = _cdiv(c, per)
    k = F.pad(k, (0, 0, 0, chunks * per - c))
    k = k.reshape(g, kh * kw, chunks, per, f).permute(0, 2, 1, 4, 3)
    planes = torch.stack(split_tf32(k), 3) if dtype == torch.float32 else k.unsqueeze(3)
    planes = planes.to(dtype).reshape(*planes.shape[:-1], 8, per // 8)
    rows = torch.arange(f, device=k.device)
    source = torch.arange(8, device=k.device)[None, :] ^ (rows[:, None] % 8)  # (F, 8)
    index = source[:, :, None].expand(f, 8, per // 8).expand(planes.shape)
    return torch.gather(planes, -2, index).reshape(g, chunks, kh * kw, -1, f, per).contiguous()


class ConvGroup:
    """G convs of one shape: HWIO kernels (kh, kw, C, F) and biases (F,) or
    None, fixed. Keeps the entry operands of each dtype and path once made
    (`operands`), so a launch does no layout work. A kernel that stays (the
    baked collapsed tail's main conv and border operators) is held as a
    ConvGroup by its owner, made once; `conv_kxk` wraps any other kernel in
    one for a single call. Run by `conv_kxk_group`, or by `conv_kxk` where
    it holds one problem."""

    def __init__(self, kernels: Sequence[torch.Tensor],
                 biases: Optional[Sequence[Optional[torch.Tensor]]] = None):
        self.kernels = [k.detach() for k in kernels]
        self.biases = [None if b is None else b.detach()
                       for b in (biases if biases is not None else [None] * len(kernels))]
        if not self.kernels or len(self.biases) != len(self.kernels):
            raise ValueError("a ConvGroup takes as many biases as kernels (%d), got %d"
                             % (len(self.kernels), len(self.biases)))
        shape = self.kernels[0].shape
        if len(shape) != 4 or any(k.shape != shape for k in self.kernels) or any(
                b is not None and b.shape != (shape[3],) for b in self.biases):
            raise ValueError("a ConvGroup takes HWIO kernels of one shape and (F,) biases")
        self.shape = shape  # each kernel's
        self._operands: Dict[Tuple[torch.dtype, str], Tuple[torch.Tensor, torch.Tensor]] = {}
        self._checked: Dict[tuple, Pads] = {}  # stacked input (shape, dtype, device, pads)

    def __len__(self) -> int:
        return len(self.kernels)

    def operands(self, dtype: torch.dtype, path: str) -> Tuple[torch.Tensor, torch.Tensor]:
        """(weights, biases) of the (`path`, `dtype`) entries: the chunked
        (tensor cores) or [kh kw][F][C] (CUDA cores) weights stacked, and
        the f32 biases (zeros for None) stacked (G, F)."""
        key = (dtype, path)
        if key not in self._operands:
            if path == "tensor_core":
                w = chunked_weight(self.kernels, dtype)
            else:
                w = torch.stack([entry_weight(k, dtype) for k in self.kernels])
            b = torch.stack([torch.zeros(self.shape[3], dtype=torch.float32,
                                         device=self.kernels[0].device) if bias is None
                             else bias.to(torch.float32) for bias in self.biases])
            self._operands[key] = (w, b)
        return self._operands[key]


def conv_kxk_group_reference(xs: Sequence[torch.Tensor], kernels, biases=None,
                             pads: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """The plain version of `conv_kxk_group`: `conv_kxk_reference` problem
    by problem (`kernels` a ConvGroup, or the kernels with `biases`)."""
    group = kernels if isinstance(kernels, ConvGroup) else ConvGroup(kernels, biases)
    kh, kw = group.kernels[0].shape[:2]
    pads = tuple(pads) if pads is not None else same_pads(kh, kw)
    return [conv_kxk_reference(x, k, b, pads)
            for x, k, b in zip(xs, group.kernels, group.biases)]


def bind(lib: ctypes.CDLL, dtype: torch.dtype, path: str = "tensor_core", group: bool = False):
    """The forward entry point of `lib` for (`path`, `dtype`), single or
    grouped (whose argument after y is the number of problems), with its C
    signature."""
    fn = getattr(lib, (_GROUP_ENTRY if group else _ENTRY)[(path, dtype)])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * (12 if group else 11) + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def bind_wgrad(lib: ctypes.CDLL, dtype: torch.dtype, path: str = "cuda_core"):
    """The weight-gradient entry point of `lib` for (`path`, `dtype`): the
    CUDA-core entry (any shape, runs of pixels) unless `path` says
    "tensor_core" (runs of WGRAD_TILE pixel tiles)."""
    fn = getattr(lib, _WGRAD_ENTRY[(path, dtype)])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 13 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _entry(dtype: torch.dtype, path: str, group: bool = False):
    return bind(build.load(SOURCE), dtype, path, group)


@functools.lru_cache(maxsize=None)
def _wgrad_entry(dtype: torch.dtype, path: str):
    return bind_wgrad(build.load(SOURCE), dtype, path)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _launch(fn, x: torch.Tensor, weights: torch.Tensor, biases: torch.Tensor, kh: int, kw: int,
            pads: Sequence[int], stream, groups: Optional[int] = None) -> torch.Tensor:
    """Call forward entry point `fn` on x (n, h, w, c), or G problems
    stacked (G, n, h, w, c) for a grouped entry (`groups` = G), with the
    entry's weight and bias operands; returns the output (G stacked)."""
    n, h, w, c = x.shape[-4:]
    f = biases.shape[-1]
    ho, wo = out_size(h, w, kh, kw, pads)
    out = torch.empty(x.shape[:-3] + (ho, wo, f), dtype=x.dtype, device=x.device)
    lead = () if groups is None else (groups,)
    err = fn(x.data_ptr(), weights.data_ptr(), biases.data_ptr(), out.data_ptr(), *lead, n, h,
             w, c, kh, kw, f, *pads, stream)
    if err != 0:
        raise RuntimeError("conv_kxk kernel launch failed: CUDA error %d" % err)
    return out


def _run(fn, x: torch.Tensor, kernel, bias: Optional[torch.Tensor], pads: Sequence[int],
         stream, path: str = "tensor_core") -> torch.Tensor:
    """Call the single forward entry point `fn` of `path` on checked
    operands: `kernel` an HWIO kernel with `bias` (laid out for this call),
    or a ConvGroup of one problem (its operands kept); returns the output."""
    group = kernel if isinstance(kernel, ConvGroup) else ConvGroup([kernel], [bias])
    weights, biases = group.operands(x.dtype, path)
    kh, kw = group.shape[:2]
    return _launch(fn, x, weights, biases, kh, kw, pads, stream)


def _run_group(fn, xs: torch.Tensor, group: ConvGroup, pads: Sequence[int], stream,
               path: str = "tensor_core") -> torch.Tensor:
    """Call the grouped forward entry point `fn` of `path` on G problems
    stacked in `xs` (G, n, h, w, c); returns the outputs stacked."""
    weights, biases = group.operands(xs.dtype, path)
    kh, kw = group.shape[:2]
    return _launch(fn, xs, weights, biases, kh, kw, pads, stream, groups=len(group))


def wgrad_splits(path: str, n: int, ho: int, wo: int, c: int, kh: int, kw: int, f: int,
                 sms: int, dtype: torch.dtype = torch.float32) -> Tuple[int, int]:
    """(splits, chunk): the output's pixel sum cut into `splits` runs of
    `chunk` (the last may be shorter, none is empty). Tensor cores: runs of
    WGRAD_TILE pixel tiles, enough for WGRAD_BLOCKS_PER_SM blocks on each of
    `sms` SMs together with the blocks of a run (16 channels x up to 48
    outputs each), f32 runs of at most MAX_TC_PIXELS pixels. CUDA cores:
    runs of pixels (a multiple of the kernel's step), enough for
    BLOCKS_PER_SM blocks an SM with the output tiles, none shorter than
    MIN_CHUNK pixels unless the output is."""
    if path == "tensor_core":
        th, tw = WGRAD_TILE
        units = n * _cdiv(ho, th) * _cdiv(wo, tw)
        blocks = c // WGRAD_BLOCK[0] * _cdiv(f, WGRAD_BLOCK[1])
        splits = max(1, min(units, _cdiv(WGRAD_BLOCKS_PER_SM * sms, blocks)))
        chunk = _cdiv(units, splits)
        if dtype == torch.float32:
            chunk = min(chunk, MAX_TC_PIXELS // (th * tw))
        return _cdiv(units, chunk), chunk
    m = n * ho * wo
    br, bf = CC_WGRAD_TILE
    tiles = _cdiv(kh * kw * c + 1, br) * _cdiv(f, bf)
    splits = max(1, min(_cdiv(BLOCKS_PER_SM * sms, tiles), m // MIN_CHUNK))
    chunk = _cdiv(_cdiv(m, splits), WGRAD_STEP) * WGRAD_STEP
    return _cdiv(m, chunk), chunk


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


def _check_operands(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
                    pads: Sequence[int]) -> Pads:
    """The checks of a conv on the card; returns the pads."""
    n, h, w, c = x.shape
    kh, kw = kernel.shape[:2]
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
    return _check_pads(pads, kh, kw, h, w)


def conv_kxk(x: torch.Tensor, kernel, bias: Optional[torch.Tensor] = None,
             pads: Optional[Sequence[int]] = None, dgrad: bool = False) -> torch.Tensor:
    """KxK conv + bias with explicit zero pads (default: SAME for an odd
    kernel). CUDA tensor: the hand-written kernel; CPU tensor: the plain
    version. `kernel` is an HWIO kernel, laid out for the entry every call,
    or a fixed one as a ConvGroup of one problem (its bias with it: `bias`
    must be None), whose operands are made once. `dgrad` marks an input
    gradient (`ConvKxKTrain.backward`), counted in DGRAD_LAUNCHES_BY_PATH as
    well."""
    group = None
    if isinstance(kernel, ConvGroup):
        if len(kernel) != 1 or bias is not None:
            raise ValueError("conv_kxk takes a ConvGroup of one problem, which carries its "
                             "bias; got %d problems%s" % (len(kernel), "" if bias is None
                                                          else " and a bias"))
        group, kernel, bias = kernel, kernel.kernels[0], kernel.biases[0]
    if kernel.dim() != 4:
        raise ValueError("kernel must be HWIO (kh, kw, C, F), got %s" % (tuple(kernel.shape),))
    kh, kw = kernel.shape[:2]
    pads = tuple(pads) if pads is not None else same_pads(kh, kw)
    if x.device.type == "cpu":
        return conv_kxk_reference(x, kernel, bias, pads)
    _check(x, "conv_kxk")
    pads = _check_operands(x, kernel, bias, pads)
    path = path_for(x.shape[3])
    with torch.cuda.device(x.device):
        out = _run(_entry(x.dtype, path), x, group or kernel, bias, pads,
                   torch.cuda.current_stream().cuda_stream, path)
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_PATH[path] += 1
    if dgrad:
        DGRAD_LAUNCHES_BY_PATH[path] += 1
    return out


def conv_kxk_group(xs: Sequence[torch.Tensor], kernels, biases=None,
                   pads: Optional[Sequence[int]] = None) -> List[torch.Tensor]:
    """G convs of one shape, conv_kxk(xs[i], kernels[i], biases[i], pads)
    for each i, in one launch; no gradient (a call where autograd wants one
    raises). `kernels` is a `ConvGroup` (its biases with it: `biases` must
    be None), or the HWIO kernels with `biases` (made into a ConvGroup for
    this call). CUDA tensors: the grouped entry of `path_for(C)` on the
    inputs stacked (views are copied into one contiguous tensor); CPU
    tensors: the plain version, problem by problem. Returns the G
    outputs."""
    if isinstance(kernels, ConvGroup):
        if biases is not None:
            raise ValueError("a ConvGroup carries its biases")
        group, tensors = kernels, list(xs)
    else:
        tensors = list(xs) + list(kernels) + list(biases or [])
        group = None
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in tensors):
        raise ValueError("conv_kxk_group computes no gradient; use conv_kxk_op per problem")
    group = group or ConvGroup(kernels, biases)
    kh, kw = group.shape[:2]
    pads = tuple(pads) if pads is not None else same_pads(kh, kw)
    if len(xs) != len(group):
        raise ValueError("conv_kxk_group takes as many inputs as kernels (%d), got %d"
                         % (len(group), len(xs)))
    if xs[0].device.type == "cpu":
        return conv_kxk_group_reference(xs, group, None, pads)
    x = torch.stack(list(xs))
    key = (x.shape, x.dtype, x.device, pads)
    if key not in group._checked:  # the checks of a shape once a group
        _check(x[0], "conv_kxk_group")
        group._checked[key] = _check_operands(x[0], group.kernels[0], group.biases[0], pads)
    pads = group._checked[key]
    path = path_for(x.shape[-1])
    with torch.cuda.device(x.device):
        out = _run_group(_entry(x.dtype, path, True), x, group, pads,
                         torch.cuda.current_stream().cuda_stream, path)
    GROUP_LAUNCHES_BY_PATH[path] += 1
    return list(out.unbind(0))


def conv_kxk_wgrad(x: torch.Tensor, g: torch.Tensor, kh: int, kw: int,
                   pads: Optional[Sequence[int]] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dW HWIO (kh, kw, C, F), db (F,)), both f32, of the conv of x with
    `pads` whose output gradient (before the bias) is g; x and g f32 or
    bf16, of one dtype. CUDA tensors: the hand-written kernel of
    `wgrad_path_for`; CPU tensors: the plain version."""
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
    path = wgrad_path_for(c, kh, kw)
    with torch.cuda.device(x.device):
        splits, chunk = wgrad_splits(path, n, ho, wo, c, kh, kw, f,
                                     _sm_count(torch.cuda.current_device()), x.dtype)
        out = _run_wgrad(_wgrad_entry(x.dtype, path), x, g, kh, kw, pads, splits, chunk,
                         torch.cuda.current_stream().cuda_stream)
    global WGRAD_LAUNCHES
    WGRAD_LAUNCHES += 1
    WGRAD_LAUNCHES_BY_PATH[path] += 1
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


def conv_kxk_op(x: torch.Tensor, kernel, bias: Optional[torch.Tensor] = None,
                pads: Optional[Sequence[int]] = None) -> torch.Tensor:
    """`conv_kxk`, through `ConvKxKTrain` where autograd wants a gradient
    of x, the kernel or the bias; a fixed kernel (a ConvGroup of one) takes
    no gradient (where one of x is wanted, this raises)."""
    kh, kw = kernel.shape[:2]
    pads = tuple(pads) if pads is not None else same_pads(kh, kw)
    x = x.contiguous()
    if isinstance(kernel, ConvGroup):
        if torch.is_grad_enabled() and x.requires_grad:
            raise ValueError("a fixed kernel's conv computes no gradient; use the HWIO kernel")
        return conv_kxk(x, kernel, bias, pads)
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad
                                       for t in (x, kernel, bias)):
        return ConvKxKTrain.apply(x, kernel, bias, pads)
    return conv_kxk(x, kernel, bias, pads)
