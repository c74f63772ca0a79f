"""Weight and bias gradient of the SAME 3x3 conv: the hand-written CUDA
kernel and its plain PyTorch version.

For x NHWC (N, H, W, C) and g (N, H, W, F), the gradient of the conv's
output before its bias, both f32:

    dW[ky, kx, c, f] = sum over n, h, w of x_pad[n, h + ky, w + kx, c] * g[n, h, w, f]
    db[f]            = sum over n, h, w of g[n, h, w, f]

dW is HWIO (3, 3, C, F), the layout of ops/conv3x3.py's kernels. It is
what XLA computes for the weight of `conv3x3` (larvanet_tpu/models/layers.py:81)
under jax.grad; the JAX package has no Pallas kernel for it.

`conv3x3_wgrad` launches `csrc/conv3x3_wgrad.cu` for a CUDA tensor and
raises on anything that kernel does not take; only a CPU tensor goes to
`conv3x3_wgrad_reference`. The kernel splits the pixel sum across blocks
(`splits_for`) and adds the partial sums in a second pass, in a fixed
order, so its result is the same on every run. Two paths by shape
(`path_for`): "narrow" (F <= 4, final_conv) and "wide". `LAUNCHES` and
`LAUNCHES_BY_PATH` count the wrapper's calls that launched it.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Tuple

import torch
import torch.nn.functional as F

from larvanet_tpu_torch.ops import build

SOURCE = "conv3x3_wgrad.cu"
_ENTRY = {"wide": "conv3x3_wgrad_f32", "narrow": "conv3x3_wgrad_f32_narrow"}
# the kernels' output tiles (rows of 9 C + 1 by output channels) and the
# pixels a block takes per step, as in the source
_TILE = {"wide": (64, 64), "narrow": (256, 4)}
_BK = 16
# blocks per SM the split aims at, and the fewest pixels worth a split
BLOCKS_PER_SM = 4
MIN_CHUNK = 256

LAUNCHES = 0
LAUNCHES_BY_PATH: Dict[str, int] = {"wide": 0, "narrow": 0}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for path in LAUNCHES_BY_PATH:
        LAUNCHES_BY_PATH[path] = 0


def path_for(f: int) -> str:
    """The kernel's path for F outputs: 256 x 4 tiles for F <= 4, else 64 x 64."""
    return "narrow" if f <= 4 else "wide"


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def splits_for(m: int, c: int, f: int, sms: int) -> Tuple[int, int]:
    """(splits, chunk): the pixel sum of M pixels cut into `splits` runs of
    `chunk` pixels (a multiple of the kernel's 16; the last run may be
    shorter, none is empty), enough for BLOCKS_PER_SM blocks on each of
    `sms` SMs together with the output tiles, none shorter than MIN_CHUNK
    pixels unless M is."""
    br, bf = _TILE[path_for(f)]
    tiles = _cdiv(9 * c + 1, br) * _cdiv(f, bf)
    splits = max(1, min(_cdiv(BLOCKS_PER_SM * sms, tiles), m // MIN_CHUNK))
    chunk = _cdiv(_cdiv(m, splits), _BK) * _BK
    return _cdiv(m, chunk), chunk


def conv3x3_wgrad_reference(x: torch.Tensor, g: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: nine (C, M) x (M, F) products over the shifted
    taps of x with its SAME halo, and g summed over the pixels, in f32."""
    n, h, w, c = x.shape
    f = g.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    g2 = g.float().reshape(n * h * w, f)
    taps = [xp[:, dy:dy + h, dx:dx + w, :].reshape(n * h * w, c).t() @ g2
            for dy in range(3) for dx in range(3)]
    return torch.stack(taps).reshape(3, 3, c, f), g2.sum(0)


def bind(lib: ctypes.CDLL, path: str = "wide"):
    """The entry point of `lib` for `path`, with its C signature."""
    fn = getattr(lib, _ENTRY[path])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _entry(path: str):
    return bind(build.load(SOURCE), path)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _run(fn, x: torch.Tensor, g: torch.Tensor, splits: int, chunk: int,
         stream) -> Tuple[torch.Tensor, torch.Tensor]:
    """Call entry point `fn` on checked operands with the pixel sum cut into
    `splits` runs of `chunk`; returns (dW HWIO, db)."""
    n, h, w, c = x.shape
    f = g.shape[3]
    rows = 9 * c + 1
    ws = torch.empty((splits, rows, f), dtype=torch.float32, device=x.device)
    out = torch.empty((rows, f), dtype=torch.float32, device=x.device)
    err = fn(x.data_ptr(), g.data_ptr(), ws.data_ptr(), out.data_ptr(), n, h, w, c, f,
             splits, chunk, stream)
    if err != 0:
        raise RuntimeError("conv3x3_wgrad kernel launch failed: CUDA error %d" % err)
    return out[:9 * c].view(3, 3, c, f), out[9 * c]


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dW HWIO (3, 3, C, F), db (F,)) of a SAME 3x3 conv. CUDA tensors:
    the hand-written kernel; CPU tensors: the plain version."""
    if x.device.type == "cpu":
        return conv3x3_wgrad_reference(x, g)
    if x.device.type != "cuda":
        raise ValueError("conv3x3_wgrad runs on CUDA or the CPU, not %s" % (x.device,))
    if x.dtype != torch.float32 or g.dtype != torch.float32:
        raise TypeError("conv3x3_wgrad takes float32, got %s and %s" % (x.dtype, g.dtype))
    if x.dim() != 4 or g.dim() != 4 or x.shape[:3] != g.shape[:3]:
        raise ValueError("x and g must be NHWC with the same N, H, W, got %s and %s"
                         % (tuple(x.shape), tuple(g.shape)))
    if not (x.is_contiguous() and g.is_contiguous()):
        raise ValueError("x and g must be contiguous")
    if g.device != x.device:
        raise ValueError("x and g must be on one device")
    n, h, w, c = x.shape
    f = g.shape[3]
    m = n * h * w
    if m == 0 or c == 0 or f == 0:
        raise ValueError("empty conv: x %s, F %d" % (tuple(x.shape), f))
    path = path_for(f)
    with torch.cuda.device(x.device):
        splits, chunk = splits_for(m, c, f, _sm_count(torch.cuda.current_device()))
        out = _run(_entry(path), x, g, splits, chunk, torch.cuda.current_stream().cuda_stream)
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_PATH[path] += 1
    return out
