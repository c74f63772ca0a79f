"""Weight and bias gradient of the SAME 3x3 conv: the hand-written CUDA
kernel and its plain PyTorch version.

For x NHWC (N, H, W, C) and g (N, H, W, F), the gradient of the conv's
output before its bias, both f32 or both bf16 (the sums and the result f32):

    dW[ky, kx, c, f] = sum over n, h, w of x_pad[n, h + ky, w + kx, c] * g[n, h, w, f]
    db[f]            = sum over n, h, w of g[n, h, w, f]

dW is HWIO (3, 3, C, F), the layout of ops/conv3x3.py's kernels. It is
what XLA computes for the weight of `conv3x3` (larvanet_tpu/models/layers.py:81)
under jax.grad; the JAX package has no Pallas kernel for it.

`conv3x3_wgrad` launches `csrc/conv3x3_wgrad.cu` for a CUDA tensor and
raises on anything that kernel does not take; only a CPU tensor goes to
`conv3x3_wgrad_reference`. The kernel splits the pixel sum across blocks
(`tile_splits` for the tiled paths, `splits_for` for the CUDA-core one)
and adds the partial sums in a second pass, in a fixed
order, so its result is the same on every run. Three paths by shape
(`path_for`, named as ops/conv3x3.py names the conv's): "tensor_core" (C %
16 == 0, F % 8 == 0: split TF32 on mma.sync over x's halo staged once per
pixel tile), "narrow" (C % 16 == 0, F <= 4, final_conv: the same staging,
CUDA-core FMAs) and "cuda_core" (everything else, first_conv's 3 -> 64: the
first design's entries, 64 x 64 tiles or 256 x 4 for F <= 4). `LAUNCHES`
and `LAUNCHES_BY_PATH` count the wrapper's calls that launched it.

bf16 (`--train_dtype bf16`): on the tensor-core path the entry
`conv3x3_wgrad_bf16_tc` reads bf16 x and g into the same halo tiles and runs
one mma.sync m16n8k16 bf16 product with f32 sums where the f32 entry runs
three TF32 ones, with the same splits and second pass. The narrow and
CUDA-core paths cast x and g to f32 here and launch their f32 entries: a
product of two bf16 values is exact in f32, so that computes the same
function. `BF16_LAUNCHES_BY_PATH` counts the bf16 calls of each path. The
plain version takes either dtype (its products in f32).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict, Optional, Tuple

import torch
import torch.nn.functional as F

from larvanet_tpu_torch.ops import build

SOURCE = "conv3x3_wgrad.cu"
# entry points: the paths' own, and the CUDA-core path's 256 x 4 tile for F <= 4
_ENTRY = {"tensor_core": "conv3x3_wgrad_f32_tc", "narrow": "conv3x3_wgrad_f32_halo_narrow",
          "cuda_core": "conv3x3_wgrad_f32", "cuda_core_narrow": "conv3x3_wgrad_f32_narrow",
          "tensor_core_bf16": "conv3x3_wgrad_bf16_tc"}
# the CUDA-core entries' output tiles (rows of 9 C + 1 by output channels)
# and the pixels a block takes per step, as in the source
_TILE = {"cuda_core": (64, 64), "cuda_core_narrow": (256, 4)}
_BK = 16
# the tiled entries' pixel tiles (H x W) and the channels and outputs a
# block takes (None: all F, which is <= 4), as in the source
PIXEL_TILE = {"tensor_core": (8, 16), "narrow": (8, 32), "tensor_core_bf16": (8, 16)}
_BLOCK_CF = {"tensor_core": (64, 64), "narrow": (64, None)}
# the most pixel tiles a tensor-core split sums: the tensor cores' f32 sums
# round toward zero, so the error grows with a split's length (H100 SXM,
# chip_wgrad_variants.py, 16 x 96x96, 64 -> 256: 1.33e-5 of max |dW| at
# 2,048 pixels a split, 2.75e-5 at 4,480, 3.78e-5 at 6,144 = 48 tiles,
# 5.26e-5 at 8,192, 2.0e-4 at 32,768; chip_smoke.py's bar is 2e-4)
MAX_TC_CHUNK = 48
# blocks per SM the CUDA-core split aims at (the tiled entries fill the
# card with one block an SM), and the fewest pixels worth a split
BLOCKS_PER_SM = 4
MIN_CHUNK = 256

LAUNCHES = 0
LAUNCHES_BY_PATH: Dict[str, int] = {"tensor_core": 0, "narrow": 0, "cuda_core": 0}
BF16_LAUNCHES_BY_PATH: Dict[str, int] = {"tensor_core": 0, "narrow": 0, "cuda_core": 0}


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0
    for counts in (LAUNCHES_BY_PATH, BF16_LAUNCHES_BY_PATH):
        for path in counts:
            counts[path] = 0


def path_for(c: int, f: int) -> str:
    """The kernel's path for C inputs and F outputs."""
    if c % 16 == 0 and f <= 4:
        return "narrow"
    if c % 16 == 0 and f % 8 == 0:
        return "tensor_core"
    return "cuda_core"


def entry_for(path: str, f: int, dtype: torch.dtype = torch.float32) -> str:
    """The `_ENTRY` key that `path` launches for F outputs in `dtype` (bf16
    has an entry of its own on the tensor cores only)."""
    if path == "tensor_core" and dtype == torch.bfloat16:
        return "tensor_core_bf16"
    return "cuda_core_narrow" if path == "cuda_core" and f <= 4 else path


def _cdiv(a: int, b: int) -> int:
    return -(-a // b)


def splits_for(m: int, c: int, f: int, sms: int) -> Tuple[int, int]:
    """(splits, chunk) for the CUDA-core entries: the pixel sum of M pixels
    cut into `splits` runs of `chunk` pixels (a multiple of the kernel's 16;
    the last run may be shorter, none is empty), enough for BLOCKS_PER_SM
    blocks on each of `sms` SMs together with the output tiles, none shorter
    than MIN_CHUNK pixels unless M is."""
    br, bf = _TILE[entry_for("cuda_core", f)]
    tiles = _cdiv(9 * c + 1, br) * _cdiv(f, bf)
    splits = max(1, min(_cdiv(BLOCKS_PER_SM * sms, tiles), m // MIN_CHUNK))
    chunk = _cdiv(_cdiv(m, splits), _BK) * _BK
    return _cdiv(m, chunk), chunk


def tile_splits(path: str, n: int, h: int, w: int, c: int, f: int,
                sms: int) -> Tuple[int, int]:
    """(splits, chunk) for a tiled entry: the image's pixel tiles
    (PIXEL_TILE[path], along W, then H, then images) cut into `splits` runs
    of `chunk` tiles (the last may be shorter, none is empty), so that the
    blocks of all splits, one for each channel chunk and output tile, fill
    `sms` SMs once, with no tensor-core split longer than MAX_TC_CHUNK."""
    th, tw = PIXEL_TILE[path]
    bc, bf = _BLOCK_CF["tensor_core" if path == "tensor_core_bf16" else path]
    tiles = n * _cdiv(h, th) * _cdiv(w, tw)
    blocks = _cdiv(c, bc) * (1 if bf is None else _cdiv(f, bf))
    chunk = _cdiv(tiles, max(1, min(tiles, sms // blocks)))
    if path in ("tensor_core", "tensor_core_bf16"):
        chunk = min(chunk, MAX_TC_CHUNK)
    return _cdiv(tiles, chunk), chunk


def conv3x3_wgrad_reference(x: torch.Tensor, g: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The plain version: nine (C, M) x (M, F) products over the shifted
    taps of x with its SAME halo, and g summed over the pixels, in f32
    (bf16 x and g are widened to f32 first, which is exact)."""
    n, h, w, c = x.shape
    f = g.shape[-1]
    xp = F.pad(x.float(), (0, 0, 1, 1, 1, 1))
    g2 = g.float().reshape(n * h * w, f)
    taps = [xp[:, dy:dy + h, dx:dx + w, :].reshape(n * h * w, c).t() @ g2
            for dy in range(3) for dx in range(3)]
    return torch.stack(taps).reshape(3, 3, c, f), g2.sum(0)


def bind(lib: ctypes.CDLL, entry: str = "tensor_core"):
    """The entry point of `lib` for an `_ENTRY` key, with its C signature."""
    fn = getattr(lib, _ENTRY[entry])
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _entry(entry: str):
    return bind(build.load(SOURCE), entry)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _run(fn, x: torch.Tensor, g: torch.Tensor, splits: int, chunk: int,
         stream) -> Tuple[torch.Tensor, torch.Tensor]:
    """Call entry point `fn` on checked operands with the pixel sum cut into
    `splits` runs of `chunk` (pixel tiles or pixels, as the entry counts);
    returns (dW HWIO, db)."""
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


def conv3x3_wgrad(x: torch.Tensor, g: torch.Tensor,
                  path: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dW HWIO (3, 3, C, F), db (F,)), both f32, of a SAME 3x3 conv of f32
    or bf16 x and g. CUDA tensors: the hand-written kernel on `path`
    (default `path_for(C, F)`; "cuda_core" runs the first design's entries
    at any shape, to time them beside the others); bf16 takes
    `conv3x3_wgrad_bf16_tc` on the tensor cores and the f32 entries of the
    other paths on x and g widened to f32. CPU tensors: the plain version."""
    if x.device.type == "cpu":
        return conv3x3_wgrad_reference(x, g)
    if x.device.type != "cuda":
        raise ValueError("conv3x3_wgrad runs on CUDA or the CPU, not %s" % (x.device,))
    if x.dtype != g.dtype or x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("conv3x3_wgrad takes float32 or bfloat16 x and g of one dtype, "
                        "got %s and %s" % (x.dtype, g.dtype))
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
    path = path or path_for(c, f)
    bf16 = x.dtype == torch.bfloat16
    entry = entry_for(path, f, x.dtype)
    if bf16 and entry != "tensor_core_bf16":
        x, g = x.float(), g.float()
    with torch.cuda.device(x.device):
        sms = _sm_count(torch.cuda.current_device())
        splits, chunk = (splits_for(n * h * w, c, f, sms) if path == "cuda_core"
                         else tile_splits(path, n, h, w, c, f, sms))
        out = _run(_entry(entry), x, g, splits, chunk, torch.cuda.current_stream().cuda_stream)
    global LAUNCHES
    LAUNCHES += 1
    LAUNCHES_BY_PATH[path] += 1
    if bf16:
        BF16_LAUNCHES_BY_PATH[path] += 1
    return out
