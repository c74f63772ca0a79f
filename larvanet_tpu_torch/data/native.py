"""The native host data path (larvanet_tpu/data/native.py), on the port's
own C++ (`csrc/host/lvt_data.cpp`, built by ops/build.py's host entry into
`build/host/` at first use and loaded with ctypes).

  * `decode_png(path)`: a PNG file as HWC uint8 RGB, the loaders' decode
    (`data/png.py` with 16-bit grey at its high byte, libpng's rule). The
    port keeps zlib's inflate; the row filters run in C (`unfilter`).
  * `NativeBatcher`: augmented NHWC float32 patch batches from a list of
    uint8 LR / HR images, the JAX package's `lvt_patch_batch` stream draw
    for draw (`--data_native 1` on a cached dataset, data/dataset.py). Its
    counter is JAX's: `batch` adds 1 to the step and then draws from
    seed + step (uint64, wrapping); `seek(step)` sets the step.

Beside them, the plain versions the tests hold them to: `unfilter_plain`
(the rows in numpy, Average and Paeth a byte at a time) and
`patch_batch_plain` (the same splitmix64 stream in numpy uint64, the
crops by np.rot90 and slicing).

A failed build raises with the compiler's output; nothing falls back.
"""

from __future__ import annotations

import ctypes
import os
from typing import List, Optional, Sequence, Tuple

import numpy as np

from larvanet_tpu_torch.ops import build as _build

SOURCE = "host/lvt_data.cpp"
MASK64 = (1 << 64) - 1
# a sample's stream starts at splitmix64(seed ^ (SAMPLE_SALT + b))
SAMPLE_SALT = 0xABCDEF12345678

_SIGNATURES = {
    "lvt_unfilter": ([ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
                      ctypes.c_void_p], ctypes.c_int),
    "lvt_patch_batch": ([ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p),
                         ctypes.POINTER(ctypes.c_int), ctypes.c_int, ctypes.c_int,
                         ctypes.c_int, ctypes.c_int, ctypes.c_uint64, ctypes.c_void_p,
                         ctypes.c_void_p, ctypes.c_int], ctypes.c_int),
}
_lib = None


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = _build.load_host(SOURCE)
        for name, (argtypes, restype) in _SIGNATURES.items():
            fn = getattr(lib, name)
            fn.argtypes, fn.restype = argtypes, restype
        _lib = lib
    return _lib


def build() -> bool:
    """Compile (if needed) and load the host library; raises if the build
    fails. True once it is loaded (JAX's `build()` returns availability)."""
    _load()
    return True


def available() -> bool:
    """Whether the host library is loaded or can be built here (a host C++
    compiler on PATH, or the library already built)."""
    if _lib is not None or _build.host_library_path(SOURCE).exists():
        return True
    try:
        from larvanet_tpu_torch.ops.emulate import compiler

        compiler()
    except RuntimeError:
        return False
    return True


# ---- PNG row filters ----------------------------------------------------------------


def unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters; raw is (height, 1 + stride) uint8, each row
    its filter byte and its bytes. Returns (height, stride) uint8; raises
    ValueError on a filter byte that is not 0-4."""
    raw = np.ascontiguousarray(raw, np.uint8)
    if raw.shape != (height, stride + 1):
        raise ValueError("unfilter: rows of shape %s, expected %s"
                         % (raw.shape, (height, stride + 1)))
    out = np.empty((height, stride), np.uint8)
    rc = _load().lvt_unfilter(raw.ctypes.data, height, stride, bpp, out.ctypes.data)
    if rc > 0:
        raise ValueError("unknown PNG filter type %d" % raw[rc - 1, 0])
    if rc != 0:
        raise ValueError("lvt_unfilter: bad arguments (height %d, stride %d, bpp %d)"
                         % (height, stride, bpp))
    return out


def _unfilter_serial(kind: int, line: bytearray, prev: bytes, bpp: int) -> bytearray:
    """Average (3) and Paeth (4) rows: each byte depends on the
    reconstructed byte bpp to its left, so they run byte by byte."""
    for i in range(len(line)):
        a = line[i - bpp] if i >= bpp else 0
        b = prev[i]
        if kind == 3:
            pred = (a + b) >> 1
        else:
            c = prev[i - bpp] if i >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        line[i] = (line[i] + pred) & 0xFF
    return line


def unfilter_plain(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """The plain version of `unfilter`, in numpy (Average and Paeth rows in
    Python, a byte at a time)."""
    out = np.zeros((height, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(height):
        kind = int(raw[y, 0])
        line = raw[y, 1:]
        if kind == 0:
            cur = line
        elif kind == 1:  # sub: a running sum along the row, per channel
            cur = np.cumsum(line.reshape(-1, bpp), axis=0, dtype=np.uint8).reshape(-1)
        elif kind == 2:  # up
            cur = line + prev  # uint8 arithmetic wraps mod 256
        elif kind in (3, 4):
            cur = np.frombuffer(_unfilter_serial(kind, bytearray(line.tobytes()),
                                                 prev.tobytes(), bpp), np.uint8)
        else:
            raise ValueError("unknown PNG filter type %d" % kind)
        out[y] = cur
        prev = out[y]
    return out


def decode_png(path: str) -> np.ndarray:
    """A PNG file as HWC uint8 RGB (larvanet_tpu/data/native.py:75-91): the
    loaders' decode. IOError if the file cannot be read (its own OSError,
    e.g. FileNotFoundError) or decoded."""
    from larvanet_tpu_torch.data import png

    with open(path, "rb") as f:
        data = f.read()
    try:
        return png.decode(data, grey16="high")
    except ValueError as exc:
        raise IOError("decode_png(%r) failed: %s" % (path, exc)) from exc


# ---- patch batches -----------------------------------------------------------------


def splitmix64(x: np.ndarray) -> np.ndarray:
    """One splitmix64 step of each uint64 in x (wrapping arithmetic)."""
    x = np.asarray(x, np.uint64) + np.uint64(0x9E3779B97F4A7C15)
    x = (x ^ (x >> np.uint64(30))) * np.uint64(0xBF58476D1CE4E5B9)
    x = (x ^ (x >> np.uint64(27))) * np.uint64(0x94D049BB133111EB)
    return x ^ (x >> np.uint64(31))


def _check_pairs(lr_images, hr_images, scale) -> None:
    if len(lr_images) != len(hr_images) or not lr_images:
        raise ValueError("need matching non-empty image lists")
    for a, b in zip(lr_images, hr_images):
        if (a.shape[0] * scale, a.shape[1] * scale) != tuple(b.shape[:2]):
            raise ValueError("HR dims must be LR dims * scale")


def patch_batch_plain(lr_images: Sequence[np.ndarray], hr_images: Sequence[np.ndarray],
                      scale: int, seed: int, batch_size: int,
                      patch: int) -> Tuple[np.ndarray, np.ndarray]:
    """The plain version of one `lvt_patch_batch` call at `seed` (the value
    the C function takes: a batcher's seed + step): the batch's streams in
    numpy uint64, the crops rotated by np.rot90 and flipped by slicing.
    Raises RuntimeError on an image not larger than the patch, as the
    batcher does."""
    _check_pairs(lr_images, hr_images, scale)
    n = len(lr_images)
    b = np.arange(batch_size, dtype=np.uint64)
    with np.errstate(over="ignore"):
        state = splitmix64(np.uint64(int(seed) & MASK64) ^ (np.uint64(SAMPLE_SALT) + b))

        def draw():
            nonlocal state
            state = splitmix64(state)
            return state

        idx = draw() % np.uint64(n)
        dims = np.array([a.shape[:2] for a in lr_images], np.int64)[idx.astype(np.int64)]
        if (dims <= patch).any():
            raise RuntimeError("lvt_patch_batch failed with code -2")
        y0 = draw() % (dims[:, 0] - patch).astype(np.uint64)
        x0 = draw() % (dims[:, 1] - patch).astype(np.uint64)
        k = draw() % np.uint64(4) + np.uint64(1)
        flip = (draw() & np.uint64(1)) != 0
    hp = patch * scale
    out_lr = np.empty((batch_size, patch, patch, 3), np.float32)
    out_hr = np.empty((batch_size, hp, hp, 3), np.float32)
    for i in range(batch_size):
        j, y, x, rot = int(idx[i]), int(y0[i]), int(x0[i]), int(k[i]) % 4
        for img, top, left, size, out in (
                (lr_images[j], y, x, patch, out_lr),
                (hr_images[j], y * scale, x * scale, hp, out_hr)):
            crop = np.rot90(img[top:top + size, left:left + size], rot, axes=(0, 1))
            out[i] = crop[:, ::-1] if flip[i] else crop
    return out_lr, out_hr


class NativeBatcher:
    """Pins a dataset's uint8 HWC images and assembles augmented NHWC
    float32 batches in C (larvanet_tpu/data/native.py:93-145): the same
    constructor, counter and stream as JAX's."""

    def __init__(self, lr_images: List[np.ndarray], hr_images: List[np.ndarray],
                 scale: int, seed: Optional[int] = None, num_threads: int = 0):
        lib = _load()
        _check_pairs(lr_images, hr_images, scale)
        self._lib = lib
        self.scale = scale
        self.seed = (int(seed) if seed is not None
                     else int(np.random.SeedSequence().entropy) % 2 ** 63) & MASK64
        self._step = 0
        self.num_threads = num_threads or min(8, os.cpu_count() or 1)
        # the arrays stay alive and contiguous while their pointers are pinned
        self._lr = [np.ascontiguousarray(a, np.uint8) for a in lr_images]
        self._hr = [np.ascontiguousarray(a, np.uint8) for a in hr_images]
        n = len(self._lr)
        self._lr_ptrs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in self._lr])
        self._hr_ptrs = (ctypes.c_void_p * n)(*[a.ctypes.data for a in self._hr])
        self._dims = (ctypes.c_int * (2 * n))(*[d for a in self._lr for d in a.shape[:2]])
        self._n = n

    @property
    def step(self) -> int:
        return self._step

    def seek(self, step: int) -> None:
        """Set the counter: the next batch draws from seed + step + 1."""
        self._step = int(step)

    def batch(self, batch_size: int, patch: int) -> Tuple[np.ndarray, np.ndarray]:
        hp = patch * self.scale
        out_lr = np.empty((batch_size, patch, patch, 3), np.float32)
        out_hr = np.empty((batch_size, hp, hp, 3), np.float32)
        self._step += 1
        rc = self._lib.lvt_patch_batch(
            self._lr_ptrs, self._hr_ptrs, self._dims, self._n, batch_size, patch,
            self.scale, (self.seed + self._step) & MASK64, out_lr.ctypes.data,
            out_hr.ctypes.data, self.num_threads)
        if rc != 0:
            raise RuntimeError("lvt_patch_batch failed with code %d" % (rc,))
        return out_lr, out_hr
