"""PNG files for the port's decoder tests, built with numpy and zlib.

`build_png` is a small writer that packs samples at any PNG bit depth,
filters each row and, for Adam7, splits the image into its seven passes:
it makes the files Pillow cannot write (packed depths with tRNS, 16-bit
grey + alpha, interlacing). `case_png` names one file per colour type and
depth (`CASES`), as tests/test_torch_png.py holds them against Pillow and
tests/test_torch_data.py against the JAX loader.
"""

import struct
import zlib

import numpy as np

from larvanet_tpu_torch.data import png


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _pack(samples, depth):
    """(h, w, channels) samples -> (h, row bytes) uint8 rows at `depth` bits
    (big-endian 16-bit samples; packed depths leftmost in the high bits)."""
    h, w, ch = samples.shape
    if depth == 16:
        return samples.astype(">u2").reshape(h, w * ch).view(np.uint8)
    if depth == 8:
        return samples.astype(np.uint8).reshape(h, w * ch)
    per = 8 // depth
    flat = np.pad(samples.reshape(h, w).astype(np.int64), ((0, 0), (0, -w % per)))
    shifts = np.arange(8 - depth, -1, -depth)
    return (flat.reshape(h, -1, per) << shifts).sum(axis=2).astype(np.uint8)


def _filter(rows, bpp, kinds):
    """Filter byte + filtered row for each row (PNG spec 9.2)."""
    raw = rows.astype(np.int32)
    out = []
    for y in range(raw.shape[0]):
        line = raw[y]
        prev = raw[y - 1] if y else np.zeros_like(line)
        left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        kind = kinds[y % len(kinds)]
        pred = {0: 0, 1: left, 2: prev, 3: (left + prev) // 2,
                4: _paeth(left, prev, up_left), 5: 0}[kind]
        out.append(bytes([kind]) + ((line - pred) & 0xFF).astype(np.uint8).tobytes())
    return b"".join(out)


def build_png(samples, depth, ctype, kinds=(4, 3, 1, 0, 2), chunks=(), interlace=False):
    """A PNG of (h, w, channels) integer samples: packed at `depth`, rows
    filtered by `kinds` in turn, `chunks` (PLTE, tRNS) before the image
    data; with `interlace`, the seven Adam7 passes one after another, an
    empty pass contributing no bytes."""
    h, w, ch = samples.shape
    bpp = max(1, depth * ch // 8)
    if interlace:
        passes = [samples[y0::dy, x0::dx] for x0, y0, dx, dy in png._ADAM7]
        data = b"".join(_filter(_pack(p, depth), bpp, kinds) for p in passes if p.size)
    else:
        data = _filter(_pack(samples, depth), bpp, kinds)
    ihdr = struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, int(interlace))
    return (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
            + b"".join(png._chunk(kind, body) for kind, body in chunks)
            + png._chunk(b"IDAT", zlib.compress(data)) + png._chunk(b"IEND", b""))


def _palette_png(rng, depth, trns, shape=(13, 17), interlace=False):
    n = min(1 << depth, 200)  # an 8-bit palette shorter than 256 entries
    palette = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    index = rng.integers(0, n, shape + (1,))
    chunks = [(b"PLTE", palette.tobytes())]
    if trns:  # alpha for the first entries only, as tRNS allows
        chunks.append((b"tRNS", rng.integers(0, 256, max(1, n // 2), dtype=np.uint8).tobytes()))
    return build_png(index, depth, 3, chunks=chunks, interlace=interlace)


def case_png(case, seed=0, shape=(13, 17), interlace=False):
    """The PNG bytes of one named case, "<kind>_<depth>" as in `CASES`."""
    rng = np.random.default_rng(seed)
    kind, depth = case.rsplit("_", 1)
    depth = int(depth)
    if kind in ("P", "P+tRNS"):
        return _palette_png(rng, depth, kind == "P+tRNS", shape, interlace)
    ctype, ch = {"L": (0, 1), "LA": (4, 2), "RGB": (2, 3), "RGBA": (6, 4)}[kind]
    samples = rng.integers(0, 1 << depth, shape + (ch,))
    if kind == "L" and depth == 16:  # both sides of the clip at 255
        samples[::2] = rng.integers(0, 256, samples[::2].shape)
    return build_png(samples, depth, ctype, interlace=interlace)


CASES = ["P_1", "P_2", "P_4", "P_8", "P+tRNS_1", "P+tRNS_2", "P+tRNS_4", "P+tRNS_8",
         "LA_8", "LA_16", "L_1", "L_2", "L_4", "RGB_16", "RGBA_16", "L_16"]
