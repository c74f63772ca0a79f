"""PNG codec in numpy and zlib, for machines without Pillow.

Decodes 8-bit, non-interlaced greyscale (colour type 0), RGB (2) and
RGBA (6) images with any of the five row filters, into an (H, W, 3)
uint8 RGB array: grey is replicated, alpha is dropped (what Pillow's
`convert("RGB")` does). Anything else (16-bit samples, palettes, grey +
alpha, Adam7 interlacing) raises `ValueError`, which the server answers
with 400. Encodes (H, W, 3) uint8 RGB with filter 0 at a zlib level.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 6: 4}  # colour type -> samples per pixel


def _chunks(data: bytes):
    pos = len(SIGNATURE)
    while pos + 8 <= len(data):
        length, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + length]
        if len(body) != length:
            raise ValueError("truncated PNG chunk %r" % (kind,))
        yield kind, body
        if kind == b"IEND":
            return
        pos += 12 + length
    raise ValueError("PNG ends without IEND")


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


def _unfilter(raw: np.ndarray, height: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the per-row filters; raw is (height, 1 + stride) uint8."""
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


def decode(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB."""
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG")
    header, idat = None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _CHANNELS:
        raise ValueError("unsupported PNG: bit depth %d, colour type %d "
                         "(8-bit grey, RGB or RGBA only)" % (depth, ctype))
    if interlace:
        raise ValueError("interlaced PNGs are not supported")
    if width == 0 or height == 0:
        raise ValueError("empty PNG")
    bpp = _CHANNELS[ctype]
    stride = width * bpp
    raw = zlib.decompress(b"".join(idat))
    if len(raw) < height * (stride + 1):
        raise ValueError("PNG image data is short")
    rows = np.frombuffer(raw, np.uint8, height * (stride + 1)).reshape(height, stride + 1)
    pixels = _unfilter(rows, height, stride, bpp).reshape(height, width, bpp)
    if ctype == 0:
        return np.repeat(pixels, 3, axis=2)
    return np.ascontiguousarray(pixels[:, :, :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def encode(rgb: np.ndarray, level: int = 6) -> bytes:
    """(H, W, 3) uint8 RGB -> PNG bytes, filter 0, zlib `level` (0-9)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError("encode takes (H, W, 3) uint8, got %s %s"
                         % (rgb.dtype, rgb.shape))
    height, width, _ = rgb.shape
    rows = np.zeros((height, 1 + 3 * width), np.uint8)  # leading 0 = filter none
    rows[:, 1:] = rgb.reshape(height, 3 * width)
    ihdr = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))
