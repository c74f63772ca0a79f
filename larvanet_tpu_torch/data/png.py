"""PNG codec in numpy, zlib and the port's host C (row filters), for machines
without Pillow.

Decodes every PNG the JAX package decodes into an (H, W, 3) uint8 RGB
array: greyscale (colour type 0) at 1, 2, 4, 8 and 16 bits, RGB (2) and
RGBA (6) at 8 and 16, palette (3) at 1, 2, 4 and 8 with or without tRNS,
grey + alpha (4) at 8 and 16, each with any of the five row filters,
plain or Adam7-interlaced. Grey is replicated and alpha (and tRNS) dropped,
as Pillow's `convert("RGB")` and the JAX package's libpng loader both do;
grey below 8 bits is scaled to 0..255 as both scale it (1 -> 255 at 1 bit)
and 16-bit samples keep their high byte. The one case where the two JAX
decoders differ is 16-bit greyscale: Pillow clips the value at 255, libpng
(`png_set_strip_16`) keeps the high byte. The caller names the rule it
follows (`grey16`). A bad signature, truncated or corrupt data, an unknown
filter type, an unknown bit depth or colour type and an empty image raise
`ValueError`, which the server answers with 400. Encodes (H, W, 3) uint8
RGB at a zlib level, every row with one filter type (0, None, by default).

zlib inflates; the row filters are undone in host C (`data/native.unfilter`,
`csrc/host/lvt_data.cpp`), whose plain version, in numpy, is
`native.unfilter_plain`.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np

from larvanet_tpu_torch.data import native

SIGNATURE = b"\x89PNG\r\n\x1a\n"
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}  # colour type -> samples per pixel
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16), 6: (8, 16)}
# Adam7: (first column, first row, column step, row step) of each pass
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4), (0, 2, 2, 4),
          (1, 0, 2, 2), (0, 1, 1, 2))
# how 16-bit greyscale becomes 8 bits: Pillow's convert("RGB") clips at 255
# (the JAX server), libpng's strip_16 keeps the high byte (the JAX loaders)
GREY16_RULES = ("clip", "high")


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


def _samples(rows: np.ndarray, width: int, depth: int, channels: int) -> np.ndarray:
    """Unfiltered rows (h, row bytes) -> (h, width, channels) samples,
    uint16 at 16 bits, else uint8 (packed depths unpacked, not scaled)."""
    h = rows.shape[0]
    if depth == 16:  # big-endian pairs
        pairs = rows.reshape(h, width * channels, 2).astype(np.uint16)
        return (pairs[:, :, 0] << 8 | pairs[:, :, 1]).reshape(h, width, channels)
    if depth == 8:
        return rows.reshape(h, width, channels)
    # grey or palette (one sample a pixel) packed in bytes, leftmost highest
    per_byte = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    unpacked = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return unpacked.reshape(h, rows.shape[1] * per_byte)[:, :width, None]


def _image(raw: bytes, width: int, height: int, depth: int, channels: int,
           interlace: int) -> np.ndarray:
    """Decompressed image data -> (height, width, channels) samples."""
    bits = depth * channels
    bpp = max(1, bits // 8)  # filter distance in bytes

    def rows_of(pos, w, h):
        stride = (w * bits + 7) // 8
        end = pos + h * (stride + 1)
        if len(raw) < end:
            raise ValueError("PNG image data is short")
        rows = np.frombuffer(raw, np.uint8, h * (stride + 1), pos).reshape(h, stride + 1)
        return _samples(native.unfilter(rows, h, stride, bpp), w, depth, channels), end

    if not interlace:
        return rows_of(0, width, height)[0]
    out = np.zeros((height, width, channels), np.uint16 if depth == 16 else np.uint8)
    pos = 0
    for x0, y0, dx, dy in _ADAM7:
        w, h = -(-(width - x0) // dx), -(-(height - y0) // dy)
        if w <= 0 or h <= 0:
            continue  # an empty pass has no bytes at all, not even filter bytes
        out[y0::dy, x0::dx], pos = rows_of(pos, w, h)
    return out


def decode(data: bytes, *, grey16: str) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB. `grey16` ("clip" or "high", see
    GREY16_RULES) turns 16-bit greyscale into 8 bits."""
    if grey16 not in GREY16_RULES:
        raise ValueError("grey16 must be one of %s, got %r" % (GREY16_RULES, grey16))
    if not data.startswith(SIGNATURE):
        raise ValueError("not a PNG")
    header, palette, idat = None, None, []
    for kind, body in _chunks(data):
        if kind == b"IHDR":
            if len(body) != 13:
                raise ValueError("bad PNG IHDR")
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body[:len(body) // 3 * 3], np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
    if header is None:
        raise ValueError("PNG without IHDR")
    width, height, depth, ctype, _, _, interlace = header
    if ctype not in _DEPTHS or depth not in _DEPTHS[ctype] or interlace > 1:
        raise ValueError("unsupported PNG: bit depth %d, colour type %d, interlace %d"
                         % (depth, ctype, interlace))
    if width == 0 or height == 0:
        raise ValueError("empty PNG")
    if ctype == 3 and palette is None:
        raise ValueError("palette PNG without PLTE")
    try:
        raw = zlib.decompress(b"".join(idat))
    except zlib.error as exc:
        raise ValueError("corrupt PNG image data: %s" % exc) from None
    samples = _image(raw, width, height, depth, _CHANNELS[ctype], interlace)
    if ctype == 3:
        # indices past the palette's end read black, as in a zero-padded palette
        full = np.zeros((256, 3), np.uint8)
        full[:len(palette)] = palette[:256]
        return full[samples[:, :, 0]]
    if depth == 16:
        if ctype == 0 and grey16 == "clip":
            samples = np.minimum(samples, 255)
        else:
            samples = samples >> 8
        samples = samples.astype(np.uint8)
    elif depth < 8:  # grey at 1, 2 or 4 bits, scaled to 0..255 by bit replication
        samples = samples * np.uint8(255 // ((1 << depth) - 1))
    if ctype in (0, 4):
        return np.repeat(samples[:, :, :1], 3, axis=2)
    return np.ascontiguousarray(samples[:, :, :3])


def _chunk(kind: bytes, body: bytes) -> bytes:
    crc = zlib.crc32(kind + body) & 0xFFFFFFFF
    return struct.pack(">I", len(body)) + kind + body + struct.pack(">I", crc)


def _filter_rows(rows: np.ndarray, kind: int, bpp: int) -> np.ndarray:
    """(h, row bytes) uint8 rows -> each filtered by `kind` (0-4) as the
    PNG spec writes it (9.2), from the raw bytes (a filter never reads
    filtered ones, so every row at once)."""
    x = rows.astype(np.int16)
    left = np.zeros_like(x)
    left[:, bpp:] = x[:, :-bpp]
    up = np.zeros_like(x)
    up[1:] = x[:-1]
    up_left = np.zeros_like(x)
    up_left[1:, bpp:] = x[:-1, :-bpp]
    if kind == 0:
        pred = 0
    elif kind == 1:
        pred = left
    elif kind == 2:
        pred = up
    elif kind == 3:
        pred = (left + up) >> 1
    elif kind == 4:
        p = left + up - up_left
        pa, pb, pc = np.abs(p - left), np.abs(p - up), np.abs(p - up_left)
        pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, up, up_left))
    else:
        raise ValueError("PNG filter type %d is not 0-4" % kind)
    return ((x - pred) & 0xFF).astype(np.uint8)


def encode(rgb: np.ndarray, level: int = 6, filter_type: int = 0) -> bytes:
    """(H, W, 3) uint8 RGB -> PNG bytes, zlib `level` (0-9), every row
    filtered by `filter_type` (0 None, 1 Sub, 2 Up, 3 Average, 4 Paeth)."""
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError("encode takes (H, W, 3) uint8, got %s %s"
                         % (rgb.dtype, rgb.shape))
    height, width, _ = rgb.shape
    rows = np.empty((height, 1 + 3 * width), np.uint8)
    rows[:, 0] = filter_type
    rows[:, 1:] = _filter_rows(rgb.reshape(height, 3 * width), filter_type, 3)
    ihdr = struct.pack(">IIBBBBB", width, height, 8, 2, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
            + _chunk(b"IEND", b""))
