"""The port's PNG codec (larvanet_tpu_torch/data/png.py) against Pillow,
pixel for pixel, in both directions."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from larvanet_tpu_torch.data import png


def _pil_png(arr, **save):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG", **save)
    return buf.getvalue()


def _pil_rgb(data):
    with Image.open(io.BytesIO(data)) as im:
        return np.asarray(im.convert("RGB"))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _filtered_png(pixels, kinds, ctype=2):
    """A PNG whose row y is written with filter kinds[y] (PNG spec 9.2)."""
    h, w, bpp = pixels.shape
    raw = pixels.reshape(h, w * bpp).astype(np.int32)
    rows = []
    for y in range(h):
        line = raw[y]
        prev = raw[y - 1] if y else np.zeros_like(line)
        left = np.concatenate([np.zeros(bpp, np.int32), line[:-bpp]])
        up_left = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        pred = {0: 0, 1: left, 2: prev, 3: (left + prev) // 2,
                4: _paeth(left, prev, up_left)}[kinds[y]]
        rows.append(bytes([kinds[y]]) + ((line - pred) & 0xFF).astype(np.uint8).tobytes())
    ihdr = struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0)
    return (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
            + png._chunk(b"IDAT", zlib.compress(b"".join(rows)))
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("channels", [3, 4, 1])
@pytest.mark.parametrize("save", [{"optimize": False}, {"optimize": True},
                                  {"compress_level": 0}, {"compress_level": 9}])
def test_decode_matches_pillow(channels, save):
    """RGB, RGBA and greyscale images as Pillow writes them."""
    rng = np.random.default_rng(channels + len(str(save)))
    h, w = 13, 17
    # half noise, half smooth ramps: Pillow's adaptive filtering then picks
    # several row filters within one image
    arr = rng.integers(0, 256, (h, w, channels), dtype=np.uint8)
    arr[h // 2:] = (np.arange(w)[None, :, None] * 7 + np.arange(h - h // 2)[:, None, None]
                    ).astype(np.uint8)
    data = _pil_png(arr if channels > 1 else arr[..., 0], **save)
    np.testing.assert_array_equal(png.decode(data), _pil_rgb(data))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, "mixed"])
def test_decode_each_filter_type(kind):
    rng = np.random.default_rng(3)
    pixels = rng.integers(0, 256, (10, 9, 3), dtype=np.uint8)
    kinds = [kind] * 10 if kind != "mixed" else [4, 3, 1, 0, 2, 4, 1, 3, 2, 0]
    data = _filtered_png(pixels, kinds)
    np.testing.assert_array_equal(_pil_rgb(data), pixels)
    np.testing.assert_array_equal(png.decode(data), pixels)


def test_decode_filtered_rgba_and_grey():
    rng = np.random.default_rng(4)
    rgba = rng.integers(0, 256, (6, 5, 4), dtype=np.uint8)
    data = _filtered_png(rgba, [4, 3, 1, 2, 4, 3], ctype=6)
    np.testing.assert_array_equal(png.decode(data), _pil_rgb(data))
    grey = rng.integers(0, 256, (6, 5, 1), dtype=np.uint8)
    data = _filtered_png(grey, [1, 4, 3, 2, 0, 4], ctype=0)
    np.testing.assert_array_equal(png.decode(data), _pil_rgb(data))


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_encode_reads_back_in_pillow(level):
    rng = np.random.default_rng(level)
    rgb = rng.integers(0, 256, (11, 14, 3), dtype=np.uint8)
    data = png.encode(rgb, level)
    np.testing.assert_array_equal(_pil_rgb(data), rgb)
    np.testing.assert_array_equal(png.decode(data), rgb)


def test_unsupported_inputs_raise():
    deep = _pil_png(np.arange(20, dtype=np.uint16).reshape(4, 5) * 3000)
    with pytest.raises(ValueError, match="bit depth 16"):
        png.decode(deep)
    palette = io.BytesIO()
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).convert("P").save(palette, format="PNG")
    with pytest.raises(ValueError, match="colour type 3"):
        png.decode(palette.getvalue())
    ihdr = struct.pack(">IIBBBBB", 2, 2, 8, 2, 0, 0, 1)
    interlaced = (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
                  + png._chunk(b"IDAT", zlib.compress(b"\0" * 14)) + png._chunk(b"IEND", b""))
    with pytest.raises(ValueError, match="interlaced"):
        png.decode(interlaced)
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode(b"GIF89a")
    with pytest.raises(ValueError):
        png.decode(png.encode(np.zeros((3, 3, 3), np.uint8))[:-20])
