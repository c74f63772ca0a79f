"""The port's PNG codec (larvanet_tpu_torch/data/png.py) against Pillow,
pixel for pixel, in both directions.

Decoding is held to Pillow's `convert("RGB")`, which the JAX server uses:
16-bit greyscale under the "clip" rule. Files Pillow cannot write (packed
depths with tRNS, 16-bit grey + alpha, Adam7 interlacing) come from
tests/torch_png_cases.py.
"""

import io
import struct
import warnings
import zlib

import numpy as np
import pytest
from PIL import Image

from larvanet_tpu_torch.data import png
from torch_png_cases import CASES, build_png, case_png


def _pil_png(arr, **save):
    buf = io.BytesIO()
    Image.fromarray(arr).save(buf, format="PNG", **save)
    return buf.getvalue()


def _pil_rgb(data):
    with Image.open(io.BytesIO(data)) as im, warnings.catch_warnings():
        # Pillow notes that a palette's tRNS is dropped by convert("RGB")
        warnings.filterwarnings("ignore", "Palette images with Transparency")
        return np.asarray(im.convert("RGB"))


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
    np.testing.assert_array_equal(png.decode(data, grey16="clip"), _pil_rgb(data))


@pytest.mark.parametrize("kind", [0, 1, 2, 3, 4, "mixed"])
def test_decode_each_filter_type(kind):
    rng = np.random.default_rng(3)
    pixels = rng.integers(0, 256, (10, 9, 3), dtype=np.uint8)
    kinds = [kind] * 10 if kind != "mixed" else [4, 3, 1, 0, 2, 4, 1, 3, 2, 0]
    data = build_png(pixels, 8, 2, kinds)
    np.testing.assert_array_equal(_pil_rgb(data), pixels)
    np.testing.assert_array_equal(png.decode(data, grey16="clip"), pixels)


def test_decode_filtered_rgba_and_grey():
    rng = np.random.default_rng(4)
    rgba = rng.integers(0, 256, (6, 5, 4), dtype=np.uint8)
    data = build_png(rgba, 8, 6, [4, 3, 1, 2, 4, 3])
    np.testing.assert_array_equal(png.decode(data, grey16="clip"), _pil_rgb(data))
    grey = rng.integers(0, 256, (6, 5, 1), dtype=np.uint8)
    data = build_png(grey, 8, 0, [1, 4, 3, 2, 0, 4])
    np.testing.assert_array_equal(png.decode(data, grey16="clip"), _pil_rgb(data))


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_encode_reads_back_in_pillow(level):
    rng = np.random.default_rng(level)
    rgb = rng.integers(0, 256, (11, 14, 3), dtype=np.uint8)
    data = png.encode(rgb, level)
    np.testing.assert_array_equal(_pil_rgb(data), rgb)
    np.testing.assert_array_equal(png.decode(data, grey16="clip"), rgb)


def test_unsupported_inputs_raise():
    """What neither JAX decoder takes: a bad signature, truncation, an
    unknown filter type, an unknown depth for the colour type, an empty
    image; and a missing or unknown 16-bit grey rule."""
    with pytest.raises(ValueError, match="not a PNG"):
        png.decode(b"GIF89a", grey16="clip")
    with pytest.raises(ValueError):
        png.decode(png.encode(np.zeros((3, 3, 3), np.uint8))[:-20], grey16="clip")
    bad_filter = build_png(np.zeros((2, 3, 3), np.uint8), 8, 2, kinds=[0, 5])
    with pytest.raises(ValueError, match="filter type 5"):
        png.decode(bad_filter, grey16="clip")
    def header_only(width, depth, ctype):
        ihdr = struct.pack(">IIBBBBB", width, 3, depth, ctype, 0, 0, 0)
        return (png.SIGNATURE + png._chunk(b"IHDR", ihdr)
                + png._chunk(b"IDAT", zlib.compress(b"\0" * 30)) + png._chunk(b"IEND", b""))

    with pytest.raises(ValueError, match="bit depth 4, colour type 2"):
        png.decode(header_only(2, 4, 2), grey16="clip")
    with pytest.raises(ValueError, match="empty PNG"):
        png.decode(header_only(0, 8, 2), grey16="clip")
    with pytest.raises(ValueError, match="grey16"):
        png.decode(png.encode(np.zeros((3, 3, 3), np.uint8)), grey16="round")
    with pytest.raises(TypeError):
        png.decode(png.encode(np.zeros((3, 3, 3), np.uint8)))  # the rule has no default


@pytest.mark.parametrize("case", CASES)
def test_decode_matches_pillow_for_every_colour_type_and_depth(case):
    data = case_png(case)
    want = _pil_rgb(data)
    got = png.decode(data, grey16="clip")
    assert got.shape == (13, 17, 3) and got.dtype == np.uint8
    np.testing.assert_array_equal(got, want)


def test_palette_indices_past_the_palette_read_black():
    """As Pillow (and the JAX loader's libpng) read them."""
    palette = np.array([[10, 20, 30], [40, 50, 60]], np.uint8)
    index = np.array([[0, 1, 2, 3, 255]])[..., None]
    data = build_png(index, 8, 3, chunks=[(b"PLTE", palette.tobytes())])
    got = png.decode(data, grey16="clip")
    np.testing.assert_array_equal(got, _pil_rgb(data))
    np.testing.assert_array_equal(got[0, 2:], 0)


def test_grey16_rules_clip_or_take_the_high_byte():
    """The two JAX decoders' rules for 16-bit grey: 4000 -> 255 (Pillow's
    clip) or 4000 >> 8 = 15 (libpng's strip_16)."""
    values = np.array([[0, 200, 255, 256, 4000, 65535]])
    data = build_png(values[..., None], 16, 0)
    np.testing.assert_array_equal(png.decode(data, grey16="clip")[..., 0],
                                  [[0, 200, 255, 255, 255, 255]])
    np.testing.assert_array_equal(png.decode(data, grey16="high")[..., 0],
                                  [[0, 0, 0, 1, 15, 255]])
    np.testing.assert_array_equal(png.decode(data, grey16="clip"), _pil_rgb(data))


@pytest.mark.parametrize("mode", ["P", "LA", "1", "I;16"])
def test_decode_matches_pillow_on_files_pillow_writes(mode):
    rng = np.random.default_rng(5)
    rgb = rng.integers(0, 256, (9, 14, 3), dtype=np.uint8)
    if mode == "I;16":
        im = Image.fromarray(rng.integers(0, 600, (9, 14)).astype(np.uint16))
    else:
        im = Image.fromarray(rgb).convert(mode)
    buf = io.BytesIO()
    im.save(buf, format="PNG")
    np.testing.assert_array_equal(png.decode(buf.getvalue(), grey16="clip"),
                                  _pil_rgb(buf.getvalue()))


@pytest.mark.parametrize("shape", [(13, 17), (1, 1), (2, 3), (5, 1), (1, 6)])
@pytest.mark.parametrize("case", ["RGB_8", "P+tRNS_2", "L_16", "RGBA_16"])
def test_decode_adam7_interlaced(case, shape):
    """Adam7 on odd sizes whose small passes are empty or one pixel wide.
    Pillow must first read the writer's file as the plain one, then the port
    must give the same pixels."""
    plain = case_png(case, seed=7, shape=shape)
    laced = case_png(case, seed=7, shape=shape, interlace=True)
    want = _pil_rgb(plain)
    np.testing.assert_array_equal(_pil_rgb(laced), want)
    np.testing.assert_array_equal(png.decode(laced, grey16="clip"), want)
    np.testing.assert_array_equal(png.decode(plain, grey16="clip"), want)
