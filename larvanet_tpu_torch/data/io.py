"""Host-side image IO (larvanet_tpu/data/io.py:22-66).

Images travel through the port as the reference's loader contract has
them: CHW float32 RGB in [0, 255]. The card's machine has no Pillow and
no libpng guarantee, so PNGs go through the port's own decoder,
`data/native.decode_png` (the counterpart of the JAX loader's libpng path):
zlib's inflate and the codec of `data/png.py`, with the row filters undone
in the port's host C (`csrc/host/lvt_data.cpp`). It gives every PNG the
values the JAX loader's libpng decoder gives (16-bit greyscale keeps its
high byte, as `png_set_strip_16` does) and raises IOError where a file
cannot be read or decoded.
"""

from __future__ import annotations

import os
from typing import List

import numpy as np

from larvanet_tpu_torch.data import native, png


def load_image_u8(path: str) -> np.ndarray:
    """Read a PNG as HWC uint8 RGB (`native.decode_png`)."""
    return native.decode_png(path)


def load_image_chw(path: str) -> np.ndarray:
    """Read a PNG as CHW float32 RGB in [0, 255] (the loader contract)."""
    return load_image_u8(path).transpose(2, 0, 1).astype(np.float32)


def save_image_chw(image_chw: np.ndarray, path: str) -> None:
    """Write a CHW uint8 or float image as PNG; floats are rounded and
    clipped (reference validate.py:29-32)."""
    save_image_hwc(np.transpose(np.asarray(image_chw), (1, 2, 0)), path)


def save_image_hwc(image_hwc: np.ndarray, path: str) -> None:
    img = np.asarray(image_hwc)
    if img.dtype != np.uint8:
        img = np.clip(np.round(img), 0, 255).astype(np.uint8)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(png.encode(img))


def list_pngs(directory: str) -> List[str]:
    """Sorted basenames (without extension) of the PNGs in a directory."""
    return sorted(os.path.splitext(f)[0] for f in os.listdir(directory)
                  if f.lower().endswith(".png"))
