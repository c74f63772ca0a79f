"""Full-frame inference in pieces (larvanet_tpu/eval/tiling.py).

1. `upscale_with_chop_forward`: the reference's chop-forward
   (utils/image_utils.py:7-65), numpy on the host around `model.upscale`:
   the CHW frame is split into 2x2 quadrants, each extended by
   overlap // 2, each quadrant upscaled on its own, and the trimmed
   quadrants pasted into the frame.

2. `TiledUpscaler`: fixed-size overlapping tiles, batched through an NHWC
   forward on the device. The frame is pushed once; the tiles are cut on
   the device and run in chunks of at most `max_batch`; each tile's owned
   range (the overlap split at the midpoint between neighbouring tile
   starts) is pasted on the device; the result is pulled once. Tiles are
   clamped to lie inside the frame (no padding), so where half the overlap
   exceeds the model's receptive radius the tiled output equals the
   full-frame forward's up to f32 rounding. A chunk is not padded to a
   power-of-two batch as in JAX, where the padding bounds XLA's compile
   count: nothing here compiles per shape, and a tile's output does not
   depend on the batch it runs in.

3. `make_strip_batched_forward` and `make_tile_scan_forward` (JAX's :34
   and :143): a frame of one fixed geometry through any NHWC forward (a
   port route, so the kernels run inside) in windows of rows, or of 2-D
   tiles, each extended by `halo` and shifted to stay inside the frame, so
   that the outer windows' SAME padding falls on the true frame edge; each
   window's owned rows (tiles) are written into one output frame on the
   device. Where `halo` reaches the model's receptive radius every owned
   pixel sees what it sees in the full frame. JAX's `lax.scan` over chunks
   and tile rows is a Python loop here: one chunk's (one tile row's)
   activations are live at a time.
"""

from __future__ import annotations

import math
from typing import Callable, List, Sequence, Tuple

import numpy as np
import torch

# ---------------------------------------------------------------------------
# Strips and 2-D tiles of one frame geometry, on the device
# ---------------------------------------------------------------------------


def _check_frame(x: torch.Tensor, height: int, width: int) -> None:
    if x.shape[1] != height or x.shape[2] != width:
        raise ValueError("frame shape %s does not match the traced (%d, %d) geometry"
                         % (tuple(x.shape[1:3]), height, width))


def make_strip_batched_forward(forward: Callable[[torch.Tensor], torch.Tensor], scale: int,
                               n_strips: int, halo: int, height: int, width: int,
                               chunk: int = 1) -> Callable[[torch.Tensor], torch.Tensor]:
    """Full-frame SR of (N, height, width, 3) frames through `forward` (an
    NHWC batch -> its NHWC x`scale` output) in `n_strips` windows of
    height / n_strips + 2 halo rows (larvanet_tpu/eval/tiling.py:34-140):
    window i starts at i sh - halo, clamped into the frame, and owns rows
    [i sh, (i + 1) sh). `chunk` strips go through `forward` as one batch
    (strip-major), one chunk after the other. Raises ValueError where
    n_strips does not divide the height, chunk does not divide n_strips,
    or a window exceeds the frame, and at call time on another geometry."""
    if height % n_strips:
        raise ValueError("height %d not divisible by n_strips %d" % (height, n_strips))
    if n_strips % chunk:
        raise ValueError("n_strips %d not divisible by chunk %d" % (n_strips, chunk))
    sh = height // n_strips
    win = sh + 2 * halo
    if win > height:
        raise ValueError("strip window %d exceeds frame height %d — fewer strips or a "
                         "smaller halo" % (win, height))
    starts = [min(max(i * sh - halo, 0), height - win) for i in range(n_strips)]
    offs = [i * sh - starts[i] for i in range(n_strips)]  # owned offset in its window
    s = scale

    @torch.no_grad()
    def run(x: torch.Tensor) -> torch.Tensor:
        _check_frame(x, height, width)
        n = x.shape[0]
        out = None
        for c0 in range(0, n_strips, chunk):
            strips = range(c0, c0 + chunk)
            outs = forward(torch.cat([x[:, starts[i]:starts[i] + win] for i in strips]))
            if out is None:
                out = outs.new_empty((n, height * s, width * s, outs.shape[-1]))
            for j, i in enumerate(strips):
                out[:, i * sh * s:(i + 1) * sh * s] = \
                    outs[j * n:(j + 1) * n, offs[i] * s:(offs[i] + sh) * s]
        return out

    return run


def make_tile_scan_forward(forward: Callable[[torch.Tensor], torch.Tensor], scale: int,
                           tile_h: int, tile_w: int, halo: int, height: int,
                           width: int) -> Callable[[torch.Tensor], torch.Tensor]:
    """Full-frame SR of (N, height, width, 3) frames through `forward` over
    a (height / tile_h, width / tile_w) grid of tiles, one tile row at a
    time (larvanet_tpu/eval/tiling.py:143-247): each tile's window reaches
    `halo` past it on every side, clamped to the frame and shifted to stay
    inside it; a row's windows go through `forward` as one batch
    (column-major within the row), and their owned tiles are written into
    the output. Raises ValueError where a tile side does not divide the
    frame's, and at call time on another geometry."""
    if height % tile_h:
        raise ValueError("height %d not divisible by tile_h %d" % (height, tile_h))
    if width % tile_w:
        raise ValueError("width %d not divisible by tile_w %d" % (width, tile_w))
    gh, gw = height // tile_h, width // tile_w
    # a window clamped to the frame only gains context on its far side
    wh, ww = min(tile_h + 2 * halo, height), min(tile_w + 2 * halo, width)
    rstarts = [min(max(i * tile_h - halo, 0), height - wh) for i in range(gh)]
    roffs = [i * tile_h - rstarts[i] for i in range(gh)]
    cstarts = [min(max(j * tile_w - halo, 0), width - ww) for j in range(gw)]
    coffs = [j * tile_w - cstarts[j] for j in range(gw)]
    s = scale

    @torch.no_grad()
    def run(x: torch.Tensor) -> torch.Tensor:
        _check_frame(x, height, width)
        n = x.shape[0]
        out = None
        for r in range(gh):
            rs, ro = rstarts[r], roffs[r]
            outs = forward(torch.cat([x[:, rs:rs + wh, cs:cs + ww] for cs in cstarts]))
            if out is None:
                out = outs.new_empty((n, height * s, width * s, outs.shape[-1]))
            for j, co in enumerate(coffs):
                out[:, r * tile_h * s:(r + 1) * tile_h * s, j * tile_w * s:(j + 1) * tile_w * s] \
                    = outs[j * n:(j + 1) * n, ro * s:(ro + tile_h) * s, co * s:(co + tile_w) * s]
        return out

    return run


# ---------------------------------------------------------------------------
# The reference's chop-forward (2x2 + overlap)
# ---------------------------------------------------------------------------


def split_image_2x2(image_chw: np.ndarray, overlap_size: int) -> List[np.ndarray]:
    """2x2 overlapping quadrants (reference utils/image_utils.py:30-45). An
    odd overlap loses its odd pixel: each quadrant reaches overlap // 2
    past the middle."""
    _, height, width = image_chw.shape
    sh, sw = height // 2, width // 2
    ho = overlap_size // 2
    return [
        image_chw[:, : sh + ho, : sw + ho].copy(),
        image_chw[:, : sh + ho, sw - ho :].copy(),
        image_chw[:, sh - ho :, : sw + ho].copy(),
        image_chw[:, sh - ho :, sw - ho :].copy(),
    ]


def combine_images_2x2(outputs: Sequence[np.ndarray], input_image_chw: np.ndarray,
                       scale: int, overlap_size: int) -> np.ndarray:
    """Paste the trimmed quadrants (reference utils/image_utils.py:47-65)."""
    _, height, width = input_image_chw.shape
    sh, sw = (height // 2) * scale, (width // 2) * scale
    nh, nw = height * scale, width * scale
    ho = (overlap_size // 2) * scale
    out = np.zeros((3, nh, nw), dtype=outputs[0].dtype)
    out[:, :sh, :sw] = outputs[0][:, :sh, :sw]
    out[:, :sh, sw:] = outputs[1][:, :sh, ho:]
    out[:, sh:, :sw] = outputs[2][:, ho:, :sw]
    out[:, sh:, sw:] = outputs[3][:, ho:, ho:]
    return out


def upscale_with_chop_forward(model, input_image: np.ndarray, scale: int,
                              overlap_size: int) -> np.ndarray:
    """The reference's chop-forward (utils/image_utils.py:7-27): four
    `model.upscale` calls, one a quadrant; CHW float32 out."""
    splits = split_image_2x2(input_image, overlap_size)
    outputs = [model.upscale([s], scale)[0] for s in splits]
    return combine_images_2x2(outputs, input_image, scale, overlap_size)


# ---------------------------------------------------------------------------
# Batched overlapping tiles on the device
# ---------------------------------------------------------------------------


def _tile_starts(extent: int, tile: int, stride: int) -> List[int]:
    """Clamped tile starts covering [0, extent) with every tile inside."""
    if extent <= tile:
        return [0]
    n = math.ceil((extent - tile) / stride) + 1
    return [min(i * stride, extent - tile) for i in range(n)]


def _owned_ranges(starts: List[int], tile: int, extent: int) -> List[Tuple[int, int, int, int]]:
    """(out_start, out_end, tile_start, tile_end) a tile: the overlap of two
    neighbours is split at the midpoint between them."""
    ranges = []
    for i, s in enumerate(starts):
        lo = 0 if i == 0 else (starts[i - 1] + tile + s) // 2
        hi = extent if i == len(starts) - 1 else (s + tile + starts[i + 1]) // 2
        ranges.append((lo, hi, lo - s, hi - s))
    return ranges


class TiledUpscaler:
    """Overlapping tile_size x tile_size tiles of a frame, batched through
    `forward_nhwc` (an NHWC f32 batch on `device` -> its NHWC output there,
    e.g. `SRModel.fwd_runtime`)."""

    def __init__(self, forward_nhwc: Callable[[torch.Tensor], torch.Tensor], scale: int,
                 tile_size: int = 128, overlap: int = 24, max_batch: int = 64,
                 device="cpu"):
        if overlap >= tile_size:
            raise ValueError("overlap must be smaller than tile_size")
        if max_batch < 1:
            raise ValueError("max_batch must be at least 1")
        self.forward = forward_nhwc
        self.scale = scale
        self.tile = tile_size
        self.stride = tile_size - overlap
        self.max_batch = max_batch
        self.device = torch.device(device)

    @torch.no_grad()
    def upscale_device(self, frame_hwc: torch.Tensor) -> torch.Tensor:
        """SR one HWC frame on the device -> HWC float32 on the device. A
        frame smaller than a tile on either side takes one full-frame call."""
        x = frame_hwc.float()
        h, w, c = x.shape
        t, s = self.tile, self.scale
        if h < t or w < t:
            return self.forward(x[None])[0]
        ys = _tile_starts(h, t, self.stride)
        xs = _tile_starts(w, t, self.stride)
        tiles = torch.stack([x[y:y + t, x0:x0 + t] for y in ys for x0 in xs])
        owned = [(r, q) for r in _owned_ranges(ys, t, h) for q in _owned_ranges(xs, t, w)]
        result = torch.empty((h * s, w * s, c), dtype=torch.float32, device=x.device)
        for i in range(0, len(tiles), self.max_batch):
            out = self.forward(tiles[i:i + self.max_batch])
            for tile_out, ((oy0, oy1, ty0, ty1), (ox0, ox1, tx0, tx1)) in zip(
                    out, owned[i:i + self.max_batch]):
                result[oy0 * s:oy1 * s, ox0 * s:ox1 * s] = \
                    tile_out[ty0 * s:ty1 * s, tx0 * s:tx1 * s]
        return result

    def upscale_hwc(self, image_hwc: np.ndarray) -> np.ndarray:
        """SR one HWC host frame (uint8 frames are pushed as uint8 and cast on
        the device) -> HWC float32 on the host."""
        frame = torch.from_numpy(np.ascontiguousarray(image_hwc)).to(self.device)
        return self.upscale_device(frame).cpu().numpy()

    def upscale_chw(self, image_chw: np.ndarray) -> np.ndarray:
        return self.upscale_hwc(np.asarray(image_chw).transpose(1, 2, 0)).transpose(2, 0, 1)
