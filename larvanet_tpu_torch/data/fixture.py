"""The frozen, reproducible synthetic DIV2K stand-in
(larvanet_tpu/data/fixture.py), written and read by the port alone.

    python -m larvanet_tpu_torch.data.fixture --root data/fixture
    python -m larvanet_tpu_torch.data.fixture --root data/fixture_real --realistic
    python -m larvanet_tpu_torch.data.fixture --root data/fixture --verify

The generator is the JAX package's, in numpy only, with the same seeds,
shapes, layout and MANIFEST keys:

* content is a seeded mixture of oriented sinusoidal gratings, smooth
  low-frequency fields, hard-edged rectangles and light noise (the
  standard tier), or 1/f natural-statistics frames at ~320x480 HR (the
  realistic tier, `--realistic`);
* LR images are exact box-average downsamples of the scale-aligned crop of
  the HR image;
* HR sizes include non-multiples of the scale (the truth-crop path) and
  odd LR widths;
* MANIFEST.json pins the sha256 of every image's raw pixels (shape and
  bytes, not the PNG bytes) with the generator's config; `verify()`
  re-hashes the tree.

PNGs are written by the port's encoder (`data/png.py`) and read by its
decoder (`data/native.decode_png`), so a card machine without Pillow can
write, verify and score the fixture. The pixels, and so the MANIFESTs,
equal the JAX package's: tests/data/fixture_manifest.json and
fixture_real_manifest.json.

Layout:

  x{s}/input/{name}.png, x{s}/truth/{name}.png
      flat scheme for basic_loader (reference dataloaders/basic_loader.py:109-142)
  test_LR/{dataset}/{name}.png, test_HR/{dataset}/{name}.png
      paper-protocol tree for the test CLI (reference test.py:91-98);
      dataset "DIV2K_val" names LR files {name}x4.png (test.py:123-125)
"""

from __future__ import annotations

import hashlib
import json
import os
from typing import Dict, Sequence, Tuple

import numpy as np

from larvanet_tpu_torch.data import io

STANDARD_SEED = 20260817
# (LR_h, LR_w, extra_h, extra_w): HR = (LR_h*s + extra_h, LR_w*s + extra_w).
# Odd LR widths and non-zero extras are deliberate (see module docstring).
STANDARD_SHAPES: Tuple[Tuple[int, int, int, int], ...] = (
    (32, 40, 0, 0),
    (30, 33, 1, 2),   # odd LR width + truth-crop extras
    (40, 28, 2, 0),
    (25, 25, 0, 1),   # odd both
    (36, 44, 0, 0),
    (28, 37, 3, 3),   # odd LR width + extras
)


def _render_hr(rng: np.random.Generator, height: int, width: int) -> np.ndarray:
    """One synthetic HR image, uint8 HWC RGB."""
    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)
    img = np.zeros((height, width, 3), dtype=np.float64)

    # smooth low-frequency field: bilinear-upsampled coarse noise
    coarse = rng.uniform(-1.0, 1.0, (6, 6, 3))
    cy = np.linspace(0, 5, height)
    cx = np.linspace(0, 5, width)
    iy, ix = np.floor(cy).astype(int), np.floor(cx).astype(int)
    iy1, ix1 = np.minimum(iy + 1, 5), np.minimum(ix + 1, 5)
    fy, fx = (cy - iy)[:, None, None], (cx - ix)[None, :, None]
    img += 0.6 * (
        coarse[iy][:, ix] * (1 - fy) * (1 - fx)
        + coarse[iy][:, ix1] * (1 - fy) * fx
        + coarse[iy1][:, ix] * fy * (1 - fx)
        + coarse[iy1][:, ix1] * fy * fx
    )

    # oriented gratings (per-channel phase offsets give chroma detail)
    for _ in range(4):
        theta = rng.uniform(0, np.pi)
        freq = rng.uniform(0.05, 0.45)
        phase = rng.uniform(0, 2 * np.pi, 3)
        u = xx * np.cos(theta) + yy * np.sin(theta)
        img += rng.uniform(0.1, 0.35) * np.sin(
            2 * np.pi * freq * u[:, :, None] + phase[None, None, :]
        )

    # hard-edged rectangles (test edge reconstruction)
    for _ in range(3):
        h0 = rng.integers(0, max(1, height - 8))
        w0 = rng.integers(0, max(1, width - 8))
        h1 = h0 + rng.integers(4, max(5, height // 3))
        w1 = w0 + rng.integers(4, max(5, width // 3))
        img[h0:h1, w0:w1] += rng.uniform(-0.5, 0.5, 3)

    img += 0.02 * rng.standard_normal((height, width, 3))
    lo, hi = img.min(), img.max()
    img = (img - lo) / max(hi - lo, 1e-9)
    return np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)


REALISTIC_SEED = 20260818
# LR geometries around 80x120 (HR ~320x480 at x4): realistic border-to-
# interior ratios for tiling/halo/border operators, odd widths and
# truth-crop extras still exercised (the 25-40 px standard tier is
# border-dominated).
REALISTIC_N_IMAGES = 48


def _realistic_shapes(rng: np.random.Generator, n: int):
    """n (LR_h, LR_w, extra_h, extra_w) tuples around 80x120 (x4 HR
    ~320x480), deterministic in rng; every 6th has an odd LR width and
    every 5th non-zero truth-crop extras."""
    shapes = []
    for i in range(n):
        lh = int(rng.integers(72, 88))
        lw = int(rng.integers(110, 130))
        if i % 6 == 3:
            lw |= 1  # force odd LR width
        eh = int(rng.integers(0, 4)) if i % 5 == 2 else 0
        ew = int(rng.integers(0, 4)) if i % 5 == 2 else 0
        shapes.append((lh, lw, eh, ew))
    return shapes


def _render_hr_natural(rng: np.random.Generator, height: int, width: int) -> np.ndarray:
    """One natural-statistics HR image, uint8 HWC RGB.

    Built to match the statistics SR models actually meet (the tiny
    fixture's gratings+rectangles are too synthetic at 320x480):

      * 1/f^1.1 spectral luminance base (the canonical natural-image
        power law) via an FFT with random phases;
      * correlated chroma: two more 1/f fields mixed through a
        luma-dominant 3x3 matrix (natural RGB channels are ~0.9
        correlated);
      * piecewise regions: soft-thresholded low-frequency fields create
        object-like segments with distinct color offsets -> real edges
        at every orientation and curvature;
      * multi-scale Gabor-like texture: 3 octaves of oriented gratings,
        each windowed by its own smooth mask (texture patches, not
        global gratings);
      * a smooth illumination gradient and mild sensor noise.
    """
    def pink(alpha: float) -> np.ndarray:
        fy = np.fft.fftfreq(height)[:, None]
        fx = np.fft.rfftfreq(width)[None, :]
        f = np.sqrt(fy * fy + fx * fx)
        f[0, 0] = 1.0
        amp = f ** (-alpha)
        amp[0, 0] = 0.0
        phase = rng.uniform(0, 2 * np.pi, amp.shape)
        spec = amp * np.exp(1j * phase)
        field = np.fft.irfft2(spec, s=(height, width))
        sd = field.std()
        return field / (sd if sd > 1e-12 else 1.0)

    yy, xx = np.mgrid[0:height, 0:width].astype(np.float64)

    # luminance + two chroma fields, mixed luma-dominant
    basis = np.stack([pink(1.1), pink(1.1), pink(1.1)], axis=-1)
    mix = np.array([[1.0, 0.9, 0.85],
                    [0.25, -0.2, 0.05],
                    [0.1, 0.15, -0.25]])
    img = basis @ mix

    # piecewise segments: smooth fields thresholded into regions, each
    # region shifted by its own color (sharp, curved edges)
    for _ in range(3):
        seg = pink(1.6)
        m = (seg > np.quantile(seg, rng.uniform(0.45, 0.75))).astype(np.float64)
        img += m[:, :, None] * rng.uniform(-0.7, 0.7, 3)

    # multi-scale windowed texture (3 octaves)
    for octave in range(3):
        freq = 0.06 * (2 ** octave) * rng.uniform(0.8, 1.25)
        theta = rng.uniform(0, np.pi)
        u = xx * np.cos(theta) + yy * np.sin(theta)
        mask = pink(1.8)
        mask = np.clip(mask - np.quantile(mask, 0.6), 0, None)
        mx = mask.max()
        if mx > 1e-12:
            mask /= mx
        img += (rng.uniform(0.15, 0.4) * mask
                * np.sin(2 * np.pi * freq * u + rng.uniform(0, 2 * np.pi))
                )[:, :, None] * rng.uniform(0.5, 1.0, 3)

    # smooth illumination gradient
    gdir = rng.uniform(0, 2 * np.pi)
    g = (xx * np.cos(gdir) + yy * np.sin(gdir)) / max(height, width)
    img += 0.3 * (g - g.mean())[:, :, None]

    img += 0.01 * rng.standard_normal((height, width, 3))

    # robust normalization (percentile, not min/max: heavy tails would
    # otherwise crush the midtones)
    lo, hi = np.quantile(img, 0.005), np.quantile(img, 0.995)
    img = (img - lo) / max(hi - lo, 1e-9)
    return np.clip(np.round(img * 255.0), 0, 255).astype(np.uint8)


def generate_realistic(
    root: str,
    seed: int = REALISTIC_SEED,
    n_images: int = REALISTIC_N_IMAGES,
    scales: Sequence[int] = (4,),
    n_test: int = 12,
    datasets: Sequence[str] = ("SynSetReal", "DIV2K_val"),
) -> Dict:
    """Write the realistic-geometry fixture tree under `root` (same layout
    as generate(): flat x{s}/ scheme + paper-protocol test trees for the
    first `n_test` images). ~28 MB, fully deterministic from the seed."""
    rng = np.random.default_rng(seed)
    shapes = _realistic_shapes(rng, n_images)
    entries: Dict[str, str] = {}

    def put(relpath: str, arr_hwc_u8: np.ndarray) -> None:
        io.save_image_hwc(arr_hwc_u8, os.path.join(root, relpath))
        entries[relpath] = _pixel_hash(arr_hwc_u8)

    for i, (lh, lw, eh, ew) in enumerate(shapes):
        name = "real%03d" % (i,)
        for s in scales:
            hr = _render_hr_natural(rng, lh * s + eh, lw * s + ew)
            lr = _box_downsample(hr[: lh * s, : lw * s], s)
            put("x%d/truth/%s.png" % (s, name), hr)
            put("x%d/input/%s.png" % (s, name), lr)
            if s == 4 and i < n_test:
                for ds in datasets:
                    lr_name = name + ("x4" if ds == "DIV2K_val" else "")
                    put("test_HR/%s/%s.png" % (ds, name), hr)
                    put("test_LR/%s/%s.png" % (ds, lr_name), lr)

    manifest = {
        "profile": "realistic",
        "seed": int(seed),
        "n_images": int(n_images),
        "shapes": [list(sh) for sh in shapes],
        "scales": [int(s) for s in scales],
        "n_test": int(n_test),
        "datasets": list(datasets),
        "images": entries,
    }
    with open(os.path.join(root, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return manifest


def ensure_realistic(root: str, **kwargs) -> Dict:
    """Generate the realistic fixture if absent, verify it if present."""
    if os.path.exists(os.path.join(root, "MANIFEST.json")):
        return verify(root)
    return generate_realistic(root, **kwargs)


def _box_downsample(hr: np.ndarray, scale: int) -> np.ndarray:
    """Exact integer-factor box average of a scale-aligned uint8 image."""
    h, w, c = hr.shape
    assert h % scale == 0 and w % scale == 0
    acc = hr.reshape(h // scale, scale, w // scale, scale, c).astype(np.float64)
    return np.clip(np.round(acc.mean(axis=(1, 3))), 0, 255).astype(np.uint8)


def _pixel_hash(arr: np.ndarray) -> str:
    h = hashlib.sha256()
    h.update(str(arr.shape).encode())
    h.update(np.ascontiguousarray(arr).tobytes())
    return h.hexdigest()


def generate(
    root: str,
    seed: int = STANDARD_SEED,
    shapes: Sequence[Tuple[int, int, int, int]] = STANDARD_SHAPES,
    scales: Sequence[int] = (2, 3, 4),
    datasets: Sequence[str] = ("SynSet", "DIV2K_val"),
) -> Dict:
    """Write the fixture tree under `root`; returns (and writes) the manifest."""
    rng = np.random.default_rng(seed)
    entries: Dict[str, str] = {}

    def put(relpath: str, arr_hwc_u8: np.ndarray) -> None:
        io.save_image_hwc(arr_hwc_u8, os.path.join(root, relpath))
        entries[relpath] = _pixel_hash(arr_hwc_u8)

    # One independent HR per (image, scale): sizes differ per scale anyway.
    for i, (lh, lw, eh, ew) in enumerate(shapes):
        name = "img%03d" % (i,)
        for s in scales:
            hr = _render_hr(rng, lh * s + eh, lw * s + ew)
            lr = _box_downsample(hr[: lh * s, : lw * s], s)
            put("x%d/truth/%s.png" % (s, name), hr)
            put("x%d/input/%s.png" % (s, name), lr)
            if s == 4:
                for ds in datasets:
                    lr_name = name + ("x4" if ds == "DIV2K_val" else "")
                    put("test_HR/%s/%s.png" % (ds, name), hr)
                    put("test_LR/%s/%s.png" % (ds, lr_name), lr)

    manifest = {
        "seed": int(seed),
        "shapes": [list(sh) for sh in shapes],
        "scales": [int(s) for s in scales],
        "datasets": list(datasets),
        "images": entries,
    }
    with open(os.path.join(root, "MANIFEST.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
    return manifest


def verify(root: str) -> Dict:
    """Re-hash every image under `root` against MANIFEST.json; raises on drift."""
    with open(os.path.join(root, "MANIFEST.json")) as f:
        manifest = json.load(f)
    bad = []
    for relpath, expect in manifest["images"].items():
        arr = io.load_image_u8(os.path.join(root, relpath))
        if _pixel_hash(arr) != expect:
            bad.append(relpath)
    if bad:
        raise ValueError("fixture drift in %d file(s): %s" % (len(bad), bad[:5]))
    return manifest


def ensure(root: str, **kwargs) -> Dict:
    """Generate the fixture if absent, verify it if present."""
    if os.path.exists(os.path.join(root, "MANIFEST.json")):
        return verify(root)
    return generate(root, **kwargs)


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser(description="Write or verify the synthetic "
                                "DIV2K stand-in fixture.")
    p.add_argument("--root", required=True)
    p.add_argument("--seed", type=int, default=None)
    p.add_argument("--verify", action="store_true")
    p.add_argument("--realistic", action="store_true",
                   help="Generate the ~320x480-HR natural-statistics tier "
                        "(48 images, x4) instead of the tiny default.")
    args = p.parse_args(argv)
    if args.verify:
        m = verify(args.root)
        print("fixture OK: %d images" % (len(m["images"]),))
    elif args.realistic:
        m = generate_realistic(args.root,
                               seed=args.seed or REALISTIC_SEED)
        print("realistic fixture written: %d images" % (len(m["images"]),))
    else:
        m = generate(args.root, seed=args.seed or STANDARD_SEED)
        print("fixture written: %d images" % (len(m["images"]),))


if __name__ == "__main__":
    main()
