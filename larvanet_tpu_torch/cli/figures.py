"""Paper-figure helpers: crop_patch / crop_LR_patch / draw_rect (the port of
larvanet_tpu/cli/figures.py; reference crop_patch.py, crop_LR_patch.py,
draw_rect.py), on the port's own PNG codec (data/png.py).

Crops fixed-coordinate patches out of HR / SR / LR images and draws
rectangles on HR images for qualitative figures:

    python -m larvanet_tpu_torch.cli.figures crop_patch --input_path SR \\
        --output_path fig --x 120 --y 64 --size 96
    ... crop_LR_patch --scale 4 ...   (HR coordinates divided by the scale)
    ... draw_rect --thickness 2 --color 255,0,0 ...
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from larvanet_tpu_torch.data import io


def crop_patch(image_hwc: np.ndarray, x: int, y: int, size: int) -> np.ndarray:
    return image_hwc[y:y + size, x:x + size]


def draw_rect(image_hwc: np.ndarray, x: int, y: int, size: int,
              color=(255, 0, 0), thickness: int = 2) -> np.ndarray:
    img = image_hwc.copy()
    c = np.asarray(color, dtype=img.dtype)
    x2, y2 = x + size, y + size
    img[y:y + thickness, x:x2] = c
    img[y2 - thickness:y2, x:x2] = c
    img[y:y2, x:x + thickness] = c
    img[y:y2, x2 - thickness:x2] = c
    return img


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("command", choices=["crop_patch", "crop_LR_patch", "draw_rect"])
    parser.add_argument("--input_path", type=str, required=True,
                        help="Input image or directory of PNGs.")
    parser.add_argument("--output_path", type=str, required=True)
    parser.add_argument("--x", type=int, required=True, help="Patch x (HR coords).")
    parser.add_argument("--y", type=int, required=True, help="Patch y (HR coords).")
    parser.add_argument("--size", type=int, default=96, help="Patch size (HR coords).")
    parser.add_argument("--scale", type=int, default=4,
                        help="For crop_LR_patch: HR coords divided by this.")
    parser.add_argument("--thickness", type=int, default=2)
    parser.add_argument("--color", type=str, default="255,0,0")
    args = parser.parse_known_args(argv)[0]

    paths = ([os.path.join(args.input_path, f) for f in sorted(os.listdir(args.input_path))
              if f.lower().endswith(".png")]
             if os.path.isdir(args.input_path) else [args.input_path])
    os.makedirs(args.output_path, exist_ok=True)
    color = tuple(int(c) for c in args.color.split(","))

    for p in paths:
        img = io.load_image_u8(p)
        if args.command == "crop_patch":
            out = crop_patch(img, args.x, args.y, args.size)
        elif args.command == "crop_LR_patch":
            s = args.scale
            out = crop_patch(img, args.x // s, args.y // s, args.size // s)
        else:
            out = draw_rect(img, args.x, args.y, args.size, color, args.thickness)
        io.save_image_hwc(out, os.path.join(args.output_path, os.path.basename(p)))
        print("wrote %s" % (os.path.basename(p),))
    print("finished")


if __name__ == "__main__":
    main()
