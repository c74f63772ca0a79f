"""Offline metric comparison of saved SR PNG trees (larvanet_tpu/cli/psnr.py;
reference PSNR.py):

    python -m larvanet_tpu_torch.cli.psnr --sr_paths runs/a,runs/b \\
        --truth_path HR [--model_names a,b] [--shave 4]

For each model's SR directory against the HR directory: each HR PNG's SR
file (the same name, else the first file that starts with its stem), the
truth cropped to it, `--shave` pixels trimmed, the Y-channel PSNR and SSIM
(eval/metrics.py, the paper protocol), per image and as means; with two
models, a per-image PSNR difference (reference PSNR.py:75-152). Host work
only: nothing runs on the card. `main` returns {model: {image: (psnr,
ssim)}}.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from larvanet_tpu_torch.data import io
from larvanet_tpu_torch.eval import metrics


def evaluate_tree(sr_dir: str, hr_dir: str, shave_border: int = 4):
    """[(HR file name, Y-PSNR, SSIM)] of the SR files in `sr_dir` against the
    HR PNGs of `hr_dir`, in name order; an HR file with no SR file is
    skipped."""
    names = [f for f in sorted(os.listdir(hr_dir)) if f.lower().endswith(".png")]
    rows = []
    for name in names:
        sr_path = os.path.join(sr_dir, name)
        if not os.path.exists(sr_path):
            stem = os.path.splitext(name)[0]
            candidates = [f for f in os.listdir(sr_dir) if f.startswith(stem)]
            if not candidates:
                continue
            sr_path = os.path.join(sr_dir, candidates[0])
        sr = io.load_image_u8(sr_path)
        hr = metrics.fit_truth_to_output(sr, io.load_image_u8(os.path.join(hr_dir, name)))
        sr_c = metrics.shave(sr, shave_border)
        hr_c = metrics.shave(hr, shave_border)
        oy = metrics.image_to_uint8(metrics.rgb_to_y(sr_c))
        ty = metrics.image_to_uint8(metrics.rgb_to_y(hr_c))
        rows.append((name, metrics.psnr_y(sr_c, hr_c), metrics.ssim(oy, ty)))
    return rows


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--sr_paths", type=str, required=True,
                        help="Comma-separated SR PNG directories (one per model).")
    parser.add_argument("--model_names", type=str, default=None,
                        help="Comma-separated display names; defaults to dir basenames.")
    parser.add_argument("--truth_path", type=str, required=True,
                        help="HR PNG directory.")
    parser.add_argument("--shave", type=int, default=4,
                        help="Border shave before metrics (reference PSNR.py uses 4).")
    args = parser.parse_known_args(argv)[0]

    sr_dirs = args.sr_paths.split(",")
    names = (args.model_names.split(",") if args.model_names
             else [os.path.basename(os.path.normpath(d)) for d in sr_dirs])
    all_rows = {}
    for model_name, sr_dir in zip(names, sr_dirs):
        rows = evaluate_tree(sr_dir, args.truth_path, args.shave)
        all_rows[model_name] = {r[0]: r[1:] for r in rows}
        for name, psnr, ssim in rows:
            print("%s %s: psnr=%.4f ssim=%.4f" % (model_name, name, psnr, ssim))
        print("%s: mean psnr=%.4f mean ssim=%.4f over %d images"
              % (model_name, np.mean([r[1] for r in rows]), np.mean([r[2] for r in rows]),
                 len(rows)))
    if len(names) == 2:
        a, b = names
        print("per-image diff (%s - %s):" % (a, b))
        for img in sorted(set(all_rows[a]) & set(all_rows[b])):
            print("%s: %+0.4f dB" % (img, all_rows[a][img][0] - all_rows[b][img][0]))
    print("finished")
    return all_rows


if __name__ == "__main__":
    main()
