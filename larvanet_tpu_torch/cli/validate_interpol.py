"""Null-model baseline: validate pure interpolation upscaling
(larvanet_tpu/cli/validate_interpol.py; reference validate_interpol.py,
F.interpolate as the 'model', :79):

    python -m larvanet_tpu_torch.cli.validate_interpol --scales 4 \\
        --data_input_path LR --data_truth_path HR \\
        [--interpolate bilinear|bicubic|nearest] [--device cpu]

Each val frame upscaled by `models/layers.interpolated_base` (F.interpolate,
align_corners=False, torch's bicubic A = -0.75; on the card unless --device
cpu), rounded and clipped to uint8, the truth cropped to it, RGB PSNR; the
mean and the mean seconds per frame per scale. `main` returns {scale:
{"mean_psnr", "per_image"}}.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from larvanet_tpu_torch.cli import common
from larvanet_tpu_torch.eval import metrics
from larvanet_tpu_torch.models.layers import interpolated_base


def main(argv=None):
    parser = argparse.ArgumentParser()
    common.add_common_flags(parser, default_loader="div2k_val_loader")
    parser.add_argument("--interpolate", type=str, default="bilinear",
                        help="Interpolation method (bilinear/bicubic/nearest; "
                             "reference validate_interpol.py:41 default).")
    args, remaining = parser.parse_known_args(argv)

    device = common.resolve_device(args)
    scale_list = common.scales_of(args)
    dataloader, _, remaining = common.setup_loader(args.dataloader, remaining, scale_list)
    common.warn_leftovers(remaining)

    results = {}
    for scale in scale_list:
        psnr_list, duration_list, per_image = [], [], {}
        n = dataloader.get_num_images()
        for idx in range(n):
            inp, tru, name = dataloader.get_image_pair(image_index=idx, scale=scale)
            t0 = time.perf_counter()
            x = torch.from_numpy(np.ascontiguousarray(inp.transpose(1, 2, 0)))[None]
            out = interpolated_base(x.to(device), scale, args.interpolate)
            out = out[0].cpu().numpy().transpose(2, 0, 1)
            duration_list.append(time.perf_counter() - t0)
            o8 = metrics.image_to_uint8(out)
            t8 = metrics.fit_truth_to_output(o8, metrics.image_to_uint8(tru))
            psnr = metrics.psnr_rgb(o8, t8)
            psnr_list.append(psnr)
            per_image[name] = float(psnr)
            print("x%d, %d/%d, psnr=%.2f" % (scale, idx + 1, n, psnr))
        print("x%d, psnr=%.2f, duration=%.4f"
              % (scale, np.mean(psnr_list), np.mean(duration_list)))
        results[scale] = {"mean_psnr": float(np.mean(psnr_list)), "per_image": per_image}
    print("finished")
    return results


if __name__ == "__main__":
    main()
