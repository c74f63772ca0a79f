"""Checkpoint-sweep PSNR trend CLI (larvanet_tpu/cli/psnr_trend.py; reference
PSNR_trend.py):

    python -m larvanet_tpu_torch.cli.psnr_trend --model edsr --scales 4 \\
        --restore_dir runs/edsr --data_input_path LR --data_truth_path HR \\
        [--ema 1] [--pipeline_depth 2] [--device cpu]

Every checkpoint of --restore_dir, in the order of the first number in its
name (the step): the JAX package's `*.ckpt` and the port's own
`model_<step>.pth` (what the port's train CLIs write). Each is restored
(--ema: its parameter average) and validated on the val set with the
challenge protocol (round and clip to uint8, crop the truth, RGB PSNR),
the mean printed per checkpoint, then the best (reference
PSNR_trend.py:86-119). The forward is the model's module on the card,
its frames quantized on the device (eval/pipeline.py); --pipeline_depth
frames are dispatched ahead, 1 being the serial loop, with the same
bytes. `main` returns [(checkpoint file name, mean PSNR)].
"""

from __future__ import annotations

import argparse
import glob
import os
import re

import numpy as np

from larvanet_tpu_torch.cli import common
from larvanet_tpu_torch.eval import metrics
from larvanet_tpu_torch.eval.pipeline import pipelined_upscale


def _step_of(path: str) -> int:
    m = re.search(r"(\d+)", os.path.basename(path))
    return int(m.group(1)) if m else 0


def checkpoints(restore_dir: str):
    """The `*.ckpt` and `*.pth` files of `restore_dir`, ordered by step."""
    found = [p for pattern in ("*.ckpt", "*.pth")
             for p in glob.glob(os.path.join(restore_dir, pattern))]
    return sorted(found, key=lambda p: (_step_of(p), p))


def main(argv=None):
    parser = argparse.ArgumentParser()
    common.add_common_flags(parser, default_loader="div2k_val_loader", default_model="edsr")
    parser.add_argument("--restore_dir", type=str, required=True,
                        help="Directory of checkpoints to sweep (*.ckpt, model_<step>.pth).")
    parser.add_argument("--ema", type=int, default=0,
                        help="Sweep the EMA weights of --ema_decay checkpoints instead of "
                             "the live params.")
    parser.add_argument("--pipeline_depth", type=int, default=2,
                        help="Dispatch-ahead in the sweep loop (eval/pipeline.py): pulls "
                             "overlapped with the card's work; byte-exact. 1 = the "
                             "serial loop.")
    args, remaining = parser.parse_known_args(argv)

    device = common.resolve_device(args)
    scale_list = common.scales_of(args)
    scale = scale_list[0]
    dataloader, _, remaining = common.setup_loader(args.dataloader, remaining, scale_list)
    model, _, remaining = common.setup_model(args.model, remaining, scale_list, device)
    common.warn_leftovers(remaining)

    ckpts = checkpoints(args.restore_dir)
    if not ckpts:
        raise FileNotFoundError("no *.ckpt or *.pth files in %s" % (args.restore_dir,))

    def items():
        for idx in range(dataloader.get_num_images()):
            inp, tru, _ = dataloader.get_image_pair(image_index=idx, scale=scale)
            yield tru, inp

    trend = []
    for ckpt in ckpts:
        model.restore(ckpt)
        common.maybe_use_ema(model, args)
        psnr_list = []
        for tru, o8, _ in pipelined_upscale(model, items(), scale,
                                            depth=args.pipeline_depth):
            t8 = metrics.fit_truth_to_output(o8, metrics.image_to_uint8(tru))
            psnr_list.append(metrics.psnr_rgb(o8, t8))
        mean_psnr = float(np.mean(psnr_list))
        trend.append((os.path.basename(ckpt), mean_psnr))
        print("%s: psnr=%.4f" % (os.path.basename(ckpt), mean_psnr))

    print("best: %s (psnr=%.4f)" % max(trend, key=lambda t: t[1]))
    print("finished")
    return trend


if __name__ == "__main__":
    main()
