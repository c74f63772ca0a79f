"""Benchmark-suite CLI: the paper protocol (larvanet_tpu/cli/test.py;
reference test.py).

Scores a restored model over benchmark trees (Set5, Set14, BSD100,
Urban100, Manga109, DIV2K_val): per image, the SR frame quantized to
uint8, the truth cropped to it, both shaved by `scale` pixels, Y-channel
PSNR and SSIM (reference test.py:152-170), or for DIV2K_val the RGB PSNR
and SSIM of the whole frame; writes the SR PNGs and `log.txt` under
`<output_root_path>/<model>/`, and --report_json.

    python -m larvanet_tpu_torch.cli.test --model edsr --scales 4 \\
        --restore_path model.pth --input_root_path data/test_LR \\
        --truth_root_path data/test_HR --datasets Set5,Set14 \\
        [--chop_forward] [--ema 1] [--serving_dtype bf16] [--device cpu]

The trees: `<input_root_path>/<dataset>/` holds the LR PNGs
(DIV2K_val names them `<name>x<scale>.png`), `<truth_root_path>/<dataset>/`
the HR PNGs. The frame is quantized on the device before the pull
(--device_uint8) and frames are dispatched ahead (--pipeline_depth).
--chop_forward runs the reference's 2x2 chop (the JAX CLI takes the flag
and runs the whole frame). --restore_path takes a .pth or a JAX .ckpt;
--ema serves its parameter average.

--int8_trunk 1 serves the W8A8 trunk (bf16 whatever --serving_dtype says),
calibrated on the first --int8_calib_images LR images of the first
dataset, centre-cropped to their common even size (`calib_from_dir`, as
JAX's `_calib_from_dir`, in [0, 255] for every model, msrr_test too).
msrr_test runs in the [0, 1] range (reference test.py:132-146; JAX's
cli/test.py:130, :149-152): its input is the frame over 255, its output is
clipped to [0, 1], times 255 and rounded to uint8 on the host (no direct
uint8 path, no dispatch-ahead). --collapsed_tail 1 (the default, as in JAX) serves EDSR through the
collapsed linear tail (ops/collapsed_tail.py: the tail probed once into
one 5x5 conv, border operators and one shuffle, on the conv_kxk kernel);
0 keeps the module's own tail.
--packed_trunk is a TPU layout rewrite of the same function: accepted,
ignored, with a notice, but for MAMNet, which takes the same collapsed tail
whatever --collapsed_tail says, as JAX's make_packed_mamnet_forward does,
and its module graph under --packed_trunk 0.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np

from larvanet_tpu_torch.cli import common
from larvanet_tpu_torch.data import io
from larvanet_tpu_torch.eval import metrics
from larvanet_tpu_torch.eval.pipeline import pipelined_upscale
from larvanet_tpu_torch.eval.tiling import upscale_with_chop_forward

REFUSED = ()
IGNORED = ("packed_trunk",)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, default="edsr", help="Name of the model.")
    parser.add_argument("--scales", type=str, default="4", help="Scales of the input images.")
    common.add_device_flags(parser)
    parser.add_argument("--restore_path", type=str, required=True,
                        help="A .pth state_dict (the reference's format) or a "
                             "JAX msgpack .ckpt.")
    parser.add_argument("--input_root_path", type=str, default="data/test_LR",
                        help="Root of the LR benchmark trees.")
    parser.add_argument("--truth_root_path", type=str, default="data/test_HR",
                        help="Root of the HR benchmark trees.")
    parser.add_argument("--output_root_path", type=str, default="data/test_SR",
                        help="Root of the SR outputs and log.txt.")
    parser.add_argument("--datasets", type=str, default="Set5,Set14,BSD100,Urban100,Manga109",
                        help="Comma-separated dataset directories; DIV2K_val is "
                             "scored by RGB PSNR.")
    common.add_chop_flags(parser)
    parser.add_argument("--device_uint8", type=int, default=1,
                        help="Quantize SR frames to uint8 on the device before the "
                             "pull (the protocol quantizes first: byte-equal).")
    parser.add_argument("--pipeline_depth", type=int, default=2,
                        help="Dispatch-ahead with --device_uint8: launch frame i+1 "
                             "before pulling frame i (eval/pipeline.py; 1 = serial).")
    parser.add_argument("--report_json", type=str,
                        help="Write per-image and mean PSNR/SSIM to this JSON file.")
    common.add_ema_flag(parser)
    common.add_int8_trunk_flag(parser, " Calibrated on the first dataset's LR images.")
    parser.add_argument("--int8_calib_images", type=int, default=4,
                        help="LR images (first dataset, centre-cropped to a common "
                             "size) in the int8 activation-scale calibration batch.")
    common.add_collapsed_tail_flag(parser)
    common.add_refused_flags(parser, REFUSED, IGNORED)
    common.add_serving_dtype_flag(parser)
    return parser


def calib_from_dir(lr_dir: str, num_images: int) -> np.ndarray:
    """The int8 calibration batch of a benchmark LR tree (test.py:29-45 in
    the JAX package): its first `num_images` PNGs centre-cropped to their
    common size, both sides even-aligned, stacked NHWC float32."""
    names = [f for f in sorted(os.listdir(lr_dir)) if f.lower().endswith(".png")]
    imgs = [io.load_image_u8(os.path.join(lr_dir, f)).astype(np.float32)
            for f in names[: max(1, int(num_images))]]
    hh = min(im.shape[0] for im in imgs) // 2 * 2
    ww = min(im.shape[1] for im in imgs) // 2 * 2
    out = []
    for im in imgs:
        top = (im.shape[0] - hh) // 2
        left = (im.shape[1] - ww) // 2
        out.append(im[top: top + hh, left: left + ww])
    return np.stack(out)


def score(output_image: np.ndarray, truth_image: np.ndarray, scale: int,
          rgb: bool):
    """(PSNR, SSIM) of a uint8 HWC SR frame against its uint8 HWC truth:
    RGB on the whole frame (DIV2K_val), else Y of the frames shaved by
    `scale` (larvanet_tpu/cli/test.py:159-174)."""
    truth_u8 = metrics.image_to_uint8(metrics.fit_truth_to_output(output_image, truth_image))
    if rgb:
        return (metrics.psnr_rgb(output_image, truth_u8),
                metrics.ssim(output_image, truth_u8))
    cropped_output = metrics.shave(output_image, scale)
    cropped_truth = metrics.shave(truth_u8, scale)
    oy = metrics.image_to_uint8(metrics.rgb_to_y(cropped_output))
    ty = metrics.image_to_uint8(metrics.rgb_to_y(cropped_truth))
    return metrics.psnr_y(cropped_output, cropped_truth), metrics.ssim(oy, ty)


def main(argv=None):
    args, remaining = build_parser().parse_known_args(argv)
    common.refuse_unported(args, REFUSED, "test")
    device = common.resolve_device(args)
    scale_list = common.scales_of(args)
    scale = scale_list[0]
    model, _, remaining = common.setup_model(args.model, remaining, scale_list, device)
    common.note_ignored(args, IGNORED, "test", model)
    common.warn_leftovers(remaining)
    model.restore(args.restore_path)
    common.maybe_use_ema(model, args)
    common.apply_serving_dtype(model, args)
    print("restored the model")
    common.maybe_collapse_tail(model, args)
    common.maybe_int8_trunk(model, args, lambda: calib_from_dir(
        os.path.join(args.input_root_path, args.datasets.split(",")[0]),
        args.int8_calib_images))

    output_root = os.path.join(args.output_root_path, args.model)
    os.makedirs(output_root, exist_ok=True)
    unit_range = args.model == "msrr_test"
    direct_u8 = args.device_uint8 and not args.chop_forward and not unit_range
    results = []
    report = {}
    with open(os.path.join(output_root, "log.txt"), "w") as log:
        for dataset in [d for d in args.datasets.split(",") if d]:
            input_path = os.path.join(args.input_root_path, dataset)
            truth_path = os.path.join(args.truth_root_path, dataset)
            output_path = os.path.join(output_root, dataset)
            os.makedirs(output_path, exist_ok=True)
            image_names = [f for f in sorted(os.listdir(truth_path))
                           if f.lower().endswith(".png")]
            print("%s: %d images are prepared" % (dataset, len(image_names)))
            log.write("%s: %d images are prepared\n" % (dataset, len(image_names)))

            def load_input(image_name, dataset=dataset, input_path=input_path):
                if dataset == "DIV2K_val":
                    image_name = os.path.splitext(image_name)[0] + "x%d.png" % scale
                return io.load_image_chw(os.path.join(input_path, image_name))

            def outputs(image_names=image_names, load_input=load_input):
                """(image name, uint8 HWC SR frame) in dataset order."""
                if direct_u8 and args.pipeline_depth > 1:
                    items = ((name, load_input(name)) for name in image_names)
                    for name, out, _ in pipelined_upscale(model, items, scale,
                                                          depth=args.pipeline_depth):
                        yield name, out.transpose(1, 2, 0)
                    return
                for name in image_names:
                    input_image = load_input(name)
                    if unit_range:
                        lr = input_image / 255.0
                        out = (upscale_with_chop_forward(model, lr, scale,
                                                         args.chop_overlap_size)
                               if args.chop_forward else model.upscale([lr], scale)[0])
                        out = np.clip(out.transpose(1, 2, 0), 0.0, 1.0) * 255.0
                        yield name, np.uint8(out.round())
                    elif args.chop_forward:
                        out = upscale_with_chop_forward(model, input_image, scale,
                                                        args.chop_overlap_size)
                        yield name, metrics.image_to_uint8(out.transpose(1, 2, 0))
                    elif direct_u8:
                        out = model.upscale_device([input_image], scale, uint8=True)
                        yield name, out[0].cpu().numpy()
                    else:
                        out = model.upscale([input_image], scale)[0]
                        yield name, metrics.image_to_uint8(out.transpose(1, 2, 0))

            start_time = time.perf_counter()
            psnr_list, ssim_list = [], []
            for image_index, (name, output_image) in enumerate(outputs()):
                truth_image = io.load_image_u8(os.path.join(truth_path, name))
                psnr, ssim = score(output_image, truth_image, scale, dataset == "DIV2K_val")
                psnr_list.append(psnr)
                ssim_list.append(ssim)
                io.save_image_hwc(output_image, os.path.join(output_path, name))
                line = "x%d, %d/%d, psnr=%.4f, ssim=%.4f" % (
                    scale, image_index + 1, len(image_names), psnr, ssim)
                print(line)
                log.write(line + "\n")

            duration = time.perf_counter() - start_time
            results.append((dataset, float(np.mean(psnr_list)), float(np.mean(ssim_list)),
                            duration))
            print("x%d, %s dataset, psnr=%.4f, ssim=%.4f, duration=%.0f"
                  % (scale, dataset, results[-1][1], results[-1][2], duration))
            report[dataset] = {
                "mean_psnr": results[-1][1],
                "mean_ssim": results[-1][2],
                "per_image": {os.path.splitext(n)[0]: {"psnr": float(p), "ssim": float(s)}
                              for n, p, s in zip(image_names, psnr_list, ssim_list)},
            }
        for dataset, psnr, ssim, duration in results:
            line = "%s, psnr=%.4f, ssim=%.4f, duration=%s" % (dataset, psnr, ssim, duration)
            print(line)
            log.write(line + "\n")
    if args.report_json:
        os.makedirs(os.path.dirname(args.report_json) or ".", exist_ok=True)
        with open(args.report_json, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
    print("finished")
    return results


if __name__ == "__main__":
    main()
