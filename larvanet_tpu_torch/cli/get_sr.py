"""Inference CLI: a directory of PNGs in, their SR PNGs out
(larvanet_tpu/cli/get_sr.py; reference get_sr.py:62-97):

    python -m larvanet_tpu_torch.cli.get_sr --model edsr --scales 4 \\
        --restore_path model.pth --input_path LR --output_path SR \\
        [--serving_dtype bf16] [--chop_forward | --tile_forward] [--ema 1] \\
        [--device cpu]

Frames cross to the device as uint8, are quantized there before the pull
(--device_uint8), and are dispatched ahead (--pipeline_depth); the mean
latency per frame is printed at the end. --chop_forward (the reference's
2x2 chop) and --tile_forward (batched tiles, eval/tiling.py) take the f32
frame and write the f32 output, quantized by the PNG writer, as JAX's
get_sr does. --restore_path takes a .pth or a JAX .ckpt; --ema serves its
parameter average.

--int8_trunk 1 serves the W8A8 trunk (bf16 whatever --serving_dtype says),
calibrated on the first input PNG, as in JAX.

Not ported yet, refused with a pointer to ROADMAP.md: --spatial_shard,
--dp_devices. --collapsed_tail 1 (the default, as in JAX) serves EDSR through the
collapsed linear tail (ops/collapsed_tail.py: the tail probed once into
one 5x5 conv, border operators and one shuffle, on the conv_kxk kernel);
0 keeps the module's own tail.
--packed_trunk and --plain_frame_px are TPU routing settings: accepted
and ignored, with a notice, but --packed_trunk for MAMNet, which takes the
same collapsed tail whatever --collapsed_tail says, as JAX's
make_packed_mamnet_forward does, and its module graph under
--packed_trunk 0.
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from larvanet_tpu_torch.cli import common
from larvanet_tpu_torch.data import io
from larvanet_tpu_torch.eval.pipeline import pipelined_upscale
from larvanet_tpu_torch.eval.tiling import upscale_with_chop_forward

REFUSED = ("spatial_shard", "dp_devices")
IGNORED = ("packed_trunk", "plain_frame_px")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, default="edsr", help="Name of the model.")
    parser.add_argument("--scales", type=str, default="4", help="Scales of the input images.")
    common.add_device_flags(parser)
    parser.add_argument("--input_path", type=str, required=True,
                        help="Base path of the input images.")
    parser.add_argument("--output_path", type=str, required=True,
                        help="Base path of the output images.")
    parser.add_argument("--restore_path", type=str, required=True,
                        help="A .pth state_dict (the reference's format) or a "
                             "JAX msgpack .ckpt.")
    common.add_chop_flags(parser)
    common.add_tile_flags(parser)
    common.add_ema_flag(parser)
    parser.add_argument("--device_uint8", type=int, default=1,
                        help="Quantize SR frames to uint8 on the device before the "
                             "pull (byte-equal to host quantization). 0 pulls f32.")
    parser.add_argument("--pipeline_depth", type=int, default=2,
                        help="Frames launched but not yet pulled (1 = serial).")
    common.add_collapsed_tail_flag(parser)
    common.add_refused_flags(parser, REFUSED, IGNORED)
    common.add_int8_trunk_flag(parser, " Calibrated on the first input PNG.")
    common.add_serving_dtype_flag(parser)
    return parser


def main(argv=None):
    args, remaining = build_parser().parse_known_args(argv)
    common.refuse_unported(args, REFUSED, "get_sr")
    device = common.resolve_device(args)
    scale_list = common.scales_of(args)
    scale = scale_list[0]
    model, _, remaining = common.setup_model(args.model, remaining, scale_list, device)
    common.note_ignored(args, IGNORED, "get_sr", model)
    common.warn_leftovers(remaining)
    model.restore(args.restore_path)
    common.maybe_use_ema(model, args)
    common.apply_serving_dtype(model, args)
    print("restored the model")
    common.maybe_collapse_tail(model, args)
    image_names = io.list_pngs(args.input_path)
    common.maybe_int8_trunk(model, args, lambda: io.load_image_chw(
        os.path.join(args.input_path, image_names[0] + ".png")).transpose(1, 2, 0)[None])
    tiler = common.make_tiler(model, args)
    # the direct path pushes uint8 frames; chop and tiles take the f32 loader
    # frame, as in JAX (larvanet_tpu/cli/get_sr.py:112-117)
    direct_u8 = args.device_uint8 and not args.chop_forward and tiler is None

    print("%d images are prepared" % (len(image_names),))
    os.makedirs(args.output_path, exist_ok=True)
    total = len(image_names)

    def frame(name):
        path = os.path.join(args.input_path, name + ".png")
        if direct_u8:  # uint8 push, cast to f32 on the device
            return io.load_image_u8(path).transpose(2, 0, 1)
        return io.load_image_chw(path)

    duration_list = []
    if direct_u8 and args.pipeline_depth > 1:
        frames = ((name, frame(name)) for name in image_names)
        results = pipelined_upscale(model, frames, scale, depth=args.pipeline_depth)
    else:
        def serial():
            for name in image_names:
                input_image = frame(name)
                start_time = time.perf_counter()
                if args.chop_forward:
                    output = upscale_with_chop_forward(model, input_image, scale,
                                                       args.chop_overlap_size)
                elif tiler is not None:
                    output = tiler.upscale_chw(input_image)
                elif args.device_uint8:
                    output = model.upscale_uint8([input_image], scale)[0]
                else:
                    output = model.upscale([input_image], scale)[0]
                yield name, output, time.perf_counter() - start_time

        results = serial()
    for i, (name, output, duration) in enumerate(results):
        duration_list.append(duration)
        io.save_image_chw(output, os.path.join(args.output_path, name + ".png"))
        print("%d/%d, %s, duration=%.4f" % (i + 1, total, name, duration))

    print("mean duration=%.4f" % (float(np.mean(duration_list)),))
    print("finished")


if __name__ == "__main__":
    main()
