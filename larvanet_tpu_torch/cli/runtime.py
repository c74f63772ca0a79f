"""Forward-latency CLI (larvanet_tpu/cli/runtime.py; reference runtime.py).

Times `fwd_runtime` per image (the loader's real images) or at one fixed
input size, each timed block bracketed with `torch.cuda.synchronize()`
as the reference does (runtime.py:63-67); warmup forwards build the
kernels and are not timed:

    python -m larvanet_tpu_torch.cli.runtime --model edsr --scales 4 \\
        --input_height 339 --input_width 510 [--restore_path model.pth] \\
        [--wino_trunk 2|4] [--serving_dtype bf16] [--ema 1] [--device cpu]

Without --restore_path the weights are random from the seed (and --ema,
as in JAX, does nothing); it takes a .pth or a JAX .ckpt. --int8_trunk 1
times the W8A8 trunk, calibrated on the loader's first input, or at a
fixed size on uniform noise of that size from default_rng(0), as in JAX.
--collapsed_tail 1 (the default, as in JAX) serves EDSR through the
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
import time

import numpy as np
import torch

from larvanet_tpu_torch.cli import common

REFUSED = ()
IGNORED = ("packed_trunk", "plain_frame_px")


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    common.add_common_flags(parser, default_loader="div2k_val_loader", default_model="edsr")
    parser.add_argument("--restore_path", type=str,
                        help="A .pth state_dict or a JAX .ckpt (optional: random "
                             "weights if omitted).")
    parser.add_argument("--input_width", type=int, default=0,
                        help="Fixed input width (0 = use the dataloader's real images).")
    parser.add_argument("--input_height", type=int, default=0)
    parser.add_argument("--num_warmup", type=int, default=2,
                        help="Warmup forwards, not timed.")
    parser.add_argument("--num_iters", type=int, default=10,
                        help="Timed iterations per image/shape.")
    common.add_ema_flag(parser)
    common.add_wino_trunk_flag(parser)
    common.add_int8_trunk_flag(parser, " Calibrated on the first input.")
    common.add_collapsed_tail_flag(parser)
    common.add_refused_flags(parser, REFUSED, IGNORED)
    common.add_serving_dtype_flag(parser)
    return parser


def main(argv=None):
    args, remaining = build_parser().parse_known_args(argv)
    common.refuse_unported(args, REFUSED, "runtime")
    device = common.resolve_device(args)
    scale_list = common.scales_of(args)
    use_loader = args.input_width == 0

    dataloader = None
    if use_loader:
        dataloader, _, remaining = common.setup_loader(args.dataloader, remaining, scale_list)
    model, _, remaining = common.setup_model(args.model, remaining, scale_list, device)
    common.note_ignored(args, IGNORED, "runtime", model)
    common.warn_leftovers(remaining)
    if args.restore_path:
        model.restore(args.restore_path)
        common.maybe_use_ema(model, args)
        print("restored the model")
    common.apply_serving_dtype(model, args)
    common.maybe_collapse_tail(model, args)
    common.maybe_wino_trunk(model, args)
    if args.int8_trunk:  # runtime.py:71-78 in the JAX package
        if dataloader is not None:
            common.maybe_int8_trunk(model, args, lambda: dataloader.get_image_pair(
                image_index=0, scale=scale_list[0])[0].transpose(1, 2, 0)[None])
        else:
            common.maybe_int8_trunk(model, args, lambda: np.random.default_rng(0).uniform(
                0, 255, (1, args.input_height, args.input_width, 3)).astype(np.float32))

    scale = scale_list[0]
    durations = []
    megapixels = []

    def bench_one(batch_nhwc: np.ndarray) -> None:
        x = torch.from_numpy(batch_nhwc).to(device)
        for _ in range(args.num_warmup):
            model.fwd_runtime(x)
        common.synchronize(device)
        t0 = time.perf_counter()
        for _ in range(args.num_iters):
            model.fwd_runtime(x)
        common.synchronize(device)
        durations.append((time.perf_counter() - t0) / args.num_iters)
        megapixels.append(batch_nhwc.shape[1] * batch_nhwc.shape[2] / 1e6)

    if use_loader:
        for i in range(dataloader.get_num_images()):
            inp, _, name = dataloader.get_image_pair(i, scale)
            bench_one(np.ascontiguousarray(inp.transpose(1, 2, 0))[None].astype(np.float32))
            print("%d/%d %s: %.4f sec" % (i + 1, dataloader.get_num_images(), name,
                                          durations[-1]))
    else:
        bench_one(np.zeros((1, args.input_height, args.input_width, 3), np.float32))

    mean_dur = float(np.mean(durations))
    mp_per_sec = float(np.sum(megapixels)) / float(np.sum(durations))
    print("mean duration=%.4f sec; throughput=%.2f LR megapixels/sec" % (mean_dur, mp_per_sec))
    return mean_dur, mp_per_sec


if __name__ == "__main__":
    main()
