"""Full-image validation CLI (larvanet_tpu/cli/validate.py; reference
validate.py).

Per image: upscale, round and clip to uint8, crop the truth to the
output, RGB PSNR; optionally save the PNG; mean PSNR and duration per
scale (reference validate.py:83-123):

    python -m larvanet_tpu_torch.cli.validate --model edsr --scales 4 \\
        --restore_path model.pth --data_input_path LR --data_truth_path HR \\
        [--wino_trunk 2|4] [--serving_dtype bf16] [--report_json r.json] \\
        [--chop_forward | --tile_forward] [--self_ensemble] [--ema 1] \\
        [--device cpu]

By default the frame is quantized on the device before the pull
(--device_uint8) and frames are dispatched ahead (--pipeline_depth);
both give the serial loop's bytes. --wino_trunk runs every 64-channel
trunk ResBlock (EDSR, LarvaNet_w64) as one fused Winograd kernel; a
48-channel LarvaNet trunk keeps the direct convs. --model takes every
name of the registry, its flags after it (e.g. LarvaNet --num_modules 2
--num_blocks 16,16; mamnet --mamnet_res_blocks 16; imdn_aim2019
--num_blocks 8). --restore_path takes a .pth or a JAX .ckpt.

Full frames in pieces (eval/tiling.py): --chop_forward is the
reference's 2x2 chop (--chop_overlap_size), --tile_forward the batched
tiles (--tile_size, --tile_overlap); both run the serving forward.
--self_ensemble averages the x8 dihedral orientations of the f32 module
forward, as JAX runs its module graph there, whatever --serving_dtype and
--wino_trunk say; with --tile_forward it is the tiles' forward. --ema
serves the checkpoint's parameter average.

--int8_trunk 1 serves the W8A8 trunk (ops/int8_forward.py; bf16 whatever
--serving_dtype says), calibrated on the first --int8_calib_images val
inputs; --int8_report also runs the exact forward per image (direct
forwards only), prints the int8-vs-exact deltas, writes them to
--report_json and exits 3 when the mean drop exceeds --int8_max_drop.

--artifact FILE validates a serving artifact (cli/export.py --stablehlo,
utils/aot.py) instead of a checkpoint: the challenge protocol runs against
the file production deploys, loaded without the model zoo. Its frames must
match the exported geometry, or pass --tile_forward (the tile size is the
exported square size). --chop_forward, --self_ensemble, --int8_trunk,
--spatial_shard, --ema, --dp_devices, a --serving_dtype other than f32 and
--restore_path are refused with it, as in JAX (the graph is baked into the
file); --wino_trunk is ignored, as JAX ignores it there.

--dp_devices N splits each forward's batch over N devices (parallel/
mesh.use_data_parallel_eval, over the route set before it), with
--tile_forward's tile batches padded to a multiple of N; without
--tile_forward a frame's batch of one cannot split and is refused, as in
JAX. --spatial_shard N splits each frame's rows over N devices with
--spatial_halo rows exchanged (parallel/halo.py), on the module graph, as
JAX does.
--collapsed_tail 1 (the default, as in JAX) serves EDSR through the
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
import torch

from larvanet_tpu_torch.cli import common
from larvanet_tpu_torch.data import io
from larvanet_tpu_torch.eval import metrics
from larvanet_tpu_torch.eval.ensemble import self_ensemble_forward
from larvanet_tpu_torch.eval.pipeline import pipelined_upscale
from larvanet_tpu_torch.eval.tiling import upscale_with_chop_forward

# refused with --artifact (larvanet_tpu/cli/validate.py:109-121)
ARTIFACT_REFUSED = ("chop_forward", "self_ensemble", "int8_trunk", "spatial_shard", "ema",
                    "dp_devices")
IGNORED = ("packed_trunk",)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    common.add_common_flags(parser, default_loader="div2k_val_loader", default_model="edsr")
    parser.add_argument("--restore_path", type=str, default=None,
                        help="A .pth state_dict (the reference's format) or a "
                             "JAX msgpack .ckpt.")
    parser.add_argument("--save_path", type=str,
                        help="Base output path of the upscaled images.")
    parser.add_argument("--device_uint8", type=int, default=1,
                        help="Quantize SR frames to uint8 on the device before the "
                             "pull (the protocol quantizes first anyway: byte-equal, "
                             "a quarter of the bytes).")
    parser.add_argument("--pipeline_depth", type=int, default=2,
                        help="Dispatch-ahead with --device_uint8: launch frame i+1 "
                             "before pulling frame i (eval/pipeline.py; 1 = serial).")
    parser.add_argument("--report_json", type=str,
                        help="Write per-image and mean PSNRs to this JSON file.")
    common.add_chop_flags(parser)
    common.add_tile_flags(parser)
    parser.add_argument("--self_ensemble", action="store_true",
                        help="x8 dihedral test-time augmentation of the f32 module "
                             "forward (eval/ensemble.py).")
    common.add_ema_flag(parser)
    common.add_wino_trunk_flag(parser)
    common.add_int8_trunk_flag(parser)
    parser.add_argument("--int8_calib_images", type=int, default=4,
                        help="Number of val images stacked (centre-cropped) into the "
                             "int8 activation-scale calibration batch.")
    parser.add_argument("--int8_report", action="store_true",
                        help="With --int8_trunk: also run the exact forward per image "
                             "and print the int8-vs-exact PSNR delta.")
    parser.add_argument("--int8_max_drop", type=float, default=0.1,
                        help="With --int8_report: refuse to bless the int8 path (exit "
                             "code 3) when the mean PSNR drop exceeds this many dB.")
    common.add_collapsed_tail_flag(parser)
    parser.add_argument("--artifact", type=str, default=None,
                        help="Validate a serving artifact (cli/export.py --stablehlo) "
                             "instead of a checkpoint: the challenge protocol runs "
                             "against the file production deploys. Images must match "
                             "the exported geometry, or pass --tile_forward (tile size "
                             "auto-set).")
    common.add_parallel_serving_flags(
        parser, "Shard eval tile batches across N devices (data-parallel serving; use "
                "with --tile_forward; 0 = off).")
    common.add_ignored_flags(parser, IGNORED)
    common.add_serving_dtype_flag(parser)
    return parser


def load_artifact_model(args, scale_list, device):
    """validate --artifact (larvanet_tpu/cli/validate.py:107-133): JAX's
    refusals, then the ArtifactModel on `device`; --tile_forward takes the
    exported square size."""
    from larvanet_tpu_torch.utils.aot import ArtifactModel

    for flag in ARTIFACT_REFUSED:
        if getattr(args, flag, 0):
            raise SystemExit("--%s does not apply to --artifact validation (the graph is "
                             "baked into the file)" % flag)
    if getattr(args, "serving_dtype", "f32") != "f32":
        raise SystemExit("--serving_dtype does not apply to --artifact validation (the "
                         "compute dtype was baked at export — use cli/export.py "
                         "--export_dtype)")
    if args.restore_path:
        raise SystemExit("pass --restore_path OR --artifact, not both")
    model = ArtifactModel(args.artifact, device)
    if scale_list != [model.scale]:
        raise SystemExit("artifact is x%d; pass --scales %d" % (model.scale, model.scale))
    if args.tile_forward:
        if model.height != model.width:
            raise SystemExit("--tile_forward needs a square exported geometry (got %dx%d)"
                             % (model.height, model.width))
        args.tile_size = model.height  # the artifact's one shape
    print("validating serving artifact %s (%s; input %s)"
          % (args.artifact, model.header.get("path_desc", ""),
             model.header.get("input_shape")))
    return model


def main(argv=None):
    args, remaining = build_parser().parse_known_args(argv)
    if not args.restore_path and not args.artifact:
        raise SystemExit("pass --restore_path (a .pth or .ckpt checkpoint) or --artifact")
    device = common.resolve_device(args)
    scale_list = common.scales_of(args)
    dataloader, _, remaining = common.setup_loader(args.dataloader, remaining, scale_list)
    if args.artifact:
        model = load_artifact_model(args, scale_list, device)
        common.warn_leftovers(remaining)
    else:
        model, _, remaining = common.setup_model(args.model, remaining, scale_list, device)
        common.note_ignored(args, IGNORED, "validate", model)
        common.warn_leftovers(remaining)
        model.restore(args.restore_path)
        common.maybe_use_ema(model, args)
        common.apply_serving_dtype(model, args)
        print("restored the model")
        common.maybe_collapse_tail(model, args)
        common.maybe_wino_trunk(model, args)
        common.maybe_int8_trunk(model, args, lambda: common.int8_calib_batch(
            dataloader, scale_list[0], args.int8_calib_images))
        common.maybe_spatial_shard(model, args, scale_list[0])
        common.maybe_dp_eval(model, args, "eval")
        if args.dp_devices > 1 and not args.tile_forward:
            print("WARNING: --dp_devices without --tile_forward: full-frame "
                  "batches of 1 cannot shard; pass --tile_forward")
    int8_report = args.int8_report and hasattr(model, "int8_exact_forward")
    if args.int8_report and not int8_report:
        print("--int8_report: int8 trunk is not active; nothing to report")
    if int8_report and (args.chop_forward or args.tile_forward):
        raise SystemExit(
            "--int8_report requires direct (non-tiled) forwards: drop "
            "--chop_forward/--tile_forward so the int8-vs-exact delta "
            "measures quantization alone")
    # the ensemble runs the f32 module graph, as JAX's runs _forward_impl
    forward = self_ensemble_forward(model.module) if args.self_ensemble else None
    tiler = common.make_tiler(model, args, forward)
    direct = not (args.chop_forward or tiler is not None or args.self_ensemble)

    print("begin validation")
    num_images = dataloader.get_num_images()
    average_psnr_dict = {}
    average_duration_dict = {}
    report = {}
    int8_verdicts = []
    for scale in scale_list:
        duration_list, psnr_list, name_list, int8_deltas = [], [], [], []

        def score(image_index, image_name, truth_image, output_image, duration,
                  input_image):
            duration_list.append(duration)
            truth_u8 = metrics.image_to_uint8(truth_image)
            output_u8 = metrics.image_to_uint8(output_image)
            if args.save_path is not None:
                out_dir = os.path.join(args.save_path, "x%d" % scale)
                io.save_image_chw(output_u8, os.path.join(out_dir, image_name + ".png"))
            truth_u8 = metrics.fit_truth_to_output(output_u8, truth_u8)
            psnr = metrics.psnr_rgb(output_u8, truth_u8)
            psnr_list.append(psnr)
            name_list.append(image_name)
            if int8_report:
                # the exact forward on the same frame (validate.py:271-282)
                with torch.no_grad():
                    x = model._input_to_device([input_image]).to(model.compute_dtype)
                    exact = model.int8_exact_forward(x.contiguous()).float()
                exact_u8 = metrics.image_to_uint8(exact[0].cpu().numpy().transpose(2, 0, 1))
                exact_psnr = metrics.psnr_rgb(exact_u8, truth_u8)
                int8_deltas.append(psnr - exact_psnr)
                print("x%d, %d/%d, psnr=%.2f, duration=%.4f  [int8 %.4f vs exact "
                      "%.4f dB, delta %+.4f]"
                      % (scale, image_index + 1, num_images, psnr, duration, psnr,
                         exact_psnr, psnr - exact_psnr))
                return
            print("x%d, %d/%d, psnr=%.2f, duration=%.4f"
                  % (scale, image_index + 1, num_images, psnr, duration))

        if direct and args.device_uint8 and args.pipeline_depth > 1 and not int8_report:
            def items():
                for image_index in range(num_images):
                    input_image, truth_image, image_name = dataloader.get_image_pair(
                        image_index=image_index, scale=scale)
                    yield (image_index, image_name, truth_image), input_image

            for (image_index, image_name, truth_image), out_u8, dt in pipelined_upscale(
                    model, items(), scale, depth=args.pipeline_depth):
                score(image_index, image_name, truth_image, out_u8, dt, None)
        else:
            for image_index in range(num_images):
                input_image, truth_image, image_name = dataloader.get_image_pair(
                    image_index=image_index, scale=scale)
                start_time = time.perf_counter()
                if args.chop_forward:
                    output_image = upscale_with_chop_forward(
                        model, input_image, scale, args.chop_overlap_size)
                elif tiler is not None:
                    output_image = tiler.upscale_chw(input_image)
                elif args.self_ensemble:
                    out = forward(model._input_to_device([input_image]))
                    output_image = out[0].cpu().numpy().transpose(2, 0, 1)
                elif args.device_uint8:
                    output_image = model.upscale_uint8([input_image], scale)[0]
                else:
                    output_image = model.upscale([input_image], scale)[0]
                score(image_index, image_name, truth_image, output_image,
                      time.perf_counter() - start_time, input_image)

        average_psnr_dict[scale] = float(np.mean(psnr_list))
        average_duration_dict[scale] = float(np.mean(duration_list))
        print("x%d, psnr=%.2f, duration=%.4f"
              % (scale, average_psnr_dict[scale], average_duration_dict[scale]))
        if int8_report:
            mean_delta = float(np.mean(int8_deltas))
            worst = float(np.min(int8_deltas))
            print("x%d, int8-vs-exact: mean delta %+.4f dB, worst %+.4f dB "
                  "(threshold --int8_max_drop %.3f)"
                  % (scale, mean_delta, worst, args.int8_max_drop))
            int8_verdicts.append((scale, mean_delta, worst))
        report.setdefault("scales", {})[str(scale)] = {
            "mean_psnr": average_psnr_dict[scale],
            "per_image": dict(zip(name_list, map(float, psnr_list))),
        }
        if int8_report:
            report["scales"][str(scale)]["int8_vs_exact"] = {
                "mean_delta_db": float(np.mean(int8_deltas)),
                "worst_delta_db": float(np.min(int8_deltas)),
                "per_image_delta": dict(zip(name_list, map(float, int8_deltas))),
            }
    if args.report_json:
        os.makedirs(os.path.dirname(args.report_json) or ".", exist_ok=True)
        with open(args.report_json, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
    print("finished")
    for scale, mean_delta, worst in int8_verdicts:
        if -mean_delta > args.int8_max_drop:
            print("int8 REFUSED: x%d mean PSNR drop %.4f dB exceeds --int8_max_drop %.3f "
                  "— do not serve this quantized model" % (scale, -mean_delta,
                                                          args.int8_max_drop))
            raise SystemExit(3)
    if int8_verdicts:
        print("int8 OK: within --int8_max_drop on every scale")
    return average_psnr_dict


if __name__ == "__main__":
    main()
