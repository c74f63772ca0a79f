"""Export a trained checkpoint as a reference-loadable `.pth`, or as a
self-contained serving artifact (`--stablehlo`): the port of
larvanet_tpu/cli/export.py.

The `.pth` is the module's state_dict in the reference's keys, which the
reference's strict `load_state_dict` takes (MeanShift and dead-module
entries included), restored from a port `.pth` or a JAX `.ckpt`:

    python -m larvanet_tpu_torch.cli.export --model edsr \\
        --restore_path runs/edsr/model_300000.ckpt --output edsr_300000.pth

`--restore_path latest --train_path DIR` picks the newest checkpoint.

The serving artifact (utils/aot.py) is a torch.export program, not
StableHLO (the flag keeps JAX's name): the serving CLIs' route (the
collapsed tail for EDSR and MAMNet, or the int8 trunk, or the module
graph) traced for ONE input geometry, with the weights as its constants
and the hand-written kernels as registered ops (ops/library.py). It loads
and runs without the model zoo (`serve --artifact`, `validate
--artifact`):

    python -m larvanet_tpu_torch.cli.export --model edsr \\
        --restore_path ... --stablehlo edsr_serve.lvt \\
        --export_batch 1 --export_height 256 --export_width 256 \\
        [--int8_trunk 1 --calib_path LR_DIR] [--export_dtype bf16] \\
        [--platforms cuda,cpu] [--device cpu]

The model is built, restored and traced on the card unless --device cpu.
--platforms names where the artifact may be loaded (cuda and cpu; tpu is
refused). --packed_trunk is a TPU layout rewrite: accepted and ignored
with a notice, but for MAMNet, whose collapsed tail it gates as in the
other CLIs.
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from larvanet_tpu_torch.cli import common

IGNORED = ("packed_trunk",)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, default="edsr", help="Name of the model.")
    parser.add_argument("--scales", type=str, default="4", help="Scale of the input images.")
    common.add_device_flags(parser)
    parser.add_argument("--restore_path", type=str, required=True,
                        help="Checkpoint to export: a .pth or a JAX .ckpt ('latest' "
                             "with --train_path).")
    parser.add_argument("--train_path", type=str, default=None,
                        help="Run directory for --restore_path latest.")
    parser.add_argument("--output", type=str, default=None, help="Destination .pth file.")
    parser.add_argument("--stablehlo", type=str, default=None,
                        help="Destination serving artifact (utils/aot.py): a torch.export "
                             "program with the weights baked in, instead of / in addition "
                             "to the .pth.")
    parser.add_argument("--export_batch", type=int, default=1, help="Artifact input batch size.")
    parser.add_argument("--export_height", type=int, default=256,
                        help="Artifact input (LR) height.")
    parser.add_argument("--export_width", type=int, default=256,
                        help="Artifact input (LR) width (even for the int8 path).")
    parser.add_argument("--collapsed_tail", type=int, default=1,
                        help="Artifact path: collapsed linear tail (EDSR).")
    parser.add_argument("--int8_trunk", type=int, default=0,
                        help="Artifact path: W8A8 quantized trunk (NOT float-exact); "
                             "requires --calib_path.")
    parser.add_argument("--calib_path", type=str, default=None,
                        help="Directory of LR PNGs for int8 calibration.")
    parser.add_argument("--platforms", type=str, default=None,
                        help="Comma-separated devices the artifact may be loaded on "
                             "('cuda', 'cpu'); default = --device.")
    parser.add_argument("--ema", type=int, default=0,
                        help="Export the EMA weights of a --ema_decay checkpoint.")
    parser.add_argument("--export_dtype", type=str, default="f32", choices=["f32", "bf16"],
                        help="Artifact compute dtype: f32 = parity; bf16 = the "
                             "throughput configuration (NOT bit-identical).")
    common.add_refused_flags(parser, (), IGNORED)
    return parser


def main(argv=None):
    args, remaining = build_parser().parse_known_args(argv)
    if not args.output and not args.stablehlo:
        raise SystemExit("nothing to do: pass --output (.pth) and/or "
                         "--stablehlo (serving artifact)")
    platforms = None
    if args.platforms:
        from larvanet_tpu_torch.utils.aot import PLATFORMS

        platforms = tuple(p.strip() for p in args.platforms.split(",") if p.strip())
        bad = [p for p in platforms if p not in PLATFORMS]
        if bad:
            raise SystemExit("--platforms %s: a torch.export artifact runs on %s"
                             % (",".join(bad), " and ".join(PLATFORMS)))
    if args.int8_trunk and args.stablehlo and not args.calib_path:
        raise SystemExit("--int8_trunk requires --calib_path "
                         "(LR PNGs for activation calibration)")
    device = common.resolve_device(args)
    scale_list = common.scales_of(args)
    model, _, remaining = common.setup_model(args.model, remaining, scale_list, device)
    common.note_ignored(args, IGNORED, "export", model)
    common.warn_leftovers(remaining)

    from larvanet_tpu_torch.utils.checkpoints import resolve_restore_path
    from larvanet_tpu_torch.utils.torch_convert import EXPORT_RULES

    if args.output and args.model not in EXPORT_RULES:
        # fail fast, before the restore
        raise SystemExit("no .pth export rules for model %r (supported: %s)"
                         % (args.model, ", ".join(sorted(EXPORT_RULES))))
    ckpt = resolve_restore_path(args.restore_path, args.train_path)
    if ckpt is None:
        raise SystemExit("no checkpoint found to export")
    model.restore(ckpt)
    common.maybe_use_ema(model, args)
    print("restored the model")

    if args.output:
        import torch

        from larvanet_tpu_torch.utils.checkpoints import to_host

        torch.save(to_host({k: v.detach() for k, v in model.module.state_dict().items()}),
                   args.output)
        print("exported %s -> %s" % (ckpt, args.output))

    if args.stablehlo:
        from larvanet_tpu_torch.utils.aot import export_serving, save_artifact

        calib = None
        if args.int8_trunk:
            calib = _calib_from_dir(args.calib_path, args.export_height, args.export_width)
        shape = (args.export_batch, args.export_height, args.export_width, 3)
        program, header = export_serving(
            model, shape, dtype="bfloat16" if args.export_dtype == "bf16" else "float32",
            packed_trunk=str(args.packed_trunk) != "0",
            collapsed_tail=bool(args.collapsed_tail), int8_trunk=bool(args.int8_trunk),
            calib=calib, platforms=platforms)
        save_artifact(args.stablehlo, program, header)
        print("exported serving artifact %s (%s; input %s; platforms %s)"
              % (args.stablehlo, header["path_desc"], shape, ",".join(header["platforms"])))
    return model


def _calib_from_dir(path, height, width, num_images=4):
    """Centre-crop the first PNGs of a directory to the export geometry for
    int8 activation calibration (JAX's `_calib_from_dir`, cli/export.py:
    148-170): NHWC float32."""
    from larvanet_tpu_torch.data import io

    names = sorted(f for f in os.listdir(path) if f.lower().endswith(".png"))
    if not names:
        raise SystemExit("no PNGs in --calib_path %s" % path)
    out = []
    for f in names[:num_images]:
        im = io.load_image_u8(os.path.join(path, f)).astype(np.float32)
        if im.shape[0] < height or im.shape[1] < width:
            raise SystemExit("calibration image %s (%dx%d) is smaller than "
                             "the export geometry %dx%d"
                             % (f, im.shape[0], im.shape[1], height, width))
        top = (im.shape[0] - height) // 2
        left = (im.shape[1] - width) // 2
        out.append(im[top:top + height, left:left + width])
    return np.asarray(out, np.float32)


if __name__ == "__main__":
    main()
