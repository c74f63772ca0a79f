"""Shared CLI plumbing (larvanet_tpu/cli/common.py, the parts the ported
CLIs use).

Entry points run on the card. `--device cpu` runs them on the CPU (the
tests do); without it and without CUDA they exit non-zero instead of
quietly running on the CPU. The JAX CLIs' TPU-only settings are accepted
and ignored with a notice (`add_ignored_flags`, `note_ignored`).
"""

from __future__ import annotations

import argparse
import os
import time
from typing import List, Sequence

import numpy as np
import torch

from larvanet_tpu_torch.core import registry
from larvanet_tpu_torch.core.config import parse_scale_list


def add_common_flags(parser: argparse.ArgumentParser, default_loader: str,
                     default_model: str = "edsr") -> None:
    """--dataloader, --model, --scales, and the device flags."""
    parser.add_argument("--dataloader", type=str, default=default_loader,
                        help="Name of the data loader.")
    parser.add_argument("--model", type=str, default=default_model,
                        help="Name of the model.")
    parser.add_argument("--scales", type=str, default="4",
                        help="Scales of the input images. Use the ',' character "
                             "to specify multiple scales (e.g., 2,3,4).")
    add_device_flags(parser)


def add_device_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--device", type=str, default="cuda",
                        choices=["cuda", "cpu"],
                        help="Where the model runs. cuda (default) needs a "
                             "card; cpu runs the kernels' plain versions.")
    parser.add_argument("--cuda_device", type=str, default="-1",
                        help="Index of the card (cuda:N); -1 = the current "
                             "device.")


def resolve_device(args) -> torch.device:
    if args.device == "cpu":
        return torch.device("cpu")
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device is available: this entry point runs "
                         "on the card (pass --device cpu to run on the CPU)")
    index = int(args.cuda_device)
    return torch.device("cuda", index if index >= 0 else torch.cuda.current_device())


def synchronize(device: torch.device) -> None:
    """Wait for the card's queued work (the counterpart of block_until_ready)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def add_ignored_flags(parser: argparse.ArgumentParser, ignored: Sequence[str]) -> None:
    """Flags of the JAX CLI that only matter on the TPU: accepted and
    ignored (`note_ignored` names them)."""
    for flag in ignored:
        parser.add_argument("--" + flag, type=str, default=None,
                            help="A TPU-only setting; accepted and ignored.")


def note_ignored(args, ignored: Sequence[str], tool: str, model) -> None:
    """Name the TPU-only flags that were given, but those that `model`
    reads when it serves (`model.serving_flags`)."""
    given = ["--" + flag for flag in ignored if getattr(args, flag, None) is not None
             and flag not in model.serving_flags]
    if given:
        print("%s: %s only matter(s) on the TPU; ignored here" % (tool, ", ".join(given)))


def setup_loader(name: str, remaining: Sequence[str], scales: List[int]):
    print("prepare data loader - %s" % (name,))
    loader = registry.get_loader(name)
    loader_args, remaining = loader.parse_args(list(remaining))
    loader.prepare(scales=scales)
    return loader, loader_args, remaining


def setup_model(name: str, remaining: Sequence[str], scales: List[int],
                device: torch.device, seed: int = 0, is_training: bool = False,
                global_step: int = 0, ema_decay: float = 0.0):
    print("prepare model - %s" % (name,))
    try:
        model = registry.get_model(name)
    except KeyError as e:
        # every name of the JAX package's registry is registered
        raise SystemExit("--model %s: %s" % (name, e.args[0]))
    model_args, remaining = model.parse_args(list(remaining))
    model.ema_decay = float(ema_decay or 0.0)  # before prepare: it makes the average
    model.prepare(scales=scales, device=device, seed=seed, is_training=is_training,
                  global_step=global_step)
    return model, model_args, remaining


def add_ema_decay_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--ema_decay", type=float, default=0.0,
                        help="Track an exponential moving average of the params "
                             "(e.g. 0.999), saved in the state file beside each "
                             "checkpoint. 0 = off.")


def add_fused_opt_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--fused_opt", type=int, default=None,
                        help="The JAX package's one-pass Adam over a flattened "
                             "parameter vector (numerically identical per "
                             "element); accepted and ignored.")


def add_ema_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--ema", type=int, default=0,
                        help="Serve the EMA weights of a --ema_decay checkpoint (a "
                             "JAX .ckpt's average, or the .state.pt beside a .pth).")


def maybe_use_ema(model, args) -> None:
    """Swap the restored parameter average into the model when --ema is set
    (larvanet_tpu/cli/common.py:222-228). Runs right after restore, before
    apply_serving_dtype and maybe_wino_trunk, which read the weights."""
    if getattr(args, "ema", 0):
        model.use_ema_params()
        print("serving the EMA weights (--ema)")


def add_chop_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--chop_forward", action="store_true",
                        help="The reference's chop-forward: the frame in 2x2 "
                             "overlapping quadrants, each upscaled on its own.")
    parser.add_argument("--chop_overlap_size", type=int, default=20,
                        help="The overlap of the chop-forward quadrants; an odd "
                             "pixel is dropped, as in the reference.")


def add_tile_flags(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--tile_forward", action="store_true",
                        help="Overlapping fixed-size LR tiles, batched through "
                             "the forward on the device (eval/tiling.py).")
    parser.add_argument("--tile_size", type=int, default=128,
                        help="LR tile size for --tile_forward.")
    parser.add_argument("--tile_overlap", type=int, default=24,
                        help="LR tile overlap for --tile_forward; the tiles "
                             "equal the full-frame forward when half of it "
                             "exceeds the model's receptive radius.")


def make_tiler(model, args, forward=None):
    """The TiledUpscaler of --tile_forward over `forward` (default: the
    model's serving forward, `fwd_runtime`), or None without the flag; its
    tile batches are rounded up to a multiple of --dp_devices."""
    from larvanet_tpu_torch.eval.tiling import TiledUpscaler

    if not getattr(args, "tile_forward", False):
        return None
    return TiledUpscaler(forward or model.fwd_runtime, scale=model.scale,
                         tile_size=args.tile_size, overlap=args.tile_overlap,
                         device=model.device,
                         min_batch=max(1, int(getattr(args, "dp_devices", 0) or 0)))


def add_serving_dtype_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--serving_dtype", type=str, default="f32",
                        choices=["f32", "bf16"],
                        help="Compute dtype of the forward. f32 (default) = "
                             "the parity configuration; bf16 = the "
                             "throughput configuration (not bit-identical "
                             "to f32).")


def apply_serving_dtype(model, args) -> None:
    model.set_serving_dtype(getattr(args, "serving_dtype", "f32"))
    if model.compute_dtype == torch.bfloat16:
        print("inference compute dtype: bfloat16 (throughput configuration; "
              "not bit-identical to f32)")


def add_wino_trunk_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--wino_trunk", type=int, default=0,
                        help="Run every 64-channel trunk ResBlock (EDSR, "
                             "LarvaNet_w64) as one fused Winograd kernel: 2 = "
                             "F(2,3), 4 = F(4,3) (ops/wino_resblock.py; "
                             "float-tolerance equal to the standard path; 0 = "
                             "off). Even input widths.")


def maybe_wino_trunk(model, args) -> None:
    """Route the EDSR or LarvaNet-family forward through the fused Winograd
    ResBlock kernel when --wino_trunk is 2 or 4 (cli/common.py:384-428 in
    the JAX package). The trunk's width, read from the module, decides the
    route once: EDSR must be 64 wide on the card; a LarvaNet trunk of any
    other width than 64 runs its ResBlocks on the direct convs with a
    notice, as JAX's 48-channel trunks do. No fallback: on the card the
    route launches the kernel or raises; with --device cpu it runs the
    kernel's plain version."""
    from larvanet_tpu_torch.ops.wino_resblock import (KERNEL_CHANNELS,
                                                      make_wino_edsr_forward,
                                                      make_wino_larvanet_forward)

    m = int(getattr(args, "wino_trunk", 0) or 0)
    if not m:
        return
    if m not in (2, 4):
        raise SystemExit("--wino_trunk must be 0, 2 or 4 (got %d)" % m)
    model_name = getattr(args, "model", None) or ""
    is_edsr = model_name in ("edsr", "edsr_loss")
    if not (is_edsr or model_name.startswith(("LarvaNet", "LarvaLeg"))):
        print("--wino_trunk: only the EDSR/LarvaNet families are routed; "
              "running the standard path for %r" % model_name)
        return
    features = model.module.features
    if is_edsr:
        if model.device.type == "cuda" and features != KERNEL_CHANNELS:
            raise SystemExit("--wino_trunk: the kernel is built for %d features, the "
                             "model has %d" % (KERNEL_CHANNELS, features))
        model.set_route(make_wino_edsr_forward(model, m))
        model.route_remake = lambda rep: make_wino_edsr_forward(rep, m)
    else:
        model.set_route(make_wino_larvanet_forward(model, m))
        model.route_remake = lambda rep: make_wino_larvanet_forward(rep, m)
        if features != KERNEL_CHANNELS:
            print("--wino_trunk: %r trunk is %d channels (the fused kernel is built "
                  "for %d); body ResBlocks run the direct conv3x3 kernel"
                  % (model_name, features, KERNEL_CHANNELS))
    print("inference: fused Winograd F(%d,3) ResBlock kernel enabled" % m)


def add_collapsed_tail_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--collapsed_tail", type=int, default=1,
                        help="Run EDSR's linear upsample tail as one collapsed conv + "
                             "pixel shuffle with exact border operators "
                             "(ops/collapsed_tail.py; float-tolerance equal to the "
                             "module's tail). 0 = the module's own tail. MAMNet takes "
                             "the collapsed tail unless --packed_trunk 0.")


def maybe_collapse_tail(model, args) -> None:
    """Route inference through the collapsed linear tail where the model
    serves one (`model.serves_collapsed_tail(args)`: EDSR under
    --collapsed_tail; MAMNet unless --packed_trunk 0, as JAX's CLIs serve
    make_packed_mamnet_forward, larvanet_tpu/cli/common.py:303-350): the
    probes run once here, with the module's f32 weights, on its device.
    Runs after --ema and restore, before maybe_wino_trunk and
    maybe_int8_trunk (whose EDSR and MAMNet forwards bake the same tail). A
    module whose MeanShift buffers are not the intended +/-mean shifts
    keeps the module graph, as JAX's EDSR route does (JAX's MAMNet route
    bakes the intended shifts regardless: ROADMAP.md queue 3). Other
    families: nothing to collapse (JAX's width-packed trunks are not
    ported)."""
    from larvanet_tpu_torch.models.layers import mean_shifts_intended
    from larvanet_tpu_torch.ops.collapsed_tail import make_collapsed_edsr_forward

    if not model.serves_collapsed_tail(args):
        return
    if not mean_shifts_intended(model.module):
        print("--collapsed_tail: the checkpoint carries trained (non-identity) "
              "MeanShift affines; the collapsed graphs bake the intended mean "
              "shifts, not these, so the exact module graph runs")
        return
    model.set_route(make_collapsed_edsr_forward(model))
    model.route_remake = make_collapsed_edsr_forward
    print("inference: collapsed linear tail enabled")


def warn_leftovers(remaining: Sequence[str]) -> None:
    if remaining:
        print("WARNING: found unhandled arguments: %s" % (list(remaining),))


def scales_of(args) -> List[int]:
    return parse_scale_list(args.scales)


def add_int8_trunk_flag(parser: argparse.ArgumentParser, help_tail: str = "") -> None:
    parser.add_argument("--int8_trunk", type=int, default=0,
                        help="Opt-in W8A8 quantized trunk (EDSR/MAMNet/LarvaNet/MSRR/"
                             "TreeNet/REGO/ebrn_rm/HRSR; "
                             "NOT float-exact; the int8 forward runs in bf16 whatever "
                             "--serving_dtype says; even widths, odd ones take the "
                             "exact forward)." + help_tail)


# model-name prefixes -> the int8 forward's maker in ops/int8_forward.py
# (larvanet_tpu/cli/common.py:345-356)
INT8_BUILDERS = {
    ("edsr", "edsr_loss", "mamnet"): "make_int8_edsr_forward",
    ("LarvaNet", "LarvaLeg"): "make_int8_larvanet_forward",
    ("msrr", "dwsr"): "make_int8_msrr_forward",
    ("REGO",): "make_int8_rego_forward",
    ("TreeNet",): "make_int8_treenet_forward",
    ("hrsr",): "make_int8_hrsr_forward",
    ("ebrn_rm",): "make_int8_ebrn_rm_forward",
}


def int8_and_exact_forwards(model, model_name: str, calib):
    """The (int8, exact) forwards of a model family, or Int8Unsupported (a
    ValueError) when the family has no int8 path or the configuration cannot
    be quantized (cli/common.py:359-381). The int8 forward is built in bf16,
    as JAX's CLIs build it (the maker's default); the exact forward, the
    odd-width route and the --int8_report reference, is the serving module
    in the serving dtype, through the collapsed tail for EDSR and MAMNet, as
    JAX's make_packed_edsr_forward and make_packed_mamnet_forward are."""
    from larvanet_tpu_torch.ops import int8_forward
    from larvanet_tpu_torch.models.layers import mean_shifts_intended
    from larvanet_tpu_torch.ops.collapsed_tail import make_collapsed_edsr_forward

    for prefixes, maker in INT8_BUILDERS.items():
        if model_name in prefixes or model_name.startswith(prefixes):
            int8_fwd = getattr(int8_forward, maker)(model, calib)
            if model.has_collapsed_tail and mean_shifts_intended(model.module):
                # JAX's exact EDSR and MAMNet forwards bake the collapsed tail too
                return int8_fwd, make_collapsed_edsr_forward(model)
            return int8_fwd, lambda x: model.serving_module(x)
    raise int8_forward.Int8Unsupported("no int8 path for model %r" % (model_name,))


def maybe_int8_trunk(model, args, get_calib) -> None:
    """Route the forward through the W8A8 trunk when --int8_trunk is set
    (cli/common.py:431-464). `get_calib` lazily returns an NHWC float32
    calibration batch; an odd width is cropped by a column first. A family
    or configuration with no int8 path (Int8Unsupported) prints JAX's
    `--int8_trunk: ...; ignoring` line and keeps the exact route; any other
    failure, a kernel's in calibration among them, propagates. Odd-width
    inputs take the exact forward, which `model.int8_exact_forward` also
    keeps for --int8_report. Runs after maybe_wino_trunk: int8 wins when
    both are given (`int8_and_exact_forwards` says what its exact forward
    is)."""
    from larvanet_tpu_torch.ops.int8_forward import Int8Unsupported

    if not getattr(args, "int8_trunk", 0):
        return
    model_name = getattr(args, "model", None) or ""
    calib = np.asarray(get_calib(), np.float32)
    if calib.shape[2] % 2:
        calib = calib[:, :, : calib.shape[2] // 2 * 2]
    try:
        forward, exact_fwd = int8_route(model, model_name, calib)
    except Int8Unsupported as e:
        print("--int8_trunk: %s; ignoring" % (e,))
        return
    model.set_route(forward)
    # a copy on another device calibrates its own on the same batch
    model.route_remake = lambda rep: int8_route(rep, model_name, calib)[0]
    model.int8_exact_forward = exact_fwd
    print("inference: int8 (W8A8) trunk enabled (NOT float-exact)")


def int8_route(model, model_name: str, calib):
    """(the --int8_trunk route, its exact forward): the int8 forward on
    even widths, the exact one on odd widths."""
    int8_fwd, exact_fwd = int8_and_exact_forwards(model, model_name, calib)

    def forward(x):
        if x.shape[2] % 2:
            return exact_fwd(x)  # odd width: the exact forward
        return int8_fwd(x)

    return forward, exact_fwd


def int8_calib_batch(dataloader, scale, num_images=4) -> np.ndarray:
    """The int8 calibration batch (cli/common.py:467-483): the first
    `num_images` val inputs centre-cropped to their common size (the width
    even-aligned), stacked NHWC float32."""
    n = min(int(num_images), dataloader.get_num_images())
    imgs = [dataloader.get_image_pair(image_index=i, scale=scale)[0].transpose(1, 2, 0)
            for i in range(n)]
    hh = min(im.shape[0] for im in imgs)
    ww = min(im.shape[1] for im in imgs) // 2 * 2
    out = []
    for im in imgs:
        top = (im.shape[0] - hh) // 2
        left = (im.shape[1] - ww) // 2
        out.append(im[top:top + hh, left:left + ww])
    return np.asarray(out, np.float32)


def add_train_flags(parser: argparse.ArgumentParser) -> None:
    """The train CLIs' --async_checkpoint, --profile_dir, --device_pipeline,
    --widen_from, --dp_devices and --orbax_checkpoint
    (larvanet_tpu/cli/train.py:36-67, common.py:140-148, 185-193)."""
    parser.add_argument("--async_checkpoint", type=int, default=0,
                        help="Write checkpoints on a worker thread: the tensors are "
                             "snapshotted on the device and the loop goes on.")
    parser.add_argument("--profile_dir", type=str, default=None,
                        help="Run the training loop under torch.profiler and write a "
                             "Chrome trace (trace.json) into this directory.")
    parser.add_argument("--device_pipeline", type=int, default=0,
                        help="Steps per chunk with the uint8 dataset resident on the "
                             "device and the patches sampled and augmented there "
                             "(0 = the host pipeline).")
    parser.add_argument("--widen_from", type=str, default=None,
                        help="Warm-start this (wider) model from a narrower checkpoint "
                             "of the same topology (a JAX .ckpt or the port's .pth): "
                             "function-preserving widening, optimizer reset. "
                             "Exclusive with --restore_path.")
    add_dp_train_flag(parser)
    parser.add_argument("--orbax_checkpoint", type=int, default=0,
                        help="Directory checkpoints (torch.distributed.checkpoint; "
                             "written by every process of an initialized group; "
                             "combines with --async_checkpoint; restore recognises "
                             "them).")


def maybe_widen_from(model, args) -> None:
    """--widen_from (larvanet_tpu/cli/common.py:151-187): the narrow
    checkpoint's parameters embedded function-preservingly into the prepared
    (wider) model, with fresh optimizer moments and average. Takes a JAX
    `.ckpt` (read by utils/flax_msgpack), the port's `.pth` or its
    --orbax_checkpoint directory; a JAX orbax directory is refused."""
    ckpt = getattr(args, "widen_from", None)
    if not ckpt:
        return
    if getattr(args, "restore_path", None):
        raise SystemExit("--widen_from and --restore_path are mutually "
                         "exclusive (widening IS the warm start)")
    from larvanet_tpu_torch.models.base import ParamEMA, make_optimizer
    from larvanet_tpu_torch.utils import flax_msgpack
    from larvanet_tpu_torch.utils.checkpoints import is_dir_checkpoint, read_dir_checkpoint
    from larvanet_tpu_torch.utils.torch_convert import load_pth
    from larvanet_tpu_torch.utils.width_transfer import widen_state_dict

    if is_dir_checkpoint(ckpt):
        old = read_dir_checkpoint(ckpt)[0]
    elif os.path.isdir(ckpt):
        raise SystemExit("--widen_from %s: a JAX orbax directory needs orbax, which the "
                         "port does not use; widen from a .ckpt, a .pth or the port's "
                         "--orbax_checkpoint directory" % (ckpt,))
    elif ckpt.endswith((".pth", ".pt")):
        old = load_pth(ckpt)
    else:
        with open(ckpt, "rb") as f:
            state = flax_msgpack.restore(f.read())
        old = model._from_jax_tree(state["params"])
    module = model.module
    names = [name for name, _ in module.named_parameters()]
    widened = widen_state_dict(old, module.state_dict(), names)
    model.load_state_dict(widened, strict=True)
    if model.optimizer is not None:
        params = list(module.parameters())
        model.optimizer = make_optimizer(model.optimizer_kind, params)
        if model.ema is not None:
            model.ema = ParamEMA(params, model.ema_decay)
    print("warm-started by widening %s into %s (function-preserving; "
          "optimizer reset)" % (ckpt, model.registry_name))


def add_parallel_serving_flags(parser: argparse.ArgumentParser, dp_help: str) -> None:
    """--dp_devices, --spatial_shard and --spatial_halo of the inference
    CLIs (larvanet_tpu/cli/validate.py:59-65)."""
    parser.add_argument("--dp_devices", type=int, default=0, help=dp_help)
    parser.add_argument("--spatial_shard", type=int, default=0,
                        help="Shard full-frame inference height across N devices with "
                             "halo exchange (0 = off; parallel/halo.py).")
    parser.add_argument("--spatial_halo", type=int, default=32,
                        help="Halo rows exchanged between spatial shards; the sharded "
                             "forward equals the full frame once it reaches the model's "
                             "receptive radius (36 LR rows for EDSR-baseline x4).")


def maybe_spatial_shard(model, args, scale: int) -> None:
    """Route the forward through an H-sharded forward when --spatial_shard
    N > 1 (larvanet_tpu/cli/common.py:485-516): the frame split over N
    devices with halo exchange (parallel/halo.py). Like JAX's, it wraps the
    module graph (its serving module, in the serving dtype), not the route
    set before it, so a sharded forward runs the module's own tail. The
    CPU's mesh repeats the CPU; on the card, fewer cards than N print and
    ignore the flag, as JAX does."""
    from larvanet_tpu_torch.parallel.halo import spatial_sharded_forward
    from larvanet_tpu_torch.parallel.mesh import devices_for, make_mesh, replicate

    n = int(getattr(args, "spatial_shard", 0) or 0)
    if n <= 1:
        return
    if model.device.type == "cuda" and torch.cuda.device_count() < n:
        print("spatial_shard=%d requested but only %d devices; ignoring"
              % (n, torch.cuda.device_count()))
        return
    mesh = make_mesh((1, n), ("data", "spatial"),
                     devices=devices_for(model.device, n, "spatial_shard"))
    halo = int(getattr(args, "spatial_halo", 32))
    inner = spatial_sharded_forward(lambda module, x: module(x), mesh, halo=halo,
                                    scale=scale, axis_name="spatial", spatial_axis=1)
    params = replicate(model.serving_module, mesh)
    model.set_route(lambda x: inner(params, x))
    print("inference: spatially sharded over %d devices (halo %d; %s)"
          % (n, halo, mesh))


def maybe_dp_eval(model, args, what: str = "serving") -> None:
    """--dp_devices N > 1 on the inference CLIs (larvanet_tpu/cli/
    validate.py:153-163, get_sr.py:93-101, serve.py:652-660): the batch of
    every forward split over a 1-D 'data' mesh of N devices, each through
    its copy of the route set so far (parallel/mesh.use_data_parallel_eval).
    The CPU's mesh repeats the CPU; on the card N must not exceed the
    cards."""
    from larvanet_tpu_torch.parallel.mesh import devices_for, make_mesh, use_data_parallel_eval

    n = int(getattr(args, "dp_devices", 0) or 0)
    if n <= 1:
        return
    mesh = make_mesh((n,), ("data",), devices=devices_for(model.device, n))
    use_data_parallel_eval(model, mesh)
    print("%s: tile batches sharded over %d devices (%s)" % (what, n, mesh))


def add_dp_train_flag(parser: argparse.ArgumentParser) -> None:
    parser.add_argument("--dp_devices", type=int, default=0,
                        help="Train data-parallel over this many devices: the global "
                             "batch splits along a 1-D 'data' mesh, each device's "
                             "replica takes its shard's gradients, averaged in device "
                             "order (parallel/mesh.use_data_parallel). batch_size must "
                             "be divisible. 0/1 = single device.")


def maybe_dp_train(model, args) -> None:
    """Switch a prepared and restored model to data-parallel training when
    --dp_devices > 1 (larvanet_tpu/cli/common.py:195-219), with JAX's
    refusals: --device_pipeline, a --batch_size the mesh does not divide,
    and more cards than are visible. Call after restore: the replicas are
    copied from the restored model."""
    from larvanet_tpu_torch.parallel.mesh import devices_for, make_mesh, use_data_parallel

    n = int(getattr(args, "dp_devices", 0) or 0)
    if n <= 1:
        return
    if getattr(args, "device_pipeline", 0):
        raise SystemExit(
            "--dp_devices composes with the host loop only; drop "
            "--device_pipeline (the device-resident pipeline is single-device)")
    if getattr(args, "batch_size", 0) % n:
        raise SystemExit("--batch_size (%d) must be divisible by "
                         "--dp_devices (%d)" % (args.batch_size, n))
    mesh = make_mesh((n,), ("data",), devices=devices_for(model.device, n))
    use_data_parallel(model, mesh)
    print("training data-parallel over %d devices (%s; gradients averaged in device "
          "order)" % (n, mesh))


class ChunkRateMeter:
    """Steps/s of the device-pipeline loops (larvanet_tpu/cli/common.py:
    528-574): the first chunk starts a differenced clock; each later chunk's
    average is (steps since the first chunk) / (wall time since it), and
    its instantaneous rate n / dt is untrusted when above TRUST_FACTOR x
    that average. `suffix` renders the log's suffix in JAX's grammar."""

    TRUST_FACTOR = 5.0

    def __init__(self):
        self._t0 = None
        self._steps0 = None
        self._chunks = 0

    def update(self, global_step: int, n_steps: int, dt: float):
        """(instantaneous rate, average or None, trusted)."""
        self._chunks += 1
        now = time.time()
        inst = n_steps / max(dt, 1e-9)
        if self._chunks == 1:
            self._t0, self._steps0 = now, global_step
            return inst, None, True
        avg = (global_step - self._steps0) / max(now - self._t0, 1e-9)
        return inst, avg, inst <= self.TRUST_FACTOR * avg

    def suffix(self, avg, trusted) -> str:
        out = ""
        if avg is not None:
            out += " avg %.1f steps/s" % avg
        if not trusted:
            out += " [untrusted]"
        return out
