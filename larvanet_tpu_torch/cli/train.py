"""Step-driven training CLI (larvanet_tpu/cli/train.py:25-140; reference
train.py):

    python -m larvanet_tpu_torch.cli.train --dataloader div2k_train_loader \\
        --model edsr --scales 4 --train_path runs/edsr \\
        --data_input_path LR --data_truth_path HR [--data_seed 0] \\
        [--batch_size 16 --input_patch_size 48] [--max_steps N] \\
        [--restore_path latest] [--ema_decay 0.999] [--grad_accum 2] \\
        [--device_pipeline 100] [--async_checkpoint 1] [--profile_dir trace] \\
        [--widen_from narrow.ckpt] [--train_dtype bf16] [--remat 1] [--device cpu] \\
        [--dp_devices N] [--orbax_checkpoint 1]

The host loop: `reseed_for_step` (with --data_seed, a resumed run draws
the batches an uninterrupted one would), `get_patch_batch`, `train_step`,
with --sleep_ratio, --log_freq, --summary_freq (scalars.jsonl per scale
directory, its writer made when the first summary is due) and --save_freq
(`model_<step>.pth` and its state file). It runs on the card unless
--device cpu is given; every 3x3 conv of the forward and the backward runs
on the hand-written kernels there. Every registered model trains: EDSR
(edsr, edsr_loss) with Adam and its step decay; the LarvaNet presets as
the JAX package's step-driven CLI trains them, AdamW on the multi-exit
loss at the plateau schedule's learning rate, which nothing validates
here, so it stays at --lr (their volume-driven loop is cli/train_larva.py).

--device_pipeline N (`_train_device_pipeline`, cli/train.py:144-195): the
uint8 set resident on the device (data/device_pipeline.py), N steps a chunk
with the patches sampled and augmented there, the chunk's draws seeded from
(--data_seed, global_step), one line a chunk with ChunkRateMeter's steps/s.
--async_checkpoint 1 writes the checkpoints on a worker thread (the CLI
waits for them before it returns). --profile_dir runs the loop under
torch.profiler and writes trace.json there (utils/profiling.py).
--widen_from warm-starts a wider model from a narrower checkpoint
(utils/width_transfer.py; exclusive with --restore_path). A JAX `.ckpt`
given to --restore_path resumes training with its optimizer state. The
model's --train_dtype bf16 (EDSR) trains in mixed precision on the kernels'
bf16 entries, and --remat 1 recomputes each conv pair in the backward.
--qat 1 trains through the fake-quant conv pairs (ops/pairs.qat_pair; even
patch width). An explicit --packed_trunk 0 makes a bf16 step f32 and is
refused with --qat 1 or --remat 1, as in JAX. --dp_devices N trains
data-parallel over N devices (parallel/mesh.use_data_parallel, after the
restore; --batch_size must divide, --device_pipeline is refused, as in
JAX). --orbax_checkpoint 1 writes each checkpoint as a directory
(torch.distributed.checkpoint; models/base.py `_save_dir`). The model's
--collapsed_tail_train and --lr_domain_loss (EDSR, default 1) train
through the live collapsed tail with the loss before the shuffle, as
JAX's default graph does (ops/collapsed_tail.py). --fused_opt 1 steps Adam
(AdamW) in one hand-written launch a step over flat moment buffers in JAX's
ravel_pytree order (ops/adam_flat.py, models/base.make_optimizer), as JAX's
flag runs optax.flatten; the checkpoints are the same either way.
"""

from __future__ import annotations

import argparse
import os
import time

from larvanet_tpu_torch.cli import common
from larvanet_tpu_torch.core.config import dump_arguments_json
from larvanet_tpu_torch.utils.checkpoints import resolve_restore_path
from larvanet_tpu_torch.utils.profiling import annotate, trace
from larvanet_tpu_torch.utils.summary import SummaryWriter



def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    common.add_common_flags(parser, default_loader="div2k_train_loader", default_model="edsr")
    parser.add_argument("--batch_size", type=int, default=16,
                        help="Size of the batches for each training step.")
    parser.add_argument("--input_patch_size", type=int, default=48,
                        help="Size of each input image patch.")
    parser.add_argument("--train_path", type=str, required=True,
                        help="Base path of the trained model to be saved.")
    parser.add_argument("--grad_accum", type=int, default=1,
                        help="Accumulate gradients over N equal microbatches: the "
                             "full-batch mean gradient at batch/N peak activation "
                             "memory. batch_size must be divisible by N.")
    parser.add_argument("--max_steps", type=int, default=300000,
                        help="The maximum number of training steps.")
    parser.add_argument("--log_freq", type=int, default=10,
                        help="The frequency of logging.")
    parser.add_argument("--summary_freq", type=int, default=1000,
                        help="The frequency of writing summaries.")
    parser.add_argument("--save_freq", type=int, default=10000,
                        help="The frequency of saving the trained model.")
    parser.add_argument("--sleep_ratio", type=float, default=0.0,
                        help="Per-step sleep ratio (a thermal throttle; default off).")
    parser.add_argument("--restore_path", type=str,
                        help="Checkpoint (.pth) to restore; 'latest' resumes from the "
                             "newest model_*.pth in --train_path.")
    parser.add_argument("--restore_target", type=str,
                        help="Target of the restoration (accepted, as in the JAX CLI).")
    parser.add_argument("--global_step", type=int, default=0,
                        help="Initial global step (a state file's step replaces it).")
    common.add_ema_decay_flag(parser)
    common.add_fused_opt_flag(parser)
    common.add_train_flags(parser)
    return parser


def main(argv=None):
    """Train; returns (the model in its final state, {global_step: loss})."""
    args, remaining = build_parser().parse_known_args(argv)
    device = common.resolve_device(args)
    scale_list = common.scales_of(args)
    os.makedirs(args.train_path, exist_ok=True)

    dataloader, loader_args, remaining = common.setup_loader(args.dataloader, remaining,
                                                             scale_list)
    model, model_args, remaining = common.setup_model(
        args.model, remaining, scale_list, device, is_training=True,
        global_step=args.global_step, ema_decay=args.ema_decay,
        fused_opt=args.fused_opt)
    model.grad_accum = args.grad_accum
    model.async_checkpoints = bool(args.async_checkpoint)
    model.orbax_checkpoints = bool(args.orbax_checkpoint)
    common.warn_leftovers(remaining)
    common.maybe_widen_from(model, args)

    restore_path = resolve_restore_path(args.restore_path, args.train_path)
    if restore_path is not None:
        model.restore(restore_path)
        print("restored the model")
    common.maybe_dp_train(model, args)

    summary_writers = {}  # by scale, made when its first summary is due
    dump_arguments_json(os.path.join(args.train_path, "arguments.json"), args, loader_args,
                        model_args)

    print("begin training")
    losses = {}
    try:
        with trace(args.profile_dir):
            if args.device_pipeline > 0:
                losses = _train_device_pipeline(args, dataloader, model, scale_list[0],
                                                device)
            else:
                _host_loop(args, dataloader, model, summary_writers, losses)
    finally:
        for w in summary_writers.values():
            w.close()
    model.wait_for_checkpoints()
    print("finished")
    return model, losses


def _host_loop(args, dataloader, model, summary_writers, losses) -> None:
    """The host pipeline: a batch from the loader and `train_step`, a step
    at a time."""
    local_step = 0
    while model.global_step < args.max_steps:
        local_step += 1
        start_time = time.time()
        scale = model.get_next_train_scale()
        summary = None
        if local_step % args.summary_freq == 0:
            if scale not in summary_writers:
                summary_writers[scale] = SummaryWriter(
                    os.path.join(args.train_path, "x%d" % scale))
            summary = summary_writers[scale]
        with annotate("data"):
            dataloader.reseed_for_step(model.global_step)  # the resumable stream
            input_list, truth_list = dataloader.get_patch_batch(
                batch_size=args.batch_size, scale=scale,
                input_patch_size=args.input_patch_size)
        with annotate("train_step"):
            loss = model.train_step(input_list=input_list, scale=scale,
                                    truth_list=truth_list, summary=summary)
        losses[model.global_step] = loss
        duration = time.time() - start_time
        if args.sleep_ratio > 0 and duration > 0:
            time.sleep(min(10.0, duration * args.sleep_ratio))
        if local_step % args.log_freq == 0:
            print("step %d, lr %f, loss %.6f (%.3f sec/batch)"
                  % (model.global_step, model.get_learning_rate(), loss, duration))
        if local_step % args.save_freq == 0:
            model.save(base_path=args.train_path)
            print("saved a model checkpoint at step %d" % (model.global_step,))


def _train_device_pipeline(args, dataloader, model, scale, device) -> dict:
    """--device_pipeline N (cli/train.py:144-195): chunks of N steps on the
    device-resident set until --max_steps, a chunk's draws seeded from
    (--data_seed, its first step); the chunk's mean loss is read back once.
    Returns {global_step after the chunk: its mean loss}."""
    from larvanet_tpu_torch.data.device_pipeline import chunk_seed, pipeline_for, run_chunk

    pipe = pipeline_for(dataloader.dataset, scale, device)
    print("device pipeline: %d images, %.1f MB resident on the device"
          % (len(pipe), pipe.nbytes() / 1e6))
    data_seed = getattr(dataloader.args, "data_seed", None) or 0
    meter = common.ChunkRateMeter()
    losses = {}
    while model.global_step < args.max_steps:
        t0 = time.time()
        lr = model.get_learning_rate()
        with annotate("chunk"):
            loss = run_chunk(model, pipe, args.device_pipeline, args.batch_size,
                             args.input_patch_size, lr,
                             chunk_seed(data_seed, model.global_step))
        model.global_step += args.device_pipeline
        loss_val = float(loss)
        dt = time.time() - t0
        inst, avg, trusted = meter.update(model.global_step, args.device_pipeline, dt)
        print("step %d, lr %f, mean loss %.6f (%.1f steps/s)%s"
              % (model.global_step, lr, loss_val, inst, meter.suffix(avg, trusted)))
        losses[model.global_step] = loss_val
        if args.save_freq and model.global_step % args.save_freq < args.device_pipeline:
            model.save(base_path=args.train_path)
            print("saved a model checkpoint at step %d" % (model.global_step,))
    return losses


if __name__ == "__main__":
    main()
