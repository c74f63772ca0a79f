"""Training with validation-driven learning-rate scheduling
(larvanet_tpu/cli/train_schedule.py; reference train_schedule.py and
train_schedule_tensor.py):

    python -m larvanet_tpu_torch.cli.train_schedule --train_path runs/hrsr \\
        --data_input_path LR --data_truth_path HR [--data_seed 0] \\
        --val_data_input_path VLR --val_data_truth_path VHR \\
        [--model hrsr] [--batch_size 16 --input_patch_size 48] \\
        [--step_per_epoch N] [--val_freq_epochs 10] [--max_steps 300000] \\
        [--restore_path latest] [--ema_decay 0.999] [--grad_accum 2] \\
        [--device_pipeline 100] [--async_checkpoint 1] [--profile_dir trace] \\
        [--widen_from narrow.ckpt] [--device cpu]

An epoch is --step_per_epoch steps, by default round_to_1(300 MiB / the
bytes of a batch: patch^2 x batch x 3), as the reference counts it
(train_schedule.py:103-106). The host loop (train_schedule.py:115-138): a
batch from the queue runners, or on an unthreaded loader `reseed_for_step`
(with --data_seed, a resumed run draws the batches an uninterrupted one
would) and `get_patch_batch`; `train_step`, with a summary (loss, lr,
images in `<train_path>/x<scale>/`) when the step it starts from is a
multiple of --summary_freq. Every --val_freq_epochs epochs
(`validate_and_step_scheduler`, :139-164): the whole val set through the
dispatch-ahead loop (eval/pipeline.pipelined_upscale, depth 2, each frame
quantized to uint8 on the device), its mean RGB PSNR stepping the model's
plateau scheduler `model.lr_scheduler` (hrsr's; a model without one, such
as hrsr_c3 or EDSR, just validates), then `model_<step>.pth` and its state
file, the scheduler's state in it.

--device_pipeline N (`_train_schedule_device`, :193-247): the uint8 set
resident on the device (data/device_pipeline.py), chunks of up to N steps
cut to land on every validation boundary, each seeded from (--data_seed,
its first step) as cli/train.py seeds them (the draws are the port's own,
not JAX's: ROADMAP.md queue 3); validation, the checkpoint and the chunk's
loss and lr summary at each boundary and at the end.

--async_checkpoint, --grad_accum, --ema_decay, --widen_from, --profile_dir
and --restore_path (a `.pth` or a JAX `.ckpt`, which resumes with its
optimizer state and scheduler) as in cli/train.py. It runs on the card
unless --device cpu is given, and never falls back to the CPU.
--dp_devices and --orbax_checkpoint as in cli/train.py. Accepted and
ignored: --fused_opt. `main` returns (the model
in its final state, {global_step: loss}, [(step, mean PSNR, lr after the
scheduler's step)] of the validations).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np

from larvanet_tpu_torch.cli import common
from larvanet_tpu_torch.cli.train_larva import round_to_1
from larvanet_tpu_torch.core.config import dump_arguments_json
from larvanet_tpu_torch.eval import metrics
from larvanet_tpu_torch.eval.pipeline import pipelined_upscale
from larvanet_tpu_torch.utils.checkpoints import resolve_restore_path
from larvanet_tpu_torch.utils.profiling import annotate, trace
from larvanet_tpu_torch.utils.summary import SummaryWriter

EPOCH_BYTES = 300 * 1024 ** 2  # an epoch's patch bytes (train_schedule.py:103-106)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    common.add_common_flags(parser, default_loader="div2k_train_loader", default_model="hrsr")
    parser.add_argument("--dataloader_val", type=str, default="div2k_val_loader",
                        help="Name of the validation data loader.")
    parser.add_argument("--val_data_input_path", type=str,
                        default="data/DIV2K_valid_LR_bicubic",
                        help="Base path of the validation input images.")
    parser.add_argument("--val_data_truth_path", type=str, default="data/DIV2K_valid_HR",
                        help="Base path of the validation ground-truth images.")
    parser.add_argument("--batch_size", type=int, default=16,
                        help="Size of the batches for each training step.")
    parser.add_argument("--input_patch_size", type=int, default=48,
                        help="Size of each input image patch.")
    parser.add_argument("--step_per_epoch", type=float, default=None,
                        help="Steps per epoch; default derives from 300 MiB of data.")
    parser.add_argument("--train_path", type=str, required=True,
                        help="Base path of the trained model to be saved.")
    parser.add_argument("--grad_accum", type=int, default=1,
                        help="Accumulate gradients over N equal microbatches; "
                             "batch_size must be divisible by N.")
    parser.add_argument("--max_steps", type=int, default=300000,
                        help="The maximum number of training steps.")
    parser.add_argument("--log_freq", type=int, default=10,
                        help="The frequency of logging.")
    parser.add_argument("--summary_freq", type=int, default=1000,
                        help="The frequency of writing summaries.")
    parser.add_argument("--val_freq_epochs", type=int, default=10,
                        help="Validate every N epochs (the reference uses 10).")
    parser.add_argument("--restore_path", type=str,
                        help="Checkpoint (.pth or a JAX .ckpt) to restore; 'latest' "
                             "resumes from the newest model_*.pth in --train_path.")
    parser.add_argument("--restore_target", type=str,
                        help="Target of the restoration (accepted, as in the JAX CLI).")
    parser.add_argument("--global_step", type=int, default=0,
                        help="Initial global step (a state file's step replaces it).")
    common.add_ema_decay_flag(parser)
    common.add_fused_opt_flag(parser)
    common.add_train_flags(parser)
    return parser


def main(argv=None):
    args, remaining = build_parser().parse_known_args(argv)
    if args.fused_opt is not None:
        print("train_schedule: --fused_opt is numerically identical per element; ignored")
    device = common.resolve_device(args)
    scale_list = common.scales_of(args)
    scale = scale_list[0]
    os.makedirs(args.train_path, exist_ok=True)

    dataloader, loader_args, remaining = common.setup_loader(args.dataloader, remaining,
                                                             scale_list)
    val_loader, _, _ = common.setup_loader(
        args.dataloader_val, ["--data_input_path", args.val_data_input_path,
                              "--data_truth_path", args.val_data_truth_path], scale_list)
    model, model_args, remaining = common.setup_model(
        args.model, remaining, scale_list, device, is_training=True,
        global_step=args.global_step, ema_decay=args.ema_decay)
    model.async_checkpoints = bool(args.async_checkpoint)
    model.orbax_checkpoints = bool(args.orbax_checkpoint)
    model.grad_accum = args.grad_accum
    common.warn_leftovers(remaining)
    common.maybe_widen_from(model, args)

    restore_path = resolve_restore_path(args.restore_path, args.train_path)
    if restore_path is not None:
        model.restore(restore_path)
        print("restored the model")
    common.maybe_dp_train(model, args)

    dump_arguments_json(os.path.join(args.train_path, "arguments.json"), args, loader_args,
                        model_args)

    if args.step_per_epoch is None:
        step_per_epoch = round_to_1(EPOCH_BYTES / (args.input_patch_size ** 2
                                                   * args.batch_size * 3))
    else:
        step_per_epoch = args.step_per_epoch
    print("%s steps equal to 1 epoch" % (step_per_epoch,))
    val_every = int(args.val_freq_epochs * step_per_epoch)
    if val_every < 1:
        raise SystemExit("--val_freq_epochs %d x %s steps an epoch validates every %d steps; "
                         "it must be at least 1" % (args.val_freq_epochs, step_per_epoch,
                                                    val_every))

    summary_box = []  # the writer, made when the first summary is due
    validations = []
    losses = {}
    print("begin training")
    try:
        with trace(args.profile_dir):
            if args.device_pipeline > 0:
                losses = _train_schedule_device(args, dataloader, val_loader, model, scale,
                                                device, step_per_epoch, val_every,
                                                summary_box, validations)
            else:
                _host_loop(args, dataloader, val_loader, model, scale, step_per_epoch,
                           val_every, summary_box, validations, losses)
    finally:
        for w in summary_box:
            w.close()
    model.wait_for_checkpoints()
    print("finished")
    return model, losses, validations


def _writer(args, scale, summary_box) -> SummaryWriter:
    if not summary_box:
        summary_box.append(SummaryWriter(os.path.join(args.train_path, "x%d" % scale)))
    return summary_box[0]


def _host_loop(args, dataloader, val_loader, model, scale, step_per_epoch, val_every,
               summary_box, validations, losses) -> None:
    """The host pipeline (train_schedule.py:115-138), until --max_steps."""
    threaded = dataloader.is_threaded
    if threaded:
        dataloader.start_training_queue_runner(batch_size=args.batch_size,
                                               input_patch_size=args.input_patch_size)
    try:
        while model.global_step < args.max_steps:
            t0 = time.time()
            with annotate("data"):
                if threaded:
                    inputs, truths = dataloader.get_queue_data(scale)
                else:
                    dataloader.reseed_for_step(model.global_step)  # the resumable stream
                    inputs, truths = dataloader.get_patch_batch(
                        args.batch_size, scale, args.input_patch_size)
            summary = (_writer(args, scale, summary_box)
                       if model.global_step % args.summary_freq == 0 else None)
            with annotate("train_step"):
                loss = model.train_step(inputs, scale, truths, summary)
            losses[model.global_step] = loss
            duration = time.time() - t0
            if model.global_step % val_every == 0:
                validations.append(validate_and_step_scheduler(args, val_loader, model, scale,
                                                               step_per_epoch))
            if model.global_step % args.log_freq == 0:
                print("step %d, lr %.8f, loss %.6f (%.3f sec/batch)"
                      % (model.global_step, model.get_learning_rate(), loss, duration))
    except KeyboardInterrupt:
        print("interrupted")
    finally:
        if threaded:
            dataloader.stop_queue_runners()


def validate_and_step_scheduler(args, val_loader, model, scale, step_per_epoch):
    """The whole val set's mean RGB PSNR (uint8 on the device, dispatch-ahead
    at depth 2), `model.lr_scheduler.step(psnr)` where the model has one,
    then a checkpoint (train_schedule.py:139-164). Returns (step, PSNR, the
    lr after the scheduler's step)."""
    print("begin validation")

    def items():
        for idx in range(val_loader.get_num_images()):
            inp, tru, _ = val_loader.get_image_pair(image_index=idx, scale=scale)
            yield tru, inp

    psnr_list = []
    for tru, o8, _ in pipelined_upscale(model, items(), scale, depth=2):
        t8 = metrics.fit_truth_to_output(o8, metrics.image_to_uint8(tru))
        psnr_list.append(metrics.psnr_rgb(o8, t8))
    average_psnr = float(np.mean(psnr_list))
    print("step %d, epoch %.0f, psnr=%.8f, lr = %.10f"
          % (model.global_step, model.global_step / step_per_epoch, average_psnr,
             model.get_learning_rate()))
    if getattr(model, "lr_scheduler", None) is not None:
        model.lr_scheduler.step(average_psnr)
    model.save(base_path=args.train_path)
    print("saved a model checkpoint at step %d" % (model.global_step,))
    return model.global_step, average_psnr, model.get_learning_rate()


def _train_schedule_device(args, dataloader, val_loader, model, scale, device,
                           step_per_epoch, val_every, summary_box, validations) -> dict:
    """--device_pipeline N (train_schedule.py:193-247): chunks of up to N
    steps on the device-resident set, cut to end on every validation
    boundary, so the scheduler sees the host loop's cadence. Returns
    {global_step after the chunk: its mean loss}."""
    from larvanet_tpu_torch.data.device_pipeline import chunk_seed, pipeline_for, run_chunk

    if dataloader.is_threaded:
        dataloader.stop_queue_runners()
    pipe = pipeline_for(dataloader.dataset, scale, device)
    print("device pipeline: %d images, %.1f MB resident on the device"
          % (len(pipe), pipe.nbytes() / 1e6))
    data_seed = getattr(dataloader.args, "data_seed", None) or 0
    meter = common.ChunkRateMeter()
    losses = {}
    while model.global_step < args.max_steps:
        to_val = val_every - model.global_step % val_every
        n = max(1, min(args.device_pipeline, to_val, args.max_steps - model.global_step))
        t0 = time.time()
        lr = model.get_learning_rate()
        with annotate("chunk"):
            loss = run_chunk(model, pipe, n, args.batch_size, args.input_patch_size, lr,
                             chunk_seed(data_seed, model.global_step))
        model.global_step += n
        loss_val = float(loss)  # waits for the chunk
        dt = time.time() - t0
        inst, avg, trusted = meter.update(model.global_step, n, dt)
        print("step %d, lr %.8f, mean loss %.6f (%.1f steps/s)%s"
              % (model.global_step, lr, loss_val, inst, meter.suffix(avg, trusted)))
        losses[model.global_step] = loss_val
        if model.global_step % val_every == 0 or model.global_step >= args.max_steps:
            validations.append(validate_and_step_scheduler(args, val_loader, model, scale,
                                                           step_per_epoch))
            writer = _writer(args, scale, summary_box)
            writer.scalar("loss", loss_val, model.global_step)
            writer.scalar("lr", model.get_learning_rate(), model.global_step)
    return losses


if __name__ == "__main__":
    main()
