"""Volume-driven multi-exit training CLI (larvanet_tpu/cli/train_larva.py;
reference train_larva.py):

    python -m larvanet_tpu_torch.cli.train_larva --train_path runs/larva \\
        [--dataloader combined_loader] [--data_input_path LR --data_truth_path HR] \\
        [--val_data_input_path VLR --val_data_truth_path VHR] \\
        [--model LarvaNet --num_modules 2 --num_blocks 16,16] [--val_volume 30e9] \\
        [--batch_size 16 --input_patch_size 48] [--max_steps N] \\
        [--restore_path latest] [--ema_decay 0.999] [--grad_accum 2] \\
        [--device_pipeline 100] [--async_checkpoint 1] [--profile_dir trace] \\
        [--widen_from narrow.ckpt] [--remat 1] [--device cpu]

A train loader (default combined_loader, threaded) and a val loader
(default div2k_val_loader, on --val_data_input_path / --val_data_truth_path),
then the host loop of train_larva.py:141-175: a batch from the queue
runners, or on an unthreaded loader `reseed_for_step` (with --data_seed, a
resumed run draws the batches an uninterrupted one would) and
`get_patch_batch_nhwc`; then the model's `train_step_larva`, which adds
volume_per_step = patch^2 * batch * 3 bytes a step and every --val_volume
bytes validates, steps the plateau schedule, saves
`model_step<N>_vol<G>G.pth` with its state file, and writes the loss and
lr to `<train_path>/x<scale>/scalars.jsonl` when the step is also a
--summary_freq step (the writer is made when the first summary is due).
--max_steps 0 runs until interrupted; the queue runners are stopped
whatever ends the loop. It runs on the card unless --device cpu is given,
every 3x3 conv of the forward and the backward on the hand-written
kernels there, and never falls back to the CPU. `main` returns (the
model in its final state, {global_step: loss}).

--device_pipeline N (`_train_larva_device`, train_larva.py:180-250): the
uint8 set resident on the device (data/device_pipeline.py), chunks of up to
N steps, each stopping at the next --val_volume boundary, the chunk's draws
seeded from (--data_seed, global_step); validation before the first chunk
and at each boundary, then the checkpoint and the summary; one line a chunk
with ChunkRateMeter's steps/s. --async_checkpoint 1, --profile_dir,
--widen_from and a JAX `.ckpt` resume as in cli/train.py; the model's
--remat 1 recomputes each body and leg conv pair in the backward. --qat 1
trains every body and leg conv pair through the fake-quant pair
(ops/pairs.qat_pair). --dp_devices and --orbax_checkpoint as in
cli/train.py. The model's --lr_domain_loss
(default 1) takes every exit's loss before the shuffle, as JAX's default
graph does. Accepted and ignored: --fused_opt (numerically identical per
element).
"""

from __future__ import annotations

import argparse
import math
import os
import time

from larvanet_tpu_torch.cli import common
from larvanet_tpu_torch.core.config import dump_arguments_json
from larvanet_tpu_torch.utils.checkpoints import resolve_restore_path
from larvanet_tpu_torch.utils.profiling import annotate, trace
from larvanet_tpu_torch.utils.summary import SummaryWriter


def round_to_1(x):
    """x to one significant figure (the reference's log line)."""
    if x <= 0:
        return x
    return round(x, -int(math.floor(math.log10(abs(x)))))


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    common.add_common_flags(parser, default_loader="combined_loader",
                            default_model="LarvaNet")
    parser.add_argument("--val_dataloader", type=str, default="div2k_val_loader",
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
    parser.add_argument("--train_path", type=str, required=True,
                        help="Base path of the trained model to be saved.")
    parser.add_argument("--grad_accum", type=int, default=1,
                        help="Accumulate gradients over N equal microbatches; "
                             "batch_size must be divisible by N.")
    parser.add_argument("--max_steps", type=int, default=0,
                        help="Stop after this many steps (0 = run until interrupted).")
    parser.add_argument("--log_freq", type=int, default=10,
                        help="The frequency of logging.")
    parser.add_argument("--summary_freq", type=int, default=1000,
                        help="The frequency of writing summaries.")
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


def main(argv=None, step: str = "train_step_larva"):
    """Train through the model's method `step` (train_squid's is
    train_step_squid); returns (the model in its final state,
    {global_step: loss})."""
    args, remaining = build_parser().parse_known_args(argv)
    if args.fused_opt is not None:
        print("train_larva: --fused_opt is numerically identical per element; ignored")
    device = common.resolve_device(args)
    scale_list = common.scales_of(args)
    os.makedirs(args.train_path, exist_ok=True)

    dataloader, loader_args, remaining = common.setup_loader(args.dataloader, remaining,
                                                             scale_list)
    print("prepare validation data loader - %s" % (args.val_dataloader,))
    val_loader, _, _ = common.setup_loader(
        args.val_dataloader, ["--data_input_path", args.val_data_input_path,
                              "--data_truth_path", args.val_data_truth_path], scale_list)
    model, model_args, remaining = common.setup_model(
        args.model, remaining, scale_list, device, is_training=True,
        global_step=args.global_step, ema_decay=args.ema_decay)
    if not hasattr(model, step):
        raise SystemExit("train_larva trains the LarvaNet family; --model %s trains with "
                         "larvanet_tpu_torch.cli.train" % (args.model,))
    model.grad_accum = args.grad_accum
    model.async_checkpoints = bool(args.async_checkpoint)
    model.orbax_checkpoints = bool(args.orbax_checkpoint)
    common.warn_leftovers(remaining)
    model.volume_per_step = args.input_patch_size ** 2 * args.batch_size * 3
    common.maybe_widen_from(model, args)

    restore_path = resolve_restore_path(args.restore_path, args.train_path)
    if restore_path is not None:
        model.restore(restore_path)
        print("restored the model")
    common.maybe_dp_train(model, args)

    dump_arguments_json(os.path.join(args.train_path, "arguments.json"), args, loader_args,
                        model_args)

    scale = scale_list[0]
    threaded = dataloader.is_threaded
    summary = None  # made when the first summary is due
    losses = {}
    local_step = 0
    print("begin training")
    if args.device_pipeline > 0:
        summary_box = []  # the writer, made when the first summary is due
        try:
            with trace(args.profile_dir):
                losses = _train_larva_device(args, dataloader, val_loader, model, scale,
                                             device, summary_box)
        finally:
            for w in summary_box:
                w.close()
        model.wait_for_checkpoints()
        print("finished")
        return model, losses
    if threaded:
        dataloader.start_training_queue_runner(batch_size=args.batch_size,
                                               input_patch_size=args.input_patch_size)
    try:
      with trace(args.profile_dir):
        while True:
            local_step += 1
            t0 = time.perf_counter()
            if threaded:
                inputs, truths = dataloader.get_queue_data(scale)
            else:
                dataloader.reseed_for_step(model.global_step)  # the resumable stream
                inputs, truths = dataloader.get_patch_batch_nhwc(args.batch_size, scale,
                                                                 args.input_patch_size)
            t1 = time.perf_counter()
            step_summary = None
            if local_step % args.summary_freq == 0:
                if summary is None:
                    summary = SummaryWriter(os.path.join(args.train_path, "x%d" % scale))
                step_summary = summary
            with annotate("train_step"):
                loss = getattr(model, step)(args, val_loader, inputs, truths,
                                            step_summary)
            losses[model.global_step] = loss
            t2 = time.perf_counter()
            if local_step % args.log_freq == 0:
                print("step %d, loss %.6f, lr %.8f (data %ss, train %ss)"
                      % (model.global_step, loss, model.get_learning_rate(),
                         round_to_1(t1 - t0), round_to_1(t2 - t1)))
            if args.max_steps and model.global_step >= args.max_steps:
                break
    except KeyboardInterrupt:
        print("interrupted")
    finally:
        if threaded:
            dataloader.stop_queue_runners()
        if summary is not None:
            summary.close()
    model.wait_for_checkpoints()
    print("finished")
    return model, losses


def _train_larva_device(args, dataloader, val_loader, model, scale, device,
                        summary_box) -> dict:
    """--device_pipeline N (train_larva.py:180-250): validation before the
    first chunk of a fresh run, then chunks of min(N, steps to the next
    --val_volume) steps on the device-resident set, each seeded from
    (--data_seed, its first step); at each volume boundary the volume is
    banked, then validation, the checkpoint, and the loss and lr summary
    where the chunk passed a --summary_freq step. Returns {global_step
    after the chunk: its mean loss}."""
    from larvanet_tpu_torch.data.device_pipeline import chunk_seed, pipeline_for, run_chunk

    pipe = pipeline_for(dataloader.dataset, scale, device)
    print("device pipeline: %d images, %.1f MB resident on the device"
          % (len(pipe), pipe.nbytes() / 1e6))
    data_seed = getattr(dataloader.args, "data_seed", None) or 0
    if model.global_step == 0 and val_loader is not None:
        model.validate_for_train(args, val_loader)
    meter = common.ChunkRateMeter()
    losses = {}
    while True:
        steps_to_val = max(1, math.ceil((model.args.val_volume - model.temp_volume)
                                        / model.volume_per_step))
        n = min(args.device_pipeline, steps_to_val)
        t0 = time.time()
        lr = model.get_learning_rate()
        with annotate("chunk"):
            loss = run_chunk(model, pipe, n, args.batch_size, args.input_patch_size, lr,
                             chunk_seed(data_seed, model.global_step))
        model.global_step += n
        model.temp_volume += n * model.volume_per_step
        loss_val = float(loss)
        dt = time.time() - t0
        inst, avg, trusted = meter.update(model.global_step, n, dt)
        print("step %d, mean loss %.6f, lr %.8f (%.1f steps/s)%s"
              % (model.global_step, loss_val, model.get_learning_rate(), inst,
                 meter.suffix(avg, trusted)))
        losses[model.global_step] = loss_val
        if model.temp_volume >= model.args.val_volume:
            model.total_volume += model.temp_volume
            model.temp_volume = 0
            if val_loader is not None:
                model.validate_for_train(args, val_loader)
            model.save(base_path=args.train_path)
            print("saved a model checkpoint at volume %.0fG" % (model.total_volume / 1e9,))
            if model.global_step % args.summary_freq < n:
                if not summary_box:
                    summary_box.append(SummaryWriter(
                        os.path.join(args.train_path, "x%d" % scale)))
                summary_box[0].scalar("loss", loss_val, model.global_step)
                summary_box[0].scalar("lr", model.get_learning_rate(), model.global_step)
        if args.max_steps and model.global_step >= args.max_steps:
            break
    return losses


if __name__ == "__main__":
    main()
