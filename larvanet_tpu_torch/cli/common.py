"""Shared CLI plumbing (larvanet_tpu/cli/common.py, the parts serving uses).

Entry points run on the card. `--device cpu` runs them on the CPU (the
tests do); without it and without CUDA they exit non-zero instead of
quietly running on the CPU.
"""

from __future__ import annotations

import argparse
from typing import List, Sequence

import torch

from larvanet_tpu_torch.core import registry
from larvanet_tpu_torch.core.config import parse_scale_list


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


def setup_model(name: str, remaining: Sequence[str], scales: List[int],
                device: torch.device, seed: int = 0):
    print("prepare model - %s" % (name,))
    model = registry.get_model(name)
    model_args, remaining = model.parse_args(list(remaining))
    model.prepare(scales=scales, device=device, seed=seed)
    return model, model_args, remaining


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


def warn_leftovers(remaining: Sequence[str]) -> None:
    if remaining:
        print("WARNING: found unhandled arguments: %s" % (list(remaining),))


def scales_of(args) -> List[int]:
    return parse_scale_list(args.scales)
