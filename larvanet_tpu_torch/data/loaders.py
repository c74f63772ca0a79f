"""Data loader plugins (larvanet_tpu/data/loaders.py:40-160, 250-285).

The reference's BaseLoader contract (reference dataloaders/base.py):
parse_args, prepare(scales), get_num_images, get_image_pair, and the
patch methods that training uses (get_patch_batch, reseed_for_step).
Registered here:

  div2k_train_loader  DIV2K file scheme, patches for training
  div2k_val_loader    DIV2K file scheme, cache always on
  basic_loader        flat file scheme (`{name}.png` in both directories)

The threaded queue loaders (div2k_train_loader_queue, combined_loader)
and div2k_train_loader_tensor are not ported yet (ROADMAP.md); the queue
methods raise here. `--data_seed` seeds patch sampling (the JAX package's
numpy stream, bit for bit); `--data_native` is accepted and ignored (the
JAX package's native decoder and batcher, which the port does not have).
"""

from __future__ import annotations

import argparse
from typing import Optional

import numpy as np

from larvanet_tpu_torch.core.config import parse_known
from larvanet_tpu_torch.core.registry import register_loader
from larvanet_tpu_torch.data.dataset import PairDataset

_QUEUES = ("the threaded queue loaders are not ported to larvanet_tpu_torch yet "
           "(see ROADMAP.md); train with div2k_train_loader")


class BaseLoader:
    """Reference BaseLoader contract (dataloaders/base.py)."""

    is_threaded = False

    def parse_args(self, args):
        raise NotImplementedError

    def prepare(self, scales):
        raise NotImplementedError

    def get_num_images(self):
        raise NotImplementedError

    def get_image_pair(self, image_index, scale):
        raise NotImplementedError

    def get_patch_batch(self, batch_size, scale, input_patch_size):
        raise NotImplementedError

    def get_random_image_patch_pair(self, scale, input_patch_size):
        raise NotImplementedError

    def get_image_patch_pair(self, image_index, scale, input_patch_size):
        raise NotImplementedError

    def reseed_for_step(self, step: int) -> None:
        """Re-key the sampling RNG to (data_seed, step), so a resumed run
        draws the batch stream an uninterrupted run would."""

    def start_training_queue_runner(self, batch_size, input_patch_size):
        raise NotImplementedError(_QUEUES)

    def stop_queue_runners(self):
        raise NotImplementedError(_QUEUES)

    def get_queue_data(self, scale):
        raise NotImplementedError(_QUEUES)


def _chw(img_hwc_u8: np.ndarray) -> np.ndarray:
    return img_hwc_u8.transpose(2, 0, 1).astype(np.float32)


class PairLoader(BaseLoader):
    """Shared implementation over PairDataset."""

    default_input_path = "data/DIV2K_train_LR_bicubic"
    default_truth_path = "data/DIV2K_train_HR"
    scheme = "div2k"
    always_cached = False

    def __init__(self):
        self.args = None
        self.dataset: Optional[PairDataset] = None

    def parse_args(self, args):
        parser = argparse.ArgumentParser()
        parser.add_argument("--data_input_path", type=str, default=self.default_input_path,
                            help="Base path of the input images.")
        parser.add_argument("--data_truth_path", type=str, default=self.default_truth_path,
                            help="Base path of the ground-truth images.")
        parser.add_argument("--data_cached", action="store_true",
                            help="If true, cache the data on the memory.")
        parser.add_argument("--data_seed", type=int, default=None,
                            help="Seed for the patch-sampling RNG (training).")
        parser.add_argument("--data_native", type=int, default=1,
                            help="The JAX package's native decoder switch; "
                                 "accepted and ignored (the port decodes PNG "
                                 "in numpy and zlib).")
        self.args, remaining = parse_known(parser, args)
        return self.args, remaining

    def prepare(self, scales):
        self.dataset = PairDataset(
            input_path=self.args.data_input_path,
            truth_path=self.args.data_truth_path,
            scheme=self.scheme,
            cached=self.args.data_cached or self.always_cached,
            seed=self.args.data_seed,
        )
        self.dataset.prepare(scales)

    def get_num_images(self):
        return len(self.dataset)

    def get_patch_batch(self, batch_size, scale, input_patch_size):
        """Two lists of `batch_size` CHW float32 patches (input, truth)."""
        input_list, truth_list = [], []
        for _ in range(batch_size):
            ip, tp = self.get_random_image_patch_pair(scale, input_patch_size)
            input_list.append(ip)
            truth_list.append(tp)
        return input_list, truth_list

    def reseed_for_step(self, step: int) -> None:
        if self.args.data_seed is None or self.dataset is None:
            return  # unseeded = entropy
        self.dataset.reseed_for_step(step)

    def get_random_image_patch_pair(self, scale, input_patch_size):
        ip, tp = self.dataset.random_patch_pair_u8(scale, input_patch_size)
        return _chw(ip), _chw(tp)

    def get_image_patch_pair(self, image_index, scale, input_patch_size):
        ip, tp = self.dataset.random_patch_pair_u8(scale, input_patch_size,
                                                   index=image_index)
        return _chw(ip), _chw(tp)

    def get_image_pair(self, image_index, scale):
        return self.dataset.image_pair_chw(image_index, scale)


@register_loader("div2k_train_loader")
class DIV2KTrainLoader(PairLoader):
    """Training loader (reference div2k_train_loader.py)."""


@register_loader("div2k_val_loader")
class DIV2KValLoader(PairLoader):
    """Validation loader; caching always on (reference div2k_val_loader.py)."""

    default_input_path = "data/DIV2K_valid_LR_bicubic"
    default_truth_path = "data/DIV2K_valid_HR"
    always_cached = True


@register_loader("basic_loader")
class BasicLoader(PairLoader):
    """Flat-directory loader (reference basic_loader.py:109-142)."""

    scheme = "flat"
    default_input_path = "data/LR"
    default_truth_path = "data/HR"
