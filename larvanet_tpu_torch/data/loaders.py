"""Data loader plugins (larvanet_tpu/data/loaders.py:40-160, 250-285).

The reference's BaseLoader contract (reference dataloaders/base.py):
parse_args, prepare(scales), get_num_images, get_image_pair, and the
patch methods that training uses (get_patch_batch, reseed_for_step).
Registered here:

  div2k_train_loader         DIV2K file scheme, patches for training
  div2k_val_loader           DIV2K file scheme, cache always on
  div2k_train_loader_queue   the train loader behind a pool of runner threads
  combined_loader            the same, with the reference's combined sets
  div2k_train_loader_tensor  the train loader with every image decoded by
                             prepare(), its path flags under the reference's
                             tensor-loader names too
  basic_loader               flat file scheme (`{name}.png` in both directories)

`--data_seed` seeds patch sampling; `--data_native` (default 1) takes the
native batch stream where JAX's takes it (data/dataset.py: a cached set's
NHWC batches, `data/native.NativeBatcher`), 0 the numpy stream. Both are
the JAX package's streams bit for bit under the same flags. PNGs decode
through `data/native.decode_png` either way.

The runner threads build their datasets as JAX's do (loaders.py:186-205):
seeded data_seed + worker_id and with the native stream on whenever the
loader caches, whatever `--data_native` says (JAX's runner datasets keep
the constructor's default).
"""

from __future__ import annotations

import argparse
import queue
import threading
from typing import Dict, List, Optional

import numpy as np

from larvanet_tpu_torch.core.config import parse_known
from larvanet_tpu_torch.core.registry import register_loader
from larvanet_tpu_torch.data.dataset import PairDataset

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
        raise NotImplementedError

    def stop_queue_runners(self):
        raise NotImplementedError

    def get_queue_data(self, scale):
        raise NotImplementedError


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
                            help="Assemble a cached set's NHWC patch batches in the "
                                 "port's host C (the JAX package's native stream); "
                                 "0 draws them from numpy.")
        self._add_extra_args(parser)
        self.args, remaining = parse_known(parser, args)
        return self.args, remaining

    def _add_extra_args(self, parser):
        pass

    def prepare(self, scales):
        self.dataset = PairDataset(
            input_path=self.args.data_input_path,
            truth_path=self.args.data_truth_path,
            scheme=self.scheme,
            cached=self.args.data_cached or self.always_cached,
            seed=self.args.data_seed,
            use_native=bool(self.args.data_native),
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

    def get_patch_batch_nhwc(self, batch_size, scale, input_patch_size):
        """An NHWC float32 batch (input, truth): the native stream where it
        applies (`PairDataset.patch_batch_nhwc`), else get_patch_batch's
        draws."""
        return self.dataset.patch_batch_nhwc(batch_size, scale, input_patch_size)

    def reseed_for_step(self, step: int) -> None:
        if self.is_threaded or self.args.data_seed is None or self.dataset is None:
            return  # the runners own their streams; unseeded = entropy
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


class _QueueRunnerMixin:
    """The supervised pool of runner threads (loaders.py:161-277)."""

    is_threaded = True
    queue_capacity = 16  # reference div2k_train_loader_queue.py:52
    default_num_runners = 8

    def __init__(self):
        super().__init__()
        self._queues: Dict[int, queue.Queue] = {}
        self._threads: List[threading.Thread] = []
        self._stop_event = threading.Event()

    def _add_extra_args(self, parser):
        parser.add_argument("--data_num_queue_runners", type=int,
                            default=self.default_num_runners,
                            help="The number of threads for each queue runner.")

    def start_training_queue_runner(self, batch_size, input_patch_size):
        self._queues = {}
        self._stop_event = threading.Event()
        self._threads = []
        for scale in self.dataset.scale_list:
            self._queues[scale] = queue.Queue(maxsize=self.queue_capacity)
            for i in range(self.args.data_num_queue_runners):
                t = threading.Thread(target=self._runner,
                                     args=(scale, batch_size, input_patch_size, i),
                                     daemon=True, name="queue-runner-x%d-%d" % (scale, i))
                t.start()
                self._threads.append(t)

    def _runner(self, scale, batch_size, input_patch_size, worker_id):
        seed = self.args.data_seed
        # use_native at its default, as JAX's runner builds it: the native
        # stream wherever the loader caches, whatever --data_native says
        local = PairDataset(input_path=self.dataset.input_path,
                            truth_path=self.dataset.truth_path, scheme=self.dataset.scheme,
                            seed=None if seed is None else seed + worker_id)
        # the loader's image list and its cache, under its lock
        local.image_names = self.dataset.image_names
        local.scale_list = self.dataset.scale_list
        local.cached = self.dataset.cached
        local._input_cache = self.dataset._input_cache
        local._truth_cache = self.dataset._truth_cache
        local._cache_lock = self.dataset._cache_lock
        q = self._queues[scale]
        while not self._stop_event.is_set():
            try:
                batch = local.patch_batch_nhwc(batch_size, scale, input_patch_size)
            except Exception as exc:  # handed to the consumer, not swallowed
                try:
                    q.put(("error", exc), timeout=1.0)
                except queue.Full:
                    pass
                return
            while not self._stop_event.is_set():
                try:
                    q.put(("batch", batch), timeout=0.25)
                    break
                except queue.Full:
                    continue

    def stop_queue_runners(self):
        """Stop and join every runner; safe to call again."""
        if not self._threads:
            return
        self._stop_event.set()
        # drain, so that runners blocked on put() see the event
        for q in self._queues.values():
            try:
                while True:
                    q.get_nowait()
            except queue.Empty:
                pass
        for t in self._threads:
            t.join(timeout=5.0)
        self._threads = []

    def get_queue_data(self, scale):
        """The next batch (inputs, truths) as NHWC float32; blocks until a
        runner has one, and raises a runner's error."""
        kind, payload = self._queues[scale].get()
        if kind == "error":
            raise payload
        return payload


@register_loader("div2k_train_loader")
class DIV2KTrainLoader(PairLoader):
    """Training loader (reference div2k_train_loader.py)."""


@register_loader("div2k_val_loader")
class DIV2KValLoader(PairLoader):
    """Validation loader; caching always on (reference div2k_val_loader.py)."""

    default_input_path = "data/DIV2K_valid_LR_bicubic"
    default_truth_path = "data/DIV2K_valid_HR"
    always_cached = True


@register_loader("div2k_train_loader_queue")
class DIV2KTrainLoaderQueue(_QueueRunnerMixin, PairLoader):
    """div2k_train_loader fed by runner threads (reference
    div2k_train_loader_queue.py)."""


@register_loader("combined_loader")
class CombinedLoader(_QueueRunnerMixin, PairLoader):
    """The merged DIV2K + Flickr2K set, 6 runners (reference
    combined_loader.py:31-36)."""

    default_input_path = "data/Combined_LR"
    default_truth_path = "data/Combined_HR"
    default_num_runners = 6


@register_loader("div2k_train_loader_tensor")
class DIV2KTrainLoaderTensor(PairLoader):
    """The eager whole-set loader (larvanet_tpu/data/loaders.py:287-321,
    reference div2k_train_loader_tensor.py:42-68): prepare() decodes every
    image into the uint8 cache, get_patch_batch returns NHWC float32 arrays,
    and --train_input_path / --train_truth_path (the reference's names for
    this loader) stand for --data_input_path / --data_truth_path."""

    always_cached = True

    def parse_args(self, args):
        ns, remaining = super().parse_args(args)
        alias = argparse.ArgumentParser()
        alias.add_argument("--train_input_path", type=str, default=None)
        alias.add_argument("--train_truth_path", type=str, default=None)
        extra, remaining = parse_known(alias, remaining)
        if extra.train_input_path:
            ns.data_input_path = extra.train_input_path
        if extra.train_truth_path:
            ns.data_truth_path = extra.train_truth_path
        return ns, remaining

    def prepare(self, scales):
        super().prepare(scales)
        for s in self.dataset.scale_list:
            for i in range(len(self.dataset)):
                self.dataset.input_u8(s, i)
                self.dataset.truth_u8(i)

    def get_patch_batch(self, batch_size, scale, input_patch_size):
        return self.dataset.patch_batch_nhwc(batch_size, scale, input_patch_size)


@register_loader("basic_loader")
class BasicLoader(PairLoader):
    """Flat-directory loader (reference basic_loader.py:109-142)."""

    scheme = "flat"
    default_input_path = "data/LR"
    default_truth_path = "data/HR"
