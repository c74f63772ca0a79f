"""Paired LR/HR image store with patch sampling and augmentation
(larvanet_tpu/data/dataset.py).

File schemes: `div2k`, input `X{s}/{name}x{s}.png` against truth
`{name}.png`; `flat`, `{name}.png` in both directories. The optional cache
holds uint8 HWC images, a quarter of the float32 CHW bytes.

Patches (dataset.py:112-165): a random crop aligned to the scale, rot90 by
k in 1..4, then a horizontal flip with p 0.5, from a numpy Generator per
dataset; `reseed_for_step` re-keys it to (seed, step), so that a resumed
run draws what an uninterrupted one would. The draws are the JAX
package's numpy path, bit for bit; its native C++ batcher (`--data_native
1` on its `patch_batch_nhwc` path) draws another stream and is not ported.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from larvanet_tpu_torch.data import io


class PairDataset:
    """LR/HR pair store with an optional in-RAM uint8 cache."""

    def __init__(self, input_path: str, truth_path: str, scheme: str = "div2k",
                 cached: bool = False, seed: Optional[int] = None):
        if scheme not in ("div2k", "flat"):
            raise ValueError("unknown file scheme %r (div2k or flat)" % (scheme,))
        self.input_path = input_path
        self.truth_path = truth_path
        self.scheme = scheme
        self.cached = cached
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.image_names: List[str] = []
        self.scale_list: List[int] = []
        self._input_cache: Dict[int, Dict[str, np.ndarray]] = {}
        self._truth_cache: Dict[str, np.ndarray] = {}
        self._cache_lock = threading.Lock()

    def prepare(self, scales: Sequence[int]) -> None:
        self.scale_list = list(scales)
        self.image_names = io.list_pngs(self.truth_path)
        for s in self.scale_list:
            self._input_cache[s] = {}
        print("data: %d images are prepared (%s)"
              % (len(self.image_names),
                 "caching enabled" if self.cached else "caching disabled"))

    def __len__(self) -> int:
        return len(self.image_names)

    def _input_file(self, scale: int, name: str) -> str:
        if self.scheme == "div2k":
            return os.path.join(self.input_path, "X%d" % scale, "%sx%d.png" % (name, scale))
        return os.path.join(self.input_path, "%s.png" % name)

    def _truth_file(self, name: str) -> str:
        return os.path.join(self.truth_path, "%s.png" % name)

    def _load(self, cache: Dict[str, np.ndarray], name: str, path: str) -> np.ndarray:
        if self.cached:
            with self._cache_lock:
                img = cache.get(name)
            if img is not None:
                return img
        img = io.load_image_u8(path)
        if self.cached:
            with self._cache_lock:
                cache[name] = img
        return img

    def input_u8(self, scale: int, index: int) -> np.ndarray:
        name = self.image_names[index]
        return self._load(self._input_cache[scale], name, self._input_file(scale, name))

    def truth_u8(self, index: int) -> np.ndarray:
        name = self.image_names[index]
        return self._load(self._truth_cache, name, self._truth_file(name))

    def image_pair_chw(self, index: int, scale: int) -> Tuple[np.ndarray, np.ndarray, str]:
        """Full-image pair as CHW float32 (the reference's get_image_pair)."""
        inp = self.input_u8(scale, index).transpose(2, 0, 1).astype(np.float32)
        tru = self.truth_u8(index).transpose(2, 0, 1).astype(np.float32)
        return inp, tru, self.image_names[index]

    # -- patch sampling --------------------------------------------------------

    def random_patch_pair_u8(self, scale: int, input_patch_size: int,
                             index: Optional[int] = None) -> Tuple[np.ndarray, np.ndarray]:
        """One augmented HWC uint8 patch pair (reference :61-98 semantics)."""
        if index is None:
            index = int(self.rng.integers(len(self.image_names)))
        inp = self.input_u8(scale, index)
        tru = self.truth_u8(index)
        h, w = inp.shape[:2]
        p = input_patch_size
        x = int(self.rng.integers(w - p))
        y = int(self.rng.integers(h - p))
        ip = inp[y:y + p, x:x + p]
        tp = tru[y * scale:(y + p) * scale, x * scale:(x + p) * scale]
        k = int(self.rng.integers(4)) + 1
        ip = np.rot90(ip, k=k, axes=(0, 1))
        tp = np.rot90(tp, k=k, axes=(0, 1))
        if self.rng.uniform() < 0.5:
            ip = ip[:, ::-1]
            tp = tp[:, ::-1]
        return np.ascontiguousarray(ip), np.ascontiguousarray(tp)

    def patch_batch_nhwc(self, batch_size: int, scale: int,
                         input_patch_size: int) -> Tuple[np.ndarray, np.ndarray]:
        """A batch of augmented patches as NHWC float32 (the numpy path)."""
        p = input_patch_size
        ins = np.empty((batch_size, p, p, 3), np.float32)
        trs = np.empty((batch_size, p * scale, p * scale, 3), np.float32)
        for i in range(batch_size):
            ins[i], trs[i] = self.random_patch_pair_u8(scale, p)
        return ins, trs

    def reseed_for_step(self, step: int) -> None:
        """Stateless re-key: the numpy stream from SeedSequence((seed, step)),
        so a run resumed at step N draws what an uninterrupted one would.
        No-op when unseeded."""
        if self.seed is None:
            return
        self.rng = np.random.default_rng((self.seed, step))
