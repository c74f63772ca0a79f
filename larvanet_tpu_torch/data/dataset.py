"""Paired LR/HR image store with patch sampling and augmentation
(larvanet_tpu/data/dataset.py).

File schemes: `div2k`, input `X{s}/{name}x{s}.png` against truth
`{name}.png`; `flat`, `{name}.png` in both directories. The optional cache
holds uint8 HWC images, a quarter of the float32 CHW bytes.

Patches (dataset.py:112-191): a random crop aligned to the scale, rot90 by
k in 1..4, then a horizontal flip with p 0.5. Two streams, each the JAX
package's bit for bit:

  * numpy: a Generator per dataset (`random_patch_pair_u8`, the CHW patch
    lists and `patch_batch_nhwc` off the native path); `reseed_for_step`
    re-keys it to (seed, step), so that a resumed run draws what an
    uninterrupted one would.
  * native (`use_native` and `cached`, JAX's conditions): `patch_batch_nhwc`
    decodes every image into the cache and assembles the batch in C
    (`data/native.NativeBatcher`, seeded seed + scale), the splitmix64
    stream of JAX's `lvt_patch_batch`; `reseed_for_step` seeks it. A set
    whose HR is not exactly LR x scale takes the numpy stream, as JAX's
    does, with one line saying why.

A batcher made after a reseed (the first batch of a run, or of a resumed
one) starts at that step; JAX's starts at 0 and seeks only from the next
reseed, so its resumed native stream repeats its first batch (ROADMAP
queue 3).
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

from larvanet_tpu_torch.data import io, native


class PairDataset:
    """LR/HR pair store with an optional in-RAM uint8 cache."""

    def __init__(self, input_path: str, truth_path: str, scheme: str = "div2k",
                 cached: bool = False, seed: Optional[int] = None, use_native: bool = True):
        if scheme not in ("div2k", "flat"):
            raise ValueError("unknown file scheme %r (div2k or flat)" % (scheme,))
        self.input_path = input_path
        self.truth_path = truth_path
        self.scheme = scheme
        self.cached = cached
        self.seed = seed
        self.use_native = use_native
        self.rng = np.random.default_rng(seed)
        self._native_batchers: Dict[int, native.NativeBatcher] = {}
        self._step = 0  # the step of the last reseed_for_step
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
        """A batch of augmented patches as NHWC float32: the native batcher's
        where it applies (`_native_batcher`), else the numpy path's."""
        nb = self._native_batcher(scale)
        if nb is not None:
            return nb.batch(batch_size, input_patch_size)
        p = input_patch_size
        ins = np.empty((batch_size, p, p, 3), np.float32)
        trs = np.empty((batch_size, p * scale, p * scale, 3), np.float32)
        for i in range(batch_size):
            ins[i], trs[i] = self.random_patch_pair_u8(scale, p)
        return ins, trs

    def reseed_for_step(self, step: int) -> None:
        """Stateless re-key: the numpy stream from SeedSequence((seed, step)),
        the native batchers seeked to step (their next batch draws from
        seed + scale + step + 1), so a run resumed at step N draws what an
        uninterrupted one would. No-op when unseeded."""
        if self.seed is None:
            return
        self.rng = np.random.default_rng((self.seed, step))
        self._step = int(step)
        for nb in self._native_batchers.values():
            nb.seek(step)

    def _native_batcher(self, scale: int) -> Optional[native.NativeBatcher]:
        """The native batcher of `scale`, made once over the whole decoded
        set (dataset.py:167-191), or None where the numpy path applies:
        without `use_native` or `cached`, or (told once) where an HR image
        is not exactly its LR image x scale."""
        if not self.use_native or not self.cached:
            return None
        nb = self._native_batchers.get(scale)
        if nb is not None:
            return nb
        lr = [self.input_u8(scale, i) for i in range(len(self.image_names))]
        hr = [self.truth_u8(i) for i in range(len(self.image_names))]
        try:
            nb = native.NativeBatcher(lr, hr, scale=scale,
                                      seed=None if self.seed is None else self.seed + scale)
        except ValueError as exc:
            print("data: the native batcher does not apply (%s); the numpy stream "
                  "draws the patches" % (exc,))
            self.use_native = False
            return None
        nb.seek(self._step)
        self._native_batchers[scale] = nb
        return nb
