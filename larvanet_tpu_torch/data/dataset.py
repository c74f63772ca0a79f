"""Paired LR/HR image store (larvanet_tpu/data/dataset.py:30-110, the
full-image part).

File schemes: `div2k`, input `X{s}/{name}x{s}.png` against truth
`{name}.png`; `flat`, `{name}.png` in both directories. The optional cache
holds uint8 HWC images, a quarter of the float32 CHW bytes. Patch sampling
and augmentation come with training.
"""

from __future__ import annotations

import os
import threading
from typing import Dict, List, Sequence, Tuple

import numpy as np

from larvanet_tpu_torch.data import io


class PairDataset:
    """LR/HR pair store with an optional in-RAM uint8 cache."""

    def __init__(self, input_path: str, truth_path: str, scheme: str = "div2k",
                 cached: bool = False):
        if scheme not in ("div2k", "flat"):
            raise ValueError("unknown file scheme %r (div2k or flat)" % (scheme,))
        self.input_path = input_path
        self.truth_path = truth_path
        self.scheme = scheme
        self.cached = cached
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
