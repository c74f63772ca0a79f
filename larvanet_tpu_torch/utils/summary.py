"""Training observability: `scalars.jsonl` always, TensorBoard when
`torch.utils.tensorboard` imports (larvanet_tpu/utils/summary.py).

The reference logs scalars (loss, lr) and input/output/truth image
triplets to per-scale directories `<train_path>/x<scale>/` (reference
train.py:68-72, models/edsr.py:98-106). This writer keeps that layout and
appends every scalar to `scalars.jsonl` in the same directory; without
TensorBoard the images go to `<log_dir>/images/<tag>/<step>.png`.
"""

from __future__ import annotations

import json
import os
import time

import numpy as np


class SummaryWriter:
    def __init__(self, log_dir: str):
        self.log_dir = log_dir
        os.makedirs(log_dir, exist_ok=True)
        self._jsonl = open(os.path.join(log_dir, "scalars.jsonl"), "a")
        self._tb = None
        self._warned_png = False
        try:
            from torch.utils.tensorboard import SummaryWriter as TBWriter
        except ImportError:
            return
        self._tb = TBWriter(log_dir=log_dir)

    def scalar(self, tag: str, value: float, step: int) -> None:
        self._jsonl.write(json.dumps({"tag": tag, "value": float(value), "step": int(step),
                                      "time": time.time()}) + "\n")
        self._jsonl.flush()
        if self._tb is not None:
            self._tb.add_scalar(tag, value, step)

    def image(self, tag: str, image_chw: np.ndarray, step: int) -> None:
        """A CHW uint8 or float [0, 255] image (the reference's add_image)."""
        img = np.clip(np.round(np.asarray(image_chw)), 0, 255).astype(np.uint8)
        if self._tb is not None:
            self._tb.add_image(tag, img, step)
            return
        if not self._warned_png:
            self._warned_png = True
            print("summary: tensorboard unavailable; writing image summaries as PNGs "
                  "under %s" % (os.path.join(self.log_dir, "images"),))
        from larvanet_tpu_torch.data import io

        io.save_image_chw(img, os.path.join(self.log_dir, "images", tag.replace("/", "_"),
                                            "%08d.png" % (int(step),)))

    def close(self) -> None:
        self._jsonl.close()
        if self._tb is not None:
            self._tb.close()
