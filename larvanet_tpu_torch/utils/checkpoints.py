"""Checkpoint discovery for `--restore_path latest`
(larvanet_tpu/utils/checkpoints.py:28-38, 132-143), over the port's
`model_<step>.pth` files."""

from __future__ import annotations

import glob
import os
import re
from typing import Optional


def find_latest(train_path: str) -> Optional[str]:
    """The newest `model_*.pth` in train_path by (step number, mtime)."""
    candidates = glob.glob(os.path.join(train_path, "model_*.pth"))
    if not candidates:
        return None

    def key(path):
        m = re.search(r"(\d+)", os.path.basename(path))
        return (int(m.group(1)) if m else -1, os.path.getmtime(path))

    return max(candidates, key=key)


def resolve_restore_path(restore_path: Optional[str],
                         train_path: Optional[str]) -> Optional[str]:
    """'latest' -> the newest checkpoint in train_path (None, with a notice,
    when there is none); any other value passes through."""
    if restore_path == "latest":
        if not train_path:
            raise ValueError("--restore_path latest requires --train_path")
        latest = find_latest(train_path)
        if latest is None:
            print("no checkpoint found in %s; starting fresh" % (train_path,))
            return None
        print("auto-resume from %s" % (latest,))
        return latest
    return restore_path
