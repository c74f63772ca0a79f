"""Checkpoint discovery for `--restore_path latest`
(larvanet_tpu/utils/checkpoints.py:28-38, 132-143), over the port's
`model_<step>.pth` files, and the writer thread of `--async_checkpoint`
(`AsyncCheckpointWriter`, checkpoints.py:41-128)."""

from __future__ import annotations

import glob
import os
import queue
import re
import threading
from typing import Callable, List, Optional, Tuple

import torch


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


def _snapshot(obj):
    """`obj` with every tensor replaced by a fresh copy on its device (the
    training step updates the originals in place); the copies to the host
    are the writer's."""
    if isinstance(obj, torch.Tensor):
        return obj.detach().clone()
    if isinstance(obj, dict):
        return {k: _snapshot(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_snapshot(v) for v in obj)
    return obj


def to_host(obj):
    """`obj` with every tensor copied to the host."""
    if isinstance(obj, torch.Tensor):
        return obj.cpu()
    if isinstance(obj, dict):
        return {k: to_host(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(to_host(v) for v in obj)
    return obj


class AsyncCheckpointWriter:
    """Checkpoint writes on a worker thread (`--async_checkpoint`).

    submit(files, save): snapshot each (object, path) of `files` to fresh
    tensors on their devices, on the caller's stream (so the copies are
    ordered after the step that made the values and before any later
    one), and return; the worker waits for the snapshot, copies it to the
    host and writes each file with `save(obj, path)` (the model's atomic
    tmp + rename). At most `max_pending` snapshots are in flight; a
    further submit blocks, which bounds the memory they hold.

    wait(): block until every submitted file is on disk; an error of the
    worker is raised here (and by the next submit).
    """

    def __init__(self, max_pending: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=max_pending)
        self._error: Optional[BaseException] = None
        self._worker = threading.Thread(target=self._run, daemon=True, name="ckpt-writer")
        self._worker.start()

    def _run(self):
        while True:
            item = self._q.get()
            if item is None:
                self._q.task_done()
                return
            files, save, event = item
            try:
                if event is not None:
                    event.synchronize()
                for obj, path in files:
                    save(to_host(obj), path)
            except BaseException as e:  # raised by wait() / submit()
                self._error = e
            finally:
                self._q.task_done()

    def _check_error(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def submit(self, files: List[Tuple[object, str]],
               save: Callable[[object, str], None]) -> None:
        self._check_error()
        snap = [(_snapshot(obj), path) for obj, path in files]
        event = None
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            event = torch.cuda.Event()
            event.record()
        for _, path in snap:
            os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        self._q.put((snap, save, event))

    def wait(self) -> None:
        self._q.join()
        self._check_error()

    def close(self) -> None:
        self.wait()
        self._q.put(None)
        self._worker.join()
