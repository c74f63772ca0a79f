"""Checkpoint discovery for `--restore_path latest`
(larvanet_tpu/utils/checkpoints.py:28-38, 132-143), over the port's
`model_<step>.pth` files and directories, the writer thread of
`--async_checkpoint` (`AsyncCheckpointWriter`, checkpoints.py:41-128), and
the directory checkpoints of `--orbax_checkpoint` (below)."""

from __future__ import annotations

import glob
import os
import queue
import re
import threading
from typing import Callable, List, Optional, Tuple

import torch


def find_latest(train_path: str) -> Optional[str]:
    """The newest `model_*.pth` in train_path (a file, or an
    --orbax_checkpoint directory) by (step number, mtime)."""
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


# ---- directory checkpoints (--orbax_checkpoint) ----------------------------
#
# The counterpart of JAX's orbax directories (larvanet_tpu/models/base.py:
# 697-775) is torch.distributed.checkpoint (DCP): a directory of `.distcp`
# files and a `.metadata` file, written by every process of an initialized
# group together (parallel/distributed.py), or by the one process without
# one. The module's tensors are stored as "model.<key>", the training
# state's tensors as "state.<path>", and the state's structure (the step,
# the optimizer's groups, the schedule) as "skeleton": torch.save bytes with
# each tensor replaced by ("__tensor__", its key), read back with
# weights_only=True. Only DCP's save, async_save, load and FileSystemReader
# are used.

DIR_METADATA = ".metadata"
_TENSOR = "__tensor__"


def is_dir_checkpoint(path: str) -> bool:
    """Whether `path` is a directory checkpoint of the port (DCP's)."""
    return os.path.isdir(path) and os.path.isfile(os.path.join(path, DIR_METADATA))


def dir_checkpoint_state(module_state: dict, train_state: Optional[dict]) -> dict:
    """The flat DCP state of a checkpoint: every tensor copied to the host
    (a snapshot: later in-place updates do not reach it), the structure of
    `train_state` (None for a weights-only save) as bytes."""
    import io

    flat = {"model." + k: v.detach().to("cpu", copy=True) for k, v in module_state.items()}

    def strip(obj, path):
        if isinstance(obj, torch.Tensor):
            key = "state" + path
            flat[key] = obj.detach().to("cpu", copy=True)
            return (_TENSOR, key)
        if isinstance(obj, dict):
            return {k: strip(v, "%s.%s" % (path, k)) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(strip(v, "%s.%d" % (path, i)) for i, v in enumerate(obj))
        return obj

    buf = io.BytesIO()
    torch.save(strip(train_state, ""), buf)
    flat["skeleton"] = buf.getvalue()
    return flat


def _quiet(fn, *args, **kwargs):
    """Call a DCP function without its notice that no process group is
    initialized (a single process is this port's usual case). The filter is
    process-wide: async_save warns on its own thread."""
    import warnings

    warnings.filterwarnings("ignore", message="torch.distributed is disabled")
    return fn(*args, **kwargs)


def save_dir_checkpoint(flat: dict, path: str, asynchronous: bool = False):
    """Write `flat` as a directory at `path`. Synchronous: into a temporary
    name, then swapped in, so an existing checkpoint stays until the new one
    is complete (JAX's base.py:755-765). Asynchronous: the old directory is
    removed first and DCP's async_save writes on its own thread; returns its
    future (None when synchronous)."""
    import shutil

    import torch.distributed.checkpoint as dcp

    from larvanet_tpu_torch.parallel.distributed import is_primary, world_size

    if os.path.isfile(path):
        os.unlink(path)  # a file checkpoint of an earlier run at this name
    if asynchronous:
        if os.path.isdir(path) and is_primary():
            shutil.rmtree(path)
        _barrier()
        return _quiet(dcp.async_save, flat, checkpoint_id=path)
    tmp = path + ".tmp-new"
    if os.path.isdir(tmp) and is_primary():
        shutil.rmtree(tmp)
    _barrier()
    _quiet(dcp.save, flat, checkpoint_id=tmp)
    if is_primary():
        if os.path.isdir(path):
            shutil.rmtree(path)
        os.rename(tmp, path)
    if world_size() > 1:
        _barrier()
    return None


def _barrier() -> None:
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.barrier()


def read_dir_checkpoint(path: str) -> Tuple[dict, Optional[dict]]:
    """(the module's state_dict, the training state or None) of a directory
    checkpoint, on the host."""
    import io

    import torch.distributed.checkpoint as dcp

    meta = dcp.FileSystemReader(path).read_metadata().state_dict_metadata
    if "skeleton" not in meta:
        raise ValueError("%s is a DCP directory but not a checkpoint of this port "
                         "(no skeleton entry)" % (path,))
    flat = {}
    for key, item in meta.items():
        if isinstance(item, dcp.TensorStorageMetadata):
            flat[key] = torch.empty(tuple(item.size), dtype=item.properties.dtype)
        else:
            flat[key] = b""
    _quiet(dcp.load, flat, checkpoint_id=path)
    module_state = {k[len("model."):]: v for k, v in flat.items() if k.startswith("model.")}

    def fill(obj):
        if isinstance(obj, tuple) and len(obj) == 2 and obj[0] == _TENSOR:
            return flat[obj[1]]
        if isinstance(obj, dict):
            return {k: fill(v) for k, v in obj.items()}
        if isinstance(obj, (list, tuple)):
            return type(obj)(fill(v) for v in obj)
        return obj

    skeleton = torch.load(io.BytesIO(flat["skeleton"]), weights_only=True)
    return module_state, fill(skeleton)
