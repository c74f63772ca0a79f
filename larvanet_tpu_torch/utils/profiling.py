"""Tracing and profiling (larvanet_tpu/utils/profiling.py).

  * `StepTimer`: named wall-clock segments of the training loop (data /
    device step / other) with running means, printable every log_freq;
  * `trace(profile_dir)`: runs its body under `torch.profiler` with the
    CPU and, where there is a card, CUDA activities, and writes a Chrome
    trace (`trace.json`, viewable in Perfetto or chrome://tracing) into
    the directory when the body ends: the counterpart of
    `jax.profiler.trace` behind the train CLIs' `--profile_dir`. The
    ctypes-launched kernels appear under their CUDA names
    (conv3x3_tc_kernel, wgrad_tc_kernel, ...), so the host's side of a
    step (launches, the optimizer's small kernels, Python) stands beside
    the card's;
  * `annotate(name)`: `torch.profiler.record_function`, a named host span
    in the trace.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, Iterator, Optional

import torch

TRACE_FILE = "trace.json"


class StepTimer:
    """Named-segment wall-clock accounting for the training loop."""

    def __init__(self):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def segment(self, name: str) -> Iterator[None]:
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.totals[name] += time.perf_counter() - t0
            self.counts[name] += 1

    def mean(self, name: str) -> float:
        c = self.counts[name]
        return self.totals[name] / c if c else 0.0

    def report(self) -> str:
        return ", ".join("%s %.4fs" % (k, self.mean(k)) for k in sorted(self.totals))

    def reset(self) -> None:
        self.totals.clear()
        self.counts.clear()


@contextlib.contextmanager
def trace(profile_dir: Optional[str]) -> Iterator[Optional[torch.profiler.profile]]:
    """Profile the body into `profile_dir`/trace.json when a directory is
    given (a no-op otherwise); yields the profiler (or None)."""
    if not profile_dir:
        yield None
        return
    os.makedirs(profile_dir, exist_ok=True)
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(profile_dir, TRACE_FILE))
    print("wrote a profiler trace to %s" % (os.path.join(profile_dir, TRACE_FILE),))


def annotate(name: str):
    """A named span of host work in the trace."""
    return torch.profiler.record_function(name)
