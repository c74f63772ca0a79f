"""Dispatch-ahead evaluation (larvanet_tpu/eval/pipeline.py:22-64).

The forward is asynchronous on the CUDA stream: `SRModel.upscale_device`
returns once the kernels are queued, so launching frame i+1 before
pulling frame i overlaps the pull (and the next frame's PNG decode) with
the card's work. `depth` bounds the frames launched but not yet pulled.
Outputs come back in order, byte-equal to the serial loop's.
"""

from __future__ import annotations

import collections
import time


def pipelined_upscale(model, items, scale, depth=2, dispatch=None):
    """Run `model`'s forward over `items`, (payload, CHW input image) pairs,
    with dispatch-ahead, quantizing each frame to uint8 on the device.
    Yields (payload, CHW uint8 output, seconds) in input order; `seconds`
    is the wall time between consecutive completions, so their sum is the
    loop's wall time. depth <= 1 is the serial loop. `dispatch(input_list)`,
    returning the device's NHWC uint8 batch, replaces `model.upscale_device`
    (validate_tree: TreeNet's per-branch forwards, pipeline.py:44-46)."""
    depth = max(1, int(depth))
    if dispatch is None:
        dispatch = lambda imgs: model.upscale_device(imgs, scale, uint8=True)  # noqa: E731
    pending = collections.deque()
    t_last = time.perf_counter()

    def pull():
        nonlocal t_last
        payload, dev = pending.popleft()
        out = dev.cpu().numpy()[0].transpose(2, 0, 1)  # waits for this frame
        now = time.perf_counter()
        dt, t_last = now - t_last, now
        return payload, out, dt

    for payload, img in items:
        pending.append((payload, dispatch([img])))
        if len(pending) >= depth:
            yield pull()
    while pending:
        yield pull()
