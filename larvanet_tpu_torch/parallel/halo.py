"""Spatially sharded inference with halo exchange, exact at the borders
(larvanet_tpu/parallel/halo.py).

The image's H axis is split over a 'spatial' mesh axis; each device runs
the whole network on its strip extended with its neighbours' rows, then
trims the extension from its output. The windows are JAX's edge windows:

    device 0:        [strip | below 2h]      (window top == image top)
    interior i:      [above h | strip | below h]
    device n-1:      [above 2h | strip]      (window bottom == image bottom)

so the edge devices' SAME zero padding falls on the image's own border, and
every output row sees at least h real rows on each side. The result equals
the full-frame forward wherever h reaches the network's receptive radius
in LR rows (`receptive_radius`: 36 for EDSR-baseline x4, more than the
CLIs' default --spatial_halo 32, in JAX as here); below it, the rows near
a seam differ from the full frame, as JAX's do. A window is 2h rows taller
than its strip, so a strip must hold at least 2h rows.

The exchange is slices of the neighbours' strips moved to the device with
`.to(device, non_blocking=True)` (JAX's ppermute); on a virtual mesh the
strips run in turn on the one device through the same code.
"""

from __future__ import annotations

from typing import Callable, List, Optional

import torch

from larvanet_tpu_torch.parallel.mesh import Mesh, replicate


def halo_exchange(strips: List[torch.Tensor], halo: int, spatial_axis: int = 1
                  ) -> List[torch.Tensor]:
    """Each strip (one a device, in mesh order, each on its device) extended
    with `halo` rows of each neighbour: the last rows of the one above, the
    first rows of the one below; zeros at the outer edges (the ppermute
    identity). Fine for interior-exact work; the border-exact inference
    windows are spatial_sharded_forward's."""
    out = []
    n = len(strips)
    for i, x in enumerate(strips):
        zeros = x.shape[:spatial_axis] + (halo,) + x.shape[spatial_axis + 1:]
        if i > 0:
            up = strips[i - 1]
            above = up.narrow(spatial_axis, up.shape[spatial_axis] - halo, halo)
            above = above.to(x.device, non_blocking=True)
        else:
            above = x.new_zeros(zeros)
        if i < n - 1:
            below = strips[i + 1].narrow(spatial_axis, 0, halo).to(x.device, non_blocking=True)
        else:
            below = x.new_zeros(zeros)
        out.append(torch.cat([above, x, below], dim=spatial_axis))
    return out


def _split(x: torch.Tensor, n: int, axis: int, axis_name: str, mesh: Mesh,
           arg: str) -> List[torch.Tensor]:
    size = x.shape[axis]
    if size % n:
        raise ValueError(
            "spatial_sharded_forward: %s of shape %s maps array axis %d (of size %d) to mesh "
            "axis '%s' (of size %d), but %d does not evenly divide %d (mesh %s)"
            % (arg, tuple(x.shape), axis, size, axis_name, n, n, size, dict(mesh.shape)))
    step = size // n
    return [x.narrow(axis, i * step, step) for i in range(n)]


def spatial_sharded_forward(
    apply_fn: Callable,
    mesh: Mesh,
    halo: int,
    scale: int,
    axis_name: str = "spatial",
    spatial_axis: int = 1,
    batch_axis_name: Optional[str] = None,
):
    """An H-sharded version of an NHWC forward, exact against the full
    frame where `halo` reaches its receptive radius (module docstring).

    apply_fn(params, window) -> y runs the whole model on one device's
    window, with `params` on that device. Returns f(params, x) -> y:
    `params` is a module or tensor tree (copied to each distinct device of
    the mesh, shared where a device repeats) or `replicate`'s result; x is
    split along `spatial_axis` over `axis_name` (and its batch over
    `batch_axis_name`, if given; the other axes replicate, so their first
    index computes); y is gathered on x's device. An axis that does not
    divide over its mesh axis, or a strip shorter than 2*halo, is refused
    with JAX's messages."""
    n_shards = mesh.shape[axis_name]
    n_batch = mesh.shape[batch_axis_name] if batch_axis_name else 1

    def device(b: int, s: int) -> torch.device:
        coords = {axis_name: s}
        if batch_axis_name:
            coords[batch_axis_name] = b
        return mesh.device(**coords)

    def window(strips: List[torch.Tensor], s: int):
        """(device s's window, the rows above its strip in it)."""
        x_local = strips[s]
        if n_shards == 1:
            return x_local, 0
        strip = x_local.shape[spatial_axis]
        if strip < 2 * halo:
            raise ValueError(
                "spatial_sharded_forward: local strip (%d rows) must be >= "
                "2*halo (%d) for border-exact windows; lower the halo or the "
                "shard count" % (strip, 2 * halo))
        h2 = 2 * halo
        dev = x_local.device
        # the window's rows above and below the strip (module docstring)
        n_above = 0 if s == 0 else (h2 if s == n_shards - 1 else halo)
        n_below = h2 - n_above
        parts = []
        if n_above:
            up = strips[s - 1]
            parts.append(up.narrow(spatial_axis, up.shape[spatial_axis] - n_above, n_above)
                         .to(dev, non_blocking=True))
        parts.append(x_local)
        if n_below:
            parts.append(strips[s + 1].narrow(spatial_axis, 0, n_below)
                         .to(dev, non_blocking=True))
        return torch.cat(parts, dim=spatial_axis).contiguous(), n_above

    def f(params, x: torch.Tensor) -> torch.Tensor:
        reps = replicate(params, mesh)
        home = x.device
        batches = _split(x, n_batch, 0, batch_axis_name, mesh, "args[1]") \
            if batch_axis_name else [x]
        # every copy is queued before any forward: a copy waits for the work
        # already queued on its source device, so a forward queued before it
        # would hold the next device back until that forward ends
        jobs = []
        for b, xb in enumerate(batches):
            strips = [t.to(device(b, s), non_blocking=True)
                      for s, t in enumerate(_split(xb, n_shards, spatial_axis, axis_name,
                                                   mesh, "args[1]"))]
            jobs += [(b, s, strips[s].shape[spatial_axis]) + window(strips, s)
                     for s in range(n_shards)]
        ys = [apply_fn(reps.on(device(b, s)), win) for b, s, _, win, _ in jobs]
        out = [y.narrow(spatial_axis, n_above * scale, strip * scale).to(home, non_blocking=True)
               for y, (_, _, strip, _, n_above) in zip(ys, jobs)]
        rows = [torch.cat(out[b * n_shards:(b + 1) * n_shards], dim=spatial_axis)
                for b in range(len(batches))]
        return torch.cat(rows, dim=0) if len(rows) > 1 else rows[0]

    return f


@torch.no_grad()
def receptive_radius(forward: Callable[[torch.Tensor], torch.Tensor], scale: int,
                     channels: int = 3, rows: int = 96, width: int = 8,
                     device="cpu", dtype=torch.float32, seed: int = 0) -> int:
    """The receptive radius of an NHWC forward in LR rows, measured: the
    output of a random frame and of the same frame with its middle row
    changed differ in output rows that map to LR rows within the radius of
    that row. `rows` must exceed twice the radius."""
    gen = torch.Generator().manual_seed(seed)
    x = torch.rand((1, rows, width, channels), generator=gen).to(device, dtype) * 255
    mid = rows // 2
    x2 = x.clone()
    x2[:, mid] += 64
    diff = (forward(x2).float() - forward(x).float()).abs().amax(dim=(0, 2, 3))
    changed = torch.nonzero(diff > 0).reshape(-1).cpu()
    if changed.numel() == 0:
        return 0
    lo, hi = int(changed[0]) // scale, int(changed[-1]) // scale
    if lo == 0 or hi == rows - 1:
        raise ValueError("receptive_radius: the change reached the frame's border; "
                         "pass more rows than %d" % rows)
    return max(mid - lo, hi - mid)
