"""Tensor (channel) parallelism for conv layers (larvanet_tpu/parallel/tp.py).

A conv's OUTPUT channels are split over a 'model' mesh axis: each device
convolves the full input with its slice of the kernel on the hand-written
`conv3x3_bias_act` kernel (models/layers' name of it), producing its
channel shard, and the shards are gathered onto every device before the
next conv, whose contraction needs the whole feature vector. It composes
with halo.py's spatial axis: a 2-D ('spatial', 'model') mesh splits H and C
at once (`make_tp_spatial_forward`). No CLI reaches it, in JAX as here; it
exists for frames whose activations do not fit on one device at full
width. Every gather moves the whole (H, W, C) map, so it is bandwidth-bound
by construction (JAX's cost model, tp.py:85-101).

One process drives the mesh, so a sharded value is a list with one tensor
a device along the axis, in mesh order, and the per-device code of JAX's
`shard_map` becomes code over those lists: `tp_conv3x3` takes the inputs,
kernel slices and bias slices of every device and returns every device's
gathered output. Shards on one device (a virtual mesh) share one gathered
copy.
"""

from __future__ import annotations

from typing import Callable, Dict, List, Optional, Sequence

import torch

from larvanet_tpu_torch.parallel.halo import _split, halo_exchange
from larvanet_tpu_torch.parallel.mesh import Mesh, device_key


def all_gather(shards: Sequence[torch.Tensor], devices: Sequence[torch.device],
               dim: int = 3) -> List[torch.Tensor]:
    """The shards concatenated along `dim` on each of `devices` (one copy a
    distinct device; JAX's tiled all_gather)."""
    made: Dict[tuple, torch.Tensor] = {}
    out = []
    for d in devices:
        key = device_key(d)
        if key not in made:
            made[key] = torch.cat([s.to(d, non_blocking=True) for s in shards], dim=dim)
        out.append(made[key])
    return out


def tp_conv3x3(xs: Sequence[torch.Tensor], kernels: Sequence[torch.Tensor],
               biases: Sequence[torch.Tensor], act: Optional[str] = None
               ) -> List[torch.Tensor]:
    """A channel-sharded SAME 3x3 conv + bias (+ act): xs[i] the full
    NHWC input on device i, kernels[i] its HWIO output-channel slice
    (3, 3, C, F/n), biases[i] (F/n,). Returns each device's gathered
    (N, H, W, F) output. The activation runs in the kernel's epilogue on
    each shard (elementwise, so the same as after the gather)."""
    from larvanet_tpu_torch.models import layers

    outs = [layers.conv3x3_bias_act(x.contiguous(), k, b, act)
            for x, k, b in zip(xs, kernels, biases)]
    return all_gather(outs, [x.device for x in xs], dim=3)


def shard_params(params, devices: Sequence[torch.device], axis_name: str = "model"):
    """A parameter tree with every 4-D leaf (an HWIO kernel) split on its
    last dim and every 1-D leaf (a bias) split, over `devices`; the other
    leaves replicated. Each leaf becomes a list of one tensor a device."""
    n = len(devices)
    if isinstance(params, dict):
        return {k: shard_params(v, devices, axis_name) for k, v in params.items()}
    t = torch.as_tensor(params)
    if t.dim() in (1, 4):
        size = t.shape[-1]
        if size % n:
            raise ValueError("tp: %d output channels do not divide the %d-way '%s' axis"
                             % (size, n, axis_name))
        step = size // n
        return [t.narrow(t.dim() - 1, i * step, step).contiguous().to(d)
                for i, d in enumerate(devices)]
    return [t.to(d) for d in devices]


def make_tp_forward(apply_local: Callable, mesh: Mesh, axis_name: str = "model"):
    """f(params, x) -> y: `apply_local(sharded_params, xs)` over the
    devices of `axis_name`, with `shard_params`' tree and x on every
    device; it returns each device's output (replicated, as tp_conv3x3's
    are), and f returns the first device's, on x's device."""
    devices = mesh.axis_devices(axis_name)

    def f(params, x: torch.Tensor) -> torch.Tensor:
        sharded = shard_params(params, devices, axis_name)
        ys = apply_local(sharded, [x.to(d, non_blocking=True) for d in devices])
        return ys[0].to(x.device)

    return f


def tp_stack_apply(params, xs: Sequence[torch.Tensor], scale: int) -> List[torch.Tensor]:
    """A conv-relu chain and a PixelShuffle with every conv output-channel
    sharded (tp_conv3x3). params: {"conv0": {"kernel", "bias"}, ...} as
    `shard_params` leaves them, applied in index order; the last conv maps
    to 3*scale**2 channels with no activation and feeds the shuffle.
    Returns each device's output."""
    from larvanet_tpu_torch.ops.pixel_shuffle import pixel_shuffle

    names = sorted((n for n in params if n.startswith("conv")), key=lambda n: int(n[4:]))
    h = list(xs)
    for i, name in enumerate(names):
        p = params[name]
        h = tp_conv3x3(h, p["kernel"], p["bias"], "relu" if i < len(names) - 1 else None)
    return [pixel_shuffle(t, scale) for t in h]


def make_tp_spatial_forward(mesh: Mesh, halo: int, scale: int, model_axis: str = "model",
                            spatial_axis: str = "spatial"):
    """The 2-D ('spatial', 'model') composition: the image's H axis split
    over `spatial_axis` with a zero-filled halo exchange (halo.py's
    `halo_exchange`), every conv's output channels over `model_axis`, and
    `halo * scale` output rows trimmed from each end of every strip, as
    JAX's make_tp_spatial_forward does (so the outer borders see zeros
    beyond the image, not SAME padding's progressive shrink). Returns
    f(params, x) -> y on x's device; H must divide the spatial axis."""
    n_spatial = mesh.shape[spatial_axis]
    n_model = mesh.shape[model_axis]

    def f(params, x: torch.Tensor) -> torch.Tensor:
        strips = _split(x, n_spatial, 1, spatial_axis, mesh, "args[1]")
        # a column of the mesh: one device a strip, for one model index
        ext = {}
        for m in range(n_model):
            column = [t.to(mesh.device(**{spatial_axis: s, model_axis: m}), non_blocking=True)
                      for s, t in enumerate(strips)]
            for s, e in enumerate(halo_exchange(column, halo)):
                ext[s, m] = e
        out = []
        trim = halo * scale
        for s in range(n_spatial):
            row = mesh.axis_devices(model_axis, **{spatial_axis: s})
            ys = tp_stack_apply(shard_params(params, row, model_axis),
                                [ext[s, m] for m in range(n_model)], scale)
            y = ys[0]
            out.append(y.narrow(1, trim, y.shape[1] - 2 * trim).to(x.device, non_blocking=True))
        return torch.cat(out, dim=1)

    return f
