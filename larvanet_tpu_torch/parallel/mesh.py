"""Device meshes, data-parallel training and data-parallel serving
(larvanet_tpu/parallel/mesh.py).

One process drives every device of its mesh, as JAX's single-controller
`shard_map` does: a `Mesh` is an array of torch devices with named axes,
and what JAX's collectives do between them is done here by tensor moves
(slices and `.to(device, non_blocking=True)`) in a fixed device order.
Launches on distinct cards are asynchronous, so the cards overlap; a mesh
may repeat a device (a virtual mesh, as the JAX tests repeat the host CPU),
and its shards then run in turn on that device through the same code.

  * Data-parallel training (`use_data_parallel`): the global batch splits
    over the 'data' axis; each shard's replica computes its loss and
    gradients (with `--grad_accum` inside the shard); the gradients are
    summed in device order on the model's device and scaled by 1/n, then
    all-reduced over the process group where one is initialized
    (parallel/distributed.py); one optimizer step and one EMA update
    follow, and the parameters are copied back to the replicas.
  * Data-parallel serving (`use_data_parallel_eval`): the inference batch
    splits over the axis, each shard through its device's copy of the
    model's route, with no collective (tiles are independent).
  * Spatial sharding with halo exchange: parallel/halo.py.

A replica on the model's own device is the model itself (`replicate` shares
a copy where the devices are the same); one on another device is a copy
whose route, with its baked tensors (collapsed-tail operators, ConvGroups,
S8Weights, split f32 weights), is built again there by the model's
`route_remake` (SRModel.set_route). `share=False` gives every position its
own copy even on a repeated device: the CPU tests take that path to hold
the copies against the model.
"""

from __future__ import annotations

import collections
import copy
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn


class Mesh:
    """An array of torch devices with named axes (jax.sharding.Mesh's
    role). `shape` maps each axis name to its size, in order."""

    def __init__(self, devices, axis_names: Sequence[str]):
        flat = [torch.device(d) for d in np.asarray(devices, dtype=object).reshape(-1)]
        arr = np.empty(len(flat), dtype=object)
        arr[:] = flat
        self.devices = arr.reshape(np.shape(np.asarray(devices, dtype=object)))
        self.axis_names = tuple(axis_names)
        if self.devices.ndim != len(self.axis_names):
            raise ValueError("a mesh of shape %s needs %d axis names, got %s"
                             % (self.devices.shape, self.devices.ndim, self.axis_names))

    @property
    def shape(self) -> "collections.OrderedDict[str, int]":
        return collections.OrderedDict(zip(self.axis_names, self.devices.shape))

    def device(self, **coords) -> torch.device:
        """The device at the named coordinates (an axis left out: index 0)."""
        unknown = set(coords) - set(self.axis_names)
        if unknown:
            raise ValueError("no mesh axis %s in %s" % (sorted(unknown), self.axis_names))
        return self.devices[tuple(int(coords.get(n, 0)) for n in self.axis_names)]

    def axis_devices(self, axis: str, **coords) -> List[torch.device]:
        """The devices along `axis`, the other axes at `coords` (default 0)."""
        return [self.device(**dict(coords, **{axis: i})) for i in range(self.shape[axis])]

    def __repr__(self) -> str:
        return "Mesh(%s: %s)" % (", ".join("%s=%d" % kv for kv in self.shape.items()),
                                 describe_devices(self.devices.reshape(-1)))


def device_key(device) -> Tuple[str, Optional[int]]:
    """(type, index) of a device, a bare 'cuda' resolved to the current card,
    so that two names of one device compare equal."""
    d = torch.device(device)
    index = d.index
    if d.type == "cuda" and index is None:
        index = torch.cuda.current_device()
    return d.type, index


def describe_devices(devices) -> str:
    """'cuda:0 x4' for a virtual mesh, 'cuda:0, cuda:1' for distinct ones."""
    names = [str(torch.device(*(k if k[1] is not None else k[:1])))
             for k in map(device_key, devices)]
    if len(set(names)) == 1 and len(names) > 1:
        return "%s x%d (virtual)" % (names[0], len(names))
    return ", ".join(names)


def default_devices() -> List[torch.device]:
    """Every visible card, or the CPU where there is none."""
    if torch.cuda.is_available():
        return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
    return [torch.device("cpu")]


def make_mesh(shape: Optional[Tuple[int, ...]] = None,
              axis_names: Sequence[str] = ("data",), devices=None) -> Mesh:
    """A mesh over `devices` (default: every visible card). shape=None
    puts every device on the first axis."""
    devices = list(devices if devices is not None else default_devices())
    if shape is None:
        shape = (len(devices),) + (1,) * (len(axis_names) - 1)
    if int(np.prod(shape)) != len(devices):
        raise ValueError("mesh shape %s does not cover %d devices" % (shape, len(devices)))
    arr = np.empty(len(devices), dtype=object)
    arr[:] = [torch.device(d) for d in devices]
    return Mesh(arr.reshape(shape), axis_names)


def devices_for(device, n: int, flag: str = "dp_devices") -> List[torch.device]:
    """The n devices of a CLI's mesh around the model's `device`: the CPU
    repeated n times (a virtual mesh, as the JAX tests' 8 CPU devices), or
    n distinct cards, the model's first. More cards than are visible exit
    with the JAX CLIs' message (larvanet_tpu/cli/common.py:213-215)."""
    device = torch.device(device)
    if device.type != "cuda":
        return [device] * n
    count = torch.cuda.device_count()
    if n > count:
        raise SystemExit("--%s %d > %d available devices" % (flag, n, count))
    first = device_key(device)[1]
    return [torch.device("cuda", i) for i in [first] + [i for i in range(count) if i != first]][:n]


def shard_batch(batch: torch.Tensor, mesh: Mesh, axis: str = "data") -> List[torch.Tensor]:
    """A batch split along its leading dim over `axis`: one shard per
    device along the axis, moved there."""
    devices = mesh.axis_devices(axis)
    n = len(devices)
    if batch.shape[0] % n:
        raise ValueError("batch %d does not divide the %d-way '%s' axis"
                         % (batch.shape[0], n, axis))
    b = batch.shape[0] // n
    return [batch[i * b:(i + 1) * b].to(d, non_blocking=True) for i, d in enumerate(devices)]


def _to_device(tree, device, fresh: bool = False):
    """`tree` on `device`: itself where it is there already, unless `fresh`
    asks for a copy in any case."""
    if isinstance(tree, nn.Module):
        tensors = list(tree.parameters()) + list(tree.buffers())
        if not fresh and all(device_key(t.device) == device_key(device) for t in tensors):
            return tree
        return copy.deepcopy(tree).to(device)
    if isinstance(tree, torch.Tensor):
        return tree.detach().to(device, copy=fresh)
    if isinstance(tree, dict):
        return {k: _to_device(v, device, fresh) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_to_device(v, device, fresh) for v in tree)
    return tree


class Replicated:
    """A value (a module, a tensor, or a dict / list tree of them) copied
    onto each device of a mesh: `copies[i]` for the mesh's flat position i.
    Positions on one device share one copy, and a position on the value's
    own device is the value itself; `share=False` copies for every
    position."""

    def __init__(self, tree, devices: Sequence[torch.device], share: bool = True):
        self.devices = [torch.device(d) for d in devices]
        self.copies = []
        made: Dict[tuple, object] = {}
        for d in self.devices:
            key = device_key(d)
            if share and key in made:
                self.copies.append(made[key])
                continue
            made[key] = _to_device(tree, d, fresh=not share)
            self.copies.append(made[key])

    def on(self, device):
        """The copy on `device` (its first position's)."""
        key = device_key(device)
        for d, c in zip(self.devices, self.copies):
            if device_key(d) == key:
                return c
        raise ValueError("no copy on %s (mesh devices %s)" % (device, self.devices))


def replicate(tree, mesh: Mesh, share: bool = True) -> Replicated:
    """Replicate a module or tensor tree across the mesh (JAX's
    device_put with a replicated sharding)."""
    if isinstance(tree, Replicated):
        return tree
    return Replicated(tree, list(mesh.devices.reshape(-1)), share=share)


def replica_model(model, device):
    """A copy of the SRModel `model` on `device`: its own module (and cast
    serving copy), sharing the wrapper's configuration; no optimizer, no
    route (the caller builds one there)."""
    rep = copy.copy(model)
    rep.module = copy.deepcopy(model.module).to(device)
    rep.device = torch.device(device)
    rep._serving_copy = None if model._serving_copy is None else rep._cast_copy()
    rep.optimizer = rep.ema = None
    rep.route = rep.route_remake = None
    rep.data_parallel = None
    rep._ckpt_writer = None
    return rep


def _model_replicas(model, devices: Sequence[torch.device], share: bool) -> list:
    """One SRModel a position: the model itself on its own device (shared),
    else a `replica_model` (one a distinct device, or one a position when
    not `share`)."""
    reps, made = [], {}
    for pos, d in enumerate(devices):
        key = device_key(d) if share else pos
        if key not in made:
            same = share and device_key(d) == device_key(model.device)
            made[key] = model if same else replica_model(model, d)
        reps.append(made[key])
    return reps


class DataParallelTrain:
    """The data-parallel step of a prepared SRModel over `axis` of `mesh`
    (make_dp_train_step's role, larvanet_tpu/parallel/mesh.py:64-94)."""

    def __init__(self, model, mesh: Mesh, axis: str = "data", share: bool = True):
        import torch.distributed as dist

        self.model = model
        self.axis = axis
        self.devices = mesh.axis_devices(axis)
        self.replicas = _model_replicas(model, self.devices, share)
        # under an initialized process group (of any size) the step's sums
        # go through its all-reduce
        self.distributed = dist.is_available() and dist.is_initialized()
        self.world = dist.get_world_size() if self.distributed else 1
        if self.distributed:
            self._broadcast()
        self.copy_out()

    def _broadcast(self) -> None:
        """Every process starts from rank 0's parameters and buffers."""
        import torch.distributed as dist

        with torch.no_grad():
            for t in list(self.model.module.parameters()) + list(self.model.module.buffers()):
                dist.broadcast(t.data, src=0)

    def _own_replicas(self):
        seen = {id(self.model)}
        for rep in self.replicas:
            if id(rep) not in seen:
                seen.add(id(rep))
                yield rep

    def copy_out(self) -> None:
        """The model's parameters and buffers copied into every replica
        that has its own module."""
        master = list(self.model.module.parameters()) + list(self.model.module.buffers())
        with torch.no_grad():
            for rep in self._own_replicas():
                mine = list(rep.module.parameters()) + list(rep.module.buffers())
                for a, b in zip(mine, master):
                    a.copy_(b, non_blocking=True)

    def loss_and_grads(self, inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """Each shard's loss and gradients on its replica, in device order;
        the gradients' mean over the shards (and the processes) left in the
        model's parameters' `.grad`; returns the mean loss on the model's
        device. Host syncs stay out of the shard loop."""
        n = len(self.devices)
        if inputs.shape[0] % n:
            raise ValueError("dp train: batch %d does not divide the %d-way '%s' axis"
                             % (inputs.shape[0], n, self.axis))
        b = inputs.shape[0] // n
        home = self.model.device
        # every shard's copy is queued before any step (a copy waits for the
        # work queued on its source device, the model's)
        shards = [(inputs[i * b:(i + 1) * b].to(d, non_blocking=True),
                   targets[i * b:(i + 1) * b].to(d, non_blocking=True))
                  for i, d in enumerate(self.devices)]
        losses, grads = [], []
        for rep, (x, y) in zip(self.replicas, shards):
            params = list(rep.module.parameters())
            for p in params:
                p.grad = None
            losses.append(rep._loss_and_grads(x, y))
            grads.append([p.grad for p in params])
            for p in params:
                p.grad = None
        total = [None if g is None else g.to(home) for g in grads[0]]
        live = [j for j, g in enumerate(total) if g is not None]
        for shard in grads[1:]:
            torch._foreach_add_([total[j] for j in live], [shard[j].to(home) for j in live])
        loss = losses[0].to(home)
        for extra in losses[1:]:
            loss = loss + extra.to(home)
        if self.distributed:
            loss = self._all_reduce([total[j] for j in live], loss)
        inv = 1.0 / (n * self.world)
        torch._foreach_mul_([total[j] for j in live], inv)
        for p, g in zip(self.model.module.parameters(), total):
            p.grad = g
        return loss * inv

    def _all_reduce(self, grads: List[torch.Tensor], loss: torch.Tensor) -> torch.Tensor:
        """The processes' gradient and loss sums, one flat all-reduce."""
        import torch.distributed as dist

        flat = torch.cat([g.reshape(-1) for g in grads] + [loss.reshape(1).to(grads[0].dtype)])
        dist.all_reduce(flat)
        offset = 0
        for g in grads:
            g.copy_(flat[offset:offset + g.numel()].view_as(g))
            offset += g.numel()
        return flat[offset].to(loss.dtype)


def make_dp_train_step(model, mesh: Mesh, axis: str = "data", share: bool = True):
    """The data-parallel optimizer step of a prepared SRModel:
    step(inputs, targets, lr) -> the global batch's mean loss (a device
    scalar), one optimizer step and one EMA update on the model."""
    dp = DataParallelTrain(model, mesh, axis, share)

    def step(inputs, targets, lr):
        previous = model.data_parallel
        model.data_parallel = dp
        try:
            return model._optimizer_step(inputs, targets, lr)
        finally:
            model.data_parallel = previous

    return step


def use_data_parallel(model, mesh: Mesh, axis: str = "data", share: bool = True) -> None:
    """Switch a prepared (and restored) SRModel to data-parallel training
    on `mesh`: every later step (`train_step`, `train_step_larva`) takes
    global batches, split over `axis`. Call after restore: the replicas are
    copied from the model here."""
    if model.optimizer is None:
        raise ValueError("use_data_parallel needs a model prepared for training")
    model.data_parallel = DataParallelTrain(model, mesh, axis, share)


def use_data_parallel_eval(model, mesh: Mesh, axis: str = "data", share: bool = True) -> None:
    """Shard inference batches over `axis` (multi-card serving): each
    device runs its share of the batch through its copy of the route set
    at this point (the collapsed tail, --wino_trunk or --int8_trunk, as
    cli/common's maybe_* leave it; or the serving module), with no
    collective. Compose with TiledUpscaler(min_batch=n) so that every tile
    batch divides the axis; any other batch that does not is refused with
    JAX's message (larvanet_tpu/parallel/mesh.py:97-123)."""
    devices = mesh.axis_devices(axis)
    n = len(devices)
    if model.route is not None and model.route_remake is None and (
            not share or len({device_key(d) for d in devices} - {device_key(model.device)})):
        raise ValueError("dp eval: the route set on %s cannot be built on another device"
                         % (model.registry_name,))
    reps = _model_replicas(model, devices, share)
    for rep in reps:
        if rep is not model and model.route is not None:
            if rep.route is None:  # a copy shared by several positions is built once
                rep.set_route(model.route_remake(rep))
                rep.route_remake = model.route_remake
    forwards = [rep.route if rep.route is not None else rep.serving_module for rep in reps]
    home = model.device

    def forward(x: torch.Tensor) -> torch.Tensor:
        if x.shape[0] % n:
            raise ValueError(
                "dp eval: batch %d does not divide the %d-way '%s' axis; "
                "use TiledUpscaler(min_batch=%d)" % (x.shape[0], n, axis, n))
        b = x.shape[0] // n
        # every shard's copy is queued before any forward (a copy waits for
        # the work queued on its source device, the model's)
        shards = [x[i * b:(i + 1) * b].to(d, non_blocking=True).contiguous()
                  for i, d in enumerate(devices)]
        outs = [fwd(shard) for fwd, shard in zip(forwards, shards)]
        return torch.cat([o.to(home, non_blocking=True) for o in outs])

    forward.replicas = reps
    model.set_route(forward)
