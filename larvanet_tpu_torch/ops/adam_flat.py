"""Adam / AdamW over flat moment buffers in one launch (`--fused_opt 1`): the
hand-written CUDA kernel and its plain PyTorch version.

The counterpart of the JAX package's `--fused_opt`, optax.flatten around
Adam (larvanet_tpu/models/base.py:265-330), which XLA runs as one fusion
over a ravel_pytree vector. `AdamFlat(params)` keeps the first and second
moments of a list of f32 parameters in two flat f32 buffers, `m` and `v`,
each parameter's slice at its offset (in the order of the list, each
offset rounded up to 4 elements so every slice starts on 16 bytes);
`view(buf, i)` is parameter i's slice shaped like it. `step(grads, s)`
updates every parameter whose gradient is not None, and its slices of m
and v, by one Adam step with the launch scalars `s` (`scalars`): on CUDA
tensors one launch of `csrc/adam_flat.cu`, counted in `LAUNCHES`; on CPU
tensors the plain version, `adam_flat_reference`. The kernel writes the
parameters through raw pointers, so the step bumps their version counters
(`bump_versions`) as torch's in-place ops do.

Per element, in f32, with each operation rounded once (the kernel's order):

    p <- p * decay                             (AdamW: decay = 1 - lr wd)
    m <- m + (1 - b1) (g - m)
    v <- v b2 + (1 - b2) g g
    p <- p + neg_step (m / (sqrt(v) / bc2_sqrt + eps))

neg_step = -lr / (1 - b1^t), bc2_sqrt = sqrt(1 - b2^t): torch's Adam and
AdamW (and optax's update), whose scalars torch also forms in double and
rounds to f32. The plain version takes the same steps in torch ops on the
gathered flat buffers, each rounded once as the kernel rounds it, and
agrees with the kernel bit for bit. Only f32 parameters are taken.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch

from larvanet_tpu_torch.ops import build

SOURCE = "adam_flat.cu"
ALIGN = 4  # elements: each slice of m and v starts on 16 bytes

LAUNCHES = 0


def reset_launches() -> None:
    global LAUNCHES
    LAUNCHES = 0


class Scalars(NamedTuple):
    """One step's launch scalars, as doubles (rounded to f32 at the launch)."""
    b1c: float       # 1 - b1
    b2: float
    b2c: float       # 1 - b2
    eps: float
    neg_step: float  # -lr / (1 - b1^t)
    bc2_sqrt: float  # sqrt(1 - b2^t)
    decay: float     # 1 - lr wd (AdamW), 1.0 (Adam)
    adamw: bool


def scalars(lr: float, betas: Tuple[float, float], eps: float, step: float,
            weight_decay: float = 0.0, adamw: bool = False) -> Scalars:
    """The scalars of step `step` (from 1), formed as torch's foreach Adam
    forms them."""
    b1, b2 = betas
    bc1 = 1 - b1 ** step
    bc2 = 1 - b2 ** step
    return Scalars(1 - b1, b2, 1 - b2, eps, (lr / bc1) * -1, bc2 ** 0.5,
                   1 - lr * weight_decay if adamw else 1.0, bool(adamw))


def _update(p: torch.Tensor, g: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
            s: Scalars) -> None:
    """One step in place on flat f32 tensors, each operation rounded once."""
    if s.adamw:
        p.mul_(s.decay)
    m.add_(g.sub(m).mul_(s.b1c))
    v.mul_(s.b2).add_(g.mul(g).mul_(s.b2c))
    # the square root correctly rounded to f32 on every device (through f64:
    # torch's vectorized f32 sqrt on the CPU is not), the divisor a device
    # tensor (a Python scalar divisor may become a product by its reciprocal)
    bc2_sqrt = torch.tensor(s.bc2_sqrt, dtype=torch.float32, device=v.device)
    d = v.double().sqrt().float().div_(bc2_sqrt).add_(s.eps)
    p.add_(m.div(d).mul_(s.neg_step))


def adam_flat_reference(params: Sequence[torch.Tensor],
                        grads: Sequence[Optional[torch.Tensor]], m: torch.Tensor,
                        v: torch.Tensor, offsets: Sequence[int], s: Scalars) -> None:
    """The plain version: the parameters with a gradient, their gradients
    and their slices of m and v gathered into flat tensors, one step in
    torch ops, the results written back."""
    live = [i for i, g in enumerate(grads) if g is not None]
    if not live:
        return
    with torch.no_grad():
        p = torch.cat([params[i].detach().reshape(-1) for i in live])
        g = torch.cat([grads[i].detach().reshape(-1).float() for i in live])
        spans = [(offsets[i], params[i].numel()) for i in live]
        mf = torch.cat([m[o:o + n] for o, n in spans])
        vf = torch.cat([v[o:o + n] for o, n in spans])
        _update(p, g, mf, vf, s)
        at = 0
        for i, (o, n) in zip(live, spans):
            params[i].detach().view(-1).copy_(p[at:at + n])
            m[o:o + n].copy_(mf[at:at + n])
            v[o:o + n].copy_(vf[at:at + n])
            at += n


def bump_versions(tensors: Sequence[torch.Tensor]) -> None:
    """Count a write through a raw pointer in each tensor's version counter,
    as an in-place torch op would: the caches keyed on (data_ptr, _version),
    conv3x3.split_weight's among them, must see the updated weights."""
    if tensors:
        torch._C._autograd._unsafe_set_version_counter(
            tuple(tensors), tuple(t._version + 1 for t in tensors))


def bind(lib: ctypes.CDLL):
    """The library's (step entry, chunk size) with their C signatures."""
    fn = lib.adam_flat_f32
    fn.argtypes = ([ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p,
                    ctypes.c_void_p] + [ctypes.c_float] * 7 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    chunk = lib.adam_flat_chunk
    chunk.restype = ctypes.c_int
    return fn, int(chunk())


@functools.lru_cache(maxsize=None)
def _entry():
    return bind(build.load(SOURCE))


def chunk_table(counts: Sequence[int], chunk: int) -> List[Tuple[int, int]]:
    """(parameter, first element) of every block: each parameter cut into
    runs of `chunk` elements."""
    return [(i, start) for i, n in enumerate(counts) for start in range(0, n, chunk)]


def _run(fn, table: torch.Tensor, chunks: torch.Tensor, m: torch.Tensor, v: torch.Tensor,
         s: Scalars, stream) -> None:
    """Call the entry `fn` on device tables: `table` (n, 4) int64 rows of
    (p, g, offset, count), `chunks` (blocks, 2) int32 rows of (parameter,
    start)."""
    err = fn(table.data_ptr(), chunks.data_ptr(), chunks.shape[0], m.data_ptr(),
             v.data_ptr(), s.b1c, s.b2, s.b2c, s.eps, s.neg_step, s.bc2_sqrt, s.decay,
             int(s.adamw), stream)
    if err != 0:
        raise RuntimeError("adam_flat kernel launch failed: CUDA error %d" % err)


class AdamFlat:
    """The flat Adam moments of a list of f32 parameters on one device, and
    the step over them."""

    def __init__(self, params: Sequence[torch.Tensor]):
        self.params = list(params)
        if not self.params:
            raise ValueError("adam_flat: no parameters")
        for p in self.params:
            if p.dtype != torch.float32:
                raise TypeError("adam_flat takes float32 parameters, got %s" % (p.dtype,))
            if not p.is_contiguous():
                raise ValueError("adam_flat: parameters must be contiguous")
        self.device = self.params[0].device
        if any(p.device != self.device for p in self.params):
            raise ValueError("adam_flat: the parameters must lie on one device")
        self.counts = [p.numel() for p in self.params]
        self.offsets, total = [], 0
        for n in self.counts:
            self.offsets.append(total)
            total += -(-n // ALIGN) * ALIGN
        self.m = torch.zeros(total, dtype=torch.float32, device=self.device)
        self.v = torch.zeros(total, dtype=torch.float32, device=self.device)
        self._chunks: Optional[torch.Tensor] = None
        self._table_key: Optional[Tuple[int, ...]] = None
        self._table: Optional[torch.Tensor] = None

    def view(self, buf: torch.Tensor, i: int) -> torch.Tensor:
        """Parameter i's slice of `buf` (m or v), shaped like it."""
        o = self.offsets[i]
        return buf[o:o + self.counts[i]].view(self.params[i].shape)

    def step(self, grads: Sequence[Optional[torch.Tensor]], s: Scalars) -> None:
        """One step of every parameter whose gradient is not None. CPU: the
        plain version; CUDA: one launch of the kernel."""
        if len(grads) != len(self.params):
            raise ValueError("adam_flat: %d gradients for %d parameters"
                             % (len(grads), len(self.params)))
        if self.device.type == "cpu":
            adam_flat_reference(self.params, grads, self.m, self.v, self.offsets, s)
            return
        if self.device.type != "cuda":
            raise ValueError("adam_flat runs on CUDA or the CPU, not %s" % (self.device,))
        for p, g in zip(self.params, grads):
            if g is not None and (g.dtype != torch.float32 or g.shape != p.shape
                                  or g.device != self.device or not g.is_contiguous()):
                raise ValueError("adam_flat: a gradient must be a contiguous float32 tensor "
                                 "of its parameter's shape on its device")
        fn, chunk = _entry()
        with torch.cuda.device(self.device):
            if self._chunks is None:
                self._chunks = torch.tensor(chunk_table(self.counts, chunk), dtype=torch.int32,
                                            device=self.device).reshape(-1, 2)
            rows = [[p.data_ptr(), 0 if g is None else g.data_ptr(), o, n]
                    for p, g, o, n in zip(self.params, grads, self.offsets, self.counts)]
            key = tuple(r[1] for r in rows) + tuple(r[0] for r in rows)
            if key != self._table_key:  # a new gradient (or parameter) address
                self._table = torch.tensor(rows, dtype=torch.int64).to(self.device)
                self._table_key = key
            _run(fn, self._table, self._chunks, self.m, self.v, s,
                 torch.cuda.current_stream().cuda_stream)
        bump_versions([p for p, g in zip(self.params, grads) if g is not None])
        global LAUNCHES
        LAUNCHES += 1
