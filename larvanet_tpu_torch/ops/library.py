"""The hand-written kernels as registered torch ops, for torch.export.

torch.export traces a route on fake tensors. Left to themselves, the
kernels' wrappers would hand it the plain version (the CPU route: its
slices, selects and matmuls end up in the graph, and no kernel is ever
launched from it) or read `data_ptr()` of a fake tensor (the CUDA route).
So while `torch.compiler.is_exporting()`, the wrappers (ops/conv3x3.py,
conv_kxk.py, conv3x3_s8.py, dwconv3x3.py) call the functions below, whose
ops stay in the graph as opaque `larvanet.*` nodes:

  larvanet::conv3x3_bias_act(Tensor x, Tensor kernel, Tensor bias, int act,
                             float slope) -> Tensor
  larvanet::conv_kxk(Tensor x, Tensor kernel, Tensor? bias, int[] pads) -> Tensor
  larvanet::conv_kxk_group(Tensor xs, Tensor[] kernels, Tensor?[] biases,
                           int[] pads) -> Tensor      (G problems stacked)
  larvanet::conv3x3_s8_a(Tensor hin, Tensor codes, Tensor scale, Tensor bias,
                         float s_in, float s_mid, int act, float slope) -> Tensor
  larvanet::conv3x3_s8_b(Tensor tq, Tensor codes, Tensor scale, Tensor bias,
                         str dtype, Tensor? res, float res_weight) -> Tensor
  larvanet::dwconv3x3(Tensor x, Tensor kernel, Tensor bias) -> Tensor

`act` is the kernels' code (ACTS: 0 none, 1 relu, 2 leaky_relu, 3 relu6).
Each op has three bodies: the CPU one, the plain version; the CUDA one, the
wrapper's own launch (`*_cuda`), which launches the kernel or raises and
counts its launch, so that the counters count when a program runs, not
when it is traced; and a fake one, the wrapper's checks on shapes and
dtypes and the output's shape and dtype. The Python objects the wrappers
take (conv_kxk's ConvGroup, conv3x3_s8's S8Weight) travel as their
tensors; the CUDA bodies make them again from those, kept in `_OPERANDS`
by the tensors' storage and version (holding the tensors, so a live
entry's pointers name no other tensor), so that a program's constants are
laid out for their kernel once, as the eager route's objects keep theirs.

Eager calls do not go through the dispatcher (the bf16 forwards are bound
by the host's launch time): the wrappers call the same bodies directly.
An artifact (utils/aot.py) imports this module before it loads a program:
the ops are all it needs of the package beyond torch.
"""

from __future__ import annotations

import collections
import threading
from typing import Callable, List, Optional, Sequence

import torch

from larvanet_tpu_torch.ops import conv3x3
from larvanet_tpu_torch.ops import conv3x3_s8 as s8
from larvanet_tpu_torch.ops import conv_kxk as ck
from larvanet_tpu_torch.ops import dwconv3x3 as dw

ACT_NAMES = {code: name for name, code in conv3x3.ACTS.items()}
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16}
DTYPE_NAMES = {v: k for k, v in DTYPES.items()}

_OPERANDS_SIZE = 256


class _OperandCache:
    """Objects made from tensors (a ConvGroup, an S8Weight), by the tensors'
    data_ptr, version, dtype, device, shape and strides; least recently
    used first. An entry holds its tensors, so their storage stays alive
    and their pointers stay theirs."""

    def __init__(self, size: int = _OPERANDS_SIZE):
        self._items: "collections.OrderedDict[tuple, tuple]" = collections.OrderedDict()
        self._size = size
        self._lock = threading.Lock()

    def get(self, kind: str, tensors: Sequence[Optional[torch.Tensor]],
            make: Callable[[], object]):
        key = (kind,) + tuple(None if t is None else (
            t.data_ptr(), t._version, t.dtype, t.device, tuple(t.shape), t.stride())
            for t in tensors)
        with self._lock:
            hit = self._items.get(key)
            if hit is not None:
                self._items.move_to_end(key)
                return hit[1]
        made = make()
        with self._lock:
            self._items[key] = (tuple(tensors), made)
            while len(self._items) > self._size:
                self._items.popitem(last=False)
        return made


_OPERANDS = _OperandCache()


def _group(kernels: Sequence[torch.Tensor], biases: Sequence[Optional[torch.Tensor]]
           ) -> ck.ConvGroup:
    return _OPERANDS.get("group", list(kernels) + list(biases),
                         lambda: ck.ConvGroup(kernels, biases))


def _s8_weight(codes: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor) -> s8.S8Weight:
    return _OPERANDS.get("s8", [codes, scale, bias], lambda: s8.S8Weight(codes, scale, bias))


# ---- conv3x3_bias_act --------------------------------------------------------------

@torch.library.custom_op("larvanet::conv3x3_bias_act", mutates_args=(), device_types="cpu")
def _conv3x3_op(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor, act: int,
                slope: float) -> torch.Tensor:
    return conv3x3.conv3x3_bias_act_reference(x, kernel, bias, ACT_NAMES[act], slope)


@_conv3x3_op.register_kernel("cuda")
def _(x, kernel, bias, act, slope):
    return conv3x3.conv3x3_bias_act_cuda(x, kernel, bias, ACT_NAMES[act], slope)


@_conv3x3_op.register_fake
def _(x, kernel, bias, act, slope):
    conv3x3.check_operands(x, kernel, bias, ACT_NAMES.get(act, act))
    return x.new_empty(tuple(x.shape[:3]) + (kernel.shape[3],))


def conv3x3_bias_act(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor,
                     act: Optional[str], slope: float) -> torch.Tensor:
    """torch.ops.larvanet.conv3x3_bias_act in the wrapper's arguments."""
    if act not in conv3x3.ACTS:
        raise ValueError("unknown activation %r" % (act,))
    return _conv3x3_op(x, kernel, bias, conv3x3.ACTS[act], float(slope))


# ---- conv_kxk ----------------------------------------------------------------------

@torch.library.custom_op("larvanet::conv_kxk", mutates_args=(), device_types="cpu")
def _conv_kxk_op(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
                 pads: List[int]) -> torch.Tensor:
    return ck.conv_kxk_reference(x, kernel, bias, pads)


@_conv_kxk_op.register_kernel("cuda")
def _(x, kernel, bias, pads):
    pads = tuple(pads)
    return ck.conv_kxk_cuda(x, _group([kernel], [bias]), pads)


@_conv_kxk_op.register_fake
def _(x, kernel, bias, pads):
    pads = ck.check_conv(x, kernel, bias, pads, cuda=False)
    ho, wo = ck.out_size(x.shape[1], x.shape[2], kernel.shape[0], kernel.shape[1], pads)
    return x.new_empty((x.shape[0], ho, wo, kernel.shape[3]))


def conv_kxk(x: torch.Tensor, kernel: torch.Tensor, bias: Optional[torch.Tensor],
             pads: Sequence[int]) -> torch.Tensor:
    """torch.ops.larvanet.conv_kxk in the wrapper's arguments."""
    return _conv_kxk_op(x, kernel, bias, [int(p) for p in pads])


@torch.library.custom_op("larvanet::conv_kxk_group", mutates_args=(), device_types="cpu")
def _conv_kxk_group_op(xs: torch.Tensor, kernels: List[torch.Tensor],
                       biases: List[Optional[torch.Tensor]], pads: List[int]) -> torch.Tensor:
    return torch.stack(ck.conv_kxk_group_reference(list(xs.unbind(0)), kernels, biases, pads))


@_conv_kxk_group_op.register_kernel("cuda")
def _(xs, kernels, biases, pads):
    return ck.conv_kxk_group_cuda(xs.contiguous(), _group(kernels, biases), tuple(pads))


@_conv_kxk_group_op.register_fake
def _(xs, kernels, biases, pads):
    if xs.dim() != 5 or xs.shape[0] != len(kernels) or len(biases) != len(kernels):
        raise ValueError("conv_kxk_group takes G stacked inputs, G kernels and G biases; got "
                         "%s, %d and %d" % (tuple(xs.shape), len(kernels), len(biases)))
    pads = ck.check_conv(xs[0].contiguous(), kernels[0], biases[0], pads, "conv_kxk_group",
                         cuda=False)
    ho, wo = ck.out_size(xs.shape[2], xs.shape[3], kernels[0].shape[0], kernels[0].shape[1],
                         pads)
    return xs.new_empty((xs.shape[0], xs.shape[1], ho, wo, kernels[0].shape[3]))


def conv_kxk_group(xs: torch.Tensor, kernels: Sequence[torch.Tensor],
                   biases: Sequence[Optional[torch.Tensor]], pads: Sequence[int]
                   ) -> torch.Tensor:
    """torch.ops.larvanet.conv_kxk_group on G inputs stacked (G, n, h, w,
    c); returns the G outputs stacked."""
    return _conv_kxk_group_op(xs, list(kernels), list(biases), [int(p) for p in pads])


# ---- conv3x3_s8 --------------------------------------------------------------------

@torch.library.custom_op("larvanet::conv3x3_s8_a", mutates_args=(), device_types="cpu")
def _s8_a_op(hin: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             s_in: float, s_mid: float, act: int, slope: float) -> torch.Tensor:
    return s8.conv_a_reference(hin, s8.S8Weight(codes, scale, bias), s_in, s_mid,
                               ACT_NAMES[act], slope)


@_s8_a_op.register_kernel("cuda")
def _(hin, codes, scale, bias, s_in, s_mid, act, slope):
    return s8.conv_a_cuda(hin, _s8_weight(codes, scale, bias), s_in, s_mid, ACT_NAMES[act],
                          slope)


@_s8_a_op.register_fake
def _(hin, codes, scale, bias, s_in, s_mid, act, slope):
    s8.check_a(hin, s8.S8Weight(codes, scale, bias), ACT_NAMES.get(act, act))
    return hin.new_empty(tuple(hin.shape[:3]) + (codes.shape[3],), dtype=torch.int8)


def conv3x3_s8_a(hin: torch.Tensor, wt: s8.S8Weight, s_in: float, s_mid: float,
                 act: Optional[str], slope: float) -> torch.Tensor:
    """torch.ops.larvanet.conv3x3_s8_a in the wrapper's arguments."""
    return _s8_a_op(hin, wt.codes, wt.scale, wt.bias, float(s_in), float(s_mid),
                    s8.ACTS[act], float(slope))


@torch.library.custom_op("larvanet::conv3x3_s8_b", mutates_args=(), device_types="cpu")
def _s8_b_op(tq: torch.Tensor, codes: torch.Tensor, scale: torch.Tensor, bias: torch.Tensor,
             dtype: str, res: Optional[torch.Tensor], res_weight: float) -> torch.Tensor:
    return s8.conv_b_reference(tq, s8.S8Weight(codes, scale, bias), DTYPES[dtype], res,
                               res_weight)


@_s8_b_op.register_kernel("cuda")
def _(tq, codes, scale, bias, dtype, res, res_weight):
    return s8.conv_b_cuda(tq, _s8_weight(codes, scale, bias), DTYPES[dtype], res, res_weight)


@_s8_b_op.register_fake
def _(tq, codes, scale, bias, dtype, res, res_weight):
    if dtype not in DTYPES:
        raise TypeError("conv_b writes float32 or bfloat16, got %s" % (dtype,))
    s8.check_b(tq, s8.S8Weight(codes, scale, bias), DTYPES[dtype], res)
    return tq.new_empty(tuple(tq.shape[:3]) + (codes.shape[3],), dtype=DTYPES[dtype])


def conv3x3_s8_b(tq: torch.Tensor, wt: s8.S8Weight, dtype: torch.dtype,
                 res: Optional[torch.Tensor], res_weight: float) -> torch.Tensor:
    """torch.ops.larvanet.conv3x3_s8_b in the wrapper's arguments."""
    if dtype not in DTYPE_NAMES:
        raise TypeError("conv_b writes float32 or bfloat16, got %s" % (dtype,))
    return _s8_b_op(tq, wt.codes, wt.scale, wt.bias, DTYPE_NAMES[dtype], res,
                    float(res_weight))


# ---- dwconv3x3 ---------------------------------------------------------------------

@torch.library.custom_op("larvanet::dwconv3x3", mutates_args=(), device_types="cpu")
def _dw_op(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    return dw.dwconv3x3_reference(x, kernel, bias)


@_dw_op.register_kernel("cuda")
def _(x, kernel, bias):
    return dw.dwconv3x3_cuda(x, kernel, bias)


@_dw_op.register_fake
def _(x, kernel, bias):
    dw.check_operands(x, kernel, bias)
    return torch.empty_like(x)


def dwconv3x3(x: torch.Tensor, kernel: torch.Tensor, bias: torch.Tensor) -> torch.Tensor:
    """torch.ops.larvanet.dwconv3x3 in the wrapper's arguments."""
    return _dw_op(x, kernel, bias)
