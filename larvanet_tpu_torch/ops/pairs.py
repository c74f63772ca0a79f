"""Conv-pair runners: calibrating / int8 (W8A8) / QAT fake-quant.

The port's counterpart of larvanet_tpu/ops/packed/pairs.py. A family walk
(EDSRModule.forward, LarvaNetModule.walk) calls `pair(idx, hin, conv1,
conv2, kind=..., res_weight=...)` for each conv pair, conv1 and conv2 the
pair's `Conv3x3` modules (conv1's fused activation is the pair's act); the
runner decides the arithmetic (the walks' default, models/layers.exact_pair,
runs the modules). kind: 'res' (conv-act-conv + skip add), 'none' (no
skip) or 'both' (the pair (t, hin + t), REGO's RESBlock). JAX runs its
pairs on a width-packed layout; the port keeps NHWC, and both give the
same integers: a packed weight column holds every original
tap of its channel, so the per-channel weight scales are the same, and the
packed grid1 mask is the SAME conv's zero padding.

  * `PairRunner(dtype)` (JAX's `make_pair_runner`): `calib` runs the exact pair
    and records max|hin| and max|act(conv_a)| per pair index; `finish(pairs)`
    quantizes each pair's f32 weights (`quantize_pair_weights`) with s_in =
    max * 1.05 / 127 and s_mid likewise (no +1e-12); `int8` replays the
    pair W8A8 on the conv3x3_s8 kernel (`csrc/conv3x3_s8.cu`), bit for bit
    JAX's `pair_int8` given the same records (`load_jax_records`).
  * `make_int8(model, calib, dtype, walk, pairs)`: one calibration pass of
    the walk, then the forward that replays it with the int8 pair.
  * `qat_pair(dtype)`: the int8 pair emulated in float with straight-through
    rounding for training (`--qat 1`): per-batch activation scales with
    +1e-12 and weight scales from the live weights, both detached, on the
    conv3x3 kernels' autograd Function.
  * `remat_pair(pair)` (`--remat 1`): the pair under
    `torch.utils.checkpoint` (non-reentrant): the backward recomputes the
    pair's activations instead of keeping them, so a step's peak memory
    holds one pair's, not the trunk's. The recomputed forward runs the same
    kernels on the same inputs, so the gradients are those of the plain
    pair bit for bit. `training_pair` picks a train step's pair as JAX's
    `_training_pair` does.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from larvanet_tpu_torch.ops import conv3x3_s8 as s8
from larvanet_tpu_torch.ops.conv3x3 import conv3x3_op

HEADROOM = 1.05  # activation scale = HEADROOM * max / 127 (pairs.py:210-211)


def _hwio(conv) -> torch.Tensor:
    return conv.weight.permute(2, 3, 1, 0)


def _finish(hin: torch.Tensor, t: torch.Tensor, kind: str, res_weight: float):
    """t times res_weight (rounded to t's dtype first, as JAX's weak-typed
    scalar is) when it is not 1, plus hin for kind 'res'; (t, hin + t) for
    kind 'both'."""
    if res_weight != 1.0:
        t = t * torch.tensor(res_weight, dtype=t.dtype, device=t.device)
    if kind == "both":
        return t, hin + t
    return hin + t if kind == "res" else t


def quantize_pair_weights(conv1, conv2, dtype: torch.dtype) -> Dict[str, object]:
    """One pair's int8 weights (`_quantize_pair_weights`, pairs.py:169-182):
    per-output-channel codes and scales of each conv's f32 kernel, and the
    biases rounded to `dtype`. Returns {ka, sa, ba, kb, sb, bb}: ka, kb int8
    HWIO numpy, sa, sb f32 numpy, ba, bb tensors."""
    ka, sa = s8.quantize_weight(_hwio(conv1).detach().float().cpu().numpy())
    kb, sb = s8.quantize_weight(_hwio(conv2).detach().float().cpu().numpy())
    return dict(ka=ka, sa=sa, ba=conv1.bias.detach().to(dtype),
                kb=kb, sb=sb, bb=conv2.bias.detach().to(dtype))


@dataclass
class QuantPair:
    """One quantized pair: the activation scales (floats, as JAX keeps them)
    and the two convs' S8Weights (codes, f32(s) * sa, bias)."""

    s_in: float
    s_mid: float
    a: s8.S8Weight
    b: s8.S8Weight
    act: Optional[str] = "relu"
    slope: float = 0.1


def quant_pair(q: Dict[str, object], s_in: float, s_mid: float, dtype: torch.dtype,
               device, act: Optional[str] = "relu", slope: float = 0.1) -> QuantPair:
    """A QuantPair from `quantize_pair_weights`' record and the scales; `act`
    and `slope` are conv1's."""
    return QuantPair(s_in, s_mid,
                     s8.make_weight(q["ka"], q["sa"], s_in, torch.as_tensor(q["ba"]), dtype,
                                    device),
                     s8.make_weight(q["kb"], q["sb"], s_mid, torch.as_tensor(q["bb"]), dtype,
                                    device), act, slope)


def load_jax_records(records: Sequence[Dict[str, np.ndarray]], dtype: torch.dtype,
                     device, act: Optional[str] = "relu",
                     slope: float = 0.1) -> List[QuantPair]:
    """JAX's quantized pair records (make_pair_runner's `quant`: ka, sa, ba,
    kb, sb, bb, s_in, s_mid, as numpy; ka and kb packed) as the port's
    QuantPairs (`torch_convert.unpack_jax_pair_record` unpacks them), each
    with the activation `act` (leaky_relu at `slope`), which JAX's walk
    hands its pair and its records do not keep."""
    from larvanet_tpu_torch.utils.torch_convert import unpack_jax_pair_record

    out = []
    for rec in records:
        q = unpack_jax_pair_record(rec)
        q["ba"] = torch.from_numpy(q["ba"]).to(dtype)
        q["bb"] = torch.from_numpy(q["bb"]).to(dtype)
        out.append(quant_pair(q, q["s_in"], q["s_mid"], dtype, device, act, slope))
    return out


def int8_pair(q: QuantPair, hin: torch.Tensor, kind: str = "res",
              res_weight: float = 1.0):
    """The W8A8 pair on the conv3x3_s8 kernel (plain version on the CPU):
    conv_a quantizes hin with s_in and requantizes act(conv + bias) with
    s_mid; conv_b dequantizes, scales and adds the skip in hin's dtype.
    Kind 'both' (pair_int8, pairs.py:249-253): conv_b without the skip,
    then (t, hin + t), the add in hin's dtype."""
    tq = s8.conv_a(hin, q.a, q.s_in, q.s_mid, q.act, q.slope)
    t = s8.conv_b(tq, q.b, hin.dtype, res=hin if kind == "res" else None,
                  res_weight=res_weight)
    return (t, hin + t) if kind == "both" else t


@dataclass
class PairRunner:
    """make_pair_runner (pairs.py:185-256): `calib` records per-pair maxima
    during one exact walk, `finish(pairs)` quantizes, `int8` replays. The
    records are keyed by pair index, so a calibration walk whose order
    diverges from `finish`'s list raises."""

    dtype: torch.dtype
    record: Dict[int, Tuple[torch.Tensor, torch.Tensor]] = field(default_factory=dict)
    quant: List[QuantPair] = field(default_factory=list)

    def calib(self, idx, hin, conv1, conv2, kind="res", res_weight=1.0):
        if idx in self.record:
            raise ValueError("pair index %d calibrated twice" % idx)
        m_in = hin.abs().max().float()
        t = conv1(hin)
        self.record[idx] = (m_in, t.abs().max().float())
        return _finish(hin, conv2(t), kind, res_weight)

    def finish(self, pairs: Sequence[Tuple[torch.nn.Module, torch.nn.Module]]) -> None:
        """Quantize `pairs` ((conv1, conv2) of the f32 module, in index
        order) with the recorded maxima."""
        if sorted(self.record) != list(range(len(pairs))):
            raise ValueError("calibration walked pair indices %r but finish() got %d pairs"
                             % (sorted(self.record), len(pairs)))
        for i, (conv1, conv2) in enumerate(pairs):
            q = quantize_pair_weights(conv1, conv2, self.dtype)
            s_in = float(self.record[i][0]) * HEADROOM / 127.0
            s_mid = float(self.record[i][1]) * HEADROOM / 127.0
            self.quant.append(quant_pair(q, s_in, s_mid, self.dtype, conv1.weight.device,
                                         conv1.act, conv1.slope))

    def int8(self, idx, hin, conv1, conv2, kind="res", res_weight=1.0):
        return int8_pair(self.quant[idx], hin, kind, res_weight)


def even_calib(calib_batch, device) -> torch.Tensor:
    """An int8 calibration batch (NHWC) as an f32 tensor on `device`; even
    width required (`_even_calib`, core.py:301-310): a padded column would
    inflate the recorded maxima."""
    calib = torch.from_numpy(np.ascontiguousarray(calib_batch, np.float32))
    if calib.shape[2] % 2:
        raise ValueError("int8 calibration batch must have even width (got %d); crop a "
                         "column first" % calib.shape[2])
    return calib.to(device)


def make_int8(model, calib_batch, dtype: torch.dtype, walk: Callable, pairs) -> Callable:
    """`_make_int8` (pairs.py:150-166): one calibration pass of `walk` over
    `calib_batch` in `dtype`, `finish(pairs)`, and the forward that replays
    the walk with the int8 pair. The forward takes an NHWC batch on the
    model's device and refuses an odd width, as JAX's does."""
    runner = PairRunner(dtype)
    with torch.no_grad():
        walk(even_calib(calib_batch, model.device).to(dtype), runner.calib)
    runner.finish(pairs)

    def forward(x: torch.Tensor) -> torch.Tensor:
        if x.shape[2] % 2:
            raise ValueError("int8 trunk requires even width")
        with torch.no_grad():
            return walk(x.to(dtype).contiguous(), runner.int8)

    forward.runner = runner
    return forward


# ---- quantization-aware training ----

def ste_round(x: torch.Tensor) -> torch.Tensor:
    """round() with a straight-through gradient (pairs.py:48-51)."""
    return x + (torch.round(x) - x).detach()


def clip127(y: torch.Tensor) -> torch.Tensor:
    """clip(y, -127, 127) with jnp.clip's gradient: 1 inside, 0 outside and
    1/2 at the ends, where its max and min tie (torch.clamp passes 1 there).
    A channel's largest weight lands on the end: max|k| / sa is 127 when the
    +1e-12 of sa is below its f32 step."""
    edge = y.abs() == 127.0
    return torch.where(edge, 0.5 * y + 0.5 * y.detach(), torch.clamp(y, -127.0, 127.0))


def fake_quant(x: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """Symmetric fake-quantization onto the int8 grid with step `s`
    (pairs.py:54-58): the clip's zero gradient outside [-127 s, 127 s] is
    the int8 path's saturation."""
    return ste_round(clip127(x / s)) * s


def _act_scale(t: torch.Tensor) -> torch.Tensor:
    return t.detach().abs().max().float() * HEADROOM / 127.0 + 1e-12


def qat_pair(dtype: torch.dtype = torch.float32) -> Callable:
    """The QAT pair (`qat_pair`, pairs.py:61-114): pair_int8's W8A8 in float
    with straight-through rounding. Weight scales max|k| / 127 + 1e-12 per
    output channel of the live f32 weights, activation scales 1.05 max /
    127 + 1e-12 of this batch, all detached; both convs on the conv3x3
    kernels (`Conv3x3Train`). An odd width raises, as the int8 path it
    trains for is even-width only."""

    def pair(idx, hin, conv1, conv2, kind="res", res_weight=1.0):
        if hin.shape[2] % 2:
            raise ValueError("--qat requires an even patch width (the int8 serving path "
                             "it trains for is even-width only); got width %d"
                             % hin.shape[2])
        ka, kb = _hwio(conv1).float(), _hwio(conv2).float()
        sa = ka.detach().abs().amax(dim=(0, 1, 2)) / 127.0 + 1e-12
        sb = kb.detach().abs().amax(dim=(0, 1, 2)) / 127.0 + 1e-12
        x = fake_quant(hin.float(), _act_scale(hin)).to(dtype)
        t = conv3x3_op(x, fake_quant(ka, sa).to(dtype), conv1.bias.to(dtype), conv1.act,
                       conv1.slope)
        t = fake_quant(t.float(), _act_scale(t)).to(dtype)
        t = conv3x3_op(t, fake_quant(kb, sb).to(dtype), conv2.bias.to(dtype), conv2.act,
                       conv2.slope)
        return _finish(hin, t, kind, res_weight)

    return pair


def remat_pair(pair: Callable) -> Callable:
    """`pair` with its activations recomputed in the backward (remat_pair,
    larvanet_tpu/ops/packed/pairs.py:117-136); a 'both' pair's two outputs
    come back as the checkpointed function's tuple."""
    from torch.utils.checkpoint import checkpoint

    def wrapped(idx, hin, conv1, conv2, kind="res", res_weight=1.0):
        if not torch.is_grad_enabled():
            return pair(idx, hin, conv1, conv2, kind=kind, res_weight=res_weight)
        return checkpoint(lambda h: pair(idx, h, conv1, conv2, kind=kind,
                                         res_weight=res_weight),
                          hin, use_reentrant=False)

    return wrapped


def training_pair(qat: bool, remat: bool, dtype: torch.dtype = torch.float32) -> Callable:
    """The pair a train step runs (_training_pair, pairs.py:139-144):
    `qat_pair` under --qat 1, else the modules' own pair; wrapped by
    `remat_pair` under --remat 1."""
    from larvanet_tpu_torch.models.layers import exact_pair

    pair = qat_pair(dtype) if qat else exact_pair
    return remat_pair(pair) if remat else pair
