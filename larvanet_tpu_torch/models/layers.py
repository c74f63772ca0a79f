"""Shared building blocks, NHWC (counterparts of larvanet_tpu/models/layers.py).

Parameters carry the reference PyTorch repo's state_dict names, so a
reference `.pth` (or one exported by the JAX package) loads with
`strict=True`. Every 3x3 conv goes through `ops.conv3x3`, which is the
hand-written CUDA kernel on the card; where a gradient is wanted, through
its `Conv3x3Train`, whose backward runs on hand-written kernels too.

Init parity, drawn from an explicit `torch.Generator`: torch's Conv2d
default, kaiming_uniform_(a=sqrt(5)) for the weight and U(-1/sqrt(fan_in),
1/sqrt(fan_in)) for the bias; or, with `init_scale=s`, the LarvaNet
family's kaiming_normal_(fan_in) times s with a zero bias
(`kaiming_normal_scaled`, layers.py:69-78).
"""

from __future__ import annotations

import math
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from larvanet_tpu_torch.ops.conv3x3 import Conv3x3Train, conv3x3_bias_act
from larvanet_tpu_torch.ops.conv_kxk import conv_kxk_op
from larvanet_tpu_torch.ops.dwconv3x3 import dwconv3x3_op
from larvanet_tpu_torch.ops.pixel_shuffle import PixelShuffle

# RGB mean used by every MeanShift in the zoo (reference models/edsr.py:181)
DIV2K_RGB_MEAN = (114.4, 111.5, 103.0)


def activation(name: Optional[str], slope: float = 0.1):
    """The activation `name` as a function (get_activation, layers.py:116-125):
    None / "none" / "linear" the identity, "relu", "relu6" (clip to [0, 6]),
    "leaky_relu" at negative slope `slope`. The convs take it fused in the
    kernel's epilogue instead (`Conv3x3(act=...)`)."""
    if name in (None, "none", "linear"):
        return lambda x: x
    if name == "relu":
        return torch.relu
    if name == "relu6":
        return lambda x: torch.clamp(x, 0.0, 6.0)
    if name == "leaky_relu":
        return lambda x: torch.where(x >= 0, x, x * slope)
    raise ValueError("unknown activation %r" % (name,))


def _draw_weight(weight: torch.Tensor, bias: torch.Tensor, fan_in: int,
                 generator: Optional[torch.Generator], init_scale: Optional[float]) -> None:
    """torch's Conv2d default init (init_scale None), or kaiming_normal_scaled(s)
    with a zero bias."""
    if init_scale is None:
        bound = 1.0 / math.sqrt(fan_in)
        weight.uniform_(-bound, bound, generator=generator)
        bias.uniform_(-bound, bound, generator=generator)
    else:
        weight.normal_(0.0, init_scale * math.sqrt(2.0 / fan_in), generator=generator)
        bias.zero_()


class MeanShift(nn.Module):
    """Frozen 1x1 RGB affine, out = M x + b (layers.py:136-164).

    M (as the reference's (3, 3, 1, 1) conv weight) and b are buffers:
    they are in the state_dict but not among the parameters. Built as
    the intended +/-mean shift (M = I, b = sign * mean); loading a
    state_dict replaces them, so the random frozen affines of genuine
    reference checkpoints (utils/torch_convert.py:290-371 in the JAX
    package) are computed exactly, at the same pre-padding position.
    """

    def __init__(self, sign: float):
        super().__init__()
        self.sign = sign
        self.register_buffer("weight", torch.eye(3).reshape(3, 3, 1, 1))
        self.register_buffer("bias", sign * torch.tensor(DIV2K_RGB_MEAN))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # in x's dtype: a bf16 train step shifts in bf16, as JAX's does
        return x @ self.weight.reshape(3, 3).t().to(x.dtype) + self.bias.to(x.dtype)

    def intended(self) -> bool:
        """Whether M and b are still the intended shift (M = I, b = sign x
        DIV2K mean). A restored reference checkpoint may carry a trained,
        non-identity affine: then the graphs that bake the intended shift
        (EDSR's collapsed tail, REGO's int8 forward) are not taken
        (larvanet_tpu/models/base.py:808-839, ops/fastpath.py:76-84)."""
        return (torch.equal(self.weight.detach().float().cpu(), torch.eye(3).reshape(3, 3, 1, 1))
                and torch.equal(self.bias.detach().float().cpu(),
                                self.sign * torch.tensor(DIV2K_RGB_MEAN)))


def inverse_shift_lr(shift: MeanShift, h: torch.Tensor) -> torch.Tensor:
    """A MeanShift on a pre-shuffle output: its channels are (RGB, scale^2
    sub-pixels) in pixel_shuffle's order, and the shift acts on each
    sub-pixel's RGB triple (the LR-domain losses)."""
    n, hh, ww, c = h.shape
    rgb = h.reshape(n, hh, ww, 3, c // 3).transpose(3, 4)
    return shift(rgb).transpose(3, 4).reshape(n, hh, ww, c)


def mean_shifts_intended(module) -> bool:
    """Whether both of EDSR's MeanShifts (`mean_shift`, `mean_inverse_shift`)
    are the intended +/-mean shifts (`MeanShift.intended`)."""
    return module.mean_shift.intended() and module.mean_inverse_shift.intended()


class Conv3x3(nn.Module):
    """SAME 3x3 conv + bias, with an optional activation fused into the
    kernel's epilogue (`act`: None, relu, relu6, or leaky_relu at `slope`,
    as ops.conv3x3 takes them). Holds the OIHW `weight` and `bias` of torch's
    Conv2d; hands the kernel the HWIO view. `init_scale` None draws torch's
    Conv2d default; a float s draws `kaiming_normal_scaled(s)`. Under
    no_grad, or when neither x nor a parameter requires grad (serving),
    the direct call; else the differentiable `Conv3x3Train`. A weight of
    another dtype than x is cast to x's first, and so is the bias
    (`--train_dtype bf16`: the f32 master weights of a bf16 step, as JAX's
    `jnp.asarray(p, bf16)`; the cast's backward takes the bf16 gradient
    back to f32)."""

    def __init__(self, in_features: int, out_features: int,
                 act: Optional[str] = None,
                 generator: Optional[torch.Generator] = None,
                 init_scale: Optional[float] = None, slope: float = 0.1):
        super().__init__()
        self.act = act
        self.slope = slope
        weight = torch.empty(out_features, in_features, 3, 3)
        bias = torch.empty(out_features)
        _draw_weight(weight, bias, in_features * 9, generator, init_scale)
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel, bias = self.weight.permute(2, 3, 1, 0), self.bias
        if kernel.dtype != x.dtype:
            kernel, bias = kernel.to(x.dtype), bias.to(x.dtype)
        if torch.is_grad_enabled() and (x.requires_grad or self.weight.requires_grad
                                        or self.bias.requires_grad):
            return Conv3x3Train.apply(x, kernel, bias, self.act, self.slope)
        return conv3x3_bias_act(x, kernel, bias, self.act, slope=self.slope)


class ConvKxK(nn.Module):
    """SAME KxK conv + bias for K other than 3 (HRSR's --hr_filter_size),
    torch's (F, C, K, K) weight, on ops.conv_kxk (its `ConvKxKTrain` where a
    gradient is wanted) with XLA's SAME pads: low (K - 1) // 2, high the
    rest (flax's padding="SAME", which puts an even kernel's extra pad
    below and right). The kernel has no activation epilogue, so `act` runs
    after it in torch. Init as Conv3x3's (fan_in C K K)."""

    def __init__(self, in_features: int, out_features: int, kernel_size: int,
                 act: Optional[str] = None,
                 generator: Optional[torch.Generator] = None,
                 init_scale: Optional[float] = None, slope: float = 0.1):
        super().__init__()
        self.act = act
        self.slope = slope
        k = kernel_size
        weight = torch.empty(out_features, in_features, k, k)
        bias = torch.empty(out_features)
        _draw_weight(weight, bias, in_features * k * k, generator, init_scale)
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)
        low = (k - 1) // 2
        self.pads = (low, k - 1 - low, low, k - 1 - low)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel, bias = self.weight.permute(2, 3, 1, 0), self.bias
        if kernel.dtype != x.dtype:
            kernel, bias = kernel.to(x.dtype), bias.to(x.dtype)
        return activation(self.act, self.slope)(conv_kxk_op(x, kernel, bias, self.pads))


class ResBlock(nn.Module):
    """conv -> act -> conv, times res_weight, plus the identity
    (layers.py:167-196, reference models/edsr.py:139-153).

    `body` keeps the reference's Sequential indices so the keys are
    body.0 / body.2; index 1, the activation (ReLU, or MSRR's ablations'
    relu6 and leaky_relu at `slope`), runs fused in body.0's kernel.
    `init_scale` as in Conv3x3 (0.1 in the LarvaNet and MSRR families).
    `kernel_size` other than 3 (HRSR's HR blocks) makes both convs
    `ConvKxK`s."""

    def __init__(self, features: int, res_weight: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 init_scale: Optional[float] = None, activation: str = "relu",
                 slope: float = 0.1, kernel_size: int = 3):
        super().__init__()
        self.res_weight = res_weight

        def conv(act):
            if kernel_size == 3:
                return Conv3x3(features, features, act=act, generator=generator,
                               init_scale=init_scale, slope=slope)
            return ConvKxK(features, features, kernel_size, act=act, generator=generator,
                           init_scale=init_scale, slope=slope)

        self.body = nn.ModuleList([conv(activation), nn.Identity(), conv(None)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return exact_pair(0, x, self.body[0], self.body[2], res_weight=self.res_weight)


def exact_pair(idx: int, hin: torch.Tensor, conv1: nn.Module, conv2: nn.Module,
               kind: str = "res", res_weight: float = 1.0) -> torch.Tensor:
    """A conv pair as the modules run it: conv1 (its act fused), conv2,
    times res_weight when it is not 1, plus hin for kind 'res' ('none': no
    skip; 'both': the pair (t, hin + t), REGO's RESBlock). The default
    `pair` of the family walks (EDSRModule.forward, LarvaNetModule.walk,
    ...), which hand every ResBlock and leg pair to a pair runner with its
    index `idx` (unused here): the fused Winograd route, the int8
    calibration and replay, QAT (ops/wino_resblock.py, ops/pairs.py)."""
    t = conv2(conv1(hin))
    if res_weight != 1.0:
        t = t * res_weight
    if kind == "both":
        return t, hin + t
    return hin + t if kind == "res" else t


class UpsampleBlock(nn.Module):
    """[conv3x3(C -> 4C) -> PixelShuffle(2)] x log2(scale) for x2/x4/x8,
    one conv3x3(C -> 9C) -> PixelShuffle(3) for x3 (layers.py:230-265).
    The convs sit at body.0, body.2, ... as in the reference.

    `activation` (MSRR's leaky_relu, reference models/msrr.py:188-205): the
    activation after every x2 shuffle, between the stages and after the
    last (MSRRModule applies that one, msrr.py:72), none for x3; it runs
    fused in each stage's conv, since an elementwise activation commutes
    with the shuffle. Each stage is then [conv, shuffle, activation] and
    the convs sit at body.0, body.3, ... as in the reference's MSRR
    Sequential (torch_convert.py:555-564)."""

    def __init__(self, features: int, scale: int,
                 generator: Optional[torch.Generator] = None,
                 activation: Optional[str] = None, init_scale: Optional[float] = None):
        super().__init__()
        if scale in (2, 4, 8):
            stages = []
            for _ in range(int(math.log2(scale))):
                stages += [Conv3x3(features, 4 * features, act=activation,
                                   generator=generator, init_scale=init_scale),
                           PixelShuffle(2)]
                if activation is not None:
                    stages.append(nn.Identity())
        elif scale == 3:
            stages = [Conv3x3(features, 9 * features, generator=generator,
                              init_scale=init_scale),
                      PixelShuffle(3)]
        else:
            raise ValueError("unsupported scale %d" % (scale,))
        self.body = nn.Sequential(*stages)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.body(x)


class ConvShuffle(nn.Module):
    """A conv, then PixelShuffle(scale): the reference's Sequential(conv,
    PixelShuffle), whose conv's keys are body.0 (REGO's SRrecon, ebrn_rm's
    upsample)."""

    def __init__(self, conv: nn.Module, scale: int):
        super().__init__()
        self.body = nn.Sequential(conv, PixelShuffle(scale))


class PReLU(nn.Module):
    """Per-channel PReLU, torch's nn.PReLU(C) with its key `weight` and
    slopes 0.25 (layers.py:268-276): x where x >= 0, else x times its
    channel's slope, on NHWC in x's dtype. An XLA op in JAX, outside every
    Pallas kernel, so plain PyTorch here."""

    def __init__(self, features: int):
        super().__init__()
        self.weight = nn.Parameter(torch.full((features,), 0.25))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.where(x >= 0, x, x * self.weight.to(x.dtype))


def _nchw(x: torch.Tensor) -> torch.Tensor:
    return x.permute(0, 3, 1, 2)  # a channels_last view of NHWC


def _nhwc(y: torch.Tensor) -> torch.Tensor:
    return y.permute(0, 2, 3, 1).contiguous()


class UpProjection(nn.Module):
    """EBRN's up-projection: torch's ConvTranspose2d(C, F, k, stride=s,
    padding=p), its weight (C, F, k, k) as the reference stores it, the
    output (H - 1) s - 2 p + k a side (k/s/p 8/4/2, 7/3/2, 6/2/2 at x4, x3,
    x2: s H). JAX computes it as a conv of the s-dilated input with the
    flipped kernel and pads k - 1 - p (layers.py:279-311); here it is
    F.conv_transpose2d, a library conv, as it is an XLA op in JAX. Init:
    U(-1/sqrt(C k k), 1/sqrt(C k k)) for the weight and the bias, JAX's."""

    def __init__(self, in_features: int, out_features: int, kernel_size: int, stride: int,
                 padding: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        k = kernel_size
        self.stride, self.padding = stride, padding
        weight = torch.empty(in_features, out_features, k, k)
        bias = torch.empty(out_features)
        _draw_weight(weight, bias, in_features * k * k, generator, None)
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv_transpose2d(_nchw(x), self.weight.to(x.dtype), self.bias.to(x.dtype),
                               stride=self.stride, padding=self.padding)
        return _nhwc(y)


class DownProjection(nn.Module):
    """EBRN's strided down-projection: torch's Conv2d(C, F, k, stride=s,
    padding=p) (ebrn.py:66-67), F.conv2d, a library conv, as it is an XLA
    op in JAX; torch's Conv2d default init."""

    def __init__(self, in_features: int, out_features: int, kernel_size: int, stride: int,
                 padding: int, generator: Optional[torch.Generator] = None):
        super().__init__()
        k = kernel_size
        self.stride, self.padding = stride, padding
        weight = torch.empty(out_features, in_features, k, k)
        bias = torch.empty(out_features)
        _draw_weight(weight, bias, in_features * k * k, generator, None)
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.conv2d(_nchw(x), self.weight.to(x.dtype), self.bias.to(x.dtype),
                     stride=self.stride, padding=self.padding)
        return _nhwc(y)


def interpolated_base(x: torch.Tensor, scale: int, method: str = "bicubic") -> torch.Tensor:
    """The residual 'base' image of the LarvaNet family, NHWC:
    F.interpolate(x, scale, mode, align_corners=False) (layers.py:314-317,
    ops/resize.py:120-140; bicubic with torch's A = -0.75, nearest is
    floor-index). Bicubic and bilinear run in f32 whatever x's dtype: the
    JAX resampler multiplies x by f32 weights, which promotes a bf16 frame,
    so its base is f32 from the bf16-rounded input; nearest copies pixels
    and keeps x's dtype, as in JAX."""
    if method not in ("bicubic", "bilinear", "nearest"):
        raise ValueError("unsupported interpolation method: %r" % (method,))
    nchw = x.permute(0, 3, 1, 2)  # a channels_last view of NHWC
    if method == "nearest":
        out = F.interpolate(nchw, scale_factor=scale, mode="nearest")
    else:
        out = F.interpolate(nchw.float(), scale_factor=scale, mode=method,
                            align_corners=False)
    return out.permute(0, 2, 3, 1).contiguous()


class DepthwiseConv3x3(nn.Module):
    """SAME depthwise 3x3 conv + bias (groups = C): torch's (C, 1, 3, 3)
    weight, handed to ops.dwconv3x3 as flax's HWIO (3, 3, 1, C), the
    hand-written kernel on the card (its Function where a gradient is
    wanted). A weight of another dtype than x is cast to x's first, as
    Conv3x3's is."""

    def __init__(self, features: int, generator: Optional[torch.Generator] = None,
                 init_scale: Optional[float] = None):
        super().__init__()
        weight = torch.empty(features, 1, 3, 3)
        bias = torch.empty(features)
        _draw_weight(weight, bias, 9, generator, init_scale)
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        kernel, bias = self.weight.permute(2, 3, 1, 0), self.bias
        if kernel.dtype != x.dtype:
            kernel, bias = kernel.to(x.dtype), bias.to(x.dtype)
        return dwconv3x3_op(x, kernel, bias)


class Conv1x1(nn.Module):
    """Pointwise conv + bias, torch's (F, C, 1, 1) weight: a plain (N H W, C)
    x (C, F) product (torch.matmul, as JAX leaves it to XLA), then the
    bias, in x's dtype."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None,
                 init_scale: Optional[float] = None):
        super().__init__()
        weight = torch.empty(out_features, in_features, 1, 1)
        bias = torch.empty(out_features)
        _draw_weight(weight, bias, in_features, generator, init_scale)
        self.weight = nn.Parameter(weight)
        self.bias = nn.Parameter(bias)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        w = self.weight[:, :, 0, 0].t().to(x.dtype)
        return torch.matmul(x, w) + self.bias.to(x.dtype)


class MAMLayer(nn.Module):
    """MAMNet's multi-path adaptive modulation (larvanet_tpu/models/mamnet.py:
    27-46, reference models/mamnet.py:151-172): x * sigmoid(CSI + ICD + CSD).
    CSI is each channel's spatial variance (ddof 1, over max(H W - 1, 1)),
    taken in f32 in two passes (the mean, then the squared deviations) and
    cast to x's dtype; ICD the 1x1 squeeze-excite (F -> F // reduction, ReLU,
    -> F) of that (N, 1, 1, F) variance on `Conv1x1` (`torch.matmul`, as
    JAX leaves it to XLA); CSD the depthwise 3x3 conv of x on the
    hand-written kernel (`DepthwiseConv3x3`; its Function where a gradient
    is wanted). The sum, the sigmoid and the product are plain PyTorch in
    x's dtype. The keys are the reference's conv_du.0 / conv_du.2 (index
    1, the ReLU) and depthwise_conv2d."""

    def __init__(self, features: int, reduction: int = 16,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        squeeze = features // reduction
        self.conv_du = nn.ModuleList([Conv1x1(features, squeeze, generator), nn.Identity(),
                                      Conv1x1(squeeze, features, generator)])
        self.depthwise_conv2d = DepthwiseConv3x3(features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        n_pix = x.shape[1] * x.shape[2]
        xf = x.float()
        mean = xf.mean(dim=(1, 2), keepdim=True)
        var = ((xf - mean) ** 2).sum(dim=(1, 2), keepdim=True) / max(n_pix - 1, 1)
        var = var.to(x.dtype)
        icd = self.conv_du[2](torch.relu(self.conv_du[0](var)))
        csd = self.depthwise_conv2d(x)
        return x * torch.sigmoid(var + icd + csd)


class DepthwiseSeparableResBlock(nn.Module):
    """dw3x3 -> pw1x1 -> act -> dw3x3 -> pw1x1, plus the identity
    (layers.py:199-227, reference models/dwsr_reduced.py
    DepthWiseResidualBlock), every conv 0.1-scaled Kaiming with a zero
    bias. The keys are the reference's body.0 / 1 / 3 / 4 (torch_convert.py:
    649-656); index 2, the activation, runs after the pointwise product."""

    def __init__(self, features: int, generator: Optional[torch.Generator] = None,
                 activation_name: str = "relu", init_scale: Optional[float] = 0.1):
        super().__init__()
        g = generator
        self.act = activation(activation_name)
        self.body = nn.ModuleList([
            DepthwiseConv3x3(features, g, init_scale), Conv1x1(features, features, g, init_scale),
            nn.Identity(),
            DepthwiseConv3x3(features, g, init_scale), Conv1x1(features, features, g, init_scale),
        ])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b = self.body
        res = self.act(b[1](b[0](x)))
        return x + b[4](b[3](res))


class ConvPairResBlock(nn.Module):
    """msrr_test's ResBlock: conv1 -> ReLU (fused) -> conv2, times
    res_weight, plus the identity, with the reference's keys conv1 / conv2
    (recon_trunk.N.conv1, torch_convert.py:640-646)."""

    def __init__(self, features: int, res_weight: float = 1.0,
                 generator: Optional[torch.Generator] = None,
                 init_scale: Optional[float] = None):
        super().__init__()
        self.res_weight = res_weight
        self.conv1 = Conv3x3(features, features, act="relu", generator=generator,
                             init_scale=init_scale)
        self.conv2 = Conv3x3(features, features, generator=generator, init_scale=init_scale)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return exact_pair(0, x, self.conv1, self.conv2, res_weight=self.res_weight)
