"""The collapsed linear tail: EDSR's upsample chain as one KxK conv + shuffle.

Counterpart of larvanet_tpu/ops/collapsed_tail.py. EDSR's tail, upsample
conv (64 -> 256) -> PixelShuffle(2) -> conv (64 -> 256) -> PixelShuffle(2)
-> final conv (64 -> 3) -> inverse mean shift, has no nonlinearity, so it
is one linear, shift-invariant map from the trunk's features to the HR
image: in the interior, a (2R+1)^2 conv to 3 s^2 channels in torch's
shuffle order (c s s + i s + j) followed by one pixel shuffle. At x4 the
plain tail's convs are 10x the MACs of the collapsed 5x5 64 -> 48 conv, and
the 256-channel 2x tensor and its shuffles go away.

  * Probes (`extract_collapsed_kernel`, `extract_border_ops`): the kernel
    is the response of the original tail to per-channel delta images, the
    biases its response to zeros. The probes run on the model's device,
    through the kernels, in f32 under no_grad, with the f32 module (never a
    bf16 serving copy); the numbers come back to numpy, where the kernel
    is cut out as in JAX. `make_collapsed_tail` trims all-zero outer rings
    (the probe radius 1 + stages is a safe upper bound: 7x7 at x4 trims to
    5x5), which needs `resp - bias_resp` to cancel exactly: the conv
    kernels sum a pixel in an order that depends on neither the batch nor
    the pixel's place in a tile.
  * The border (`apply_collapsed_tail`): within r LR pixels of the border
    the plain tail's per-stage SAME padding cuts paths the collapsed conv
    keeps. At inference the exact border comes from probed operators: the
    four sides are (b + r) x (2r + 1) convs of 4-pixel strips with the strip
    rows folded into the outputs, the corners dense maps of 2b x 2b patches,
    run as 2b x 2b convs with no pads. Training (the live tail, no baked
    operators) recomputes the border with the original tail on halo strips.
    A frame with 2b >= its height or width runs the original tail.
  * `make_collapsed_edsr_forward`: EDSR's own walk (`EDSRModule.forward`)
    with the baked tail as its `tail` hook; `collapsed_edsr_tail` probes a
    model once per set of tail weights and keeps it, so the plain, int8 and
    Winograd routes share it (ops/int8_forward.py, ops/wino_resblock.py).
  * `live_collapsed_edsr_tail`: the kernel composed in the graph from the
    live tail weights (a delta batch through the chain with full padding:
    each 3x3 conv a SAME conv of its input padded by one more pixel, on
    `Conv3x3Train`), so training through the collapsed tail is loss- and
    gradient-equivalent to the plain tail; `lr_domain` returns the output
    before the shuffle for the LR-domain loss.
  * `make_collapsed_base`, `bicubic_phase_conv_kernel`,
    `make_collapsed_larvanet_forward`: the interpolated base folded into a
    conv, wired into no CLI, as in JAX (a measured negative result there).

Every conv here runs on a hand-written kernel: the 3x3 convs of the original
tail on ops/conv3x3.py, the KxK ones on ops/conv_kxk.py (corners included).
The width-packed layout of JAX (`packed=True`) is not kept, as everywhere in
the port.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from larvanet_tpu_torch.models.layers import DIV2K_RGB_MEAN, Conv3x3, interpolated_base
from larvanet_tpu_torch.ops.conv3x3 import conv3x3_op
from larvanet_tpu_torch.ops.conv_kxk import ConvGroup, conv_kxk_group, conv_kxk_op
from larvanet_tpu_torch.ops.pixel_shuffle import pixel_shuffle, pixel_unshuffle

TailFn = Callable[[torch.Tensor], torch.Tensor]


def make_probe(tail_fn: TailFn, device) -> Callable[[np.ndarray], np.ndarray]:
    """probe(x) -> tail_fn(x) for an NHWC f32 numpy batch, run on `device`
    in f32 under no_grad, back as numpy (make_cpu_probe, :46-73). The same
    callable serves the delta and the zero probes, so their rounding is the
    same and `resp - bias_resp` cancels where a delta does not reach."""

    def probe(x: np.ndarray) -> np.ndarray:
        with torch.no_grad():
            xt = torch.from_numpy(np.ascontiguousarray(x, np.float32)).to(device)
            return tail_fn(xt).float().cpu().numpy()

    return probe


def extract_collapsed_kernel(tail_fn: TailFn, in_channels: int, scale: int, radius: int,
                             device="cpu") -> np.ndarray:
    """The composed kernel (2R+1, 2R+1, C, 3 s s) of a linear tail, from one
    batched delta probe (:76-111): out[s (center - U) + i, s (center - V) +
    j, c] = K[U, V, cin, c s s + i s + j]."""
    k = 2 * radius + 1
    canvas = 4 * radius + 2  # delta centered, responses fully interior
    center = canvas // 2
    probe = make_probe(tail_fn, device)
    bias_resp = probe(np.zeros((1, canvas, canvas, in_channels), np.float32))
    deltas = np.zeros((in_channels, canvas, canvas, in_channels), np.float32)
    deltas[np.arange(in_channels), center, center, np.arange(in_channels)] = 1.0
    resps = probe(deltas) - bias_resp  # (C, canvas s, canvas s, 3)
    kernel = np.zeros((k, k, in_channels, 3 * scale * scale), np.float32)
    for u in range(-radius, radius + 1):
        for v in range(-radius, radius + 1):
            block = resps[:, scale * (center - u): scale * (center - u + 1),
                          scale * (center - v): scale * (center - v + 1), :]
            # block[cin, i, j, c] -> channel c s s + i s + j
            kernel[u + radius, v + radius] = block.transpose(0, 3, 1, 2).reshape(
                in_channels, -1)
    return kernel


def _unshuffle_np(a: np.ndarray, s: int) -> np.ndarray:
    """(..., H s, W s, 3) -> (..., H, W, 3 s s), channel c s s + i s + j."""
    lead = a.shape[:-3]
    h, w, c3 = a.shape[-3:]
    a = a.reshape(*lead, h // s, s, w // s, s, c3)
    a = np.moveaxis(a, (-4, -2), (-2, -1))
    return a.reshape(*lead, h // s, w // s, c3 * s * s)


def extract_border_ops(tail_fn: TailFn, in_channels: int, scale: int, r: int,
                       bias_tile: np.ndarray, device="cpu") -> Dict[str, object]:
    """The exact border of a linear tail as four 1-D convs and four dense
    corner maps, probed on canvases whose edges are true borders (:114-223;
    numpy, inference only). Side kernels are HWIO with the b strip rows
    folded into the outputs (y-major); corner maps are ((2b)^2 C, b^2 q),
    their rows in (y, x, c) order. The biases have the interior bias tile
    subtracted (it is added back after the stitch)."""
    b = r
    s = scale
    c = in_channels
    q = 3 * s * s
    hs = b + r
    wc = 4 * r + 2
    cc = wc // 2
    tile_q = np.asarray(bias_tile).transpose(2, 0, 1).reshape(q)  # (c, I, J)
    probe = make_probe(tail_fn, device)

    # horizontal sides (top and bottom share one probe)
    p = hs * c
    idx = np.arange(p)
    canvas = np.zeros((p, hs, wc, c), np.float32)
    canvas[idx, idx // c, cc, idx % c] = 1.0
    bias0 = probe(np.zeros((1, hs, wc, c), np.float32))
    lr = _unshuffle_np(probe(canvas) - bias0, s)            # (P, Hs, Wc, q)
    win = lr[:, :, cc - r:cc + r + 1, :].reshape(hs, c, hs, 2 * r + 1, q)  # (u, c, y, w+r, q)
    k_top = win[:, :, :b].transpose(0, 3, 1, 2, 4)[:, ::-1]  # (u, t, c, y, q)
    k_top = np.ascontiguousarray(k_top.reshape(hs, 2 * r + 1, c, b * q))
    k_bot = win[:, :, r:].transpose(0, 3, 1, 2, 4)[:, ::-1]
    k_bot = np.ascontiguousarray(k_bot.reshape(hs, 2 * r + 1, c, b * q))
    bias_lr = _unshuffle_np(bias0, s)[0]                     # (Hs, Wc, q)
    bias_top = (bias_lr[:b, cc] - tile_q).reshape(b * q)
    bias_bot = (bias_lr[r:, cc] - tile_q).reshape(b * q)

    # vertical sides (left and right)
    canvas = np.zeros((p, wc, hs, c), np.float32)
    canvas[idx, cc, idx // c, idx % c] = 1.0
    bias0v = probe(np.zeros((1, wc, hs, c), np.float32))
    lrv = _unshuffle_np(probe(canvas) - bias0v, s)           # (P, Wc, Hs, q)
    winv = lrv[:, cc - r:cc + r + 1].reshape(hs, c, 2 * r + 1, hs, q)  # (v, c, w+r, j, q)
    k_left = winv[:, :, ::-1, :b].transpose(2, 0, 1, 3, 4)   # (t, v, c, j, q)
    k_left = np.ascontiguousarray(k_left.reshape(2 * r + 1, hs, c, b * q))
    k_right = winv[:, :, ::-1, r:].transpose(2, 0, 1, 3, 4)
    k_right = np.ascontiguousarray(k_right.reshape(2 * r + 1, hs, c, b * q))
    bias_lrv = _unshuffle_np(bias0v, s)[0]                   # (Wc, Hs, q)
    bias_left = (bias_lrv[cc, :b] - tile_q).reshape(b * q)
    bias_right = (bias_lrv[cc, r:] - tile_q).reshape(b * q)

    # corners: dense operators on (2b) x (2b) patches
    n2 = 2 * b
    p3 = n2 * n2 * c
    idx = np.arange(p3)
    canvas = np.zeros((p3, n2, n2, c), np.float32)
    canvas[idx, idx // (n2 * c), (idx // c) % n2, idx % c] = 1.0
    bias0c = probe(np.zeros((1, n2, n2, c), np.float32))
    lrc = _unshuffle_np(probe(canvas) - bias0c, s)           # (P3, n2, n2, q)
    bias_c = _unshuffle_np(bias0c, s)[0]
    rows = {"t": slice(0, b), "b": slice(b, n2)}
    cols = {"l": slice(0, b), "r": slice(b, n2)}
    corner_k, corner_b = {}, {}
    for rk, rs in rows.items():
        for ck, cs in cols.items():
            corner_k[rk + ck] = np.ascontiguousarray(lrc[:, rs, cs, :].reshape(p3, b * b * q))
            corner_b[rk + ck] = (bias_c[rs, cs] - tile_q).reshape(b * b * q)
    return {"b": b, "Hs": hs, "q": q,
            "k_top": k_top, "k_bot": k_bot, "bias_top": bias_top, "bias_bot": bias_bot,
            "k_left": k_left, "k_right": k_right,
            "bias_left": bias_left, "bias_right": bias_right,
            "corner_k": corner_k, "corner_b": corner_b}


def trim_zero_rings(kernel: np.ndarray) -> np.ndarray:
    """Drop all-zero outer rings of a (k, k, C, F) kernel (:243-248)."""
    while kernel.shape[0] > 1 and not (np.any(kernel[0]) or np.any(kernel[-1])
                                       or np.any(kernel[:, 0]) or np.any(kernel[:, -1])):
        kernel = kernel[1:-1, 1:-1]
    return kernel


class BorderOps:
    """The probed border operators on a device, in one dtype, as the three
    groups that `apply_collapsed_tail` launches (`conv_kxk_group`): "rows"
    (top, bottom) and "cols" (left, right) side kernels HWIO, "corners" (tl,
    tr, bl, br) as HWIO (2b, 2b, C, b^2 q) kernels of a 2b x 2b patch; each
    group a `ConvGroup` of kernels and biases, which makes its entry operands
    at its first launch and keeps them."""

    def __init__(self, border: Dict[str, object], channels: int, device, dtype):
        self.b, self.hs, self.q = border["b"], border["Hs"], border["q"]
        n2 = 2 * self.b

        def dev(a):
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(device, dtype)

        def group(kernels, biases):
            return ConvGroup([dev(k) for k in kernels], [dev(b) for b in biases])

        self.groups = {
            "rows": group([border["k_top"], border["k_bot"]],
                          [border["bias_top"], border["bias_bot"]]),
            "cols": group([border["k_left"], border["k_right"]],
                          [border["bias_left"], border["bias_right"]]),
            "corners": group([border["corner_k"][key].reshape(n2, n2, channels, -1)
                              for key in ("tl", "tr", "bl", "br")],
                             [border["corner_b"][key] for key in ("tl", "tr", "bl", "br")])}


def apply_collapsed_tail(h: torch.Tensor, kernel, bias_tile: torch.Tensor,
                         tail_fn: TailFn, scale: int, border: Optional[BorderOps] = None,
                         lr_domain: bool = False) -> torch.Tensor:
    """The collapsed conv for the interior and the exact border frame
    (:271-480), all in h's dtype: the main conv on `conv_kxk` (through
    `ConvKxKTrain` where a gradient is wanted; `kernel` HWIO, or a baked
    tail's ConvGroup of one, which takes none), the border from `border`'s
    probed operators where they are given (b == r), else from the original
    tail on halo strips; the frame is stitched in the LR 3 s^2-channel
    domain, the interior bias tile added there, then one pixel shuffle
    (`lr_domain`: none, the output before the shuffle, every bias
    included)."""
    r = kernel.shape[0] // 2
    n, hh, ww, _ = h.shape
    s = scale
    tile = bias_tile.to(h.dtype)
    b = min(r, hh, ww)
    if b > 0 and (2 * b >= hh or 2 * b >= ww):
        # too small for an interior: the original tail is exact
        out = tail_fn(h).to(h.dtype)
        return pixel_unshuffle(out, s) if lr_domain else out

    main = kernel if isinstance(kernel, ConvGroup) else kernel.to(h.dtype)
    out_lr = conv_kxk_op(h, main, None, (r, r, r, r))

    if b > 0 and border is not None and b == r:
        hs, q, n2 = border.hs, border.q, 2 * b
        # three launches: top + bottom, left + right, the four corners
        top, bot = conv_kxk_group([h[:, :hs], h[:, hh - hs:]], border.groups["rows"], None,
                                  (0, 0, r, r))
        left, right = conv_kxk_group([h[:, :, :hs], h[:, :, ww - hs:]],
                                     border.groups["cols"], None, (r, r, 0, 0))
        corners = conv_kxk_group([h[:, :n2, :n2], h[:, :n2, ww - n2:], h[:, hh - n2:, :n2],
                                  h[:, hh - n2:, ww - n2:]], border.groups["corners"], None,
                                 (0, 0, 0, 0))
        top = top.reshape(n, ww, b, q).transpose(1, 2)
        bot = bot.reshape(n, ww, b, q).transpose(1, 2)
        left = left.reshape(n, hh, b, q)
        right = right.reshape(n, hh, b, q)
        tl, tr, bl, br = (c.reshape(n, b, b, q) for c in corners)

        out_lr[:, :b, b:ww - b] = top[:, :, b:ww - b]
        out_lr[:, hh - b:, b:ww - b] = bot[:, :, b:ww - b]
        out_lr[:, b:hh - b, :b] = left[:, b:hh - b]
        out_lr[:, b:hh - b, ww - b:] = right[:, b:hh - b]
        out_lr[:, :b, :b] = tl
        out_lr[:, :b, ww - b:] = tr
        out_lr[:, hh - b:, :b] = bl
        out_lr[:, hh - b:, ww - b:] = br
    elif b > 0:
        # halo = r suffices: kept output rows < b need input rows <= b - 1
        # + r, and a strip's inner-edge truncation only reaches rows >= b
        halo = min(r, hh - b, ww - b)
        strip = b + max(halo, 0)
        tile_lr = tile.permute(2, 0, 1).reshape(-1)
        # opposing strips batched into one original-tail call each
        tb = pixel_unshuffle(tail_fn(torch.cat([h[:, :strip], h[:, hh - strip:]], 0)), s)
        lr_ = pixel_unshuffle(tail_fn(torch.cat([h[:, :, :strip], h[:, :, ww - strip:]], 0)), s)
        # the interior bias removed (added back below): the border keeps
        # the strips' own truncated biases
        tb, lr_ = tb.to(out_lr.dtype) - tile_lr, lr_.to(out_lr.dtype) - tile_lr
        # the sides own the full-height columns (corners included), top
        # and bottom the middle columns
        out_lr[:, :, :b] = lr_[:n, :, :b]
        out_lr[:, :, ww - b:] = lr_[n:, :, strip - b:]
        out_lr[:, :b, b:ww - b] = tb[:n, :b, b:ww - b]
        out_lr[:, hh - b:, b:ww - b] = tb[n:, strip - b:, b:ww - b]

    # the interior bias tile, per LR channel in shuffle order (c s s + i s
    # + j): pixel_shuffle is a permutation, so this is the post-shuffle add
    out_lr = out_lr + tile.permute(2, 0, 1).reshape(1, 1, 1, -1)
    return out_lr if lr_domain else pixel_shuffle(out_lr, s)


class CollapsedTail:
    """A baked collapsed tail (`make_collapsed_tail`): the f32 kernel (a
    ConvGroup of one), bias tile and border operators on the device, cast to
    each dtype once.
    `__call__(h)` is `apply_collapsed_tail` in h's dtype."""

    def __init__(self, kernel: np.ndarray, bias_tile: np.ndarray,
                 border: Optional[Dict[str, object]], tail_fn: TailFn, scale: int, device):
        self.kernel_np, self.bias_tile_np, self.border_np = kernel, bias_tile, border
        self.tail_fn, self.scale, self.device = tail_fn, scale, torch.device(device)
        self.radius = kernel.shape[0] // 2
        self._cast: Dict[torch.dtype, Tuple[ConvGroup, torch.Tensor, Optional[BorderOps]]] = {}

    def operands(self, dtype: torch.dtype):
        if dtype not in self._cast:
            def dev(a):
                return torch.from_numpy(np.ascontiguousarray(a)).to(self.device, dtype)
            border = (None if self.border_np is None else
                      BorderOps(self.border_np, self.kernel_np.shape[2], self.device, dtype))
            self._cast[dtype] = (ConvGroup([dev(self.kernel_np)]), dev(self.bias_tile_np), border)
        return self._cast[dtype]

    def __call__(self, h: torch.Tensor, lr_domain: bool = False) -> torch.Tensor:
        kernel, tile, border = self.operands(h.dtype)
        return apply_collapsed_tail(h, kernel, tile, self.tail_fn, self.scale, border=border,
                                    lr_domain=lr_domain)


def make_collapsed_tail(tail_fn: TailFn, in_channels: int, scale: int, radius: int,
                        device="cpu") -> CollapsedTail:
    """The baked tail equal to `tail_fn` (:226-268): the probed kernel with
    its zero rings trimmed, the interior bias tile (the zero response's
    central s x s block) and the border operators, probed on `device`."""
    kernel = trim_zero_rings(extract_collapsed_kernel(tail_fn, in_channels, scale, radius,
                                                      device))
    r = kernel.shape[0] // 2
    canvas = 4 * radius + 2
    cc = canvas // 2
    zero = np.zeros((1, canvas, canvas, in_channels), np.float32)
    bias_tile = make_probe(tail_fn, device)(zero)[0, cc * scale:(cc + 1) * scale,
                                                  cc * scale:(cc + 1) * scale, :]
    border = extract_border_ops(tail_fn, in_channels, scale, r, bias_tile, device) \
        if r > 0 else None
    return CollapsedTail(kernel, bias_tile, border, tail_fn, scale, device)


# ---- EDSR ----

def edsr_tail_fn(module) -> TailFn:
    """The original tail of an EDSRModule, run by its own layers in h's
    dtype (the Conv3x3 layers cast their f32 weights to it)."""

    def tail_fn(h: torch.Tensor) -> torch.Tensor:
        return module.mean_inverse_shift(module.final_conv(module.upsample(h)))

    return tail_fn


def upsample_convs(module):
    return [m for m in module.upsample.body if isinstance(m, Conv3x3)]


def mean_shifts_intended(module) -> bool:
    """Whether the module's MeanShift buffers are the intended +/-mean
    shifts (identity matrix, bias = sign x DIV2K mean). A restored
    reference checkpoint may carry trained, non-identity affines: then the
    collapsed graphs, which bake the intended shifts, are not taken
    (larvanet_tpu/models/base.py:808-839, ops/fastpath.py:76-84)."""
    mean = torch.tensor(DIV2K_RGB_MEAN)
    eye = torch.eye(3).reshape(3, 3, 1, 1)
    for shift, sign in ((module.mean_shift, 1.0), (module.mean_inverse_shift, -1.0)):
        if not (torch.equal(shift.weight.detach().float().cpu(), eye)
                and torch.equal(shift.bias.detach().float().cpu(), sign * mean)):
            return False
    return True


def _tail_key(module) -> tuple:
    """What the baked tail depends on: the tail's weights and both mean
    shifts' buffers, by storage, version (an in-place load bumps it) and
    device; read on the host, with no copy from the card."""
    tensors = [t for conv in upsample_convs(module) + [module.final_conv]
               for t in (conv.weight, conv.bias)]
    tensors += [t for shift in (module.mean_shift, module.mean_inverse_shift)
                for t in (shift.weight, shift.bias)]
    return tuple((t.data_ptr(), t._version, t.device) for t in tensors)


def collapsed_edsr_tail(model) -> Optional[CollapsedTail]:
    """The baked collapsed tail of an EDSR model (make_collapsed_edsr_forward,
    :752-827): probed from `model.module` (f32), radius 1 + the upsample
    stages, on the model's device, and kept on the model until its weights
    change (a restore, --ema), so a route that asks on every call follows
    them. None when the module's mean shifts are not the intended ones
    (`mean_shifts_intended`): the routes then run the module's own tail."""
    module = model.module
    key = _tail_key(module)
    cached = getattr(model, "_collapsed_tail", None)
    if cached is None or cached[0] != key:
        tail = None
        if mean_shifts_intended(module):
            tail = make_collapsed_tail(edsr_tail_fn(module), module.features, model.scale,
                                       1 + len(upsample_convs(module)), model.device)
        model._collapsed_tail = cached = (key, tail)
    return cached[1]


def make_collapsed_edsr_forward(model):
    """EDSR inference with the trunk as it is and the tail collapsed
    (:752-827): the module's own walk with the baked tail
    (`collapsed_edsr_tail`, asked for on every call) as its `tail` hook, on
    `model.serving_module` (the module, or its cast copy), in the input's
    dtype. Returns forward(x) for an NHWC batch on the model's device;
    raises ValueError when the mean shifts are not the intended ones."""
    if collapsed_edsr_tail(model) is None:
        raise ValueError("the module's MeanShift affines are not the intended +/-mean "
                         "shifts; the collapsed tail bakes those")

    @torch.no_grad()
    def forward(x: torch.Tensor) -> torch.Tensor:
        return model.serving_module(x, tail=collapsed_edsr_tail(model))

    return forward


def live_collapsed_edsr_tail(module, scale: int, dtype: torch.dtype = torch.float32
                             ) -> Tuple[torch.Tensor, torch.Tensor, TailFn]:
    """(kernel, bias_tile, tail_fn) composed from the live tail weights
    (:483-567), all differentiable functions of them. The kernel is the
    response of the bias-less chain to a (C, 1, 1, C) identity batch with
    full conv padding (nothing truncated, so the canvas is the kernel's
    support), in f32, then cast to `dtype`; the bias tile is the biased
    chain's zero response at the center of a (2R+1)^2 canvas, in `dtype`."""
    f = 2 if scale != 3 else 3
    convs = upsample_convs(module)
    c = module.features
    device = module.final_conv.weight.device
    zero_bias = {}

    def full_conv(x, conv):
        kernel = conv.weight.permute(2, 3, 1, 0)
        fo = kernel.shape[3]
        if fo not in zero_bias:
            zero_bias[fo] = torch.zeros(fo, dtype=torch.float32, device=device)
        # a full 3x3 conv is a SAME one of the input padded by one more pixel
        return conv3x3_op(F.pad(x, (0, 0, 1, 1, 1, 1)).contiguous(), kernel, zero_bias[fo])

    x = torch.eye(c, dtype=torch.float32, device=device).reshape(c, 1, 1, c)
    start = 0  # the true coordinate of index 0
    for conv in convs:
        x = pixel_shuffle(full_conv(x, conv), f)
        start = (start - 1) * f
    x = full_conv(x, module.final_conv)
    start -= 1
    s = scale
    t = x.shape[1]
    rr = (-start + s - 1) // s  # the composed radius in LR pixels
    pad_l = rr * s + start
    pad_r = (2 * rr + 1) * s - t - pad_l
    assert pad_l >= 0 and pad_r >= 0, (start, t, rr)
    xp = F.pad(x, (0, 0, pad_l, pad_r, pad_l, pad_r))
    k = 2 * rr + 1
    # padded index (2R - U) s + I: (cin, U', I, V', J, c) -> (U', V', cin, c, I,
    # J), flipped (a delta response is the spatially flipped kernel)
    kernel = xp.reshape(c, k, s, k, s, 3).permute(1, 3, 0, 5, 2, 4).reshape(k, k, c, 3 * s * s)
    kernel = kernel.flip(0, 1).to(dtype)

    tail_fn = edsr_tail_fn(module)
    resp = tail_fn(torch.zeros((1, k, k, c), dtype=dtype, device=device))
    bias_tile = resp[0, rr * s:(rr + 1) * s, rr * s:(rr + 1) * s, :]
    return kernel, bias_tile, tail_fn


def live_collapsed_tail_hook(module, scale: int, lr_domain: bool = False) -> TailFn:
    """The `tail` hook of a training step through the live collapsed tail
    (_edsr_walk mode 'live_collapsed', ops/packed/edsr.py:17-101): composes
    the kernel and bias tile in h's dtype, then `apply_collapsed_tail` with
    the border recomputed on strips; `lr_domain`: the output before the
    shuffle."""

    def tail(h: torch.Tensor) -> torch.Tensor:
        kernel, bias_tile, tail_fn = live_collapsed_edsr_tail(module, scale, h.dtype)
        return apply_collapsed_tail(h, kernel, bias_tile, tail_fn, scale, lr_domain=lr_domain)

    return tail


# ---- the interpolated base (unwired, as in JAX) ----

def _cubic_near(t: np.ndarray, a: float) -> np.ndarray:
    return ((a + 2.0) * t - (a + 3.0)) * t * t + 1.0


def _cubic_far(t: np.ndarray, a: float) -> np.ndarray:
    return (((a * t - 5.0 * a) * t) + 8.0 * a) * t - 4.0 * a


def bicubic_weights(scale: int, a: float = -0.75) -> Tuple[np.ndarray, np.ndarray]:
    """Per-phase 4-tap cubic weights (scale, 4) f32 and base offsets (scale,)
    (copy of larvanet_tpu/ops/resize.py:46-67): phase p reads input indices
    base[p] + {0, 1, 2, 3} - 1 of its input pixel."""
    p = np.arange(scale, dtype=np.float64)
    src = (p + 0.5) / scale - 0.5
    base = np.floor(src).astype(np.int64)
    f = src - base
    w = np.stack([_cubic_far(f + 1.0, a), _cubic_near(f, a), _cubic_near(1.0 - f, a),
                  _cubic_far(2.0 - f, a)], axis=1)
    return w.astype(np.float32), base


_BASE_CACHE: Dict[tuple, tuple] = {}


def make_collapsed_base(scale: int, mode: str = "bicubic", device="cpu"):
    """LR-domain interpolated base: base_lr(x) -> (N, H, W, 3 s s)
    (:573-623). The resampler is a fixed linear map: a probed (2R+1)^2 conv
    to torch-ordered LR channels plus probed border operators that capture
    its edge clamp exactly. Probed once per (scale, mode, device)."""
    key = (scale, mode, str(torch.device(device)))
    if key not in _BASE_CACHE:
        def base_fn(x):
            return interpolated_base(x.float(), scale, mode)

        kernel = trim_zero_rings(extract_collapsed_kernel(base_fn, 3, scale, 3, device))
        r = kernel.shape[0] // 2
        tile = np.zeros((scale, scale, 3), np.float32)  # the resampler of 0 is 0
        # nearest collapses to a 1x1 kernel (r = 0): exact everywhere
        border = extract_border_ops(base_fn, 3, scale, r, tile, device) if r > 0 else None
        _BASE_CACHE[key] = CollapsedTail(kernel, tile, border, base_fn, scale, device)
    tail = _BASE_CACHE[key]

    def base_lr(x: torch.Tensor) -> torch.Tensor:
        return tail(x, lr_domain=True)

    return base_lr


def bicubic_phase_conv_kernel(scale: int, channels: int = 3) -> np.ndarray:
    """Bicubic x`scale` upsampling as a (2R+1)^2 conv to channels s s
    torch-ordered channels + PixelShuffle, exact in the interior (the
    resampler edge-clamps where a conv zero-pads) (:626-652)."""
    w, base = bicubic_weights(scale)
    radius = int(max(abs(int(base.min()) - 1), abs(int(base.max()) + 2)))
    k = 2 * radius + 1
    kernel = np.zeros((k, k, channels, channels * scale * scale), np.float32)
    for i in range(scale):
        for j in range(scale):
            for ty in range(4):
                for tx in range(4):
                    u = int(base[i]) + ty - 1
                    v = int(base[j]) + tx - 1
                    coeff = float(w[i, ty] * w[j, tx])
                    for c in range(channels):
                        kernel[u + radius, v + radius, c,
                               c * scale * scale + i * scale + j] += coeff
    return kernel


def make_collapsed_larvanet_forward(model, dtype: torch.dtype = torch.float32):
    """LarvaNet forward with the bicubic base folded into a conv (:655-749):
    exact, and measured slower than the module forward on the TPU, so wired
    into no CLI. The module's own layers for the head, bodies and last
    leg; base = PS4(conv_bicubic(x)) added in LR space before the one
    shuffle; the 2-LR-pixel border frame, where the conv's zero padding
    departs from the resampler's edge clamp, corrected additively from thin
    halo strips. The flagship configuration only (plain bodies, '2conv'
    legs, no tail, bicubic)."""
    from larvanet_tpu_torch.models.larvanet import SCALE
    from larvanet_tpu_torch.models.layers import exact_pair

    mod = model.module
    if (mod.body_style != "plain" or mod.bodies()[0].leg.style != "2conv"
            or mod.use_tail or mod.interpolate != "bicubic"):
        raise ValueError("collapsed forward supports the flagship LarvaNet config only")
    kb = ConvGroup([torch.from_numpy(bicubic_phase_conv_kernel(SCALE, 3)).to(model.device, dtype)])
    r = kb.shape[0] // 2  # the bicubic radius in LR pixels (2)
    s = SCALE

    def conv_b(xs):
        return conv_kxk_op(xs, kb, None, (r, r, r, r))

    @torch.no_grad()
    def forward(x: torch.Tensor) -> torch.Tensor:
        x = x.to(dtype).contiguous()
        fea = mod.head["feature_extraction"](x)
        for body in mod.bodies():
            hcur = fea
            for block in body.res_blocks:
                hcur = exact_pair(0, hcur, block.body[0], block.body[2],
                                  res_weight=block.res_weight)
            fea = fea + hcur
        t = mod.bodies()[-1].leg.recon_block(fea)

        hh, ww = x.shape[1], x.shape[2]
        b = min(r, hh, ww)
        halo = min(r, hh - b, ww - b)
        if 2 * b >= hh or 2 * b >= ww or halo < r:
            # too small for disjoint border strips: the exact resampler base
            return pixel_shuffle(t, s) + interpolated_base(x, s, "bicubic").to(dtype)
        out = pixel_shuffle(t + conv_b(x), s)
        # out_exact = out + (base_exact - base_conv), nonzero only within r
        # LR pixels of each border; a strip with r halo rows reproduces both
        strip = b + halo
        bs = b * s

        def base_pair(xs):
            xs = xs.contiguous()
            return interpolated_base(xs, s, "bicubic").to(dtype) - pixel_shuffle(conv_b(xs), s)

        top = base_pair(x[:, :strip])[:, :bs]
        bot = base_pair(x[:, hh - strip:])[:, -bs:]
        left = base_pair(x[:, :, :strip])[:, :, :bs]
        right = base_pair(x[:, :, ww - strip:])[:, :, -bs:]
        out[:, :bs] += top
        out[:, -bs:] += bot
        # the corners were corrected with the rows
        out[:, bs:-bs, :bs] += left[:, bs:-bs]
        out[:, bs:-bs, -bs:] += right[:, bs:-bs]
        return out

    return forward
