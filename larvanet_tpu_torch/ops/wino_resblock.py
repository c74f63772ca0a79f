"""Fused Winograd ResBlock: the hand-written CUDA kernels and their plain
PyTorch version.

Counterpart of larvanet_tpu/ops/wino_pallas.py. One call computes a whole
EDSR ResBlock,

    y = x + res_weight * (conv_b(ReLU(conv_a(x) + b_a)) + b_b),

with both 3x3 convs in 1-D Winograd F(m, 3) along H (m = 2: 4 basis taps
for 2 output rows; m = 4: 6 basis taps for 4 rows) and the 3 direct taps
along W. The TPU kernel's width-packed (N, H, W/2, 2C) layout, its grid
masks and row-shifted input aliases exist to fill 128-lane TPU tiles;
the port works on plain NHWC at C channels.

Numerics follow the TPU kernel (wino_pallas.py:143-144,167,199-202,225):
input and weight transforms in f32; the operands of the point products
rounded to the activation dtype (bf16 when serving bf16) and summed in
f32; the intermediate t kept in f32 and zero on every row and column
outside the image (conv_b's SAME padding sees zeros there, not
ReLU(b_a)); bias, ReLU, res_weight and the residual add in f32, then one
cast to x's dtype.

The weight transform U[p, kw] = sum_kh G[p, kh] * k[kh, kw] (HWIO k ->
(P, 3, C, C)) runs outside the kernel, as in JAX (`h_transform_kernel`,
wino_pallas.py:103-113), and is cast to x's dtype.

`wino_resblock` launches `csrc/wino_resblock.cu` for a CUDA tensor and
raises on anything that kernel does not take; only a CPU tensor goes to
the plain version. `LAUNCHES` counts the kernel's launches, per m.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from larvanet_tpu_torch.ops import build

SOURCE = "wino_resblock.cu"

# F(2,3), points {0, 1, -1, inf}: y = A^T [(G k) * (B^T d)]
_G4 = np.array([[1.0, 0.0, 0.0],
                [0.5, 0.5, 0.5],
                [0.5, -0.5, 0.5],
                [0.0, 0.0, 1.0]], np.float32)
_BT4 = np.array([[1, 0, -1, 0],
                 [0, 1, 1, 0],
                 [0, -1, 1, 0],
                 [0, 1, 0, -1]], np.float32)
_AT24 = np.array([[1, 1, 1, 0],
                  [0, 1, -1, -1]], np.float32)

# F(4,3), points {0, +-1, +-2, inf} (Lavin's construction)
_G6 = np.array([
    [1 / 4, 0, 0],
    [-1 / 6, -1 / 6, -1 / 6],
    [-1 / 6, 1 / 6, -1 / 6],
    [1 / 24, 1 / 12, 1 / 6],
    [1 / 24, -1 / 12, 1 / 6],
    [0, 0, 1]], np.float32)
_BT6 = np.array([
    [4, 0, -5, 0, 1, 0],
    [0, -4, -4, 1, 1, 0],
    [0, 4, -4, -1, 1, 0],
    [0, -2, -1, 2, 1, 0],
    [0, 2, -1, -2, 1, 0],
    [0, 4, 0, -5, 0, 1]], np.float32)
_AT46 = np.array([
    [1, 1, 1, 1, 1, 0],
    [0, 1, -1, 2, -2, 0],
    [0, 1, 1, 4, 4, 0],
    [0, 1, -1, 8, -8, 1]], np.float32)

# m -> (G, B^T, A^T)
MATRICES = {2: (_G4, _BT4, _AT24), 4: (_G6, _BT6, _AT46)}
# the channel count the CUDA kernel is built for (EDSR-baseline's width)
KERNEL_CHANNELS = 64
_ENTRY = {(2, torch.float32): "wino_resblock_f2_f32",
          (2, torch.bfloat16): "wino_resblock_f2_bf16",
          (4, torch.float32): "wino_resblock_f4_f32",
          (4, torch.bfloat16): "wino_resblock_f4_bf16"}

LAUNCHES: Dict[int, int] = {2: 0, 4: 0}


def reset_launches() -> None:
    for m in LAUNCHES:
        LAUNCHES[m] = 0


def _check_m(m: int) -> None:
    if m not in MATRICES:
        raise ValueError("Winograd size m must be 2 or 4, got %r" % (m,))


def h_transform_kernel(kernel: torch.Tensor, m: int = 2) -> torch.Tensor:
    """HWIO kernel (3, 3, C, F) -> Winograd basis U (m + 2, 3, C, F),
    U[p, kw] = sum_kh G[p, kh] * k[kh, kw], in f32."""
    _check_m(m)
    g = torch.from_numpy(MATRICES[m][0]).to(kernel.device)
    return torch.einsum("pk,kwio->pwio", g, kernel.float())


def _wino_conv(x: torch.Tensor, u: torch.Tensor, m: int) -> torch.Tensor:
    """SAME 3x3 conv of f32 NHWC x with basis u (P, 3, C, F) in the
    activation dtype: F(m, 3) along H, direct taps along W. Output rows
    are grouped m at a time from row 0; the point-product operands are
    rounded to u's dtype and summed in f32. Returns f32 (N, H, W, F)."""
    _, bt, at = MATRICES[m]
    n, h, w, c = x.shape
    groups = -(-h // m)
    # group g reads rows g*m - 1 .. g*m + m (zero outside the image)
    xp = F.pad(x, (0, 0, 1, 1, 1, groups * m + 1 - h))
    d = xp.unfold(1, m + 2, m)                   # (N, G, W+2, C, m+2)
    v = torch.einsum("pj,ngwcj->pngwc", torch.from_numpy(bt).to(x.device), d)
    v = v.to(u.dtype).float()
    uf = u.float()
    acc = None
    for kw in range(3):
        term = torch.einsum("pngwc,pcf->pngwf", v[:, :, :, kw:kw + w], uf[:, kw])
        acc = term if acc is None else acc + term
    y = torch.einsum("ip,pngwf->ngiwf", torch.from_numpy(at).to(x.device), acc)
    return y.reshape(n, groups * m, w, -1)[:, :h]


def wino_resblock_transformed_reference(x, u_a, b_a, u_b, b_b,
                                        res_weight: float = 1.0,
                                        m: int = 2) -> torch.Tensor:
    """The plain version on pre-transformed weights (see
    `wino_resblock_transformed`)."""
    _check_m(m)
    xf = x.float()
    t = torch.relu(_wino_conv(xf, u_a, m) + b_a.float())
    y = _wino_conv(t, u_b, m) + b_b.float()
    if res_weight != 1.0:
        y = y * float(res_weight)
    return (xf + y).to(x.dtype)


def wino_resblock_reference(x, k_a, b_a, k_b, b_b, res_weight: float = 1.0,
                            m: int = 2) -> torch.Tensor:
    """The plain version: the same Winograd arithmetic as the kernel, with
    tensor ops. x NHWC (f32 or bf16), k_a/k_b HWIO (3, 3, C, C), b_a/b_b (C,)."""
    u_a = h_transform_kernel(k_a, m).to(x.dtype)
    u_b = h_transform_kernel(k_b, m).to(x.dtype)
    return wino_resblock_transformed_reference(x, u_a, b_a, u_b, b_b, res_weight, m)


def bind(lib: ctypes.CDLL, m: int, dtype: torch.dtype):
    """The entry point of `lib` for (m, dtype), with its C signature."""
    fn = getattr(lib, _ENTRY[(m, dtype)])
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _entry(m: int, dtype: torch.dtype):
    return bind(build.load(SOURCE), m, dtype)


def _run(fn, x, u_a, b_a, u_b, b_b, res_weight: float, m: int, stream) -> torch.Tensor:
    """Call entry point `fn` on checked operands; returns the output."""
    n, h, w, _ = x.shape
    ua = u_a.to(x.dtype).contiguous()
    ub = u_b.to(x.dtype).contiguous()
    ba = b_a.to(torch.float32).contiguous()
    bb = b_b.to(torch.float32).contiguous()
    out = torch.empty_like(x)
    err = fn(x.data_ptr(), ua.data_ptr(), ba.data_ptr(), ub.data_ptr(), bb.data_ptr(),
             out.data_ptr(), float(res_weight), n, h, w, stream)
    if err != 0:
        raise RuntimeError("wino_resblock F(%d,3) kernel launch failed: CUDA error %d"
                           % (m, err))
    return out


def wino_resblock_transformed(x: torch.Tensor, u_a: torch.Tensor,
                              b_a: torch.Tensor, u_b: torch.Tensor,
                              b_b: torch.Tensor, res_weight: float = 1.0,
                              m: int = 2) -> torch.Tensor:
    """The fused ResBlock on pre-transformed weights u_a/u_b (m + 2, 3, C, C)
    in x's dtype (`h_transform_kernel(k, m).to(x.dtype)`). CUDA tensor: the
    hand-written kernel; CPU tensor: the plain version."""
    if x.device.type == "cpu":
        return wino_resblock_transformed_reference(x, u_a, b_a, u_b, b_b,
                                                   res_weight, m)
    if x.device.type != "cuda":
        raise ValueError("wino_resblock runs on CUDA or the CPU, not %s" % (x.device,))
    _check_m(m)
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError("wino_resblock takes float32 or bfloat16, got %s" % (x.dtype,))
    if x.dim() != 4 or not x.is_contiguous():
        raise ValueError("x must be a contiguous NHWC tensor, got shape %s"
                         % (tuple(x.shape),))
    n, h, w, c = x.shape
    if c != KERNEL_CHANNELS:
        raise ValueError("the wino_resblock kernel is built for C = %d, got C = %d"
                         % (KERNEL_CHANNELS, c))
    if n * h * w == 0:
        raise ValueError("empty input %s" % (tuple(x.shape),))
    basis = (m + 2, 3, c, c)
    for name, u in (("u_a", u_a), ("u_b", u_b)):
        if tuple(u.shape) != basis:
            raise ValueError("%s must be %s, got %s" % (name, basis, tuple(u.shape)))
    for name, b in (("b_a", b_a), ("b_b", b_b)):
        if tuple(b.shape) != (c,):
            raise ValueError("%s must be (%d,), got %s" % (name, c, tuple(b.shape)))
    for t in (u_a, u_b, b_a, b_b):
        if t.device != x.device:
            raise ValueError("x, weights and biases must be on one device")
    with torch.cuda.device(x.device):
        out = _run(_entry(m, x.dtype), x, u_a, b_a, u_b, b_b, res_weight, m,
                   torch.cuda.current_stream().cuda_stream)
    LAUNCHES[m] += 1
    return out


def wino_resblock(x: torch.Tensor, k_a: torch.Tensor, b_a: torch.Tensor,
                  k_b: torch.Tensor, b_b: torch.Tensor, res_weight: float = 1.0,
                  m: int = 2) -> torch.Tensor:
    """The fused ResBlock from HWIO kernels (3, 3, C, C): transforms the
    weights, then `wino_resblock_transformed`."""
    u_a = h_transform_kernel(k_a, m).to(x.dtype)
    u_b = h_transform_kernel(k_b, m).to(x.dtype)
    return wino_resblock_transformed(x, u_a, b_a, u_b, b_b, res_weight, m)


def make_wino_edsr_forward(model, m: int = 2):
    """EDSR inference forward with every ResBlock in one `wino_resblock`
    call (counterpart of make_wino_pallas_edsr_forward,
    wino_pallas.py:467-491). Head, after_res_conv and tail run the
    module's own layers. Takes and returns what `model.module` does; reads
    the module's weights on every call, so a later restore or
    set_serving_dtype holds. The weight transforms are cached per block
    and recomputed when a weight changes. Even input widths only, as in
    JAX."""
    _check_m(m)
    cache: Dict[int, tuple] = {}

    def basis(i, block, dtype):
        """(u_a, u_b) of ResBlock i in `dtype`, recomputed when a weight changed."""
        weights = (block.body[0].weight, block.body[2].weight)
        key = tuple((w.data_ptr(), w._version, w.dtype, w.device) for w in weights) + (dtype,)
        hit = cache.get(i)
        if hit is None or hit[0] != key:
            hit = (key, tuple(h_transform_kernel(w.permute(2, 3, 1, 0), m).to(dtype)
                              for w in weights))
            cache[i] = hit
        return hit[1]

    @torch.no_grad()
    def forward(x: torch.Tensor) -> torch.Tensor:
        if x.shape[2] % 2:
            raise ValueError("wino_trunk requires even width")
        mod = model.module
        h = mod.first_conv(mod.mean_shift(x))
        res = h
        for i, block in enumerate(mod.res_blocks):
            u_a, u_b = basis(i, block, res.dtype)
            res = wino_resblock_transformed(res, u_a, block.body[0].bias, u_b,
                                            block.body[2].bias, block.res_weight, m)
        h = h + mod.after_res_conv(res)
        h = mod.final_conv(mod.upsample(h))
        return mod.mean_inverse_shift(h)

    return forward
