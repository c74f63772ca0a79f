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
the plain version. Both dtypes run on the "tensor_core" entries
(`path_for`): mma.sync point products on a transformed window in shared
memory, bf16 products in bf16, f32 products in split TF32 (each operand
split into two TF32 parts, hi + lo, three TF32 products an f32 product,
f32 sums). The "cuda_core" entries of both dtypes stay in the source as
the earlier kernels of the same function (`_entry(m, dtype,
"cuda_core")`); nothing routes to them. The tensor-core entries take the
basis with its channel axes swapped, (P, 3, C_out, C_in): a row of a
weight slab is then one output channel's inputs, the layout in which
ldmatrix loads the B operand. The f32 entry reads that basis split once
per weight into its hi and lo parts; `entry_basis` keeps the exact basis
in front of them, (3, P, 3, C_out, C_in), so the plain version of a
cached basis sees it bit for bit. `LAUNCHES` counts the kernel's
launches per m and `LAUNCHES_BY_PATH` per path.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from larvanet_tpu_torch.ops import build
from larvanet_tpu_torch.models.layers import exact_pair
from larvanet_tpu_torch.ops.conv3x3 import split_tf32

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
_ENTRY = {(2, torch.float32, "cuda_core"): "wino_resblock_f2_f32",
          (2, torch.bfloat16, "cuda_core"): "wino_resblock_f2_bf16",
          (4, torch.float32, "cuda_core"): "wino_resblock_f4_f32",
          (4, torch.bfloat16, "cuda_core"): "wino_resblock_f4_bf16",
          (2, torch.bfloat16, "tensor_core"): "wino_resblock_f2_bf16_tc",
          (4, torch.bfloat16, "tensor_core"): "wino_resblock_f4_bf16_tc",
          (2, torch.float32, "tensor_core"): "wino_resblock_f2_f32_tc",
          (4, torch.float32, "tensor_core"): "wino_resblock_f4_f32_tc"}

LAUNCHES: Dict[int, int] = {2: 0, 4: 0}
LAUNCHES_BY_PATH: Dict[str, int] = {"cuda_core": 0, "tensor_core": 0}


def reset_launches() -> None:
    for m in LAUNCHES:
        LAUNCHES[m] = 0
    for path in LAUNCHES_BY_PATH:
        LAUNCHES_BY_PATH[path] = 0


def path_for(dtype: torch.dtype) -> str:
    """The kernel path for activations in `dtype`: the tensor cores, for
    both dtypes the kernel takes (bf16 products in bf16, f32 products in
    split TF32)."""
    del dtype  # every dtype the kernel takes has a tensor-core entry
    return "tensor_core"


def _split_basis(dtype: torch.dtype, path: str) -> bool:
    """Whether the entry of (`path`, `dtype`) reads the split basis."""
    return path == "tensor_core" and dtype == torch.float32


def entry_basis(u: torch.Tensor, path: str) -> torch.Tensor:
    """Basis u (P, 3, C, F) as the entry of (`path`, u.dtype) takes it,
    contiguous: as it is for the CUDA cores; (P, 3, F, C) for the bf16
    tensor-core entry; for the f32 one (3, P, 3, F, C), that transposed
    basis followed by its split-TF32 parts hi and lo (`split_tf32`), which
    the entry reads."""
    if path != "tensor_core":
        return u.contiguous()
    ut = u.transpose(2, 3)
    if _split_basis(u.dtype, path):
        return torch.stack((ut,) + split_tf32(ut)).contiguous()
    return ut.contiguous()


def _public_basis(u: torch.Tensor) -> torch.Tensor:
    """The basis (P, 3, C, F) of a tensor-core entry's basis."""
    return (u[0] if u.dim() == 5 else u).transpose(2, 3)


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
                                        res_weight: float = 1.0, m: int = 2,
                                        entry_layout: bool = False) -> torch.Tensor:
    """The plain version on pre-transformed weights (see
    `wino_resblock_transformed`, whose arguments it takes)."""
    _check_m(m)
    if entry_layout and path_for(x.dtype) == "tensor_core":
        u_a, u_b = _public_basis(u_a), _public_basis(u_b)
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


def bind(lib: ctypes.CDLL, m: int, dtype: torch.dtype, path: str = "cuda_core"):
    """The entry point of `lib` for (m, dtype, path), with its C signature."""
    fn = getattr(lib, _ENTRY[(m, dtype, path)])
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_float] + [ctypes.c_int] * 3
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.lru_cache(maxsize=None)
def _entry(m: int, dtype: torch.dtype, path: str):
    return bind(build.load(SOURCE), m, dtype, path)


def _run(fn, x, u_a, b_a, u_b, b_b, res_weight: float, m: int, stream) -> torch.Tensor:
    """Call entry point `fn` on checked operands, u_a/u_b in its layout
    (`entry_basis`; of a split basis the entry reads the hi and lo parts);
    returns the output."""
    n, h, w, _ = x.shape
    ua, ub = ((u[1:] if u.dim() == 5 else u).to(x.dtype).contiguous() for u in (u_a, u_b))
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
                              m: int = 2, entry_layout: bool = False) -> torch.Tensor:
    """The fused ResBlock on pre-transformed weights u_a/u_b (m + 2, 3, C, C)
    in x's dtype (`h_transform_kernel(k, m).to(x.dtype)`); with
    `entry_layout`, already in the layout of the entry that
    `path_for(x.dtype)` picks (`entry_basis`), as `make_wino_edsr_forward`
    caches them. CUDA tensor: the hand-written kernel; CPU tensor: the
    plain version."""
    if x.device.type == "cpu":
        return wino_resblock_transformed_reference(x, u_a, b_a, u_b, b_b,
                                                   res_weight, m, entry_layout)
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
    if entry_layout and _split_basis(x.dtype, path_for(x.dtype)):
        basis = (3,) + basis
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
        return _launch(x, u_a, b_a, u_b, b_b, res_weight, m, entry_layout,
                       torch.cuda.current_stream().cuda_stream)


def _launch(x, u_a, b_a, u_b, b_b, res_weight: float, m: int, entry_layout: bool,
            stream) -> torch.Tensor:
    """Launch the entry of `path_for(x.dtype)` on checked operands and count it."""
    path = path_for(x.dtype)
    if not entry_layout:
        u_a, u_b = (entry_basis(u.to(x.dtype), path) for u in (u_a, u_b))
    out = _run(_entry(m, x.dtype, path), x, u_a, b_a, u_b, b_b, res_weight, m, stream)
    LAUNCHES[m] += 1
    LAUNCHES_BY_PATH[path] += 1
    return out


def wino_resblock(x: torch.Tensor, k_a: torch.Tensor, b_a: torch.Tensor,
                  k_b: torch.Tensor, b_b: torch.Tensor, res_weight: float = 1.0,
                  m: int = 2) -> torch.Tensor:
    """The fused ResBlock from HWIO kernels (3, 3, C, C): transforms the
    weights, then `wino_resblock_transformed`."""
    u_a = h_transform_kernel(k_a, m).to(x.dtype)
    u_b = h_transform_kernel(k_b, m).to(x.dtype)
    return wino_resblock_transformed(x, u_a, b_a, u_b, b_b, res_weight, m)


def fused_resblock_runner(m: int = 2):
    """The pair runner of the family walks (models/layers.exact_pair's
    signature): a 'res' pair, a ResBlock's two convs, runs in one
    `wino_resblock_transformed` call; any other kind (a LarvaNet leg) runs
    exact_pair, as JAX's wino_pallas_pair_with_fallback does. The weight
    transforms are cached per pair, in the layout of the dtype's entry
    (`entry_basis`; in f32 with their split-TF32 parts), and recomputed
    when a weight changes, so a later restore or set_serving_dtype holds."""
    _check_m(m)
    cache: Dict[torch.nn.Module, tuple] = {}

    @torch.no_grad()
    def run(idx: int, x: torch.Tensor, conv1, conv2, kind: str = "res",
            res_weight: float = 1.0) -> torch.Tensor:
        if kind != "res":
            return exact_pair(idx, x, conv1, conv2, kind, res_weight)
        weights = (conv1.weight, conv2.weight)
        key = tuple((w.data_ptr(), w._version, w.dtype, w.device) for w in weights) \
            + (x.dtype,)
        hit = cache.get(conv1)
        if hit is None or hit[0] != key:
            hit = (key, tuple(entry_basis(h_transform_kernel(w.permute(2, 3, 1, 0), m)
                                          .to(x.dtype), path_for(x.dtype))
                              for w in weights))
            cache[conv1] = hit
        u_a, u_b = hit[1]
        return wino_resblock_transformed(x, u_a, conv1.bias, u_b, conv2.bias, res_weight, m,
                                         entry_layout=True)

    return run


def _check_even_width(x: torch.Tensor) -> None:
    if x.shape[2] % 2:
        raise ValueError("wino_trunk requires even width")


def make_wino_edsr_forward(model, m: int = 2):
    """EDSR inference forward with every ResBlock in one `wino_resblock`
    call and the collapsed tail baked (counterpart of
    make_wino_pallas_edsr_forward, wino_pallas.py:467-491, which bakes it
    whatever --collapsed_tail says; ops/collapsed_tail.collapsed_edsr_tail,
    the module's own tail when its mean shifts are not the intended ones).
    Head and after_res_conv run the module's own layers. Takes and returns
    what `model.module` does; reads the weights of `model.serving_module`
    (the module, or its cast copy) and the baked tail on every call
    (`fused_resblock_runner`, `collapsed_edsr_tail`), so a later restore
    holds. Even input widths only, as in JAX."""
    from larvanet_tpu_torch.ops.collapsed_tail import collapsed_edsr_tail

    run = fused_resblock_runner(m)

    @torch.no_grad()
    def forward(x: torch.Tensor) -> torch.Tensor:
        _check_even_width(x)
        return model.serving_module(x, run, collapsed_edsr_tail(model))

    return forward


def make_wino_larvanet_forward(model, m: int = 2):
    """LarvaNet-family inference forward with fused body ResBlocks
    (counterpart of make_wino_pallas_larvanet_forward and the pair rule of
    wino_pallas_pair_with_fallback, wino_pallas.py:413-464): the topology
    is the module's own walk (`LarvaNetModule.walk`: the 'res' body
    stream, the serving exit of --leg, the V2 tail). A trunk of
    KERNEL_CHANNELS (64, LarvaNet_w64) runs every body ResBlock in the
    kernel; any other width runs the module's own ResBlocks, as JAX's
    96-lane 48-channel trunks take its exact path. The width is read once,
    here, from the module. Legs and the tail always run the direct convs.
    Even input widths only, as in JAX."""
    _check_m(m)
    run = fused_resblock_runner(m) if model.module.features == KERNEL_CHANNELS else exact_pair

    @torch.no_grad()
    def forward(x: torch.Tensor):
        _check_even_width(x)
        mod = model.serving_module
        return mod.walk(x, mod.exits, run)

    return forward
