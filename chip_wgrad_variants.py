#!/usr/bin/env python3
"""Variants of the weight gradient's tensor-core entry, and its error
against the length of a split.

    python3 chip_wgrad_variants.py      # from the repo root, on a machine with one H100

Builds copies of larvanet_tpu_torch/csrc/conv3x3_wgrad.cu with the
tensor-core entry's tile constants replaced (VARIANTS; one nvcc each, all
started together, into build/wgrad_variants/), prints each copy's
registers and spills (ptxas -v), holds each against the plain version and
times them in turns with torch.nn.grad.conv2d_weight (TF32 off) at a
train step's tensor-core shapes (batch 16: the trunk's 64 -> 64 at 48x48,
the upsample's 64 -> 256 at 48x48 and 96x96). Then, for the entry as
built, the error against the plain version as the pixels a split sums
grow (the tensor core's f32 sums round toward zero), at the longest
sums of a train step and at the trunk's. Exits non-zero without a card,
if a constant is not found once, or if a variant misses GRAD_RTOL.
"""

from __future__ import annotations

import ctypes
import re
import subprocess
import sys
import threading
from pathlib import Path

import chip_smoke

# name -> {constant: value}, or {"_replace": [(text, new text)]}
VARIANTS = {
    "as built (8 x 16 tiles, 12 warps, k-steps unrolled by 2)": {},
    "4 x 16 pixel tiles": {"kTcTH": 4},
    "k-steps not unrolled": {"_replace": [("#pragma unroll 2\n    for (int ks",
                                           "#pragma unroll 1\n    for (int ks")]},
    "18 warps x 2 m16 tiles": {"kTcWarps": 18, "kTcMW": 2},
}
SHAPES = ((16, 48, 64, 64), (16, 48, 64, 256), (16, 96, 64, 256))  # (N, H = W, C, F)
SWEEP_SHAPES = ((16, 96, 64, 256), (16, 48, 64, 64))
SWEEP_CHUNKS = (1, 4, 16, 35, 48, 64, 256)  # pixel tiles a split
OUT = Path("build") / "wgrad_variants"


def variant_source(src: str, params) -> str:
    for key, value in params.items():
        if key == "_replace":
            for old, new in value:
                if src.count(old) != 1:
                    raise SystemExit("chip_wgrad_variants: %r not found once" % old[:40])
                src = src.replace(old, new)
            continue
        src, n = re.subn(r"constexpr int %s = \d+;" % key, "constexpr int %s = %d;" % (key, value),
                         src)
        if n != 1:
            raise SystemExit("chip_wgrad_variants: constant %s not found once" % key)
    return src


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_wgrad_variants: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from larvanet_tpu_torch.ops import build
    from larvanet_tpu_torch.ops import conv3x3_wgrad as wg

    print("device: %s" % chip_smoke.nvidia_smi_line(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / wg.SOURCE).read_text()
    libs, logs = {}, {}

    def make(i, name, params):
        cu = OUT / ("v%d.cu" % i)
        cu.write_text(variant_source(src, params))
        so = cu.with_suffix(".so")
        proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                              capture_output=True, text=True)
        logs[name] = proc.stdout + proc.stderr
        if proc.returncode == 0:
            libs[name] = so

    threads = [threading.Thread(target=make, args=(i, name, params))
               for i, (name, params) in enumerate(VARIANTS.items())]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    for name in VARIANTS:
        if name not in libs:
            raise SystemExit("chip_wgrad_variants: nvcc failed on %s:\n%s" % (name, logs[name]))
        m = re.search(r"wgrad_tc_kernel[^\n]*\n[^\n]*wgrad_tc_kernel[^\n]*\n\s*(\d+) bytes stack "
                      r"frame, (\d+) bytes spill stores[^\n]*\n[^\n]*Used (\d+) registers",
                      logs[name])
        print("variant %s: %s registers, %s bytes stack, %s bytes spilled" % (
            name, *(m.group(3, 1, 2) if m else ("?",) * 3)), flush=True)
    fns = {name: wg.bind(ctypes.CDLL(str(so)), "tensor_core") for name, so in libs.items()}
    stream = torch.cuda.current_stream().cuda_stream
    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 11)
    tile = wg.PIXEL_TILE["tensor_core"]

    def operands(n, h, c, f):
        x = torch.randn((n, h, h, c), generator=gen, device="cuda")
        g = torch.randn((n, h, h, f), generator=gen, device="cuda") / (n * h * h)
        return x, g, wg.conv3x3_wgrad_reference(x, g)

    def rel_err(got, want):
        return max(float((a - b).abs().max() / b.abs().max()) for a, b in zip(got, want))

    for n, h, c, f in SHAPES:
        x, g, want = operands(n, h, c, f)
        calls = {}
        for name, fn in fns.items():
            th = VARIANTS[name].get("kTcTH", tile[0])
            wg.PIXEL_TILE["tensor_core"] = (th, tile[1])
            splits, chunk = wg.tile_splits("tensor_core", n, h, h, c, f, 132)
            got = wg._run(fn, x, g, splits, chunk, stream)
            torch.cuda.synchronize()
            err = rel_err(got, want)
            print("  %s at %s: %d splits of %d tiles, max |d| / max |dW| %.3g"
                  % (name, (n, h, h, c, f), splits, chunk, err), flush=True)
            if err > chip_smoke.GRAD_RTOL:
                raise SystemExit("chip_wgrad_variants: %s disagrees with the plain version" % name)
            calls[name] = (lambda fn=fn, s=splits, k=chunk: wg._run(fn, x, g, s, k, stream))
        wg.PIXEL_TILE["tensor_core"] = tile
        x_nchw, g_nchw = x.permute(0, 3, 1, 2), g.permute(0, 3, 1, 2)
        calls["conv2d_weight"] = lambda: torch.nn.grad.conv2d_weight(
            x_nchw, (f, c, 3, 3), g_nchw, padding=1)
        times = chip_smoke.time_windows(torch, calls)
        for name, t in times.items():
            print("time %s C=%d F=%d %s: %s" % ((n, h, h), c, f, name, chip_smoke.spread(t)),
                  flush=True)
        del x, g, want
        torch.cuda.empty_cache()

    fn = wg._entry("tensor_core")
    for n, h, c, f in SWEEP_SHAPES:
        x, g, want = operands(n, h, c, f)
        tiles = n * -(-h // tile[0]) * -(-h // tile[1])
        for chunk in SWEEP_CHUNKS:
            if chunk > tiles:
                continue
            splits = -(-tiles // chunk)
            err = rel_err(wg._run(fn, x, g, splits, chunk, stream), want)
            print("split length %s C=%d F=%d: %d tiles (%d pixels) a split, max |d| / max |dW| "
                  "%.3g" % ((n, h, h), c, f, chunk, chunk * tile[0] * tile[1], err), flush=True)
        del x, g, want
        torch.cuda.empty_cache()
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
