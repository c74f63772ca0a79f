#!/usr/bin/env python3
"""Variants of the KxK conv kernels (larvanet_tpu_torch/csrc/conv_kxk.cu):
where their time goes, and what a change of the source would give.

    python3 chip_kxk_variants.py      # from the repo root, on a machine with one H100

Builds copies of the source with text replaced (VARIANTS; one nvcc each,
all started together, into build/kxk_variants/), prints each copy's
registers and spills (ptxas -v), and times each copy's entries at the
collapsed tail's shapes as CUDA graph replays of one call (no host work
between two), in turns with the library call of the same function, also
replayed (F.conv2d / conv2d_weight, TF32 off): the 5x5 64 -> 48 conv at 4
x 192x192, the top + bottom, left + right and corner groups, and the
weight gradient at batch 16 x 48x48, in f32 and bf16. The "clock64 spans"
variants then print, for one run, each block's cycles: the forward's to
its first halo, waiting for halos and for weight chunks, and in all; the
weight gradient's to its first tile, waiting, computing, in all; with the
blocks' spread on the global timer. A variant that removes work (the
products) is a measurement, not a kernel: its outputs are not checked;
the others are held to the plain version. Exits non-zero without a card
or if a replaced text is not found once.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import chip_smoke

# name -> ([(text, new text)], check): each text found once in the source;
# `check`: whether the variant still computes the function
VARIANTS = {
    "as built": ([], True),
    "clock64 spans of the forward's blocks": ([
        ("// ---- tensor-core forward (C % 16 == 0) ----",
         "__device__ unsigned long long kxk_fprof[8192][8];\n"
         "__device__ __forceinline__ unsigned long long fprof_gtime() {\n"
         "  unsigned long long t;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
         "  return t;\n}\n"
         "// ---- tensor-core forward (C % 16 == 0) ----"),
        ("  const int lane = threadIdx.x % 32;\n\n"
         "  if (threadIdx.x == 0) {\n    for (int i = 0; i < p.hs",
         "  const int lane = threadIdx.x % 32;\n"
         "  const unsigned long long fprof_g0 = fprof_gtime();\n"
         "  const long long fprof_t0 = clock64();\n"
         "  long long fprof_hw = 0, fprof_ww = 0, fprof_first = -1;\n"
         "  int fprof_tiles = 0;\n\n  if (threadIdx.x == 0) {\n    for (int i = 0; i < p.hs"),
        ("      mbar_wait(halo_full + hslot, (unsigned)(hround & 1));",
         "      { const long long a = clock64();\n"
         "        mbar_wait(halo_full + hslot, (unsigned)(hround & 1));\n"
         "        const long long b = clock64(); fprof_hw += b - a;\n"
         "        if (fprof_first < 0) fprof_first = b - fprof_t0; }"),
        ("            mbar_wait(w_full + (p.resident ? 0 : slot), (unsigned)(wround & 1));",
         "          { const long long a = clock64();\n"
         "            mbar_wait(w_full + (p.resident ? 0 : slot), (unsigned)(wround & 1));\n"
         "            fprof_ww += clock64() - a; }"),
        ("    // acc[i][j][2e + q]: pixel g + 8e of m16 tile i, output 8 (j0 + j) + 2t + q",
         "    ++fprof_tiles;\n"
         "    // acc[i][j][2e + q]: pixel g + 8e of m16 tile i, output 8 (j0 + j) + 2t + q"),
        ("bias_s[nl]);\n          }\n      }\n  }\n}",
         "bias_s[nl]);\n          }\n      }\n  }\n"
         "  if (warp == 0 && lane == 0) {\n"
         "    unsigned long long* r = kxk_fprof[blockIdx.x % 8192];\n"
         "    r[0] = fprof_g0; r[1] = fprof_gtime(); r[2] = fprof_first; r[3] = fprof_hw;\n"
         "    r[4] = fprof_ww; r[5] = clock64() - fprof_t0; r[6] = fprof_tiles; r[7] = 1;\n"
         "  }\n}"),
        ("}  // namespace\n",
         "}  // namespace\n\n"
         "extern \"C\" int kxk_fprof_read(void* dst) {\n"
         "  return (int)cudaMemcpyFromSymbol(dst, kxk_fprof, sizeof(kxk_fprof));\n}\n"
         "extern \"C\" int kxk_fprof_clear() {\n"
         "  static unsigned long long zero[8192][8];\n"
         "  return (int)cudaMemcpyToSymbol(kxk_fprof, zero, sizeof(zero));\n}\n"),
    ], True),
    "clock64 spans of the wgrad's blocks": ([
        ("// ---- tensor-core weight gradient (C % 16 == 0, kh kw <= 25) ----",
         "__device__ unsigned long long kxk_prof[8192][8];\n"
         "__device__ __forceinline__ long long prof_clock() { return clock64(); }\n"
         "__device__ __forceinline__ unsigned long long prof_gtime() {\n"
         "  unsigned long long t;\n"
         "  asm volatile(\"mov.u64 %0, %%globaltimer;\" : \"=l\"(t));\n"
         "  return t;\n}\n"
         "// ---- tensor-core weight gradient (C % 16 == 0, kh kw <= 25) ----"),
        ("  const int rows = taps * p.c + 1;\n  const int tid = threadIdx.x;",
         "  const int rows = taps * p.c + 1;\n  const int tid = threadIdx.x;\n"
         "  const unsigned long long prof_g0 = prof_gtime();\n"
         "  const long long prof_t0 = prof_clock();\n"
         "  long long prof_wait = 0, prof_comp = 0, prof_first = -1, prof_mark = 0;"),
        ("    const int stage = (int)((tile - t_begin) % 2);\n    if (tile + 1 < t_end) {",
         "    prof_mark = prof_clock();\n"
         "    const int stage = (int)((tile - t_begin) % 2);\n    if (tile + 1 < t_end) {"),
        ("    __syncthreads();  // this tile's halo and g have landed for every thread",
         "    __syncthreads();  // this tile's halo and g have landed for every thread\n"
         "    { const long long now = prof_clock(); prof_wait += now - prof_mark;\n"
         "      if (prof_first < 0) prof_first = now - prof_t0; prof_mark = now; }"),
        ("    __syncthreads();  // every thread is done with this stage before it is refilled",
         "    prof_comp += prof_clock() - prof_mark;\n"
         "    __syncthreads();  // every thread is done with this stage before it is refilled"),
        ("  float* const part = ws + (long long)blockIdx.z * rows * p.f;",
         "  const long long prof_loop = prof_clock();\n"
         "  float* const part = ws + (long long)blockIdx.z * rows * p.f;"),
        ("      part[(long long)(rows - 1) * p.f + f0 + tid] = sum;\n    }\n  }\n}",
         "      part[(long long)(rows - 1) * p.f + f0 + tid] = sum;\n    }\n  }\n"
         "  __syncthreads();\n"
         "  if (tid == 0) {\n"
         "    unsigned long long* r = kxk_prof[(blockIdx.z * gridDim.x + blockIdx.x) % 8192];\n"
         "    r[0] = prof_g0; r[1] = prof_gtime(); r[2] = prof_first; r[3] = prof_wait;\n"
         "    r[4] = prof_comp; r[5] = prof_loop - prof_t0; r[6] = prof_clock() - prof_t0;\n"
         "    r[7] = t_end - t_begin;\n  }\n}"),
        ("}  // namespace\n",
         "}  // namespace\n\n"
         "extern \"C\" int kxk_prof_read(void* dst) {\n"
         "  return (int)cudaMemcpyFromSymbol(dst, kxk_prof, sizeof(kxk_prof));\n}\n"),
    ], True),
    "no products": ([("                for (int j = 0; j < NW; ++j) "
                      "mma_bf16(acc[i][j], a, bh[j][0], bh[j][1]);",
                      "                for (int j = 0; j < NW; ++j) acc[i][j][0] += "
                      "__uint_as_float(a[0] ^ bh[j][0] ^ bh[j][1]);"),
                     ("          for (int j = 0; j < NT; ++j) mma_bf16(acc[i][j], a, b[j][0], "
                      "b[j][1]);",
                      "          for (int j = 0; j < NT; ++j) acc[i][j][0] += "
                      "__uint_as_float(a[0] ^ b[j][0] ^ b[j][1]);"),
                     ("                  mma_tf32(acc[i][j], al, bh[j][0], bh[j][1]);\n"
                      "                  mma_tf32(acc[i][j], ah, bl[j][0], bl[j][1]);\n"
                      "                  mma_tf32(acc[i][j], ah, bh[j][0], bh[j][1]);",
                      "                  acc[i][j][0] += __uint_as_float(al[0] ^ ah[1] ^ bh[j][0] "
                      "^ bl[j][1]);"),
                     ("            mma_tf32(acc[i][j], al, bh[j][0], bh[j][1]);\n"
                      "            mma_tf32(acc[i][j], ah, bl[j][0], bl[j][1]);\n"
                      "            mma_tf32(acc[i][j], ah, bh[j][0], bh[j][1]);",
                      "            acc[i][j][0] += __uint_as_float(al[0] ^ ah[1] ^ bh[j][0] ^ "
                      "bl[j][1]);")], False),
}
OUT = Path("build") / "kxk_variants"


def variant_source(src: str, replacements) -> str:
    for old, new in replacements:
        if src.count(old) != 1:
            raise SystemExit("chip_kxk_variants: %r not found once" % old[:60])
        src = src.replace(old, new)
    return src


def main() -> int:
    import torch
    import torch.nn.functional as F

    if not torch.cuda.is_available():
        print("chip_kxk_variants: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    from larvanet_tpu_torch.ops import build
    from larvanet_tpu_torch.ops import conv_kxk as ck

    print("device: %s" % chip_smoke.nvidia_smi_line(), flush=True)
    OUT.mkdir(parents=True, exist_ok=True)
    src = (build.CSRC / ck.SOURCE).read_text()
    procs = []
    for i, (name, (replacements, _)) in enumerate(VARIANTS.items()):
        cu = OUT / ("v%d.cu" % i)
        cu.write_text(variant_source(src, replacements))
        so = cu.with_suffix(".so")
        procs.append((name, so, subprocess.Popen(
            [build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
    libs = {}
    for name, so, proc in procs:
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit("chip_kxk_variants: nvcc failed on %s:\n%s" % (name, log))
        spills = [line.strip() for line in log.splitlines()
                  if "registers" in line or "spill" in line]
        print("variant %r: %s" % (name, "; ".join(spills[:8])), flush=True)
        libs[name] = ctypes.CDLL(str(so))

    gen = torch.Generator(device="cuda").manual_seed(chip_smoke.SEED + 18)
    n, h, w = chip_smoke.LR_BATCH
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731

    for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        x = torch.randn((n, h, w, 64), generator=gen, device="cuda").to(dtype)
        k = 0.1 * torch.randn((5, 5, 64, 48), generator=gen, device="cuda")
        main = ck.ConvGroup([k])  # laid out once, as the baked tail holds it
        strips = torch.randn((2, n, 4, w, 64), generator=gen, device="cuda").to(dtype)
        ks = [0.1 * torch.randn((4, 5, 64, 96), generator=gen, device="cuda") for _ in range(2)]
        patches = torch.randn((4, n, 4, 4, 64), generator=gen, device="cuda").to(dtype)
        kc = [0.1 * torch.randn((4, 4, 64, 192), generator=gen, device="cuda") for _ in range(4)]
        columns = torch.randn((2, n, h, 4, 64), generator=gen, device="cuda").to(dtype)
        kl = [0.1 * torch.randn((5, 4, 64, 96), generator=gen, device="cuda") for _ in range(2)]
        top_bottom, left_right, corners = ck.ConvGroup(ks), ck.ConvGroup(kl), ck.ConvGroup(kc)
        xw = torch.randn((16, 48, 48, 64), generator=gen, device="cuda").to(dtype)
        gw = (torch.randn((16, 48, 48, 48), generator=gen, device="cuda") / 4e4).to(dtype)
        cases = {
            "5x5 64->48": (
                lambda lib: ck._run(ck.bind(lib, dtype), x, main, None, (2, 2, 2, 2), stream()),
                lambda: ck.conv_kxk_reference(x, k, None, (2, 2, 2, 2)),
                lambda: F.conv2d(x.permute(0, 3, 1, 2), k.to(dtype).permute(3, 2, 0, 1),
                                 padding=2)),
            "top+bottom": (
                lambda lib: ck._run_group(ck.bind(lib, dtype, group=True), strips, top_bottom,
                                          (0, 0, 2, 2), stream()),
                lambda: torch.stack([ck.conv_kxk_reference(s, kk, None, (0, 0, 2, 2))
                                     for s, kk in zip(strips, ks)]),
                lambda: [F.conv2d(s.permute(0, 3, 1, 2), kk.to(dtype).permute(3, 2, 0, 1),
                                  padding=(0, 2)) for s, kk in zip(strips, ks)]),
            "left+right": (
                lambda lib: ck._run_group(ck.bind(lib, dtype, group=True), columns, left_right,
                                          (2, 2, 0, 0), stream()),
                lambda: torch.stack([ck.conv_kxk_reference(s, kk, None, (2, 2, 0, 0))
                                     for s, kk in zip(columns, kl)]),
                lambda: [F.conv2d(s.permute(0, 3, 1, 2), kk.to(dtype).permute(3, 2, 0, 1),
                                  padding=(2, 0)) for s, kk in zip(columns, kl)]),
            "4 corners": (
                lambda lib: ck._run_group(ck.bind(lib, dtype, group=True), patches, corners,
                                          (0, 0, 0, 0), stream()),
                lambda: torch.stack([ck.conv_kxk_reference(s, kk, None, (0, 0, 0, 0))
                                     for s, kk in zip(patches, kc)]),
                lambda: [F.conv2d(s.permute(0, 3, 1, 2), kk.to(dtype).permute(3, 2, 0, 1))
                         for s, kk in zip(patches, kc)]),
            "wgrad 5x5 64->48": (
                lambda lib: ck._run_wgrad(
                    ck.bind_wgrad(lib, dtype, "tensor_core"), xw, gw, 5, 5, (2, 2, 2, 2),
                    *ck.wgrad_splits("tensor_core", 16, 48, 48, 64, 5, 5, 48, ck._sm_count(0),
                                     dtype), stream())[0],
                lambda: ck.conv_kxk_wgrad_reference(xw, gw, 5, 5, (2, 2, 2, 2))[0],
                lambda: torch.nn.grad.conv2d_weight(xw.permute(0, 3, 1, 2), (48, 64, 5, 5),
                                                    gw.permute(0, 3, 1, 2), padding=2)),
        }
        for case, (run, plain, library) in cases.items():
            want = plain().float()
            fns = {"library": chip_smoke.graph_replay(torch, library)}
            for name, lib in libs.items():
                got = run(lib)
                torch.cuda.synchronize()
                fns[name] = chip_smoke.graph_replay(torch, lambda lib=lib: run(lib))
                if VARIANTS[name][1]:
                    err = float((got.float() - want).abs().max() / want.abs().max())
                    if err > 1e-2:
                        raise SystemExit("chip_kxk_variants: %r %s %s disagrees (%.3g of max)"
                                         % (name, case, dname, err))
            t = chip_smoke.time_windows(torch, fns)
            print("%s %s: %s" % (case, dname, "; ".join(
                "%s %s" % (name, chip_smoke.spread(v)) for name, v in t.items())), flush=True)
        fprofiled = libs.get("clock64 spans of the forward's blocks")
        if fprofiled is not None:
            for case in ("5x5 64->48", "top+bottom", "left+right", "4 corners"):
                forward_spans(torch, fprofiled, cases[case][0], case, dname)
        profiled = libs.get("clock64 spans of the wgrad's blocks")
        if profiled is not None:
            wgrad_spans(torch, profiled, ck, xw, gw, dtype, dname)
    return 0


def forward_spans(torch, lib, run, case, dname):
    """One run of the instrumented forward: each block's first consumer
    warp's clock64 spans (cycles): to its first halo, waiting for halos,
    waiting for weight chunks, the whole block; the blocks' spread on the
    global timer."""
    import numpy as np

    clear = lib.kxk_fprof_clear
    if clear() != 0:
        raise SystemExit("chip_kxk_variants: clearing the spans failed")
    run(lib)
    torch.cuda.synchronize()
    rec = np.zeros((8192, 8), dtype=np.uint64)
    read = lib.kxk_fprof_read
    read.argtypes = [ctypes.c_void_p]
    if read(rec.ctypes.data) != 0:
        raise SystemExit("chip_kxk_variants: reading the spans failed")
    rec = rec[rec[:, 7] == 1].astype(np.int64)
    names = ("to the first halo", "waiting for halos", "waiting for weights", "block")
    print("forward %s %s spans over %d blocks of %d-%d tiles (cycles, median / max): %s; the "
          "blocks ran within %.1f us on the global timer (starts spread %.1f us, ends %.1f "
          "us)" % (case, dname, len(rec), rec[:, 6].min(), rec[:, 6].max(), ", ".join(
              "%s %d / %d" % (n, np.median(rec[:, c]), rec[:, c].max())
              for n, c in zip(names, (2, 3, 4, 5))),
              (rec[:, 1].max() - rec[:, 0].min()) / 1e3,
              (rec[:, 0].max() - rec[:, 0].min()) / 1e3,
              (rec[:, 1].max() - rec[:, 1].min()) / 1e3), flush=True)


def wgrad_spans(torch, lib, ck, x, g, dtype, dname):
    """One run of the instrumented weight gradient: each block's clock64
    spans (cycles): to its first tile's data, waiting for tiles, computing,
    the loop, the whole block; and the blocks' spread on the global timer."""
    import numpy as np

    splits, chunk = ck.wgrad_splits("tensor_core", 16, 48, 48, 64, 5, 5, 48, ck._sm_count(0),
                                    dtype)
    ck._run_wgrad(ck.bind_wgrad(lib, dtype, "tensor_core"), x, g, 5, 5, (2, 2, 2, 2), splits,
                  chunk, torch.cuda.current_stream().cuda_stream)
    torch.cuda.synchronize()
    rec = np.zeros((8192, 8), dtype=np.uint64)
    read = lib.kxk_prof_read
    read.argtypes = [ctypes.c_void_p]
    if read(rec.ctypes.data) != 0:
        raise SystemExit("chip_kxk_variants: reading the spans failed")
    blocks = 64 // 16 * splits  # channel chunks x runs (48 outputs: one output block)
    rec = rec[:blocks].astype(np.int64)
    span = (rec[:, 1].max() - rec[:, 0].min()) / 1e3
    names = ("to the first tile", "waiting", "computing", "loop", "block")
    cols = (2, 3, 4, 5, 6)
    print("wgrad %s spans over %d blocks of %d-%d tiles (cycles, median / max): %s; the blocks "
          "ran within %.1f us on the global timer (starts spread %.1f us, ends %.1f us)" % (
              dname, blocks, rec[:, 7].min(), rec[:, 7].max(), ", ".join(
                  "%s %d / %d" % (n, np.median(rec[:, c]), rec[:, c].max())
                  for n, c in zip(names, cols)), span,
              (rec[:, 0].max() - rec[:, 0].min()) / 1e3,
              (rec[:, 1].max() - rec[:, 1].min()) / 1e3), flush=True)


if __name__ == "__main__":
    sys.exit(main())
