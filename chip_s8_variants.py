#!/usr/bin/env python3
"""Where a tile's SM cycles go in the s8 conv kernel, and variants of it.

    python3 chip_s8_variants.py                      # on a machine with one H100
    python3 chip_s8_variants.py --first-design build/s8_first.cu

Variants: builds copies of larvanet_tpu_torch/csrc/conv3x3_s8.cu with
design constants replaced (VARIANTS: the product, the ring's slots, the
tile; one nvcc each, all started together, into build/s8_variants/),
prints each copy's registers and spills (ptxas -v), holds each against the
plain version at every S8_SHAPES point of chip_smoke.py on 4 x 192x192 LR
and the 339x510 frame (0 values may differ), and times both entries of
each in bf16 and f32 on 4 x 192x192 in turns, with the first design's
source beside them when `--first-design PATH` names it (`git show
e3303fc:larvanet_tpu_torch/csrc/conv3x3_s8.cu > PATH`; its weight operand
is laid out here as that design read it, [9][F padded to 64][C padded to
32]).

Wide: the kernel as built at 256->256 and 40->24 (its other paths), held
bit for bit in both geometries and dtypes and timed (`wide`).

Overhead: each entry timed through the wrapper, straight through its C
entry and as a CUDA graph replay, in turns, beside the host's time to
issue a call (`overhead`).

Phases: a copy of the source with clock64() stamps at its phase
boundaries (thread 0 of each of the first 64 blocks, summed over the tiles
the block runs): the mean SM cycles a block spends in each phase of both
entries, bf16 and f32, at 64->64 and 48->48 on 4 x 192x192 LR; the same of
the first design with `--first-design`.

Everything printed is also written to chiprun_out/s8_variants/run.log,
beside each variant's ptxas log and SASS (v<i>.log, v<i>.sass). Exits
non-zero without a card, if a constant or a phase boundary is not found
once, if nvcc fails, or if a run differs from the plain version.
"""

from __future__ import annotations

import argparse
import ctypes
import dataclasses
import re
import subprocess
import sys
import threading
from pathlib import Path

import chip_smoke

BLOCKS = 64
SHAPES = (("64->64", 64, 64), ("48->48", 48, 48))
# widths that take the kernel's other paths: 256->256 (the large EDSR's)
# keeps its weights in global memory and copies conv_b's halo by the
# producer warp; 40->24 pads C to 64 and F to 32
WIDE = (("256->256", 256, 256), ("40->24", 40, 24))
OUT = Path("build") / "s8_variants"

# name -> {constant: value, "_replace": [(text, new text)]}
VARIANTS = {
    "as built": {},
    "8 x 16 tiles (8 consumer warps)": {"kTH": 8},
    "8 x 16 tiles, 1 raw slot": {"kTH": 8, "kRawSlots": 1},
    "12 x 16 tiles (12 consumer warps)": {"kTH": 12},
    "2 rows a warp (8 consumer warps)": {"kRW": 2},
    "2 code slots": {"kCodeSlots": 2},
    "weights in global memory": {"kResident": "false"},
    "every code by the division": {
        "_replace": [("  return !(fabsf(y) >= 128.f) && !(0.5f - fabsf(y - q) > kNearHalf);",
                      "  return true;")]},
}

# the design as built, per tile: consumer warp 0's wait for the tile's halo
# (conv_a: for its raw halo, then for every warp's share of the quantize),
# conv_a's quantize of its share, the products, the epilogue; the
# producer's wait for a free slot and the issue of its TMA
PHASES = ("halo wait", "quantize", "products", "epilogue", "producer: slot wait",
          "producer: TMA issued")
PHASE_GROUPS = ((0, 4), (4, 6))
# (text, stamp before it, stamp after it)
STAMPS = (
    ("  mbar_wait(weights_in, 0);\n", "", "  PH_START\n"),
    ("        mbar_wait(full_raw + rs, (i / s.raw_slots) & 1);\n", "", "        PHASE(0)\n"),
    ("      mbar_arrive(full_code + slot);\n", "", "      PHASE(1)\n"),
    ("    mbar_wait(full_code + slot, (i / s.code_slots) & 1);\n", "",
     "    PHASE(0)\n    PH_TILE\n"),
    ("      if (f0 + kBN >= s.np) {", "      PHASE(2)\n", ""),
    ("      __syncwarp();  // the staging rows are free for the next pass\n", "",
     "      PHASE(3)\n"),
    ("      if (i >= slots) mbar_wait(empty + slot, (i / slots - 1) & 1);\n",
     "      PH_START\n", "      PHASE(4)\n"),
    ("                    full + slot);\n", "", "        PHASE(5)\n"),
)

# the first design: per 32-code chunk, the halo staged (conv_a
# quantizing as it goes), the chunk's weights staged, the 9 taps; then the
# epilogue. (text, stamp before it, stamp after it)
FIRST_PHASES = ("halo (+ quantize)", "weights", "products", "epilogue")
FIRST_STAMPS = (
    ("  const int row0 = warp * kRW;\n", (), ("START",)),
    ("    // the weights: [9][Fp][Cp] int8", (0,), ()),
    ("#pragma unroll 1\n    for (int tap = 0;", (1,), ()),
    ("    }\n  }\n\n  // epilogue: pixel", (), ()),
    ("\nint refusal(", (), ()),
)


def stamp_head(threads="threadIdx.x == 0") -> str:
    """The stamps' store: thread(s) `threads` of blocks 0 .. BLOCKS - 1 add
    the cycles since their last stamp to phase i."""
    return ("__device__ long long g_phase[%d][9];\n"
            "#define PH_ON ((%s) && blockIdx.x < %d && blockIdx.y == 0)\n"
            "#define PH_START long long ph_last = clock64();\n"
            "#define PHASE(i) { const long long ph_now = clock64(); "
            "if (PH_ON) g_phase[blockIdx.x][i] += ph_now - ph_last; ph_last = ph_now; }\n"
            "#define PH_TILE { if (PH_ON && threadIdx.x == 0) g_phase[blockIdx.x][8] += 1; }\n"
            % (BLOCKS, threads, BLOCKS))


READ = ('\nextern "C" int read_phases(void* host) {\n'
        '  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));\n}\n'
        'extern "C" int clear_phases() {\n'
        '  static long long zero[%d][9];\n'
        '  return (int)cudaMemcpyToSymbol(g_phase, zero, sizeof(zero));\n}\n' % BLOCKS)


def _once(src: str, text: str) -> None:
    if src.count(text) != 1:
        raise SystemExit("chip_s8_variants: phase boundary not found once: %r" % text[:60])


def variant_source(src: str, params) -> str:
    for key, value in params.items():
        if key == "_replace":
            for old, new in value:
                if src.count(old) != 1:
                    raise SystemExit("chip_s8_variants: %r not found once" % old[:40])
                src = src.replace(old, new)
            continue
        src, n = re.subn(r"(constexpr \w+ %s = )[^;]+;" % key, r"\g<1>%s;" % value, src)
        if n != 1:
            raise SystemExit("chip_s8_variants: constant %s not found once" % key)
    return src


def stamped(src: str) -> str:
    for text, _, _ in STAMPS:
        _once(src, text)
    head = stamp_head("threadIdx.x == 0 || threadIdx.x == kThreads - 32")
    src = src.replace("namespace {\n", head + "namespace {\n", 1)
    for text, before, after in STAMPS:
        src = src.replace(text, before + text + after)
    return src + READ


def first_stamped(src: str) -> str:
    for text, _, _ in FIRST_STAMPS:
        _once(src, text)
    src = src.replace("namespace {\n", stamp_head() + "namespace {\n", 1)
    src = src.replace(FIRST_STAMPS[0][0], FIRST_STAMPS[0][0] + "  PH_START\n")
    src = src.replace(FIRST_STAMPS[1][0], "    PHASE(0)\n" + FIRST_STAMPS[1][0])
    src = src.replace(FIRST_STAMPS[2][0], "    PHASE(1)\n" + FIRST_STAMPS[2][0])
    src = src.replace(FIRST_STAMPS[3][0], "    }\n    PHASE(2)\n  }\n\n  // epilogue: pixel")
    # the kernel's closing brace: the epilogue's end
    src = src.replace("    }\n  }\n}\n" + FIRST_STAMPS[4][0],
                      "    }\n  }\n  PHASE(3)\n}\n" + FIRST_STAMPS[4][0])
    if src.count("PHASE(3)") != 1:
        raise SystemExit("chip_s8_variants: the kernel's end not found once")
    return src + READ


def first_entry(torch, wt):
    """The first design's weight operand: [9][Fp][Cp], F padded to 64 and C
    to 32 with zero codes."""
    c, f = wt.codes.shape[2], wt.codes.shape[3]
    cp, fp = -(-c // 32) * 32, -(-f // 64) * 64
    w = torch.zeros((9, fp, cp), dtype=torch.int8, device=wt.codes.device)
    w[:, :f, :c] = wt.codes.reshape(9, c, f).transpose(1, 2)
    return w.contiguous()


def build_libs(sources, build):
    """{name: (CDLL, ptxas log)} of {name: source}: one nvcc each, all at once."""
    OUT.mkdir(parents=True, exist_ok=True)
    done = {}

    def make(i, name, src):
        cu = OUT / ("v%d.cu" % i)
        cu.write_text(src)
        so = cu.with_suffix(".so")
        proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", str(so), str(cu)],
                              capture_output=True, text=True)
        done[name] = (proc.returncode, so, proc.stdout + proc.stderr)

    threads = [threading.Thread(target=make, args=(i, name, src))
               for i, (name, src) in enumerate(sources.items())]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    libs = {}
    for name in sources:
        rc, so, log = done[name]
        if rc != 0:
            raise SystemExit("chip_s8_variants: nvcc failed on %s:\n%s" % (name, log))
        libs[name] = (ctypes.CDLL(str(so)), log)
    return libs


def ptxas_line(log: str) -> str:
    """Registers and spills of each conv3x3_s8_kernel instance in a ptxas log."""
    out = []
    for m in re.finditer(r"Compiling entry function '([^']*conv3x3_s8_kernel[^']*)'[^\n]*\n"
                         r"(?:[^\n]*\n)*?\s*(\d+) bytes stack frame, (\d+) bytes spill stores"
                         r"[^\n]*\n[^\n]*Used (\d+) registers", log):
        kind = "conv_a" if "Lb1E" in m.group(1) else "conv_b"
        out.append("%s: %s regs, %s B spilled" % (kind, m.group(4), m.group(3)))
    return "; ".join(out) or "?"


def operands(torch, np, c, f, dtype, rng, geometry=chip_smoke.LR_BATCH):
    """hin, the two S8Weights, the scales and conv_b's residual (when C = F)
    of one pair at `geometry`."""
    from larvanet_tpu_torch.ops import conv3x3_s8 as s8

    n, h, w = geometry
    hin = torch.from_numpy((rng.standard_normal((n, h, w, c)) * 3).astype(np.float32))
    hin = hin.cuda().to(dtype)
    s_in = float(hin.float().abs().max()) * 1.05 / 127.0
    mk = lambda ci, fi, s: s8.make_weight(  # noqa: E731
        rng.integers(-127, 128, (3, 3, ci, fi)).astype(np.int8),
        (rng.uniform(0.5, 2.0, fi) * 1e-3).astype(np.float32), s,
        torch.from_numpy(rng.standard_normal(fi).astype(np.float32)), dtype, "cuda")
    wa = mk(c, c, s_in)
    t = s8._dequant(s8.conv_codes_reference(s8.quantize(hin, s_in), wa.codes), wa, dtype)
    s_mid = float(torch.relu(t).float().abs().max()) * 1.05 / 127.0
    wb = mk(c, f, s_mid)
    res = (torch.randn((n, h, w, f), device="cuda") * 4).to(dtype) if c == f else None
    return hin, wa, wb, s_in, s_mid, res


def variants(torch, np, libs, first_lib=None):
    """Every variant (and the first design) at every S8_SHAPES point, both
    geometries and dtypes, held bit for bit to the plain version; times on
    4 x 192x192 in turns, each beside its bound."""
    from larvanet_tpu_torch.ops import conv3x3_s8 as s8

    rng = np.random.default_rng(chip_smoke.SEED + 16)
    stream = torch.cuda.current_stream().cuda_stream
    runs = dict(libs)
    if first_lib is not None:
        runs["first design"] = first_lib
    for label, c, f in chip_smoke.S8_SHAPES:
        for geometry in (chip_smoke.LR_BATCH, chip_smoke.RAGGED):
            for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
                hin, wa, wb, s_in, s_mid, res = operands(torch, np, c, f, dtype, rng, geometry)
                want_a = s8.conv_a_reference(hin, wa, s_in, s_mid)
                want_b = s8.conv_b_reference(want_a, wb, dtype, res)
                calls = {}
                for name, lib in runs.items():
                    wa_l, wb_l = wa, wb
                    if lib is first_lib:
                        wa_l = dataclasses.replace(wa, _entry=first_entry(torch, wa))
                        wb_l = dataclasses.replace(wb, _entry=first_entry(torch, wb))
                    fa, fb = s8.bind(lib, "conv_a", dtype), s8.bind(lib, "conv_b", dtype)
                    try:
                        got_a = s8._run_a(fa, hin, wa_l, s_in, s_mid, "relu", stream)
                        got_b = s8._run_b(fb, want_a, wb_l, dtype, res, 1.0, stream)
                    except RuntimeError as exc:
                        if name == "as built":
                            raise
                        # a plan past the shared memory a block may have
                        print("variant %s at %s %s %s: refused (%s)"
                              % (name, label, geometry, dname, exc), flush=True)
                        continue
                    torch.cuda.synchronize()
                    bad = (int((got_a != want_a).sum()),
                           int((got_b.float().view(torch.int32)
                                != want_b.float().view(torch.int32)).sum()))
                    if any(bad) and name.startswith("timing only"):
                        print("variant %s at %s %s %s: %d / %d values differ (not held)"
                              % (name, label, geometry, dname, *bad), flush=True)
                    elif any(bad):
                        raise SystemExit("chip_s8_variants: %s at %s %s %s: %d / %d values "
                                         "differ" % (name, label, geometry, dname, *bad))
                    calls[(name, "conv_a")] = (lambda fn=fa, w_=wa_l: s8._run_a(
                        fn, hin, w_, s_in, s_mid, "relu", stream))
                    calls[(name, "conv_b")] = (lambda fn=fb, w_=wb_l: s8._run_b(
                        fn, want_a, w_, dtype, res, 1.0, stream))
                print("variants %s %s %s: every variant held bit for bit with the plain version"
                      % (label, geometry, dname), flush=True)
                if geometry == chip_smoke.LR_BATCH:
                    times = chip_smoke.time_windows(torch, calls)
                    item = 4 if dname == "f32" else 2
                    bound = {"conv_a": chip_smoke.s8_bound_ms(*geometry, c, c, item, "conv_a")[0],
                             "conv_b": chip_smoke.s8_bound_ms(*geometry, c, f, item, "conv_b",
                                                              res is not None)[0]}
                    for (name, entry), t in times.items():
                        print("time %s %s %s %s %s: %s, %.1fx its %.4f ms bound" % (
                            label, geometry, dname, entry, name, chip_smoke.spread(t),
                            t[0] / bound[entry], bound[entry]), flush=True)
                del hin, wa, wb, res, want_a, want_b, calls
                torch.cuda.empty_cache()


def wide(torch, np, lib):
    """The kernel as built at widths outside S8_SHAPES that take its other
    paths (WIDE), both geometries and dtypes, held bit for bit to the plain
    version; times on 4 x 192x192 as CUDA graph replays beside the bound."""
    from larvanet_tpu_torch.ops import conv3x3_s8 as s8

    rng = np.random.default_rng(chip_smoke.SEED + 18)
    for label, c, f in WIDE:
        for geometry in (chip_smoke.LR_BATCH, chip_smoke.RAGGED):
            for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
                hin, wa, wb, s_in, s_mid, res = operands(torch, np, c, f, dtype, rng, geometry)
                fa, fb = s8.bind(lib, "conv_a", dtype), s8.bind(lib, "conv_b", dtype)
                run_a = lambda: s8._run_a(fa, hin, wa, s_in, s_mid, "relu",  # noqa: E731
                                          torch.cuda.current_stream().cuda_stream)
                want_a = s8.conv_a_reference(hin, wa, s_in, s_mid)
                run_b = lambda: s8._run_b(fb, want_a, wb, dtype, res, 1.0,  # noqa: E731
                                          torch.cuda.current_stream().cuda_stream)
                want_b = s8.conv_b_reference(want_a, wb, dtype, res)
                got_a, got_b = run_a(), run_b()
                torch.cuda.synchronize()
                bad = (int((got_a != want_a).sum()),
                       int((got_b.float().view(torch.int32)
                            != want_b.float().view(torch.int32)).sum()))
                if any(bad):
                    raise SystemExit("chip_s8_variants: %s %s %s: %d / %d values differ"
                                     % (label, geometry, dname, *bad))
                line = "wide %s %s %s: 0 values differ" % (label, geometry, dname)
                if geometry == chip_smoke.LR_BATCH:
                    graphs = {}
                    for key, call in (("conv_a", run_a), ("conv_b", run_b)):
                        graphs[key] = torch.cuda.CUDAGraph()
                        with torch.cuda.graph(graphs[key]):
                            call()
                    t = chip_smoke.time_windows(torch, {k: g.replay for k, g in graphs.items()})
                    item = 4 if dname == "f32" else 2
                    bound = {"conv_a": chip_smoke.s8_bound_ms(*geometry, c, c, item, "conv_a")[0],
                             "conv_b": chip_smoke.s8_bound_ms(*geometry, c, f, item, "conv_b",
                                                              res is not None)[0]}
                    line += "; " + ", ".join("%s %s, %.1fx its %.4f ms bound" % (
                        k, chip_smoke.spread(t[k]), t[k][0] / bound[k], bound[k]) for k in t)
                print(line, flush=True)
                del hin, wa, wb, res, want_a, want_b, got_a, got_b
                torch.cuda.empty_cache()


def phases(torch, np, lib, names, groups, entry_of=None):
    """Run both entries of `lib` (a stamped build) at SHAPES in bf16 and
    f32, check them, and print the mean cycles per phase."""
    from larvanet_tpu_torch.ops import conv3x3_s8 as s8

    rng = np.random.default_rng(chip_smoke.SEED + 15)
    stream = torch.cuda.current_stream().cuda_stream
    for label, c, f in SHAPES:
        for dname, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
            hin, wa, wb, s_in, s_mid, res = operands(torch, np, c, f, dtype, rng)
            if entry_of is not None:
                wa._entry, wb._entry = entry_of(torch, wa), entry_of(torch, wb)
            tq_want = s8.conv_a_reference(hin, wa, s_in, s_mid)
            out_want = s8.conv_b_reference(tq_want, wb, dtype, res)
            for entry in ("conv_a", "conv_b"):
                fn = s8.bind(lib, entry, dtype)
                for rep in range(3):
                    if lib.clear_phases() != 0:
                        raise SystemExit("chip_s8_variants: clearing the stamps failed")
                    if entry == "conv_a":
                        got = s8._run_a(fn, hin, wa, s_in, s_mid, "relu", stream)
                        want = tq_want
                    else:
                        got = s8._run_b(fn, tq_want, wb, dtype, res, 1.0, stream)
                        want = out_want
                torch.cuda.synchronize()
                differ = int((got.float().view(torch.int32)
                              != want.float().view(torch.int32)).sum())
                if differ:
                    raise SystemExit("chip_s8_variants: %s %s %s: %d values differ"
                                     % (label, dname, entry, differ))
                stamps = np.zeros((BLOCKS, 9), np.int64)
                if lib.read_phases(stamps.ctypes.data_as(ctypes.c_void_p)) != 0:
                    raise SystemExit("chip_s8_variants: reading the stamps failed")
                spans = stamps[:, :len(names)]
                # each role's phases (the roles overlap)
                for lo, hi in groups:
                    total = spans[:, lo:hi].sum(axis=1)
                    if not total.any():
                        continue
                    print("phases %s %s %s (4 x 192x192)%s: SM cycles a block (blocks 0-%d, "
                          "%.2f tiles each), mean %.0f, min %d, max %d: %s" % (
                              label, dname, entry, "" if lo == 0 else " " + names[lo].split(":")[0],
                              BLOCKS - 1,
                              stamps[:, 8].mean(), total.mean(), total.min(), total.max(),
                              ", ".join(
                                  "%s %.0f (%.1f%%)" % (names[i], spans[:, i].mean(),
                                                        100.0 * spans[:, i].mean()
                                                        / max(total.mean(), 1))
                                  for i in range(lo, hi))), flush=True)
            del hin, wa, wb, res, tq_want, out_want
            torch.cuda.empty_cache()


def overhead(torch, np, lib):
    """Where a timed call's time goes beyond the kernel, at 64->64 and 48->48
    in bf16 on 4 x 192x192: in turns, each entry called as the wrapper does
    it (conv3x3_s8.conv_a / conv_b: its checks, the device guard and the
    count), straight through the C entry (_run_a / _run_b), and as one CUDA
    graph of TIMED_REPS direct calls replayed (no host work a call); and the
    host's microseconds to issue one call of each of the first two, with no
    wait for the card. A time on CUDA events is the host's where the host
    issues slower than the card runs."""
    import time
    from unittest import mock

    from larvanet_tpu_torch.ops import conv3x3_s8 as s8

    rng = np.random.default_rng(chip_smoke.SEED + 17)
    reps = chip_smoke.TIMED_REPS
    with mock.patch.object(s8, "_entry", lambda entry, dtype: s8.bind(lib, entry, dtype)):
        for label, c, f in SHAPES:
            dtype = torch.bfloat16
            hin, wa, wb, s_in, s_mid, res = operands(torch, np, c, f, dtype, rng)
            stream = torch.cuda.current_stream().cuda_stream
            tq = s8.conv_a(hin, wa, s_in, s_mid)
            fa, fb = s8.bind(lib, "conv_a", dtype), s8.bind(lib, "conv_b", dtype)
            calls = {
                ("conv_a", "wrapper"): lambda: s8.conv_a(hin, wa, s_in, s_mid),
                ("conv_a", "direct"): lambda: s8._run_a(fa, hin, wa, s_in, s_mid, "relu",
                                                        torch.cuda.current_stream().cuda_stream),
                ("conv_b", "wrapper"): lambda: s8.conv_b(tq, wb, dtype, res),
                ("conv_b", "direct"): lambda: s8._run_b(fb, tq, wb, dtype, res, 1.0,
                                                        torch.cuda.current_stream().cuda_stream),
            }
            for entry in ("conv_a", "conv_b"):
                direct = calls[(entry, "direct")]
                for _ in range(3):
                    direct()
                torch.cuda.synchronize()
                graph = torch.cuda.CUDAGraph()
                with torch.cuda.graph(graph):
                    for _ in range(reps):
                        direct()
                calls[(entry, "graph")] = graph.replay
            times = chip_smoke.time_windows(torch, {k: v for k, v in calls.items()
                                                    if k[1] != "graph"})
            # a replay runs `reps` calls
            graph_times = chip_smoke.time_windows(
                torch, {k: v for k, v in calls.items() if k[1] == "graph"})
            for key, t in graph_times.items():
                times[key] = tuple(v / reps for v in t)
            host = {}
            for key in calls:
                if key[1] == "graph":
                    continue
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                for _ in range(reps):
                    calls[key]()
                host[key] = 1e6 * (time.perf_counter() - t0) / reps
                torch.cuda.synchronize()
            for entry in ("conv_a", "conv_b"):
                print("overhead %s bf16 %s (4 x 192x192): CUDA events a call: wrapper %s, "
                      "direct %s, graph replay %s; host issue a call: wrapper %.1f us, "
                      "direct %.1f us" % (
                          label, entry, chip_smoke.spread(times[(entry, "wrapper")]),
                          chip_smoke.spread(times[(entry, "direct")]),
                          chip_smoke.spread(times[(entry, "graph")]),
                          host[(entry, "wrapper")], host[(entry, "direct")]), flush=True)
            del hin, wa, wb, res, tq, calls
            torch.cuda.empty_cache()


class Tee:
    """stdout, and a copy in a file, so the whole report survives when only
    the end of the output is kept."""

    def __init__(self, *streams):
        self.streams = streams

    def write(self, text):
        for stream in self.streams:
            stream.write(text)

    def flush(self):
        for stream in self.streams:
            stream.flush()


def main() -> int:
    import numpy as np
    import torch

    parser = argparse.ArgumentParser()
    parser.add_argument("--first-design", help="the first design's source: time and stamp it too")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_s8_variants: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    from larvanet_tpu_torch.ops import build

    dump = Path("chiprun_out") / "s8_variants"
    dump.mkdir(parents=True, exist_ok=True)
    sys.stdout = Tee(sys.stdout, open(dump / "run.log", "w"))
    print("device: %s (torch %s, CUDA %s)" % (chip_smoke.nvidia_smi_line(), torch.__version__,
                                              torch.version.cuda), flush=True)
    print(subprocess.run([build.nvcc(), "--version"], capture_output=True,
                         text=True).stdout.strip().splitlines()[-1], flush=True)
    src = (build.CSRC / "conv3x3_s8.cu").read_text()
    sources = {name: variant_source(src, params) for name, params in VARIANTS.items()}
    sources["stamped"] = stamped(src)
    if args.first_design:
        old = Path(args.first_design).read_text()
        sources["first design"] = old
        sources["first design, stamped"] = first_stamped(old)
    libs = build_libs(sources, build)
    print("stamped copy: %s" % ptxas_line(libs["stamped"][1]), flush=True)
    for i, name in enumerate(VARIANTS):
        log = libs[name][1]
        print("variant %s: %s" % (name, ptxas_line(log)), flush=True)
        for line in log.splitlines():
            if "warning" in line.lower():
                print("  ptxas: %s" % line.strip(), flush=True)
        (dump / ("v%d.log" % i)).write_text(log)
        sass = subprocess.run([str(Path(build.nvcc()).with_name("cuobjdump")), "-sass",
                               str(OUT / ("v%d.so" % i))], capture_output=True, text=True)
        (dump / ("v%d.sass" % i)).write_text(sass.stdout)
    variants(torch, np, {name: libs[name][0] for name in VARIANTS},
             libs["first design"][0] if args.first_design else None)
    wide(torch, np, libs["as built"][0])
    overhead(torch, np, libs["as built"][0])
    phases(torch, np, libs["stamped"][0], PHASES, PHASE_GROUPS)
    if args.first_design:
        phases(torch, np, libs["first design, stamped"][0], FIRST_PHASES,
               ((0, len(FIRST_PHASES)),), first_entry)
    print(chip_smoke.nvidia_smi_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
