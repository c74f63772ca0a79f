#!/usr/bin/env python3
"""Where a tile's time goes in the tensor-core fused Winograd ResBlocks.

    python3 chip_wino_phases.py      # from the repo root, on a machine with one H100

Builds a copy of larvanet_tpu_torch/csrc/wino_resblock.cu with clock64()
stamps at the phase boundaries of `wino_resblock_tc_kernel` (thread 0 of
each of the first 64 blocks, on the last tile the block walks), runs
both tensor-core entries on a bf16 batch of 4 x 192x192 LR frames at C =
64, holds each against the plain version, and prints the mean SM cycles
a tile spends in each phase: waiting for its x window and first slab,
transforming x into V, stage A's point products, stage A's epilogue (with
the border pass), transforming t, stage B's point products, stage B's
epilogue. A stamp is thread 0's view; the phases between barriers are
the block's. Exits non-zero without a card or if the source no longer
has a phase boundary this script expects. It stamps the bf16 kernel
only: the f32 entries run another kernel (`wino_resblock_f32_tc_kernel`,
V built one basis tap at a time), whose boundaries it does not mark.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys
import tempfile

PHASES = ("x + U_0 wait", "transform x", "A products", "A epilogue", "transform t",
          "B products", "B epilogue")
BLOCKS = 64
# (a statement that ends a phase or starts one, stamps before it, stamps after it)
STAMPS = (
    ("    __pipeline_wait_prior(0);\n    __syncthreads();  // the x window and U_0", (0,), ()),
    ("    transform<M, Tl::GA, Tl::VWA, Tl::XW, kC, kThreads>(xs, vs);\n", (1,), (2,)),
    ("lane, [] {});\n", (), (3,)),
    ("    transform<M, GB, Tl::VWB, Tl::TC, kTLd, kThreads>(ts, vs);\n", (4,), (5,)),
    ("lane, head);\n", (), (6,)),
    # the closing braces of the tile loop and the kernel: the end of a tile
    ("  }\n}\n\ntemplate <int M, int GB, int TW, int MT, int NQ, int NW>\nint launch_tc",
     (7,), ()),
)
HEAD = ("__device__ long long g_phase[%d][8];\n"
        "#define PHASE(i) { if (threadIdx.x == 0 && blockIdx.x < %d) "
        "g_phase[blockIdx.x][i] = clock64(); }\n" % (BLOCKS, BLOCKS))
READ = ('\nextern "C" int read_phases(void* host) {\n'
        '  return (int)cudaMemcpyFromSymbol(host, g_phase, sizeof(g_phase));\n}\n')


def stamped_source(src: str) -> str:
    anchor = "constexpr int kTLd = kC + 4;"
    for text in [anchor] + [t for t, _, _ in STAMPS]:
        if src.count(text) != 1:
            raise SystemExit("chip_wino_phases: phase boundary not found once: %r" % text[:60])
    src = src.replace(anchor, HEAD + anchor)
    for text, before, after in STAMPS:
        stamp = "".join("PHASE(%d)\n" % i for i in before)
        src = src.replace(text, stamp + text + "".join("PHASE(%d)\n" % i for i in after))
    return src + READ


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_wino_phases: no CUDA device", file=sys.stderr)
        return 1
    from larvanet_tpu_torch.ops import build
    from larvanet_tpu_torch.ops import wino_resblock as wr

    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         check=True).stdout.strip()
    print("device: %s" % smi)
    with tempfile.TemporaryDirectory() as tmp:
        cu = os.path.join(tmp, "wino_phases.cu")
        so = os.path.join(tmp, "wino_phases.so")
        with open(cu, "w") as f:
            f.write(stamped_source((build.CSRC / wr.SOURCE).read_text()))
        subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", so, cu], check=True,
                       capture_output=True, text=True)
        lib = ctypes.CDLL(so)

        c = wr.KERNEL_CHANNELS
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn((4, 192, 192, c), generator=gen, device="cuda").bfloat16()
        k_a, k_b = ((2 * torch.rand((3, 3, c, c), generator=gen, device="cuda") - 1) / 24
                    for _ in range(2))
        b_a, b_b = ((2 * torch.rand((c,), generator=gen, device="cuda") - 1) / 24
                    for _ in range(2))
        stream = torch.cuda.current_stream().cuda_stream
        for m in (2, 4):
            u_a, u_b = (wr.h_transform_kernel(k, m).bfloat16() for k in (k_a, k_b))
            fn = wr.bind(lib, m, torch.bfloat16, "tensor_core")
            args = (x, wr.entry_basis(u_a, "tensor_core"), b_a,
                    wr.entry_basis(u_b, "tensor_core"), b_b, 1.0, m, stream)
            for _ in range(3):
                got = wr._run(fn, *args)
            torch.cuda.synchronize()
            want = wr.wino_resblock_transformed_reference(x, u_a, b_a, u_b, b_b, 1.0, m)
            err = float((got.float() - want.float()).abs().max())
            if err > 2.0 ** -6 * float(want.float().abs().max()):
                raise SystemExit("chip_wino_phases: F(%d,3) disagrees, max |d| %g" % (m, err))
            stamps = np.zeros((BLOCKS, 8), np.int64)
            if lib.read_phases(stamps.ctypes.data_as(ctypes.c_void_p)) != 0:
                raise SystemExit("chip_wino_phases: reading the stamps failed")
            spans = np.diff(stamps[:, :8], axis=1)
            total = stamps[:, 7] - stamps[:, 0]
            print("F(%d,3), 4 x 192x192 bf16: SM cycles per tile (blocks 0-%d): mean %.0f, "
                  "min %d, max %d" % (m, BLOCKS - 1, total.mean(), total.min(), total.max()))
            for i, name in enumerate(PHASES):
                print("  %-14s %8.0f  (%.1f%%)" % (name, spans[:, i].mean(),
                                                   100.0 * spans[:, i].mean() / total.mean()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
