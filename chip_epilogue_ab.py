#!/usr/bin/env python3
"""The conv3x3 and s8 kernels of a parent tree (before their epilogues took
relu6 and a leaky_relu slope: entries without a `slope` argument) against
this tree's, in one process on the card, from the repo root:

    git archive b236784 larvanet_tpu_torch/csrc | tar -x -C build/parent
    python3 chip_epilogue_ab.py build/parent/larvanet_tpu_torch/csrc

Both sources are built side by side (nvcc, build.NVCC_FLAGS, into
build/ab/); every existing act (none, relu, leaky_relu 0.1) runs on each
conv3x3 path (the tensor cores, the CUDA cores, the narrow path) in f32 and
bf16 and conv_a (none, relu) in both dtypes, on the same inputs: the
outputs must be equal bit for bit, and each conv pair is timed in turns
(parent, change, change, parent) as CUDA graph replays. Fails if any output
differs."""
import ctypes
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.getcwd())
import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from larvanet_tpu_torch.ops import build, conv3x3  # noqa: E402
from larvanet_tpu_torch.ops import conv3x3_s8 as s8  # noqa: E402

torch.backends.cuda.matmul.allow_tf32 = False
torch.backends.cudnn.allow_tf32 = False
print(cs.nvidia_smi_line(), flush=True)
out_dir = "build/ab"
os.makedirs(out_dir, exist_ok=True)
srcs = {"parent": sys.argv[1], "change": str(build.CSRC)}


def compile_one(job):
    side, stem = job
    lib = os.path.join(out_dir, "%s_%s.so" % (side, stem))
    subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", lib,
                    os.path.join(srcs[side], stem + ".cu")], check=True, capture_output=True)
    return job, lib


jobs = [(side, stem) for side in srcs for stem in ("conv3x3_bias_act", "conv3x3_s8")]
with ThreadPoolExecutor(len(jobs)) as ex:
    libs = {job: ctypes.CDLL(lib) for job, lib in ex.map(compile_one, jobs)}


def conv_fn(side, dtype, path):
    fn = getattr(libs[(side, "conv3x3_bias_act")], conv3x3._ENTRY[(path, dtype)])
    fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 6
                   + ([ctypes.c_float] if side == "change" else []) + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


gen = torch.Generator(device="cuda").manual_seed(0)
stream = torch.cuda.current_stream().cuda_stream
rows = []
for (n, h, w, c, f, act) in ((4, 192, 192, 64, 64, "relu"), (4, 192, 192, 48, 48, None),
                             (4, 192, 192, 3, 64, None), (4, 192, 192, 64, 256, "leaky_relu"),
                             (1, 192, 192, 64, 3, None), (4, 192, 192, 48, 48, "leaky_relu")):
    x32 = torch.randn((n, h, w, c), generator=gen, device="cuda")
    k = torch.randn((3, 3, c, f), generator=gen, device="cuda") / (9 * c) ** 0.5
    b = torch.randn((f,), generator=gen, device="cuda")
    for dtype in (torch.float32, torch.bfloat16):
        x = x32.to(dtype)
        path = conv3x3.path_for(c, f, dtype)
        kmat = conv3x3.entry_weight(k, dtype, path)
        outs = {}
        calls = {}
        for side in srcs:
            fn = conv_fn(side, dtype, path)
            y = torch.empty((n, h, w, f), dtype=dtype, device="cuda")
            extra = [0.1] if side == "change" else []
            args = [x.data_ptr(), kmat.data_ptr(), b.data_ptr(), y.data_ptr(), n, h, w, c, f,
                    conv3x3.ACTS[act], *extra]
            assert fn(*args, stream) == 0
            torch.cuda.synchronize()
            outs[side] = y.clone()
            calls[side] = cs.graph_replay(torch, lambda fn=fn, args=args: fn(
                *args, torch.cuda.current_stream().cuda_stream))
        same = torch.equal(outs["parent"], outs["change"])
        tm = cs.time_windows(torch, {"parent": calls["parent"], "change": calls["change"],
                                     "change ": calls["change"], "parent ": calls["parent"]})
        print("conv3x3 %s %d->%d %s %s: %s; parent %s, change %s" % (
            (n, h, w), c, f, act, str(dtype)[6:], "bit for bit" if same else "DIFFER",
            cs.spread(tm["parent"]), cs.spread(tm["change"])), flush=True)
        rows.append(same)

rng = np.random.default_rng(1)
for c in (64, 48):
    codes = rng.integers(-127, 128, (3, 3, c, c)).astype(np.int8)
    sa = (rng.uniform(0.5, 2.0, c) * 1e-3).astype(np.float32)
    bias = torch.from_numpy(rng.standard_normal(c).astype(np.float32))
    hin32 = torch.randn((4, 192, 192, c), generator=gen, device="cuda") * 3
    for dtype in (torch.float32, torch.bfloat16):
        hin = hin32.to(dtype)
        s_in = float(hin.float().abs().max()) * 1.05 / 127
        wt = s8.make_weight(codes, sa, s_in, bias, dtype, "cuda")
        for act in (None, "relu"):
            outs = {}
            for side in srcs:
                fn = getattr(libs[(side, "conv3x3_s8")], s8._ENTRY[("conv_a", dtype)])
                fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 5 + [ctypes.c_float] * 2
                               + [ctypes.c_int] + ([ctypes.c_float] if side == "change" else [])
                               + [ctypes.c_void_p])
                fn.restype = ctypes.c_int
                y = torch.empty((4, 192, 192, c), dtype=torch.int8, device="cuda")
                extra = [0.1] if side == "change" else []
                assert fn(hin.data_ptr(), wt.entry.data_ptr(), wt.scale.data_ptr(),
                          wt.bias.data_ptr(), y.data_ptr(), 4, 192, 192, c, c, s_in, 0.05,
                          s8.ACTS[act], *extra, stream) == 0
                torch.cuda.synchronize()
                outs[side] = y
            same = torch.equal(outs["parent"], outs["change"])
            print("conv3x3_s8 conv_a %d->%d %s %s: %s" % (c, c, act, str(dtype)[6:],
                                                           "bit for bit" if same else "DIFFER"))
            rows.append(same)
print("epilogue A/B: %d of %d comparisons bit for bit" % (sum(rows), len(rows)))
assert all(rows)
