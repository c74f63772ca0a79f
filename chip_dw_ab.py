#!/usr/bin/env python3
"""The depthwise kernels of a parent tree (`csrc/dwconv3x3.cu` before its
redesign: one 8-row tile a block, a fixed tree in shared memory for the
weight gradient) against this tree's, in one process on the card, from the
repo root:

    mkdir -p build/parent
    git archive dc7e992 larvanet_tpu_torch/csrc | tar -x -C build/parent
    python3 chip_dw_ab.py build/parent/larvanet_tpu_torch/csrc

Both sources are built side by side (nvcc, build.NVCC_FLAGS, one thread
each, into build/ab_dw/; ptxas's registers and spills and the SASS mix of
each kernel printed). At every shape of chip_smoke.py's phase 15a (the
forward at DW_SHAPES, its input gradient and the weight gradient at
DW_GRAD_SHAPES), f32 (TF32 off) and bf16, on the same inputs: each side's
forward and input gradient must equal the plain version bit for bit, and
its weight gradient lie within GRAD_RTOL of it with two runs bit for bit.
Each pair is timed in turns (parent, change, change, parent) as CUDA graph
replays of one call of the entry (on operands cast to the entry's types
beforehand: the taps to x's dtype, the bias to f32), and through the
wrapper (`dwconv3x3` / `dwconv3x3_wgrad`, whose `_entry` and `_run_wgrad`
are routed to the side in turn by one extra Python call on both sides: the
host's issue time of a call beside the device's). Each side's replays also
go through torch.profiler: the card's time of each kernel of the call (the
weight gradient's two apart). Last, dwsr_reduced x4 at full width with
random weights from chip_smoke.SEED, its depthwise convs routed to each
side in turn: the serving forward on chip_smoke.LR_BATCH (f32 and bf16)
and the f32 train step at batch TRAIN_BATCH x TRAIN_PATCH^2, timed in
turns, so that the model's end-to-end times with either side's kernels
come from one call. The whole output also goes to
chiprun_out/dw_ab/run.log. Fails if a check of the parent or the change
fails."""
import ctypes
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from unittest import mock

sys.path.insert(0, os.getcwd())
import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from larvanet_tpu_torch.ops import build  # noqa: E402
from larvanet_tpu_torch.ops import dwconv3x3 as dw  # noqa: E402

# the parent's weight gradient took at most this many blocks (its wrapper's
# WGRAD_BLOCKS)
PARENT_WGRAD_BLOCKS = 264
OUT_DIR = "build/ab_dw"
LOG = "chiprun_out/dw_ab/run.log"


def log(line=""):
    print(line, flush=True)
    with open(LOG, "a") as fh:
        fh.write(line + "\n")


def compile_one(job):
    side, src = job
    lib = os.path.join(OUT_DIR, "%s_dwconv3x3.so" % side)
    proc = subprocess.run([build.nvcc(), *build.NVCC_FLAGS, "-o", lib,
                           os.path.join(src, dw.SOURCE)],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError("nvcc failed on the %s source:\n%s" % (side, proc.stdout + proc.stderr))
    return side, lib, proc.stdout + proc.stderr


def sass_mix(lib):
    """{kernel: instruction counts} of `lib` (cuobjdump -sass)."""
    tool = os.path.join(os.path.dirname(build.nvcc()), "cuobjdump")
    sass = subprocess.run([tool, "-sass", lib], capture_output=True, text=True,
                          timeout=120).stdout
    kinds = {"LDGSTS": r"\bLDGSTS\b", "LDG": r"\bLDG\b", "LDS": r"\bLDS\b",
             "STG": r"\bSTG\b", "FMUL": r"\bFMUL\b", "FADD": r"\bFADD\b",
             "FFMA": r"\bFFMA\b", "SHFL": r"\bSHFL\b", "BAR": r"\bBAR\b",
             "LDL/STL": r"\b(?:LDL|STL)\b"}
    out = {}
    for fn in re.split(r"\n\s*Function : ", sass)[1:]:
        name = fn.split("\n", 1)[0].strip()
        out[name] = {k: len(re.findall(v, fn)) for k, v in kinds.items()}
    return out


def in_turns(fns):
    """time_windows' order of the two sides: parent, change, change, parent"""
    return {"parent": fns["parent"], "change": fns["change"], "change ": fns["change"],
            "parent ": fns["parent"]}


def dwsr_in_turns(wrapped):
    """dwsr_reduced x4's serving forward (f32, bf16) and f32 train step, the
    depthwise wrappers routed to a side by `wrapped(side, call)`, timed in
    turns; each side's dwconv3x3 launches held to chip_smoke.py's 15c and
    15d counts."""
    import numpy as np

    from larvanet_tpu_torch.core.registry import get_model

    def held(fns, want, what):
        for side, fn in fns.items():
            dw.reset_launches()
            fn()
            if dw.LAUNCHES_BY_ENTRY != want:
                raise AssertionError("dwsr_reduced %s on the %s: dwconv3x3 launches %s, not %s"
                                     % (what, side, dw.LAUNCHES_BY_ENTRY, want))

    def model(training):
        m = get_model("dwsr_reduced")
        m.parse_args([])
        m.prepare([4], device="cuda", seed=cs.SEED, is_training=training)
        return m

    rng = np.random.default_rng(cs.SEED + 21)
    n, h, w = cs.LR_BATCH
    x = torch.from_numpy(rng.uniform(0.0, 255.0, (n, h, w, 3)).astype(np.float32)).cuda()
    serving = model(False)
    per_dw = cs.MSRR_MODELS["dwsr_reduced"][2]
    for dname in ("f32", "bf16"):
        serving.set_serving_dtype(dname)
        fns = {side: wrapped(side, lambda: serving.fwd_runtime(x)) for side in ("parent", "change")}
        held(fns, {"forward": per_dw, "dgrad": 0, "wgrad": 0}, "forward")
        tm = cs.time_windows(torch, in_turns(fns))
        log("dwsr_reduced x4 forward %s on %s, dwconv3x3 %d a forward: parent %s, change %s "
            "(%.2fx)" % (dname, (n, h, w), per_dw, cs.spread(tm["parent"]),
                         cs.spread(tm["change"]), tm["parent"][0] / tm["change"][0]))
    del serving
    batch, patch = cs.TRAIN_BATCH, cs.TRAIN_PATCH
    lr = rng.uniform(0.0, 255.0, (batch, patch, patch, 3)).astype(np.float32)
    hr = rng.uniform(0.0, 255.0, (batch, 4 * patch, 4 * patch, 3)).astype(np.float32)
    trained = model(True)
    fns = {side: wrapped(side, lambda: trained.train_step(lr, 4, hr))
           for side in ("parent", "change")}
    want = cs.MSRR_TRAIN["dwsr_reduced"]["dw"]
    held(fns, want, "train step")
    tm = cs.time_windows(torch, in_turns(fns), windows=3, reps=5)
    log("dwsr_reduced x4 train step f32 at %d x %d^2, dwconv3x3 %s a step: parent %s, change "
        "%s (%.2fx)" % (batch, patch, want, cs.spread(tm["parent"]), cs.spread(tm["change"]),
                        tm["parent"][0] / tm["change"][0]))
    del trained
    torch.cuda.empty_cache()


def main() -> int:
    os.makedirs(OUT_DIR, exist_ok=True)
    os.makedirs(os.path.dirname(LOG), exist_ok=True)
    open(LOG, "w").close()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log(cs.nvidia_smi_line())
    srcs = {"parent": sys.argv[1], "change": str(build.CSRC)}
    with ThreadPoolExecutor(len(srcs)) as ex:
        built = list(ex.map(compile_one, srcs.items()))
    fns, libs = {}, {}
    blocks = {"parent": PARENT_WGRAD_BLOCKS, "change": dw.WGRAD_BLOCKS}
    for side, lib, ptxas in built:
        log("ptxas %s:\n%s" % (side, ptxas.strip()))
        for name, mix in sass_mix(lib).items():
            log("sass %s %s: %s" % (side, name, mix))
        libs[side] = ctypes.CDLL(lib)
        fns[side] = {(entry, dtype): dw.bind(libs[side], entry, dtype)
                     for entry in ("forward", "wgrad")
                     for dtype in (torch.float32, torch.bfloat16)}
    # the public wrappers, routed to the side named in `on`
    on = ["change"]
    run_wgrad = dw._run_wgrad
    routed = mock.patch.multiple(
        dw, _entry=lambda entry, dtype: fns[on[0]][(entry, dtype)],
        _run_wgrad=lambda fn, x, g, st: run_wgrad(fn, x, g, st, blocks[on[0]]))
    routed.start()

    def wrapped(side, call):
        def run():
            on[0] = side
            return call()
        return run

    gen = torch.Generator(device="cuda").manual_seed(cs.SEED + 15)
    stream = lambda: torch.cuda.current_stream().cuda_stream  # noqa: E731
    checks, ratios = [], []

    def check(side, ok, what):
        checks.append(ok)
        if not ok:
            log("DIFFER: %s %s" % (side, what))

    def kernel_split(calls):
        # {side: "kernel ms, ..."} from torch.profiler's records of 10 replays
        out = {}
        for side, fn in calls.items():
            _, parts = cs.device_breakdown(torch, fn, ("dw_forward", "dw_wgrad_kernel",
                                                      "dw_wgrad_finish"))
            out[side] = ("not measured" if parts is None else ", ".join(
                "%s %.4f" % kv for kv in parts.items() if kv[1]))
        return out

    def compare(label, calls, wrappers):
        tm = cs.time_windows(torch, in_turns(calls))
        tw = cs.time_windows(torch, in_turns(wrappers))
        ratios.append(tm["change"][0] / tm["parent"][0])
        for side, split in kernel_split(calls).items():
            log("  profile %s %s: %s ms" % (label.split(" (")[0], side, split))
        log("%s: replay parent %s, change %s (%.2fx); wrapper parent %s, change %s"
            % (label, cs.spread(tm["parent"]), cs.spread(tm["change"]),
               tm["parent"][0] / tm["change"][0], cs.spread(tw["parent"]),
               cs.spread(tw["change"])))

    for label, (n, h, w), c in cs.DW_SHAPES:
        k = 0.3 * torch.randn((3, 3, 1, c), generator=gen, device="cuda")
        b = torch.randn((c,), generator=gen, device="cuda")
        x32 = 3.0 * torch.randn((n, h, w, c), generator=gen, device="cuda")
        for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            x = x32.to(dtype)
            kx = k.to(dtype)  # the entry's own taps: the replay holds the kernel alone
            want = dw.dwconv3x3_reference(x, k, b)
            calls, wrappers = {}, {}
            for side in srcs:
                fn = fns[side][("forward", dtype)]
                got = dw._run(fn, x, k, b, stream())
                check(side, torch.equal(got, want), "forward %s %s %s" % (label, (n, h, w, c),
                                                                          dname))
                calls[side] = cs.graph_replay(torch, lambda fn=fn: dw._run(fn, x, kx, b,
                                                                           stream()))
                wrappers[side] = wrapped(side, lambda: dw.dwconv3x3(x, k, b))
            plan = dw.plan(libs["change"], (x.data_ptr(), kx.data_ptr(), x.data_ptr()), dtype,
                           x.shape)
            compare("forward %s %s %s (plan %s)" % (label, (n, h, w, c), dname, plan),
                    calls, wrappers)
        del x32
    for label, (n, h, w), c in cs.DW_GRAD_SHAPES:
        k = 0.3 * torch.randn((3, 3, 1, c), generator=gen, device="cuda")
        x32 = 3.0 * torch.randn((n, h, w, c), generator=gen, device="cuda")
        g32 = torch.randn((n, h, w, c), generator=gen, device="cuda")
        zero = torch.zeros((c,), device="cuda")
        kr = dw.dgrad_kernel(k)
        for dname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            x, g = x32.to(dtype), g32.to(dtype)
            krx = kr.to(dtype)
            want = dw.dwconv3x3_reference(g, kr, zero)
            want_k, want_b = dw.dwconv3x3_wgrad_reference(x, g)
            calls, wrappers, wcalls, wwrappers = {}, {}, {}, {}
            for side in srcs:
                fn = fns[side][("forward", dtype)]
                check(side, torch.equal(dw._run(fn, g, kr, zero, stream()), want),
                      "dgrad %s %s" % (label, dname))
                calls[side] = cs.graph_replay(torch, lambda fn=fn: dw._run(fn, g, krx, zero,
                                                                           stream()))
                wfn = fns[side][("wgrad", dtype)]
                dk, db = run_wgrad(wfn, x, g, stream(), blocks[side])
                again = run_wgrad(wfn, x, g, stream(), blocks[side])
                rel = max(float((dk - want_k).abs().max() / want_k.abs().max()),
                          float((db - want_b).abs().max() / want_b.abs().max()))
                same = torch.equal(again[0], dk) and torch.equal(again[1], db)
                check(side, rel <= cs.GRAD_RTOL and same, "wgrad %s %s" % (label, dname))
                log("wgrad %s %s %s: max |d| / max |g| %.3g, two runs %s"
                    % (side, label, dname, rel, "equal" if same else "DIFFER"))
                wcalls[side] = cs.graph_replay(
                    torch, lambda wfn=wfn, side=side: run_wgrad(wfn, x, g, stream(),
                                                                blocks[side]))
                wrappers[side] = wrapped(side, lambda: dw.dwconv3x3(g, kr, zero, dgrad=True))
                wwrappers[side] = wrapped(side, lambda: dw.dwconv3x3_wgrad(x, g))
            plan = dw.plan(libs["change"], (g.data_ptr(), krx.data_ptr(), g.data_ptr()), dtype,
                           x.shape)
            compare("dgrad %s %s %s (plan %s)" % (label, (n, h, w, c), dname, plan),
                    calls, wrappers)
            plan = dw.plan(libs["change"], (x.data_ptr(), g.data_ptr(), g.data_ptr()), dtype,
                           x.shape, "wgrad")
            compare("wgrad %s %s %s (plan %s)" % (label, (n, h, w, c), dname, plan),
                    wcalls, wwrappers)
        del x32, g32
    dwsr_in_turns(wrapped)
    routed.stop()
    log("dw A/B: %d of %d checks held; change / parent time %.3f-%.3f"
        % (sum(checks), len(checks), min(ratios), max(ratios)))
    return 0 if all(checks) else 1


if __name__ == "__main__":
    sys.exit(main())
