#!/usr/bin/env python3
"""On-card smoke run of the PyTorch/CUDA port, `larvanet_tpu_torch`.

    python3 chip_smoke.py        # from the repo root, on a machine with one H100

It drives the port's main path, serving EDSR-baseline x4, on the card and
fails (exit code != 0, no result line) if any phase fails:

 1. device: CUDA must be available; prints nvidia-smi's name and power limit.
 2. build: compiles every kernel of the path from larvanet_tpu_torch/csrc/
    with nvcc for sm_90a, all sources at once, and prints the seconds.
 3. kernels: holds each kernel against its plain PyTorch version on the
    card at every conv shape of the x4 forward, for a batch of 4 LR tiles
    of 192x192 and one ragged 339x510 frame, in f32 (TF32 off) and bf16.
    Prints each shape's kernel, plain-version and F.conv2d times (CUDA
    events, mean of TIMED_REPS launches after WARMUP_REPS) and its bound.
 4. serve: EDSR-baseline x4 at full width (64 features, 16 ResBlocks),
    random weights from SEED with final_conv rescaled so the output spans
    the pixel range (see fit_output_range), saved as a .pth; the port's HTTP server
    (build_service + make_server) in this process with --dynamic_batch 2.
    After /healthz turns 200, the launch counters are zeroed and four PNG
    frames are POSTed (two of one geometry, held so they form one batch,
    and two of other sizes, one odd); the counters are read right after.
    Every response must have the x4 geometry; at least MIN_INSIDE of the
    plain-version forward's pixels must lie strictly inside (0, 255), so
    the clamp hides nothing; the response must lie within 1 uint8 level
    of that forward, and the unclamped f32 forward through the kernels
    within FWD_RTOL of it.
 5. forward: times the whole x4 forward on the batch of 4 x 192x192 LR
    tiles, f32 and bf16 (CUDA events), to set the convs' share against it.
 6. prints the kernels JSON line, the nvidia-smi line, then the result line
    {"ok": true, "device": {...}}.

The kernels line reports, per kernel: its launches in phase 4; and summed
over the convs of one x4 forward of the 4 x 192x192 f32 batch (the 37
launches), its time, its plain version's, F.conv2d's and its bound; and the
largest f32 error of phase 3.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request
from unittest import mock

SEED = 0
WARMUP_REPS = 2
TIMED_REPS = 10
# f32: the kernel and the plain version sum the same f32 products in another
# order; tools/pallas_check.py holds the TPU kernel to the same bar.
F32_ATOL = 2e-4
# bf16: both see the same bf16 inputs and sum in f32, so the outputs differ by
# at most one bf16 rounding step of the value: 2^-7 relative, plus a floor for
# values near 0.
BF16_RTOL = 2.0 ** -7
BF16_ATOL = 1e-3
# the whole f32 forward, kernels against plain versions: 37 convs of
# errors like F32_ATOL's, relative to the largest output value
FWD_RTOL = 1e-4
# share of served pixels strictly inside (0, 255)
MIN_INSIDE = 0.9
# H100 SXM peaks (NVIDIA data sheet): f32 on CUDA cores, bf16 dense tensor
# cores, HBM3 bandwidth. The f32 kernel runs on CUDA cores.
PEAK_FLOPS = {"f32": 67e12, "bf16": 989e12}
PEAK_BYTES = 3.35e12
LR_BATCH = (4, 192, 192)
RAGGED = (1, 339, 510)
# (name, LR-size multiple of the conv's input, C, F, act, launches per x4 forward)
X4_CONVS = (
    ("first_conv", 1, 3, 64, None, 1),
    ("res_block.body.0", 1, 64, 64, "relu", 16),
    ("res_block.body.2+after_res_conv", 1, 64, 64, None, 17),
    ("upsample.body.0", 1, 64, 256, None, 1),
    ("upsample.body.2", 2, 64, 256, None, 1),
    ("final_conv", 4, 64, 3, None, 1),
)


def nvidia_smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def time_ms(torch, fn) -> float:
    for _ in range(WARMUP_REPS):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(TIMED_REPS):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / TIMED_REPS


def bound_ms(n, h, w, c, f, dtype_name):
    """The least time of one conv: bytes (x, kernel, outputs once; bias f32)
    over HBM bandwidth vs operations over the dtype's peak."""
    item = 4 if dtype_name == "f32" else 2
    nbytes = item * (n * h * w * (c + f) + 9 * c * f) + 4 * f
    flops = 2 * n * h * w * 9 * c * f
    t_bytes, t_ops = nbytes / PEAK_BYTES, flops / PEAK_FLOPS[dtype_name]
    return 1e3 * max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def kernel_phase(torch):
    """Phase 3. Returns (per-forward sums at the LR batch in f32, worst f32 err)."""
    import torch.nn.functional as F

    from larvanet_tpu_torch.ops.conv3x3 import (conv3x3_bias_act,
                                                conv3x3_bias_act_reference)

    dtypes = {"f32": torch.float32, "bf16": torch.bfloat16}
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    sums = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bound_ms": 0.0}
    bound_kind = {}
    worst_f32 = 0.0
    for geometry in (LR_BATCH, RAGGED):
        for name, mult, c, f, act, count in X4_CONVS:
            n, h, w = geometry[0], geometry[1] * mult, geometry[2] * mult
            x32 = torch.randn((n, h, w, c), generator=gen, device="cuda")
            k32 = 0.1 * torch.randn((3, 3, c, f), generator=gen, device="cuda")
            b32 = torch.randn((f,), generator=gen, device="cuda")
            for dname, dtype in dtypes.items():
                x = x32.to(dtype)
                got = conv3x3_bias_act(x, k32, b32, act)
                torch.cuda.synchronize()  # a fault during the run shows here
                want = conv3x3_bias_act_reference(x, k32, b32, act)
                if got.shape != want.shape or got.dtype != want.dtype:
                    raise AssertionError("%s: kernel gave %s %s, plain %s %s" % (
                        name, tuple(got.shape), got.dtype, tuple(want.shape),
                        want.dtype))
                diff = (got.float() - want.float()).abs()
                err = float(diff.max())
                if dname == "f32":
                    ok = err <= F32_ATOL
                    worst_f32 = max(worst_f32, err)
                else:
                    ok = bool((diff <= BF16_ATOL + BF16_RTOL * want.float().abs()).all())
                if not ok or not torch.isfinite(got).all():
                    raise AssertionError("%s %s %s: kernel disagrees with its plain "
                                         "version, max |d| = %g" % (name, dname,
                                                                    (n, h, w, c, f), err))
                w_oihw = k32.to(dtype).permute(3, 2, 0, 1).contiguous()
                x_nchw = x.permute(0, 3, 1, 2)  # channels_last view of NHWC
                b_lib = b32.to(dtype)
                ms = time_ms(torch, lambda: conv3x3_bias_act(x, k32, b32, act))
                plain = time_ms(torch, lambda: conv3x3_bias_act_reference(x, k32, b32, act))
                lib = time_ms(torch, lambda: F.conv2d(x_nchw, w_oihw, b_lib, padding=1))
                bound, by = bound_ms(n, h, w, c, f, dname)
                print("conv3x3 %-32s %-4s x=%s C=%d F=%d act=%s: kernel %.4f ms, "
                      "plain %.4f ms, F.conv2d %.4f ms, bound %.4f ms (%s), "
                      "max|d| %.3g" % (name, dname, (n, h, w), c, f, act, ms, plain,
                                       lib, bound, by, err), flush=True)
                if geometry == LR_BATCH and dname == "f32":
                    sums["ms"] += count * ms
                    sums["plain_ms"] += count * plain
                    sums["library_ms"] += count * lib
                    sums["bound_ms"] += count * bound
                    bound_kind[by] = bound_kind.get(by, 0.0) + count * bound
                del x, got, want, diff
            del x32, k32, b32
            torch.cuda.empty_cache()
    sums["bound_by"] = max(bound_kind, key=bound_kind.get)
    return sums, worst_f32


def _http(url, data=None):
    req = urllib.request.Request(url, data=data, method="POST" if data else "GET")
    try:
        with urllib.request.urlopen(req, timeout=300) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def fit_output_range(torch, model, img_chw):
    """Rescale final_conv so the random model's output on `img_chw` has
    mean 128 and std 40 in every channel. Left as drawn, the random convs
    shrink the signal and the inverse mean shift puts nearly every pixel
    below 0, where the clamp to [0, 255] would hide any error of the
    forward. mean_inverse_shift stays the intended -mean."""
    module = model.module
    shift = module.mean_inverse_shift.bias
    f = model.upscale_device([img_chw], 4, uint8=False) - shift
    mean_f = f.mean((0, 1, 2))
    a = 40.0 / float(f.std())
    with torch.no_grad():
        module.final_conv.weight.mul_(a)
        module.final_conv.bias.copy_(a * (module.final_conv.bias - mean_f)
                                     + 128.0 - shift)


def serve_phase(torch, device="cuda"):
    """Phase 4. Returns the kernel launches counted while serving, and the
    served model."""
    import numpy as np

    from larvanet_tpu_torch.cli import serve
    from larvanet_tpu_torch.core.registry import get_model
    from larvanet_tpu_torch.data import png
    from larvanet_tpu_torch.eval.metrics import psnr_rgb_device
    from larvanet_tpu_torch.models import layers
    from larvanet_tpu_torch.ops import conv3x3

    rng = np.random.default_rng(SEED)

    def frame(h, w):
        # smooth gradients plus noise, like a photo more than pure noise
        yy, xx = np.mgrid[0:h, 0:w]
        base = np.stack([xx * 255.0 / w, yy * 255.0 / h,
                         (xx + yy) * 127.0 / (h + w)])
        noisy = base + rng.normal(0, 12, (3, h, w))
        return np.clip(noisy, 0, 255).astype(np.uint8)

    frames = [frame(120, 160), frame(120, 160), frame(67, 93), frame(96, 128)]
    with tempfile.TemporaryDirectory() as tmp:
        model = get_model("edsr")
        model.parse_args([])
        model.prepare([4], device=device, seed=SEED)
        n_params = model.num_parameters()
        if n_params != 1517571:
            raise AssertionError("EDSR-baseline x4 has %d parameters, not 1517571"
                                 % n_params)
        fit_output_range(torch, model, frames[0])
        pth = os.path.join(tmp, "edsr_baseline_x4.pth")
        torch.save(model.module.state_dict(), pth)
        del model

        args, remaining = serve.build_parser().parse_known_args(
            ["--model", "edsr", "--scales", "4", "--restore_path", pth,
             "--device", device, "--dynamic_batch", "2"])
        service = serve.build_service(args, remaining)
        httpd = serve.make_server(service, "127.0.0.1", 0)
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        url = "http://127.0.0.1:%d" % httpd.server_address[1]
        try:
            code, _ = _http(url + "/healthz")
            if code != 503:
                raise AssertionError("/healthz gave %d before warmup" % code)
            t0 = time.perf_counter()
            service.warmup(128, 128)
            print("serve: warmup took %.3f s" % (time.perf_counter() - t0))
            code, _ = _http(url + "/healthz")
            if code != 200:
                raise AssertionError("/healthz gave %d after warmup" % code)

            bodies = [png.encode(f.transpose(1, 2, 0)) for f in frames]
            replies = [None] * len(frames)
            wall = [0.0] * len(frames)

            def post(i):
                t = time.perf_counter()
                replies[i] = _http(url + "/upscale", bodies[i])
                wall[i] = time.perf_counter() - t

            conv3x3.LAUNCHES = 0
            # hold the dispatch lock until both same-geometry requests wait,
            # so the server coalesces them into one batch of 2
            with service._lock:
                pair = [threading.Thread(target=post, args=(i,)) for i in (0, 1)]
                for t in pair:
                    t.start()
                deadline = time.perf_counter() + 60
                while service.info()["queue_depth"] < 2:
                    if time.perf_counter() > deadline:
                        raise AssertionError("the two requests never queued")
                    time.sleep(0.005)
            for t in pair:
                t.join(timeout=300)
            for i in (2, 3):
                post(i)
            launches = conv3x3.LAUNCHES
            info = json.loads(_http(url + "/info")[1])
        finally:
            httpd.shutdown()
            httpd.server_close()
            thread.join(timeout=60)

        print("serve: /info num_requests=%d num_forwards=%d mean_batch_size=%s "
              "device_seconds=%s queue_wait_seconds=%s device_memory_mb=%s"
              % (info["num_requests"], info["num_forwards"], info["mean_batch_size"],
                 info["device_seconds"], info["queue_wait_seconds"],
                 info["device_memory_mb"]))
        print("serve: client wall seconds per request: %s"
              % ", ".join("%.4f" % s for s in wall))
        if info["num_requests"] != 4 or info["num_forwards"] != 3:
            raise AssertionError("expected 4 requests in 3 forwards (one batch of "
                                 "2), /info says %s" % info)
        if launches != 37 * info["num_forwards"]:
            raise AssertionError("conv3x3 kernel launched %d times for %d forwards, "
                                 "not 37 each" % (launches, info["num_forwards"]))
        print("serve: %d conv3x3 kernel launches for %d forwards (37 each)"
              % (launches, info["num_forwards"]))

        for i, (img, (code, body)) in enumerate(zip(frames, replies)):
            if code != 200:
                raise AssertionError("request %d: HTTP %d %r" % (i, code, body[:80]))
            got = png.decode(body)
            h, w = img.shape[1:]
            if got.shape != (4 * h, 4 * w, 3):
                raise AssertionError("request %d: reply %s, not x4 of %s"
                                     % (i, got.shape, (h, w)))
            # the unclamped f32 forward through the kernels, then the same
            # forward with every conv in its plain version
            fwd = service.model.upscale_device([img], 4, uint8=False)[0]
            with mock.patch.object(layers, "conv3x3_bias_act",
                                   conv3x3.conv3x3_bias_act_reference):
                ref = service.model.upscale_device([img], 4, uint8=False)[0]
            if not (torch.isfinite(ref).all() and torch.isfinite(fwd).all()):
                raise AssertionError("request %d: forward not finite" % i)
            fwd_err = float((fwd - ref).abs().max())
            fwd_bar = FWD_RTOL * float(ref.abs().max())
            ref_u8 = torch.clamp(torch.round(ref), 0, 255).to(torch.int16)
            inside = float(((ref_u8 > 0) & (ref_u8 < 255)).float().mean())
            got_t = torch.from_numpy(got).to(ref.device).to(torch.int16)
            levels = int((got_t - ref_u8).abs().max())
            psnr = float(psnr_rgb_device(got_t[None].float(), ref[None]))
            print("serve: request %d %dx%d -> %dx%d: %.4f of pixels inside (0, 255), "
                  "f32 max |d| %.3g (bar %.3g), max %d uint8 level(s) from the "
                  "plain-version forward, PSNR %.2f dB" % (
                      i, h, w, 4 * h, 4 * w, inside, fwd_err, fwd_bar, levels, psnr))
            if inside < MIN_INSIDE:
                raise AssertionError("request %d: only %.4f of the pixels inside "
                                     "(0, 255)" % (i, inside))
            if fwd_err > fwd_bar or levels > 1:
                raise AssertionError("request %d: kernel forward disagrees with the "
                                     "plain forward" % i)
    return launches, service.model


def forward_phase(torch, model):
    """The whole x4 forward (`fwd_runtime`) on the LR batch of phase 3, in
    f32 and bf16: the denominator of the conv kernel's share of a forward."""
    n, h, w = LR_BATCH
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    x = 255.0 * torch.rand((n, h, w, 3), generator=gen, device="cuda")
    for name in ("f32", "bf16"):
        model.set_serving_dtype(name)
        ms = time_ms(torch, lambda: model.fwd_runtime(x))
        print("forward: EDSR-baseline x4, %d x %dx%d LR, %s: %.4f ms per forward, "
              "%.3f LR-MP/s" % (n, h, w, name, ms, n * h * w / 1e3 / ms))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    print("device: %s (torch %s, CUDA %s)" % (smi, torch.__version__, torch.version.cuda))

    from larvanet_tpu_torch.ops import build

    t0 = time.perf_counter()
    built = build.build()
    print("build: %.2f s (%s)" % (time.perf_counter() - t0,
                                   ", ".join("%s %.2f s" % kv for kv in built.items())
                                   or "cached"))
    for source in build.SOURCES:
        print("build log %s:\n%s" % (source, build.build_log(source).strip()))

    sums, worst_f32 = kernel_phase(torch)
    launches, model = serve_phase(torch)
    forward_phase(torch, model)

    kernels = [{
        "name": "conv3x3_bias_act",
        "route": "cuda",
        "source": "larvanet_tpu_torch/csrc/conv3x3_bias_act.cu",
        "replaces": "larvanet_tpu/ops/pallas_conv.py:61",
        "launches": launches,
        "max_abs_err": worst_f32,
        "ms": sums["ms"],
        "plain_ms": sums["plain_ms"],
        "bound_ms": sums["bound_ms"],
        "bound_by": sums["bound_by"],
        "library_ms": sums["library_ms"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(nvidia_smi_line())
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
