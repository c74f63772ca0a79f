"""Production serving: a persistent HTTP SR server on the card.

The port of larvanet_tpu/cli/serve.py: the checkpoint is restored and
the kernels built once, then every request reuses them. Only the
standard library's HTTP server:

    python -m larvanet_tpu_torch.cli.serve --model edsr --scales 4 \
        --restore_path model.pth --port 8080 [--dynamic_batch 4] \
        [--chop_forward | --tile_forward] [--ema 1] [--dp_devices N]
    python -m larvanet_tpu_torch.cli.serve --model LarvaNet --num_modules 2 \
        --num_blocks 16,16 --scales 4 --restore_path larvanet.pth

Endpoints:
    GET  /healthz   -> 200 "ok" once the warmup forward has run
    GET  /info      -> JSON: model, scale, request counters, p50/p95/p99
                       device and queue-wait latencies, memory
    GET  /metrics   -> /info as Prometheus text
    POST /upscale   -> PNG body in, SR PNG out

Concurrency: a ThreadingHTTPServer; PNG decode and encode run in the
request threads, the device dispatch is serialized by a lock. At most
--max_queue requests wait for the device; beyond that a request gets an
immediate 503 + Retry-After. Requests of one geometry that are waiting
together are coalesced into one batched forward (up to --dynamic_batch),
and the device->host pull of a finished batch runs outside the dispatch
lock, so the next batch's kernels are queued behind it (up to
--pipeline_depth batches launched but not yet pulled).

Modes (`/info` "mode"): "direct" above; "chop" (--chop_forward, the
reference's 2x2 chop) and "tile" (--tile_forward, batched tiles) run each
request alone through eval/tiling.py under the dispatch lock, as JAX's
server does; --dynamic_batch > 1 does not compose with them and exits.
--restore_path takes a .pth or a JAX .ckpt; --ema serves its parameter
average.

--int8_trunk 1 serves the W8A8 trunk (bf16 whatever --serving_dtype says;
odd widths take the exact forward), calibrated on the first 4 PNGs of
--int8_calib_path, or, without it, on noise with a warning, as JAX's
server does.

--artifact FILE serves a serving artifact (cli/export.py --stablehlo,
utils/aot.py) through `ArtifactService`: no model zoo, no restore, no
graph build (`/info` "mode" "artifact-direct" or "artifact-tile", with the
artifact's "path_desc" and "input_shape"). Direct mode takes requests of
exactly the exported LR geometry, and a batch-N artifact coalesces up to N
waiting requests into one call; --tile_forward serves any frame at least
the exported square tile through tiles of that size. --dynamic_batch,
--chop_forward, --int8_trunk, --spatial_shard, --dp_devices, --ema, a
--serving_dtype other than f32 and --restore_path are refused with it, as
in JAX.

--dp_devices N splits every forward's batch over N devices (parallel/
mesh.use_data_parallel_eval; on the CPU a mesh of N repeats the CPU, on
the card N distinct cards): tile batches are padded to a multiple of N,
and in direct mode --dynamic_batch is raised to N and each coalesced batch
is padded up to a multiple of N. --spatial_shard N splits each frame's
rows over N devices with --spatial_halo rows exchanged (parallel/halo.py),
on the module graph, as JAX does; with fewer cards than N it is ignored
with a notice. --collapsed_tail 1 (the default, as in JAX) serves EDSR through the
collapsed linear tail (ops/collapsed_tail.py: the tail probed once into
one 5x5 conv, border operators and one shuffle, on the conv_kxk kernel);
0 keeps the module's own tail.
--packed_trunk is a TPU layout rewrite of the same function: accepted,
ignored, with a notice, but for MAMNet, which takes the same collapsed tail
whatever --collapsed_tail says, as JAX's make_packed_mamnet_forward does,
and its module graph under --packed_trunk 0.
"""

from __future__ import annotations

import argparse
import collections
import json
import signal
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import numpy as np
import torch

from larvanet_tpu_torch.cli import common
from larvanet_tpu_torch.data import png
from larvanet_tpu_torch.eval.tiling import TiledUpscaler, upscale_with_chop_forward

# refused with --artifact (larvanet_tpu/cli/serve.py:768-796)
ARTIFACT_REFUSED = ("chop_forward", "int8_trunk", "spatial_shard", "dp_devices", "ema")
IGNORED = ("packed_trunk",)


class ServerBusy(RuntimeError):
    """Raised when --max_queue requests are already waiting on the device."""


def _percentiles(values, qs=(50, 95, 99)):
    if not values:
        return {("p%d" % q): 0.0 for q in qs}
    s = sorted(values)
    out = {}
    for q in qs:
        idx = min(len(s) - 1, max(0, int(round(q / 100.0 * (len(s) - 1)))))
        out["p%d" % q] = round(s[idx], 6)
    return out


class SRService:
    """A restored model behind one device lock, shared by HTTP threads.

    Every request enqueues an entry and competes for a pipeline slot and
    the dispatch lock; whichever thread gets the lock serves its own
    entry plus up to dynamic_batch - 1 waiting entries of the same
    geometry in one forward. Batch sizes come from power-of-two buckets
    no larger than the number waiting, so nothing is padded and a lone
    request runs at once at batch 1. Per-request device and queue-wait
    latencies go into a sliding window for /info.

    `mode` "chop" (the reference's chop-forward, `chop_overlap`) or "tile"
    (`tiler`, a TiledUpscaler) runs each request alone through that
    forward, which pulls its f32 frame itself."""

    def __init__(self, model, scale: int, max_queue: int = 32,
                 latency_window: int = 1024, dynamic_batch: int = 1,
                 device_uint8: bool = True, pipeline_depth: int = 2,
                 uint8_input: bool = True, mode: str = "direct", tiler=None,
                 chop_overlap: int = 20, batch_multiple: int = 1):
        if mode not in ("direct", "chop", "tile") or (mode == "tile") != (tiler is not None):
            raise ValueError("mode %r with tiler %r" % (mode, tiler))
        if mode != "direct" and int(dynamic_batch) > 1:
            raise ValueError("--dynamic_batch coalesces direct forwards only")
        self.model = model
        self.scale = scale
        self.mode = mode
        self.tiler = tiler
        self.chop_overlap = int(chop_overlap)
        # quantize on the device before the pull: a quarter of the bytes,
        # and byte-equal to quantizing the f32 frame on the host
        self.device_uint8 = bool(device_uint8)
        # PNG decodes are uint8; the cast to f32 happens on the device
        self.input_dtype = np.uint8 if uint8_input else np.float32
        self.max_queue = int(max_queue)
        # the data-parallel mesh's size (--dp_devices): every forwarded
        # batch is a multiple of it, a short one padded with copies of its
        # first frame, dropped on the device before the pull
        # (larvanet_tpu/cli/serve.py:94-111)
        self._multiple = max(1, int(batch_multiple))
        self.dynamic_batch = max(self._multiple, int(dynamic_batch))
        cap = -(-self.dynamic_batch // self._multiple) * self._multiple
        self._buckets = []
        b = self._multiple
        while b < cap:
            self._buckets.append(b)
            b *= 2
        self._buckets.append(cap)
        self._pending = []                    # coalescing queue (under _stats)
        self._lock = threading.Lock()         # serializes device dispatch
        self._stats = threading.Lock()        # guards counters + window
        # bounds batches launched but not yet pulled (device memory)
        self._pipeline = max(1, int(pipeline_depth))
        self._pull_sem = threading.Semaphore(self._pipeline)
        self._waiting = 0
        self.num_requests = 0
        self.num_rejected = 0
        self.num_forwards = 0
        self.total_device_s = 0.0
        self._lat_device = collections.deque(maxlen=latency_window)
        self._lat_wait = collections.deque(maxlen=latency_window)
        self.ready = False
        self.draining = False

    def _dispatch_batch(self, imgs):
        """Launch the forward on `imgs` (a whole bucket) and return a
        zero-argument `pull()` that copies the outputs to the host and
        returns them as a list of CHW arrays."""
        if self.mode == "chop":
            out = upscale_with_chop_forward(self.model, imgs[0], self.scale,
                                            self.chop_overlap)
            return lambda: [out]
        if self.mode == "tile":
            out = self.tiler.upscale_chw(imgs[0])
            return lambda: [out]
        n = len(imgs)
        bucket = next((b for b in self._buckets if b >= n), n)
        if bucket > n:
            dev = self.model.upscale_device(list(imgs) + [imgs[0]] * (bucket - n), self.scale,
                                            uint8=self.device_uint8, keep=n)
        else:
            dev = self.model.upscale_device(imgs, self.scale, uint8=self.device_uint8)

        def pull():
            arr = dev.cpu().numpy().transpose(0, 3, 1, 2)
            return list(arr)

        return pull

    def upscale_chw(self, img_chw: np.ndarray) -> np.ndarray:
        entry = {"img": img_chw, "shape": tuple(img_chw.shape),
                 "event": threading.Event(), "t_q": time.perf_counter(),
                 "out": None, "err": None}
        with self._stats:
            if self._waiting >= self.max_queue:
                self.num_rejected += 1
                raise ServerBusy(
                    "%d requests already queued on the device (--max_queue)"
                    % self._waiting)
            self._waiting += 1
            self._pending.append(entry)
        try:
            while not entry["event"].is_set():
                with self._stats:
                    mine = any(e is entry for e in self._pending)
                if not mine:
                    # a leader took our entry; its event fires when the
                    # batch's pull completes (or fails)
                    entry["event"].wait()
                    break
                # timed, so we re-check whether another leader served us
                if not self._pull_sem.acquire(timeout=0.1):
                    continue
                batch = None
                pull = None
                err = None
                with self._lock:
                    # identity-based list surgery: entries hold numpy
                    # arrays, so == comparisons are ill-defined
                    with self._stats:
                        if any(e is entry for e in self._pending):
                            cand = [e for e in self._pending
                                    if e["shape"] == entry["shape"]]
                            # the largest bucket the waiting requests fill; fewer
                            # than the smallest are padded up to it
                            fit = [b for b in self._buckets if b <= len(cand)]
                            k = fit[-1] if fit else len(cand)
                            batch = cand[:k]
                            if not any(e is entry for e in batch):
                                batch = cand[: k - 1] + [entry]
                            taken = set(map(id, batch))
                            self._pending = [e for e in self._pending
                                             if id(e) not in taken]
                    if batch is not None:
                        t0 = time.perf_counter()
                        try:
                            pull = self._dispatch_batch(
                                [e["img"] for e in batch])
                        except Exception as exc:
                            err = exc
                if batch is None:
                    # served between the pending check and the lock
                    self._pull_sem.release()
                    continue
                if err is not None:
                    self._pull_sem.release()
                    for e in batch:
                        e["err"] = err
                        e["event"].set()
                    break
                # the pull runs OUTSIDE the dispatch lock
                try:
                    outs = pull()
                except Exception as exc:
                    for e in batch:
                        e["err"] = exc
                        e["event"].set()
                    break
                finally:
                    self._pull_sem.release()
                dev_s = time.perf_counter() - t0
                with self._stats:
                    for e in batch:
                        self.total_device_s += dev_s
                        self.num_requests += 1
                        self._lat_device.append(dev_s)
                        self._lat_wait.append(t0 - e["t_q"])
                    self.num_forwards += 1
                for e, o in zip(batch, outs):
                    e["out"] = o
                    e["event"].set()
                break
            if entry["err"] is not None:
                raise entry["err"]
            return entry["out"]
        finally:
            with self._stats:
                self._waiting -= 1

    def drain(self, timeout=None, poll_s=0.05) -> bool:
        """Stop admitting requests (the HTTP layer sheds with 503 once
        draining is set) and wait for in-flight ones. False if they did
        not finish within `timeout`."""
        self.draining = True
        t0 = time.perf_counter()
        while True:
            with self._stats:
                if self._waiting == 0:
                    return True
            if timeout is not None and time.perf_counter() - t0 > timeout:
                return False
            time.sleep(poll_s)

    def warmup(self, height: int, width: int) -> None:
        """Build the kernels and run every batch bucket once at the warmup
        geometry before accepting traffic; then zero the counters."""
        dummy = np.zeros((3, height, width), self.input_dtype)
        self.upscale_chw(dummy)
        for b in self._buckets[1:]:
            self._dispatch_batch([dummy] * b)()
        with self._stats:
            self.num_requests = 0
            self.num_rejected = 0
            self.num_forwards = 0
            self.total_device_s = 0.0
            self._lat_device.clear()
            self._lat_wait.clear()
        self.ready = True

    def info(self) -> dict:
        with self._stats:
            n = self.num_requests
            fwd = self.num_forwards
            mean_s = self.total_device_s / n if n else 0.0
            dev = _percentiles(self._lat_device)
            wait = _percentiles(self._lat_wait)
            waiting = self._waiting
            rejected = self.num_rejected
        return {
            "model": self.model.registry_name,
            "scale": self.scale,
            "mode": self.mode,
            "device": str(self.model.device),
            "ready": self.ready,
            "draining": self.draining,
            "num_requests": n,
            "num_rejected": rejected,
            "queue_depth": waiting,
            "max_queue": self.max_queue,
            "dynamic_batch": self.dynamic_batch,
            "pipeline_depth": self._pipeline,
            "device_uint8": self.device_uint8,
            "uint8_input": self.input_dtype == np.uint8,
            "num_forwards": fwd,
            "mean_batch_size": round(n / fwd, 3) if fwd else 0.0,
            "mean_device_seconds": round(mean_s, 6),
            "device_seconds": dev,
            "queue_wait_seconds": wait,
            "host_rss_mb": host_rss_mb(),
            "device_memory_mb": device_memory_mb(self.model.device),
        }


class ArtifactService(SRService):
    """Serve from a serving artifact (cli/export.py --stablehlo;
    larvanet_tpu/cli/serve.py:381-437): no model zoo, no checkpoint
    restore, no graph build, only `load_artifact`. Direct mode requires
    requests of exactly the exported LR geometry; --tile_forward serves any
    frame at least the exported tile through tiles of that size (the
    artifact's batch padded or chunked). Smaller frames are refused in both
    modes: zero-padding them into the fixed canvas would not be exact for
    these models, so export a smaller artifact for small inputs instead."""

    def __init__(self, path: str, tile: bool, tile_overlap: int = 24, max_queue: int = 32,
                 device="cuda", pipeline_depth: int = 2, device_uint8: bool = True,
                 uint8_input: bool = True):
        from larvanet_tpu_torch.utils.aot import ArtifactModel

        model = ArtifactModel(path, device)
        self.header = model.header
        tiler = None
        if tile:
            h, w = model.height, model.width
            if h != w:
                raise ValueError("--tile_forward over an artifact needs a square exported "
                                 "geometry, got %dx%d" % (h, w))
            tiler = TiledUpscaler(model.fwd_runtime, scale=model.scale, tile_size=h,
                                  overlap=tile_overlap, max_batch=max(model.batch, 16),
                                  device=model.device)
        # a batch-N artifact pays its whole batch each call: direct mode
        # coalesces up to N waiting requests into it
        dyn = model.batch if (not tile and model.batch > 1) else 1
        super().__init__(model, model.scale, max_queue=max_queue, dynamic_batch=dyn,
                         device_uint8=device_uint8, pipeline_depth=pipeline_depth,
                         uint8_input=uint8_input, mode="tile" if tile else "direct",
                         tiler=tiler)

    def warmup(self, height: int, width: int) -> None:
        # the exported geometry whatever --warmup_size says: the artifact has
        # one shape, and the tiler's small-frame call must not see a smaller one
        if self.mode == "direct":
            height, width = self.model.height, self.model.width
        else:
            height, width = max(height, self.model.height), max(width, self.model.width)
        super().warmup(height, width)

    def info(self) -> dict:
        out = super().info()
        # whether the model zoo was imported: an artifact needs only the ops
        out.update(mode="artifact-" + self.mode, path_desc=self.header.get("path_desc", ""),
                   input_shape=self.header.get("input_shape"),
                   model_zoo_loaded="larvanet_tpu_torch.models" in sys.modules)
        return out


def host_rss_mb():
    """Server-process resident set (MB), the leak signal of a long soak."""
    try:
        with open("/proc/self/status") as f:
            for line in f:
                if line.startswith("VmRSS:"):
                    return round(int(line.split()[1]) / 1024.0, 1)
    except (OSError, ValueError, IndexError):
        return None
    return None


def device_memory_mb(device: torch.device):
    """Bytes PyTorch holds in tensors on the card (None on the CPU)."""
    if device.type != "cuda":
        return None
    return round(torch.cuda.memory_allocated(device) / 1e6, 1)


def prometheus_metrics(info: dict) -> bytes:
    """/info as Prometheus text exposition (counters + summary quantiles)."""
    lines = [
        "# TYPE lvt_requests_total counter",
        "lvt_requests_total %d" % info.get("num_requests", 0),
        "# TYPE lvt_rejected_total counter",
        "lvt_rejected_total %d" % info.get("num_rejected", 0),
        "# TYPE lvt_forwards_total counter",
        "lvt_forwards_total %d" % info.get("num_forwards", 0),
        "# TYPE lvt_queue_depth gauge",
        "lvt_queue_depth %d" % info.get("queue_depth", 0),
        "# TYPE lvt_ready gauge",
        "lvt_ready %d" % (1 if info.get("ready") else 0),
        "# TYPE lvt_draining gauge",
        "lvt_draining %d" % (1 if info.get("draining") else 0),
        "# TYPE lvt_mean_batch_size gauge",
        "lvt_mean_batch_size %s" % info.get("mean_batch_size", 0.0),
    ]
    for gauge, key in (("lvt_host_rss_mb", "host_rss_mb"),
                       ("lvt_device_memory_mb", "device_memory_mb")):
        if info.get(key) is not None:
            lines += ["# TYPE %s gauge" % gauge,
                      "%s %s" % (gauge, info[key])]
    for name, key in (("lvt_device_seconds", "device_seconds"),
                      ("lvt_queue_wait_seconds", "queue_wait_seconds")):
        lines.append("# TYPE %s summary" % name)
        for q, v in sorted(info.get(key, {}).items()):
            lines.append('%s{quantile="0.%s"} %s' % (name, q[1:], v))
    return ("\n".join(lines) + "\n").encode()


def png_to_chw(data: bytes, dtype=np.float32) -> np.ndarray:
    """Decode a request PNG to a CHW frame of `dtype`. 16-bit greyscale is
    clipped at 255, as the JAX server's Pillow `convert("RGB")` does."""
    return png.decode(data, grey16="clip").astype(dtype, copy=False).transpose(2, 0, 1)


def chw_to_png(img_chw: np.ndarray, compress_level: int = 6) -> bytes:
    """PNG-encode a CHW frame; float frames are rounded and clipped."""
    if img_chw.dtype == np.uint8:  # already quantized on the device
        arr = img_chw.transpose(1, 2, 0)
    else:
        arr = np.clip(np.round(img_chw.transpose(1, 2, 0)), 0, 255).astype(np.uint8)
    return png.encode(np.ascontiguousarray(arr), compress_level)


def make_server(service: SRService, host: str, port: int,
                max_body_mb: int = 64, png_level: int = 1):
    max_body = int(max_body_mb) * 1024 * 1024
    png_level = int(png_level)

    class Handler(BaseHTTPRequestHandler):
        # keep-alive: every response carries Content-Length
        protocol_version = "HTTP/1.1"

        def _send(self, code: int, body: bytes, ctype: str, retry_after=False):
            self.send_response(code)
            self.send_header("Content-Type", ctype)
            self.send_header("Content-Length", str(len(body)))
            if retry_after:
                self.send_header("Retry-After", "1")
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                if service.draining:
                    self._send(503, b"draining", "text/plain")
                elif service.ready:
                    self._send(200, b"ok", "text/plain")
                else:
                    self._send(503, b"warming up", "text/plain")
            elif self.path == "/info":
                self._send(200, json.dumps(service.info()).encode(),
                           "application/json")
            elif self.path == "/metrics":
                self._send(200, prometheus_metrics(service.info()),
                           "text/plain; version=0.0.4")
            else:
                self._send(404, b"not found", "text/plain")

        def do_POST(self):
            if self.path.rstrip("/") != "/upscale":
                self._send(404, b"not found", "text/plain")
                return
            if service.draining:
                # graceful shutdown: shed so the balancer retries elsewhere
                self._send(503, b"server draining, retry elsewhere",
                           "text/plain", retry_after=True)
                return
            try:
                length = int(self.headers.get("Content-Length", "0"))
            except ValueError:
                self._send(400, b"bad request", "text/plain")
                return
            if length > max_body:
                # never trust a client-declared size into one read()
                self._send(413, ("request body exceeds %d MiB limit"
                                 % max_body_mb).encode(), "text/plain")
                return
            # errors are logged here; internals are never echoed to the client
            try:
                img = png_to_chw(self.rfile.read(length), service.input_dtype)
            except Exception as exc:  # malformed input must not kill the server
                print("serve: bad request body: %r" % (exc,), file=sys.stderr)
                self._send(400, b"bad request: could not decode the image",
                           "text/plain")
                return
            try:
                out = chw_to_png(service.upscale_chw(img), png_level)
            except ServerBusy:
                self._send(503, b"server busy: device queue full, retry later",
                           "text/plain", retry_after=True)
                return
            except Exception as exc:  # the server's fault, e.g. a kernel launch
                print("serve: upscale failed: %r" % (exc,), file=sys.stderr)
                self._send(500, b"internal error: the upscale failed",
                           "text/plain")
                return
            self._send(200, out, "image/png")

        def log_message(self, fmt, *a):  # no per-request stderr lines
            pass

    return ThreadingHTTPServer((host, port), Handler)


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser()
    parser.add_argument("--model", type=str, default="edsr", help="Name of the model.")
    parser.add_argument("--scales", type=str, default="4")
    common.add_device_flags(parser)
    parser.add_argument("--restore_path", type=str, default=None,
                        help="A .pth state_dict (the reference's format) or a "
                             "JAX msgpack .ckpt.")
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8080,
                        help="0 picks an ephemeral port (printed at startup).")
    parser.add_argument("--max_body_mb", type=int, default=64,
                        help="Reject request bodies above this size with 413.")
    parser.add_argument("--drain_timeout", type=float, default=30.0,
                        help="On SIGTERM: stop admitting requests and wait up "
                             "to this many seconds for in-flight ones.")
    parser.add_argument("--png_level", type=int, default=1,
                        help="zlib level of the response PNGs (0-9).")
    parser.add_argument("--max_queue", type=int, default=32,
                        help="Max requests waiting on the device before new "
                             "ones get an immediate 503.")
    parser.add_argument("--pipeline_depth", type=int, default=2,
                        help="Batches that may be launched but not yet pulled "
                             "to the host (1 = the pull holds the device).")
    parser.add_argument("--uint8_input", type=int, default=1,
                        help="Push request frames as uint8 and cast to f32 on "
                             "the device (exact).")
    parser.add_argument("--device_uint8", type=int, default=1,
                        help="Quantize SR frames to uint8 on the device before "
                             "the pull (byte-equal to host quantization).")
    parser.add_argument("--dynamic_batch", type=int, default=1,
                        help="Coalesce up to N waiting same-geometry requests "
                             "into one batched forward.")
    parser.add_argument("--warmup_size", type=str, default="128x128",
                        help="WxH run through the model before serving traffic.")
    common.add_chop_flags(parser)
    common.add_tile_flags(parser)
    common.add_ema_flag(parser)
    common.add_int8_trunk_flag(parser)
    parser.add_argument("--int8_calib_path", type=str, default=None,
                        help="Directory of representative PNGs whose first 4, cropped "
                             "to their common size, calibrate --int8_trunk.")
    common.add_collapsed_tail_flag(parser)
    parser.add_argument("--artifact", type=str, default=None,
                        help="Serve a serving artifact (cli/export.py --stablehlo) instead "
                             "of a checkpoint: no model build or restore.")
    common.add_parallel_serving_flags(
        parser, "Shard forward batches across N devices (data-parallel serving): tile "
                "batches under --tile_forward, coalesced request batches in direct mode "
                "(--dynamic_batch raised to N). 0 = off.")
    common.add_ignored_flags(parser, IGNORED)
    common.add_serving_dtype_flag(parser)
    return parser


def int8_calib(args):
    """serve's int8 calibration batch (larvanet_tpu/cli/serve.py:632-647): the
    first 4 PNGs of --int8_calib_path cropped to their common size, or
    noise from default_rng(0) with a warning."""
    from larvanet_tpu_torch.data import io

    if args.int8_calib_path:
        names = io.list_pngs(args.int8_calib_path)[:4]
        calib = [io.load_image_chw("%s/%s.png" % (args.int8_calib_path, n)).transpose(1, 2, 0)
                 for n in names]
        h = min(a.shape[0] for a in calib)
        w = min(a.shape[1] for a in calib)
        return np.stack([a[:h, :w] for a in calib])
    print("WARNING: --int8_trunk without --int8_calib_path calibrates on noise; pass a "
          "directory of representative PNGs")
    return np.random.default_rng(0).uniform(0, 255, (1, 64, 64, 3)).astype(np.float32)


def build_service(args, remaining) -> SRService:
    """Restore the model on the device and wrap it in an SRService."""
    mode = "chop" if args.chop_forward else "tile" if args.tile_forward else "direct"
    if args.dynamic_batch > 1 and mode != "direct":
        raise SystemExit("--dynamic_batch coalesces same-geometry direct forwards; it "
                         "does not compose with --%s_forward (the tiler already batches "
                         "tiles within a request)" % mode)
    device = common.resolve_device(args)
    scales = common.scales_of(args)
    model, _, remaining = common.setup_model(args.model, remaining, scales, device)
    scale = model.scale
    common.note_ignored(args, IGNORED, "serve", model)
    common.warn_leftovers(remaining)
    model.restore(args.restore_path)
    common.maybe_use_ema(model, args)
    common.apply_serving_dtype(model, args)
    print("restored the model")
    common.maybe_collapse_tail(model, args)
    if args.int8_trunk:
        common.maybe_int8_trunk(model, args, lambda: int8_calib(args))
    common.maybe_spatial_shard(model, args, scale)
    common.maybe_dp_eval(model, args)
    tiler = common.make_tiler(model, args) if mode == "tile" else None
    dyn, multiple = args.dynamic_batch, 1
    if args.dp_devices > 1 and mode == "direct":
        # every forward must divide the mesh: request batches are coalesced
        # and padded up to a multiple of it (larvanet_tpu/cli/serve.py:678-690)
        multiple = args.dp_devices
        if dyn < multiple:
            dyn = multiple
            print("serving: --dynamic_batch raised to %d (= --dp_devices) so request "
                  "batches shard across the mesh" % multiple)
    return SRService(model, scale, mode=mode, tiler=tiler,
                     chop_overlap=args.chop_overlap_size,
                     max_queue=args.max_queue,
                     dynamic_batch=dyn, batch_multiple=multiple,
                     pipeline_depth=args.pipeline_depth,
                     device_uint8=bool(args.device_uint8),
                     uint8_input=bool(args.uint8_input))


def build_artifact_service(args, remaining) -> ArtifactService:
    """serve --artifact (larvanet_tpu/cli/serve.py:768-801): JAX's
    refusals, then the ArtifactService on the device."""
    if args.dynamic_batch > 1:
        raise SystemExit("--dynamic_batch does not apply to --artifact serving: the batch "
                         "dimension was baked at export, and a batch-N artifact already "
                         "coalesces up to N queued requests per execution automatically")
    for flag in ARTIFACT_REFUSED:
        if getattr(args, flag, 0):
            raise SystemExit("--%s does not apply to --artifact serving (the graph and "
                             "weights are baked into the file; re-export with the right "
                             "options)" % flag)
    if getattr(args, "serving_dtype", "f32") != "f32":
        raise SystemExit("--serving_dtype does not apply to --artifact serving (the compute "
                         "dtype was baked at export — use cli/export.py --export_dtype)")
    if args.restore_path:
        raise SystemExit("pass --restore_path OR --artifact, not both")
    common.warn_leftovers(remaining)
    service = ArtifactService(args.artifact, tile=args.tile_forward,
                              tile_overlap=args.tile_overlap, max_queue=args.max_queue,
                              device=common.resolve_device(args),
                              pipeline_depth=args.pipeline_depth,
                              device_uint8=bool(args.device_uint8),
                              uint8_input=bool(args.uint8_input))
    print("serving artifact %s (%s)" % (args.artifact, service.header.get("path_desc", "")))
    return service


def main(argv=None):
    args, remaining = build_parser().parse_known_args(argv)
    if args.artifact:
        service = build_artifact_service(args, remaining)
    elif args.restore_path:
        service = build_service(args, remaining)
    else:
        raise SystemExit("pass --restore_path (a .pth or .ckpt checkpoint) or --artifact "
                         "(a serving artifact)")
    w, h = (int(v) for v in args.warmup_size.split("x"))
    print("warmup %dx%d ..." % (w, h))
    service.warmup(h, w)
    print("ready")

    httpd = make_server(service, args.host, args.port,
                        max_body_mb=args.max_body_mb, png_level=args.png_level)

    # SIGTERM = graceful rollout: healthz 503s, new POSTs shed, in-flight
    # frames finish, then stop. SIGINT stays immediate.
    def _graceful(signum, _frame):
        print("serve: SIGTERM, draining (up to %.0fs)..." % args.drain_timeout)

        def _stop():
            clean = service.drain(timeout=args.drain_timeout)
            print("serve: drained" if clean
                  else "serve: drain timed out with requests in flight")
            httpd.shutdown()

        threading.Thread(target=_stop, daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _graceful)
    except ValueError:
        pass  # not the main thread (embedded use)

    print("serving %s on http://%s:%d" % (
        service.model.registry_name, httpd.server_address[0], httpd.server_address[1]))
    try:
        httpd.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        httpd.server_close()


if __name__ == "__main__":
    main()
