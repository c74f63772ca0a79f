"""The port's HTTP server (larvanet_tpu_torch/cli/serve.py) on the CPU.

Both servers, the port's (with --device cpu) and the JAX package's (its
default routing), load one tiny `.pth`; a PNG POSTed to each must give
the port's own `upscale_uint8` bytes and agree within 1 uint8 level.
Then the serving mechanics: healthz gating, 400, 404, 413, 503 shedding,
dynamic batching, draining, and the refusal to run without CUDA.
"""

import argparse
import io
import json
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch
from PIL import Image

from larvanet_tpu.cli import serve as jax_serve
from larvanet_tpu_torch.cli import serve
from larvanet_tpu_torch.core.registry import get_model
from larvanet_tpu_torch.data import png

torch.set_num_threads(1)  # tiny tensors: more intra-op threads cost more than they give

TINY = ["--edsr_res_blocks", "2", "--edsr_conv_features", "8"]
# The JAX server's default routing is its fast path (width-packed trunk +
# collapsed tail), which composes the tail's convs in another order; it
# holds to its module graph at atol 0.1 on a tiny model's output
# (tests/test_collapsed_tail.py). Relative to the output's range here:
JAX_SERVER_RTOL = 2e-3


def _frame():
    """The HWC uint8 frame every parity check of this file serves."""
    return np.random.default_rng(0).integers(0, 256, (9, 11, 3), dtype=np.uint8)


def _fit_output_range(model, img_chw):
    """Rescale final_conv so the random model's output on `img_chw` has
    mean 128 and std 40 in every channel. Left as drawn, the inverse mean
    shift puts nearly every pixel below 0, and the clamp to [0, 255]
    would hide any error of the forward. mean_inverse_shift stays the
    intended -mean, so the JAX server keeps its default routing."""
    module = model.module
    shift = module.mean_inverse_shift.bias
    f = model.upscale_device([img_chw], 4, uint8=False) - shift
    mean_f = f.mean((0, 1, 2))
    a = 40.0 / float(f.std())
    with torch.no_grad():
        module.final_conv.weight.mul_(a)
        module.final_conv.bias.copy_(a * (module.final_conv.bias - mean_f)
                                     + 128.0 - shift)


def _pth(tmp_path, seed=0):
    m = get_model("edsr")
    m.parse_args(list(TINY))
    m.prepare([4], device="cpu", seed=seed)
    _fit_output_range(m, _frame().transpose(2, 0, 1))
    path = str(tmp_path / "edsr_tiny.pth")
    torch.save(m.module.state_dict(), path)
    return path


def _port_args(pth, *extra):
    return serve.build_parser().parse_known_args(
        ["--restore_path", pth, "--device", "cpu", *extra, *TINY])


def _spin(service, **kw):
    httpd = serve.make_server(service, "127.0.0.1", 0, **kw)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return httpd, "http://127.0.0.1:%d" % httpd.server_address[1]


def _get(url):
    try:
        with urllib.request.urlopen(url, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


def _post(url, data):
    req = urllib.request.Request(url, data=data, method="POST")
    try:
        with urllib.request.urlopen(req, timeout=60) as r:
            return r.status, r.read()
    except urllib.error.HTTPError as e:
        return e.code, e.read()


@pytest.fixture(scope="module")
def port_server(tmp_path_factory):
    pth = _pth(tmp_path_factory.mktemp("port"))
    service = serve.build_service(*_port_args(pth))
    httpd, url = _spin(service)
    yield service, url, pth
    httpd.shutdown()
    httpd.server_close()


def test_healthz_gates_on_warmup(port_server):
    service, url, _ = port_server
    assert _get(url + "/healthz") == (503, b"warming up")
    service.warmup(8, 8)
    assert _get(url + "/healthz") == (200, b"ok")


def test_png_reply_equals_upscale_uint8_and_jax_server(port_server, tmp_path):
    service, url, pth = port_server
    service.ready or service.warmup(8, 8)
    img = _frame()
    body = png.encode(img)

    code, reply = _post(url + "/upscale", body)
    assert code == 200
    got = png.decode(reply, grey16="clip")
    assert got.shape == (36, 44, 3)
    # most pixels must lie inside the range, or the clamp hides errors
    inside = float(np.mean((got > 0) & (got < 255)))
    assert inside >= 0.9, inside
    own = service.model.upscale_uint8([img.transpose(2, 0, 1)], 4)[0]
    assert png.encode(own.transpose(1, 2, 0), 1) == reply

    jax_args = argparse.Namespace(
        model="edsr", scales="4", restore_path=pth, restore_target=None,
        chop_forward=False, chop_overlap_size=20, tile_forward=False,
        tile_size=32, tile_overlap=8, spatial_shard=0, spatial_halo=32,
        collapsed_tail=1, packed_trunk=1, int8_trunk=0, int8_calib_path=None,
        dp_devices=0)
    jax_service = jax_serve.build_service(jax_args, list(TINY))
    jax_service.warmup(9, 11)
    img_f32 = [img.transpose(2, 0, 1).astype(np.float32)]
    port_f32 = service.model.upscale(img_f32, 4)
    jax_f32 = jax_service.model.upscale(img_f32, 4)
    err = float(np.abs(port_f32 - jax_f32).max())
    print("parity unclamped f32 vs JAX server model: max |d| %g" % err)
    assert err <= JAX_SERVER_RTOL * float(np.abs(jax_f32).max())
    jhttpd = jax_serve.make_server(jax_service, "127.0.0.1", 0)
    threading.Thread(target=jhttpd.serve_forever, daemon=True).start()
    try:
        jcode, jreply = _post("http://127.0.0.1:%d/upscale" % jhttpd.server_address[1],
                              body)
    finally:
        jhttpd.shutdown()
        jhttpd.server_close()
    assert jcode == 200
    jgot = png.decode(jreply, grey16="clip")
    levels = int(np.abs(got.astype(np.int16) - jgot.astype(np.int16)).max())
    print("parity served PNG vs JAX server: max %d uint8 level(s)" % levels)
    assert levels <= 1


def test_info_and_metrics(port_server):
    service, url, _ = port_server
    service.ready or service.warmup(8, 8)
    code, body = _get(url + "/info")
    info = json.loads(body)
    assert code == 200 and info["model"] == "edsr" and info["scale"] == 4
    assert info["device"] == "cpu" and info["device_memory_mb"] is None
    code, body = _get(url + "/metrics")
    text = body.decode()
    assert code == 200 and "lvt_ready 1" in text
    for line in text.strip().splitlines():
        if not line.startswith("#"):
            float(line.rsplit(" ", 1)[1])


def test_malformed_body_is_400_and_unknown_path_404(port_server):
    service, url, _ = port_server
    service.ready or service.warmup(8, 8)
    code, body = _post(url + "/upscale", b"this is not a png")
    assert code == 400 and body == b"bad request: could not decode the image"
    assert _post(url + "/upscale", png.SIGNATURE + b"broken")[0] == 400
    assert _get(url + "/nope")[0] == 404
    assert _post(url + "/nope", b"x")[0] == 404
    assert _get(url + "/healthz")[0] == 200  # still serving


def test_oversized_body_is_413(tmp_path):
    service = serve.build_service(*_port_args(_pth(tmp_path)))
    httpd, url = _spin(service, max_body_mb=0)
    try:
        code, body = _post(url + "/upscale", b"x")
        assert code == 413 and b"exceeds" in body
    finally:
        httpd.shutdown()
        httpd.server_close()


class _SlowModel:
    """The SRModel serving surface with a forward that holds the device
    long enough for requests to pile up; records every batch size."""

    registry_name = "slow"
    device = torch.device("cpu")

    def __init__(self, hold_s=0.15):
        self.hold_s = hold_s
        self.batch_sizes = []

    def upscale_device(self, input_list, scale, uint8=True, keep=None):
        time.sleep(self.hold_s)
        self.batch_sizes.append(len(input_list))
        x = torch.from_numpy(np.stack(input_list)).permute(0, 2, 3, 1)
        out = x.repeat_interleave(scale, 1).repeat_interleave(scale, 2)
        return out[:keep] if keep is not None else out


def _burst(url, images):
    results = {}

    def client(i):
        results[i] = _post(url + "/upscale", png.encode(images[i]))

    threads = [threading.Thread(target=client, args=(i,)) for i in range(len(images))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    return results


def test_palette_png_is_served_as_its_rgb_image(port_server):
    """A palette PNG answers 200 with the bytes of the same image sent as
    RGB (the JAX server decodes it with Pillow's convert("RGB"))."""
    service, url, _ = port_server
    service.ready or service.warmup(8, 8)
    rng = np.random.default_rng(1)
    palette = rng.integers(0, 256, (16, 3), dtype=np.uint8)
    index = rng.integers(0, 16, (9, 11), dtype=np.uint8)
    im = Image.frombytes("P", (11, 9), index.tobytes())
    im.putpalette(palette.tobytes())
    buf = io.BytesIO()
    im.save(buf, format="PNG", bits=4)
    rgb_code, rgb_reply = _post(url + "/upscale", png.encode(palette[index]))
    code, reply = _post(url + "/upscale", buf.getvalue())
    assert rgb_code == code == 200
    assert reply == rgb_reply
    assert png.decode(reply, grey16="clip").shape == (36, 44, 3)


def test_load_shedding_503():
    service = serve.SRService(_SlowModel(hold_s=0.3), 4, max_queue=1)
    service.ready = True
    httpd, url = _spin(service)
    try:
        results = _burst(url, [np.zeros((4, 4, 3), np.uint8)] * 6)
        codes = sorted(code for code, _ in results.values())
        assert codes.count(200) >= 1 and codes.count(503) >= 1, codes
        assert all(b"busy" in body for code, body in results.values() if code == 503)
        assert service.info()["num_rejected"] >= 1
        assert _get(url + "/healthz")[0] == 200
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_dynamic_batch_coalesces_and_keeps_each_frame():
    model = _SlowModel()
    service = serve.SRService(model, 4, dynamic_batch=4)
    service.ready = True
    httpd, url = _spin(service)
    try:
        images = [np.full((5, 7, 3), i, np.uint8) for i in range(12)]
        results = _burst(url, images)
        for i, (code, body) in results.items():
            assert code == 200
            np.testing.assert_array_equal(
                png.decode(body, grey16="clip"), np.repeat(np.repeat(images[i], 4, 0), 4, 1))
        info = service.info()
        assert info["num_requests"] == 12
        assert info["num_forwards"] == len(model.batch_sizes) < 12
        assert set(model.batch_sizes) <= {1, 2, 4} and max(model.batch_sizes) > 1
    finally:
        httpd.shutdown()
        httpd.server_close()


class _FailingModel(_SlowModel):
    """A forward that fails as a kernel launch does on the card."""

    def upscale_device(self, input_list, scale, uint8=True, keep=None):
        raise RuntimeError("conv3x3_bias_act: CUDA error 719 (launch failure)")


def test_server_fault_is_500_not_400():
    service = serve.SRService(_FailingModel(), 4)
    service.ready = True
    httpd, url = _spin(service)
    try:
        code, body = _post(url + "/upscale", png.encode(np.zeros((4, 4, 3), np.uint8)))
        assert (code, body) == (500, b"internal error: the upscale failed")
        assert _post(url + "/upscale", b"not a png")[0] == 400
        assert _get(url + "/healthz")[0] == 200  # still serving
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_drain_sheds_new_requests():
    service = serve.SRService(_SlowModel(hold_s=0.0), 4)
    service.ready = True
    httpd, url = _spin(service)
    try:
        assert service.drain(timeout=5)
        assert _get(url + "/healthz") == (503, b"draining")
        assert _post(url + "/upscale", png.encode(np.zeros((2, 2, 3), np.uint8)))[0] == 503
    finally:
        httpd.shutdown()
        httpd.server_close()


def test_unported_flags_are_refused(tmp_path, capsys):
    """--dp_devices and --spatial_shard, refused until the port had its
    parallel package, now serve on --device cpu (a mesh of 2 that repeats
    the CPU) the unsharded service's frames: --dp_devices 2 in direct mode
    (--dynamic_batch raised to 2, a lone request padded to 2) and over
    --tile_forward's tiles (batches padded to a multiple of 2);
    --spatial_shard 2 at --spatial_halo 8, the tiny EDSR's receptive
    radius, on the module graph (held against --collapsed_tail 0)."""
    pth = _pth(tmp_path)
    img = np.random.default_rng(1).integers(0, 256, (3, 32, 20), dtype=np.uint8)
    tile = ("--tile_forward", "--tile_size", "12", "--tile_overlap", "4")
    runs = (((), ("--dp_devices=2",)), (tile, ("--dp_devices=2",)),
            (("--collapsed_tail", "0"), ("--spatial_shard=2", "--spatial_halo", "8")))
    for base, flags in runs:
        want = serve.build_service(*_port_args(pth, *base)).upscale_chw(img)
        service = serve.build_service(*_port_args(pth, *base, *flags))
        got = service.upscale_chw(img)
        if flags[0] == "--dp_devices=2" and not base:
            assert service.dynamic_batch == 2 and service._buckets == [2]
            assert "--dynamic_batch raised to 2" in capsys.readouterr().out
        if base == tile:
            assert service.tiler.min_batch == 2
        assert got.shape == want.shape == (3, 128, 80)
        assert int(np.abs(got.astype(int) - want.astype(int)).max()) <= 1, (base, flags)


def test_no_cuda_without_device_cpu_exits_nonzero(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pth = _pth(tmp_path)
    with pytest.raises(SystemExit) as exc:
        serve.main(["--restore_path", pth, *TINY])
    assert exc.value.code not in (0, None)


LARVA_TINY = ["--num_modules", "2", "--num_blocks", "1,1"]


def test_served_larvanet_request_is_x4_and_matches_jax_server(tmp_path):
    """`serve --model LarvaNet` answers a PNG with its x4 frame, the bytes of
    the port model's own upscale_uint8, within 1 uint8 level of the JAX
    server on the same .pth (the port module's state_dict, which the JAX
    package's LarvaNet rules read)."""
    model = get_model("LarvaNet")
    model.parse_args(list(LARVA_TINY))
    model.prepare([4], device="cpu", seed=3)
    with torch.no_grad():  # a trunk that moves the output by tens of levels
        for name, value in model.module.named_parameters():
            value.copy_(torch.randn(value.shape, generator=torch.Generator().manual_seed(
                len(name))) if name.endswith("bias") else 2.0 * value)
    pth = str(tmp_path / "larvanet_tiny.pth")
    torch.save(model.module.state_dict(), pth)
    args, remaining = serve.build_parser().parse_known_args(
        ["--model", "LarvaNet", "--restore_path", pth, "--device", "cpu", *LARVA_TINY])
    service = serve.build_service(args, remaining)
    service.warmup(8, 8)
    httpd, url = _spin(service)
    img = _frame()
    try:
        code, reply = _post(url + "/upscale", png.encode(img))
        info = json.loads(_get(url + "/info")[1])
    finally:
        httpd.shutdown()
        httpd.server_close()
    assert code == 200 and info["model"] == "LarvaNet"
    got = png.decode(reply, grey16="clip")
    assert got.shape == (36, 44, 3)
    own = service.model.upscale_uint8([img.transpose(2, 0, 1)], 4)[0]
    assert png.encode(own.transpose(1, 2, 0), 1) == reply

    jax_args = argparse.Namespace(
        model="LarvaNet", scales="4", restore_path=pth, restore_target=None,
        chop_forward=False, chop_overlap_size=20, tile_forward=False,
        tile_size=32, tile_overlap=8, spatial_shard=0, spatial_halo=32,
        collapsed_tail=1, packed_trunk=1, int8_trunk=0, int8_calib_path=None,
        dp_devices=0)
    jax_service = jax_serve.build_service(jax_args, list(LARVA_TINY))
    want = jax_service.model.upscale_uint8([img.transpose(2, 0, 1)], 4)[0]
    levels = int(np.abs(own.astype(np.int16) - want.astype(np.int16)).max())
    img_f32 = [img.transpose(2, 0, 1).astype(np.float32)]
    err = float(np.abs(service.model.upscale(img_f32, 4) - jax_service.model.upscale(
        img_f32, 4)).max())
    print("parity served LarvaNet PNG vs JAX server model: max %d uint8 level(s), "
          "unclamped f32 max |d| %.3g" % (levels, err))
    # f32 graphs summed in another order (tests/test_torch_larvanet.py's bar)
    assert levels <= 1 and err <= 1e-3
