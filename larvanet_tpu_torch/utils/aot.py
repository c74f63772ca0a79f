"""Self-contained serving artifacts via torch.export.

The port's counterpart of larvanet_tpu/utils/aot.py. An artifact is ONE
file holding the serving graph that the inference CLIs would route to
(the collapsed tail for EDSR and MAMNet, the int8 W8A8 trunk, or the
module graph) for one static NHWC float32 input shape, traced with
torch.export, with the trained weights, the baked tail's operators and
the int8 codes and scales as the program's constants. A server loads it
with `load_artifact` and runs it without the model zoo, flag parsing,
checkpoint restore or graph-build code; an int8 artifact carries its
calibration.

The hand-written kernels are in the graph as the registered ops of
ops/library.py (`larvanet.conv3x3_bias_act`, `larvanet.conv_kxk`, ...), so
a program loaded on the card launches the same kernels, as many times, as
the live route, and one loaded on the CPU runs their plain versions.
`load_artifact` imports that module and nothing of
`larvanet_tpu_torch.models`; it moves the program to the asked device
(`move_to_device_pass`) and refuses a device that is not in the header's
`platforms`.

File format (little-endian), JAX's layout with the port's own magic:
    magic  b"LVTPT01\\n"
    u32    header length
    bytes  UTF-8 JSON header {model, scale, input_shape, dtype,
           platforms, path_desc, framework}
    bytes  the torch.export.save archive

CLI: `python -m larvanet_tpu_torch.cli.export --stablehlo out.lvt ...`
(cli/export.py); `serve --artifact` and `validate --artifact` run one.
"""

from __future__ import annotations

import io
import json
import struct
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

MAGIC = b"LVTPT01\n"
JAX_MAGIC = b"LVTAOT1\n"  # larvanet_tpu/utils/aot.py: a StableHLO artifact
FRAMEWORK = "larvanet_tpu_torch"
PLATFORMS = ("cuda", "cpu")


class _Program(torch.nn.Module):
    """The traced root: `forward(x)` is the route on an NHWC float32 batch,
    cast to float32. It registers no parameter: the route's weights are
    closed over, so the export captures them as the program's constants."""

    def __init__(self, route):
        super().__init__()
        self.route = route

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.route(x).float()


def serving_forward(model, dtype: str = "float32", packed_trunk: bool = True,
                    collapsed_tail: bool = True, int8_trunk: bool = False, calib=None):
    """(forward, description) of the route the serving CLIs would build for
    `model` (restored) in `dtype` ("float32" or "bfloat16"), the counterpart
    of JAX's `build_fast_forward` (ops/fastpath.py): the W8A8 trunk under
    `int8_trunk` for a family that has one (calibrated on `calib`, an NHWC
    float32 batch of even width, in `dtype`, as JAX's export builds it);
    else the baked collapsed tail where the model serves one
    (`serves_collapsed_tail`: EDSR under `collapsed_tail`, MAMNet unless
    `packed_trunk` is off) and its mean shifts are the intended ones; else
    the module graph. The tail is probed here, before any trace: its
    operators are fixed tensors from then on. `forward` takes an NHWC
    batch on the model's device and returns float32. Sets the model's
    serving dtype."""
    from types import SimpleNamespace

    from larvanet_tpu_torch.cli import common
    from larvanet_tpu_torch.models.layers import mean_shifts_intended
    from larvanet_tpu_torch.ops import int8_forward
    from larvanet_tpu_torch.ops.collapsed_tail import collapsed_edsr_tail
    from larvanet_tpu_torch.ops.library import DTYPES

    if dtype not in DTYPES:
        raise ValueError("dtype must be float32 or bfloat16, got %r" % (dtype,))
    torch_dtype = DTYPES[dtype]
    model.set_serving_dtype("bf16" if torch_dtype == torch.bfloat16 else "f32")
    name = model.registry_name or ""
    tail = None
    if model.has_collapsed_tail and mean_shifts_intended(model.module):
        tail = collapsed_edsr_tail(model)
        tail.operands(torch_dtype)
    if int8_trunk:
        if calib is None:
            raise ValueError("int8_trunk requires a calibration batch")
        for prefixes, maker in common.INT8_BUILDERS.items():
            if name in prefixes or name.startswith(prefixes):
                int8_fwd = getattr(int8_forward, maker)(model, calib, torch_dtype)
                return (torch.no_grad()(lambda x: int8_fwd(x).float()),
                        "int8 (W8A8) trunk" + (" + collapsed tail" if tail is not None
                                               else ""))
        print("int8_trunk: no int8 path for model %r; exporting its exact route" % (name,))
    module = model.serving_module
    flags = SimpleNamespace(collapsed_tail=int(collapsed_tail), packed_trunk=int(packed_trunk))
    collapsed = tail is not None and model.serves_collapsed_tail(flags)

    @torch.no_grad()
    def forward(x: torch.Tensor) -> torch.Tensor:
        h = x.to(torch_dtype).contiguous()
        return (module(h, tail=tail) if collapsed else module(h)).float()

    return forward, "collapsed linear tail" if collapsed else "module graph"


def export_serving(model, input_shape, dtype: str = "float32", packed_trunk: bool = True,
                   collapsed_tail: bool = True, int8_trunk: bool = False, calib=None,
                   platforms: Optional[Sequence[str]] = None):
    """Trace the model's serving forward (`serving_forward`) for one input
    shape (`trace_serving`). Returns (torch.export.ExportedProgram, header
    dict)."""
    fwd, desc = serving_forward(model, dtype, packed_trunk, collapsed_tail, int8_trunk, calib)
    return trace_serving(model, fwd, desc, input_shape, dtype, platforms)


def trace_serving(model, forward, desc: str, input_shape, dtype: str = "float32",
                  platforms: Optional[Sequence[str]] = None):
    """torch.export of `forward` (`serving_forward`'s, described by `desc`)
    under no_grad on the model's device.

    input_shape: (N, H, W, 3) NHWC, static (one artifact per serving
    geometry). `platforms` names the devices the artifact may be loaded on
    ("cuda", "cpu"; default the model's): its ops have a body on both.
    Returns (torch.export.ExportedProgram, header dict)."""
    if len(input_shape) != 4 or input_shape[-1] != 3:
        raise ValueError("input_shape must be NHWC with 3 channels, got %r"
                         % (tuple(input_shape),))
    platforms = list(platforms) if platforms else [model.device.type]
    bad = [p for p in platforms if p not in PLATFORMS]
    if bad:
        raise ValueError("a torch.export artifact runs on %s, not %s"
                         % (" or ".join(PLATFORMS), ", ".join(bad)))
    example = torch.zeros(tuple(int(v) for v in input_shape), dtype=torch.float32,
                          device=model.device)
    with torch.no_grad():
        program = torch.export.export(_Program(forward), (example,))
    header = {
        "model": model.registry_name or "",
        "scale": int(model.scale),
        "input_shape": [int(v) for v in input_shape],
        "dtype": dtype,
        "platforms": platforms,
        "path_desc": desc,
        "framework": FRAMEWORK,
    }
    return program, header


def save_artifact(path: str, program, header: dict) -> None:
    buf = io.BytesIO()
    torch.export.save(program, buf)
    head = json.dumps(header, sort_keys=True).encode("utf-8")
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<I", len(head)))
        f.write(head)
        f.write(buf.getvalue())


def read_artifact(path: str) -> Tuple[dict, bytes]:
    """(header, payload) of an artifact file; a JAX StableHLO artifact and
    any other file are refused by name."""
    with open(path, "rb") as f:
        magic = f.read(len(MAGIC))
        if magic == JAX_MAGIC:
            raise ValueError(
                "%s is a JAX StableHLO serving artifact (larvanet_tpu.cli.export "
                "--stablehlo); it runs under larvanet_tpu.utils.aot. Export a torch.export "
                "artifact with larvanet_tpu_torch.cli.export --stablehlo" % (path,))
        if magic != MAGIC:
            raise ValueError("%s is not a larvanet_tpu_torch serving artifact (bad magic %r)"
                             % (path, magic))
        (hlen,) = struct.unpack("<I", f.read(4))
        header = json.loads(f.read(hlen).decode("utf-8"))
        return header, f.read()


def load_artifact(path: str, device="cuda"):
    """Returns (callable, header). The callable takes one NHWC float32
    tensor of exactly the exported shape on `device` and returns the SR
    output there (float32). `device` must be one of the header's
    platforms; the program's constants are moved there once."""
    from torch.export.passes import move_to_device_pass

    from larvanet_tpu_torch.ops import library  # noqa: F401  (registers the ops)

    header, payload = read_artifact(path)
    device = torch.device(device)
    if device.type not in header.get("platforms", ()):
        raise ValueError("%s was exported for %s, not %s"
                         % (path, ",".join(header.get("platforms", ())), device.type))
    program = move_to_device_pass(torch.export.load(io.BytesIO(payload)), device)
    graph = program.module()
    want = tuple(header["input_shape"])

    def serve(x: torch.Tensor) -> torch.Tensor:
        if tuple(x.shape) != want:
            raise ValueError(
                "artifact was exported for input shape %r, got %r — export "
                "one artifact per serving geometry (or tile to the exported "
                "shape)" % (want, tuple(x.shape)))
        with torch.no_grad():
            return graph(x)

    serve.program = program
    return serve, header


class ArtifactModel:
    """Duck-typed stand-in for an SRModel's serving surface, backed by a
    serving artifact (JAX's aot.ArtifactModel): `fwd_runtime(batch NHWC on
    the device)` (chunks and zero-pads the batch to the exported N),
    `upscale_device`, `upscale` and `upscale_uint8` (the reference's CHW
    float32 host contract), as `SRService` and `validate` call them. Lets
    validate run the challenge protocol against the deployed file. Spatial
    dims must match the exported geometry (direct) or come from the tiler
    (tile size = exported H = W); other inputs raise (spatial zero-padding
    would not be exact for these models)."""

    def __init__(self, path: str, device="cuda"):
        self._serve, self.header = load_artifact(path, device)
        self.device = torch.device(device)
        self.registry_name = self.header.get("model", "artifact") or "artifact"
        self.scale = int(self.header["scale"])
        n, h, w, _ = self.header["input_shape"]
        self.batch, self.height, self.width = int(n), int(h), int(w)

    def fwd_runtime(self, batch: torch.Tensor) -> torch.Tensor:
        if tuple(batch.shape[1:3]) != (self.height, self.width):
            raise ValueError(
                "artifact was exported for %dx%d inputs, got %dx%d — larger "
                "frames should run --tile_forward at the exported size; "
                "frames smaller than the exported geometry need a smaller "
                "artifact (spatial zero-padding would not be exact for "
                "these models)"
                % (self.height, self.width, batch.shape[1], batch.shape[2]))
        batch = batch.float()
        n = self.batch
        outs = []
        for i in range(0, len(batch), n):
            chunk = batch[i:i + n]
            if len(chunk) < n:
                pad = chunk.new_zeros((n - len(chunk),) + tuple(chunk.shape[1:]))
                outs.append(self._serve(torch.cat([chunk, pad]))[: len(chunk)])
            else:
                outs.append(self._serve(chunk.contiguous()))
        return torch.cat(outs) if len(outs) > 1 else outs[0]

    def _input_to_device(self, images) -> torch.Tensor:
        """A list of CHW host frames -> an NHWC float32 batch on the device
        (uint8 frames pushed as uint8 and cast there)."""
        arrs = [np.asarray(im) for im in images]
        if not all(a.dtype == np.uint8 for a in arrs):
            arrs = [a.astype(np.float32, copy=False) for a in arrs]
        x = np.ascontiguousarray(np.stack(arrs).transpose(0, 2, 3, 1))
        return torch.from_numpy(x).to(self.device).float()

    def _check_scale(self, scale) -> None:
        if scale is not None and int(scale) != self.scale:
            raise ValueError("artifact is x%d, requested x%s" % (self.scale, scale))

    def upscale_device(self, input_list, scale=None, uint8: bool = True,
                       keep: Optional[int] = None) -> torch.Tensor:
        """The forward of CHW host frames, left on the device (NHWC)."""
        self._check_scale(scale)
        out = self.fwd_runtime(self._input_to_device(input_list))
        if uint8:
            out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
        return out if keep is None else out[:keep]

    def upscale(self, input_list, scale=None) -> np.ndarray:
        return self.upscale_device(input_list, scale, uint8=False).cpu().numpy().transpose(
            0, 3, 1, 2)

    def upscale_uint8(self, input_list, scale=None) -> np.ndarray:
        return self.upscale_device(input_list, scale).cpu().numpy().transpose(0, 3, 1, 2)
