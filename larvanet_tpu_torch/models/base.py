"""Model wrapper: the serving surface of larvanet_tpu/models/base.py.

The host contract is the reference's: lists of CHW float32 [0, 255]
frames in, CHW frames out (models/base.py:509-557). On the device every
tensor is NHWC, the JAX package's layout. PyTorch runs eagerly, so the
JAX package's jitted closures become plain calls of the module.

  * `prepare(scales, device, seed)` builds the module on the CPU from a
    seeded `torch.Generator` (the same weights on every device), then
    moves it to `device`.
  * `restore(path)` reads a `.pth` state_dict (the reference's format,
    which the JAX package also reads and writes) with a strict load and
    shape checks. msgpack `.ckpt` files and orbax directories need flax
    and are refused.
  * `set_serving_dtype("bf16")` casts the module, so every conv runs the
    kernel's bf16 variant (the counterpart of serving_compute_dtype,
    models/base.py:42-54); inputs are cast on the device and outputs
    come back as f32.
  * `set_route(forward)` sends `fwd_runtime` through another forward of
    the same module (e.g. ops/wino_resblock.make_wino_edsr_forward), the
    counterpart of the JAX CLIs replacing `model._fwd_jit`. A route reads
    the module's weights on every call, so restore and set_serving_dtype
    keep working with one set.
  * uint8 frames (PNG decodes) cross to the device as uint8 and are cast
    to f32 there: exact, and a quarter of the bytes (base.py:489-507).
    `upscale_uint8` quantizes on the device before the pull with
    round-half-to-even then clip, as jnp.round / np.round do.
"""

from __future__ import annotations

import os
from typing import Dict, Optional, Sequence

import numpy as np
import torch
from torch import nn

from larvanet_tpu_torch.utils.torch_convert import load_pth

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


class SRModel:
    """Base class of every model wrapper of the port."""

    supported_scales = (2, 3, 4)
    registry_name: Optional[str] = None

    def __init__(self):
        self.args = None
        self.module: Optional[nn.Module] = None
        self.scale = 4
        self.device = torch.device("cpu")
        self.compute_dtype = torch.float32
        self.route = None

    # ---- plugin protocol -------------------------------------------------

    def parse_args(self, args):
        raise NotImplementedError

    def build_module(self, generator: torch.Generator) -> nn.Module:
        raise NotImplementedError

    def prepare(self, scales: Sequence[int], device="cuda", seed: int = 0):
        if len(scales) != 1:
            raise ValueError("Only one scale should be provided.")
        if scales[0] not in self.supported_scales:
            raise ValueError("Unsupported scale is provided.")
        self.scale = scales[0]
        self.device = torch.device(device)
        generator = torch.Generator().manual_seed(seed)
        self.module = self.build_module(generator).to(self.device).eval()
        self.compute_dtype = torch.float32

    def set_serving_dtype(self, name: str) -> None:
        self.compute_dtype = DTYPES[name]
        self.module.to(self.compute_dtype)

    def set_route(self, forward) -> None:
        """Run `fwd_runtime` through `forward` (NHWC batch in the compute
        dtype -> NHWC output) instead of the module; None restores it."""
        self.route = forward

    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.module.parameters())

    # ---- checkpoints -------------------------------------------------------

    def restore(self, ckpt_path: str) -> None:
        """Strict restore of a `.pth` state_dict."""
        if not ckpt_path.endswith((".pth", ".pt")):
            kind = "an orbax directory" if os.path.isdir(ckpt_path) \
                else "a msgpack checkpoint"
            raise ValueError(
                "%s is %s: restoring it needs flax, which the port does not "
                "use; convert it to .pth with the JAX package "
                "(larvanet_tpu.utils.torch_convert.save_pth). See ROADMAP.md."
                % (ckpt_path, kind))
        self.load_state_dict(load_pth(ckpt_path))

    def load_state_dict(self, state: Dict[str, torch.Tensor]) -> None:
        current = self.module.state_dict()
        missing = sorted(set(current) - set(state))
        unexpected = sorted(set(state) - set(current))
        if missing or unexpected:
            raise ValueError("checkpoint keys do not match model %s: missing %s, "
                             "unexpected %s" % (self.registry_name, missing,
                                                unexpected))
        for key, value in state.items():
            if tuple(value.shape) != tuple(current[key].shape):
                raise ValueError(
                    "checkpoint shape mismatch at %r: model %s vs checkpoint %s"
                    % (key, tuple(current[key].shape), tuple(value.shape)))
        self.module.load_state_dict(state, strict=True)

    # ---- forward -----------------------------------------------------------

    @torch.no_grad()
    def fwd_runtime(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        """The forward on an NHWC float batch already on the device; the
        result is f32 NHWC on the device, not synchronised."""
        x = x_nhwc.to(self.compute_dtype).contiguous()
        out = self.module(x) if self.route is None else self.route(x)
        return out.float()

    def _input_to_device(self, input_list) -> torch.Tensor:
        """A list of CHW host frames -> NHWC f32 batch on the device.

        uint8 frames are pushed as uint8 and cast on the device; any
        other frames are pushed as f32 (the reference contract)."""
        if not isinstance(input_list, (list, tuple)) or not input_list:
            raise ValueError("expected a non-empty list of CHW frames")
        if all(getattr(im, "dtype", None) == np.uint8 for im in input_list):
            x8 = np.stack([np.asarray(im) for im in input_list])
            x8 = np.ascontiguousarray(x8.transpose(0, 2, 3, 1))
            return torch.from_numpy(x8).to(self.device).float()
        arr = np.stack([np.asarray(im, np.float32) for im in input_list])
        arr = np.ascontiguousarray(arr.transpose(0, 2, 3, 1))
        return torch.from_numpy(arr).to(self.device)

    def upscale_device(self, input_list, scale, uint8: bool = True,
                       keep: Optional[int] = None) -> torch.Tensor:
        """Launch the SR forward and return the NHWC batch on the device
        without waiting for it: the caller pulls it (`.cpu()`) later,
        outside its dispatch lock (cli/serve.py --pipeline_depth). `keep`
        drops padded frames on the device before the pull."""
        out = self.fwd_runtime(self._input_to_device(input_list))
        if uint8:
            out = torch.clamp(torch.round(out), 0, 255).to(torch.uint8)
        if keep is not None and keep < out.shape[0]:
            out = out[:keep]
        return out

    def upscale(self, input_list, scale) -> np.ndarray:
        """SR a list of CHW host frames -> (N, 3, sH, sW) float32 numpy."""
        out = self.upscale_device(input_list, scale, uint8=False)
        return out.cpu().numpy().transpose(0, 3, 1, 2)

    def upscale_uint8(self, input_list, scale) -> np.ndarray:
        """SR, quantized to uint8 on the device -> (N, 3, sH, sW) uint8."""
        out = self.upscale_device(input_list, scale, uint8=True)
        return out.cpu().numpy().transpose(0, 3, 1, 2)
