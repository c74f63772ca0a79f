"""Model wrapper: the serving and training surface of
larvanet_tpu/models/base.py.

The host contract is the reference's: lists of CHW float32 [0, 255]
frames in, CHW frames out (models/base.py:509-557). On the device every
tensor is NHWC, the JAX package's layout. PyTorch runs eagerly, so the
JAX package's jitted closures become plain calls of the module.

  * `prepare(scales, device, seed, is_training, global_step)` builds the
    module on the CPU from a seeded `torch.Generator` (the same weights on
    every device), then moves it to `device`; for training it also makes
    the optimizer (`make_optimizer`: torch's Adam or AdamW, the formulas
    of optax's, with the learning rate set before every step) and, with
    `ema_decay` set first, the parameter average (`param_ema`).
  * `train_step(inputs, scale, truths)` is one optimizer step on CHW host
    lists (models/base.py:425-487): the loss and its gradients, summed
    over `grad_accum` equal microbatches and scaled by 1/accum, then Adam,
    then the average.
  * `save(dir)` writes `model_<step>.pth`, the module's bare state_dict
    (the reference's format, which the JAX package restores), and beside
    it `model_<step>.state.pt` with what a resume needs: the step, Adam's
    moments and the average. `restore(path)` reads a `.pth` with a strict
    load and shape checks, and, when training, its state file if there is
    one; a `.pth` alone restarts the moments and leaves the average at the
    weights `prepare` built, as in the reference and JAX.
    msgpack `.ckpt` files and orbax directories need flax and are refused.
  * `set_serving_dtype("bf16")` serves through a bf16 copy of the module,
    so every conv runs the kernel's bf16 variant (the counterpart of
    serving_compute_dtype, models/base.py:42-54); the module keeps its f32
    weights, and `set_serving_dtype("f32")` drops the copy. Inputs are cast
    on the device and outputs come back as f32.
  * `set_route(forward)` sends `fwd_runtime` through another forward of
    the same model (e.g. ops/wino_resblock.make_wino_edsr_forward), the
    counterpart of the JAX CLIs replacing `model._fwd_jit`. A route reads
    `serving_module` on every call, so restore and set_serving_dtype keep
    working with one set.
  * uint8 frames (PNG decodes) cross to the device as uint8 and are cast
    to f32 there: exact, and a quarter of the bytes (base.py:489-507).
    `upscale_uint8` quantizes on the device before the pull with
    round-half-to-even then clip, as jnp.round / np.round do.
"""

from __future__ import annotations

import copy
import os
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from larvanet_tpu_torch.train.losses import l1_loss
from larvanet_tpu_torch.utils.torch_convert import load_pth

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def make_optimizer(kind: str, params) -> torch.optim.Optimizer:
    """Adam or AdamW with torch's defaults (betas 0.9 / 0.999, eps 1e-8;
    AdamW's weight decay 0.01 on every parameter), the learning rate set
    into `param_groups` before every step (make_optimizer,
    larvanet_tpu/models/base.py:267-330). Their updates are optax's: eps
    outside the square root, both bias corrections; AdamW's p (1 - lr wd)
    before the step is optax's joint update."""
    if kind == "adam":
        return torch.optim.Adam(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8)
    if kind == "adamw":
        return torch.optim.AdamW(params, lr=0.0, betas=(0.9, 0.999), eps=1e-8,
                                 weight_decay=0.01)
    raise ValueError("unknown optimizer %r" % (kind,))


class ParamEMA:
    """The parameter average of `--ema_decay` (param_ema,
    larvanet_tpu/models/base.py:148-178): ema <- d ema + (1 - d) p after
    every optimizer step, in f32, with d and 1 - d rounded to f32 as JAX
    takes them."""

    def __init__(self, params: Sequence[torch.Tensor], decay: float):
        self.decay = float(decay)
        self.params = list(params)
        self.average = [p.detach().float().clone() for p in self.params]

    def update(self) -> None:
        d = np.float32(self.decay)
        torch._foreach_mul_(self.average, float(d))
        torch._foreach_add_(self.average, torch._foreach_mul(
            [p.detach().float() for p in self.params], float(np.float32(1.0) - d)))

    def load(self, average: List[torch.Tensor]) -> None:
        if len(average) != len(self.average):
            raise ValueError("the saved average has %d tensors, the model %d"
                             % (len(average), len(self.average)))
        for mine, saved in zip(self.average, average):
            mine.copy_(saved)


class SRModel:
    """Base class of every model wrapper of the port."""

    supported_scales = (2, 3, 4)
    registry_name: Optional[str] = None
    loss = staticmethod(l1_loss)
    optimizer_kind = "adam"

    def __init__(self):
        self.args = None
        self.module: Optional[nn.Module] = None
        self.scale = 4
        self.scale_list: List[int] = []
        self.device = torch.device("cpu")
        self.compute_dtype = torch.float32
        self.route = None
        self._serving_copy: Optional[nn.Module] = None
        self.global_step = 0
        self.is_training = False
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.ema: Optional[ParamEMA] = None
        # set before prepare, as the train CLI does
        self.ema_decay = 0.0
        self.grad_accum = 1
        self._rng = np.random.default_rng()

    # ---- plugin protocol -------------------------------------------------

    def parse_args(self, args):
        raise NotImplementedError

    def build_module(self, generator: torch.Generator) -> nn.Module:
        raise NotImplementedError

    def prepare(self, scales: Sequence[int], device="cuda", seed: int = 0,
                is_training: bool = False, global_step: int = 0):
        if len(scales) != 1:
            raise ValueError("Only one scale should be provided.")
        if scales[0] not in self.supported_scales:
            raise ValueError("Unsupported scale is provided.")
        self.scale = scales[0]
        self.scale_list = list(scales)
        self.device = torch.device(device)
        generator = torch.Generator().manual_seed(seed)
        self.module = self.build_module(generator).to(self.device).eval()
        self.compute_dtype = torch.float32
        self._serving_copy = None
        self.global_step = global_step
        self.is_training = is_training
        self.optimizer = self.ema = None
        if is_training:
            params = list(self.module.parameters())
            self.optimizer = make_optimizer(self.optimizer_kind, params)
            if self.ema_decay:
                self.ema = ParamEMA(params, self.ema_decay)

    def set_serving_dtype(self, name: str) -> None:
        """Serve in `name` ("f32" or "bf16"). bf16 runs a bf16 copy of the
        module, cast once here; the module's own f32 weights stay as they
        are, and "f32" drops the copy."""
        self.compute_dtype = DTYPES[name]
        self._serving_copy = None
        if self.compute_dtype != torch.float32:
            self._serving_copy = self._cast_copy()

    def _cast_copy(self) -> nn.Module:
        return copy.deepcopy(self.module).to(self.compute_dtype)

    @property
    def serving_module(self) -> nn.Module:
        """The module the forward runs: the module itself in f32, its cast
        copy in another serving dtype."""
        return self.module if self._serving_copy is None else self._serving_copy

    def set_route(self, forward) -> None:
        """Run `fwd_runtime` through `forward` (NHWC batch in the compute
        dtype -> NHWC output) instead of the serving module; None restores
        it."""
        self.route = forward

    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.module.parameters())

    # ---- checkpoints -------------------------------------------------------

    def checkpoint_name(self) -> str:
        return "model_%d.pth" % (self.global_step,)

    def save(self, base_path: str) -> str:
        """Write `model_<step>.pth` (the module's bare state_dict, the
        reference's format) and, when training, its state file beside it
        (`state_path`: the step, Adam's moments, the average). Returns the
        .pth path."""
        os.makedirs(base_path, exist_ok=True)
        path = os.path.join(base_path, self.checkpoint_name())
        state = {k: v.detach().cpu() for k, v in self.module.state_dict().items()}
        _save_atomic(state, path)
        if self.optimizer is not None:
            _save_atomic({"global_step": self.global_step,
                          "optimizer": self.optimizer.state_dict(),
                          "ema": None if self.ema is None else self.ema.average},
                         state_path(path))
        return path

    def restore(self, ckpt_path: str) -> None:
        """Strict restore of a `.pth` state_dict; when training, also its
        state file (`state_path`) if it exists: the step, Adam's moments and
        the average continue where the saved run stopped. Without one the
        moments restart and the average stays where `prepare` made it,
        from the weights the module had then, as the reference and JAX's
        `_restore_pth` leave them (larvanet_tpu/models/base.py:160-164,
        :786-852): the restored weights reach the average only through its
        updates."""
        if not ckpt_path.endswith((".pth", ".pt")):
            kind = "an orbax directory" if os.path.isdir(ckpt_path) \
                else "a msgpack checkpoint"
            raise ValueError(
                "%s is %s: restoring it needs flax, which the port does not "
                "use; convert it to .pth with the JAX package "
                "(larvanet_tpu.utils.torch_convert.save_pth). See ROADMAP.md."
                % (ckpt_path, kind))
        self.load_state_dict(load_pth(ckpt_path))
        if self.optimizer is None:
            return
        saved = state_path(ckpt_path)
        if not os.path.exists(saved):
            return
        state = torch.load(saved, map_location=self.device, weights_only=True)
        if (state["ema"] is None) != (self.ema is None):
            raise ValueError(
                "%s was saved %s an EMA; --ema_decay must be consistent across a "
                "resumed run" % (saved, "without" if state["ema"] is None else "with"))
        self.optimizer.load_state_dict(state["optimizer"])
        if self.ema is not None:
            self.ema.load(state["ema"])
        self.global_step = int(state["global_step"])

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
        if self._serving_copy is not None:
            self._serving_copy = self._cast_copy()

    # ---- forward -----------------------------------------------------------

    @torch.no_grad()
    def fwd_runtime(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        """The forward on an NHWC float batch already on the device; the
        result is f32 NHWC on the device, not synchronised."""
        x = x_nhwc.to(self.compute_dtype).contiguous()
        out = self.serving_module(x) if self.route is None else self.route(x)
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

    # ---- training ------------------------------------------------------------

    def get_learning_rate(self) -> float:
        raise NotImplementedError

    def get_next_train_scale(self) -> int:
        return self.scale_list[self._rng.integers(len(self.scale_list))]

    def _compute_loss(self, inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        return self.loss(self.module(inputs), targets)

    def _loss_and_grads(self, inputs: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        """The loss, with the gradients left in the parameters' `.grad`.
        `--grad_accum` k: k equal microbatches in turn, their gradients and
        losses summed, then scaled by 1/k (larvanet_tpu/models/base.py:444-463:
        exact for the families' mean losses); a batch that does not divide is
        refused."""
        accum = int(self.grad_accum or 1)
        if inputs.shape[0] % accum:
            raise ValueError("batch size %d is not divisible by --grad_accum %d"
                             % (inputs.shape[0], accum))
        mb = inputs.shape[0] // accum
        total = 0
        for i in range(accum):
            loss = self._compute_loss(inputs[i * mb:(i + 1) * mb], targets[i * mb:(i + 1) * mb])
            loss.backward()
            total = total + loss.detach()
        if accum > 1:
            inv = 1.0 / accum
            torch._foreach_mul_([p.grad for p in self.module.parameters()
                                 if p.grad is not None], inv)
            total = total * inv
        return total

    def train_step(self, input_list, scale, truth_list, summary=None) -> float:
        """One optimizer step on a batch of CHW host frames (reference
        models/base.py:65-76 contract). Returns the loss."""
        if self.optimizer is None:
            raise RuntimeError("train_step needs prepare(..., is_training=True)")
        inputs = self._input_to_device(input_list)
        targets = self._input_to_device(truth_list)
        lr = self.get_learning_rate()
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.zero_grad(set_to_none=True)
        loss = self._loss_and_grads(inputs, targets)
        self.optimizer.step()
        if self.ema is not None:
            self.ema.update()
        self.global_step += 1
        loss_val = float(loss)
        if summary is not None:
            summary.scalar("loss", loss_val, self.global_step)
            summary.scalar("lr", lr, self.global_step)
            # input/output/truth triplets (reference models/edsr.py:102-106)
            with torch.no_grad():
                out = self.module(inputs[:4]).cpu().numpy()
            for i in range(out.shape[0]):
                summary.image("input/%d" % i, inputs[i].cpu().numpy().transpose(2, 0, 1),
                              self.global_step)
                summary.image("output/%d" % i, out[i].transpose(2, 0, 1), self.global_step)
                summary.image("truth/%d" % i, targets[i].cpu().numpy().transpose(2, 0, 1),
                              self.global_step)
        return loss_val


def state_path(pth_path: str) -> str:
    """The training state file beside a `model_<step>.pth`."""
    return os.path.splitext(pth_path)[0] + ".state.pt"


def _save_atomic(obj, path: str) -> None:
    tmp = "%s.%d.tmp" % (path, os.getpid())
    torch.save(obj, tmp)
    os.replace(tmp, path)


class StepDecayMixin:
    """lr = base * decay^(step // decay_steps) (reference models/edsr.py:124-125)."""

    lr_flag = "lr"
    decay_flag = "lr_decay"
    decay_steps_flag = "lr_step"

    def get_learning_rate(self) -> float:
        base = getattr(self.args, self.lr_flag)
        decay = getattr(self.args, self.decay_flag)
        steps = getattr(self.args, self.decay_steps_flag)
        return base * (decay ** (self.global_step // steps))
