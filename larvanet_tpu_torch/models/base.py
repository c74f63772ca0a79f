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
  * `train_step(inputs, scale, truths)` is one optimizer step on a host
    batch (models/base.py:425-487): the loss and its gradients, summed
    over `grad_accum` equal microbatches and scaled by 1/accum, then Adam,
    then the average. A batch is a list of CHW frames or one 4-D float
    array, NHWC or NCHW (`chw_list_to_nhwc`'s rule, base.py:117-135).
  * Volume bookkeeping for the volume-driven trainers (base.py:345-373):
    `total_volume` and `temp_volume` (reset by `prepare`) and
    `volume_per_step`, which the train_larva CLI sets; `psnr_on_device`
    scores one frame on the device with one scalar read back (:592-599).
  * `save(dir)` writes `checkpoint_name()` (`model_<step>.pth`), the
    module's bare state_dict (the reference's format, which the JAX
    package restores), and beside it a `.state.pt` with what a resume
    needs: the step, `total_volume`, Adam's moments, the average and
    what a subclass adds (`_train_state`). `restore(path)` reads a `.pth`
    with shape checks, strict by default; `strict=False` loads the keys
    both sides have and keeps the init of the rest (the V2 presets'
    partial restore, base.py:889-921). When training it also loads the
    state file, if there is one and the `.pth` covered every key; a
    `.pth` alone restarts the moments and leaves the average at the
    weights `prepare` built, as in the reference and JAX. Any other file
    is a flax msgpack checkpoint of the JAX package (`model_<step>.ckpt`),
    read by the port's own reader (`utils/flax_msgpack`): its params,
    step and volume, and for evaluation its EMA subtree; when training,
    its optax state too (`_load_jax_opt_state`: Adam's or AdamW's `mu`,
    `nu` and `count` become torch's `exp_avg`, `exp_avg_sq` and `step`
    per parameter, per leaf or in `--fused_opt`'s one flat vector; the
    EMA node becomes `ParamEMA`'s average) and what a subclass adds
    (`_load_jax_train_extras`: the plateau schedule), so the next step is
    the one JAX takes from the same file. A JAX orbax directory is refused.
  * `--orbax_checkpoint` (`orbax_checkpoints` set): `save` writes a
    directory at the same name (`_save_dir`, torch.distributed.checkpoint:
    every process of an initialized group writes its part), swapped in
    when complete, or with `--async_checkpoint` by DCP's async_save;
    `restore` recognises such a directory by its `.metadata` file.
  * Data-parallel training (parallel/mesh.use_data_parallel): with
    `data_parallel` set, `_optimizer_step` takes the shards' mean loss and
    gradients from it, steps the optimizer and the average once, and
    copies the parameters back to the replicas.
  * `--async_checkpoint` (`async_checkpoints` set): `save` snapshots the
    files' tensors on the device and returns; a worker thread writes them
    (utils/checkpoints.AsyncCheckpointWriter). `wait_for_checkpoints()`
    blocks until they are on disk and raises the writer's errors.
  * `--remat 1` (`remat_requested`): the train step's conv pairs run under
    `torch.utils.checkpoint` (ops/pairs.remat_pair); refused with an
    explicit --packed_trunk 0, as JAX refuses it.
  * `use_ema_params()` swaps the restored parameter average into the
    module (the eval CLIs' `--ema`): a `.ckpt`'s EMA subtree, or the
    `"ema"` of the `.state.pt` beside a `.pth`.
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
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from larvanet_tpu_torch.eval.metrics import psnr_rgb_device
from larvanet_tpu_torch.train.losses import l1_loss
from larvanet_tpu_torch.utils import flax_msgpack
from larvanet_tpu_torch.utils.checkpoints import AsyncCheckpointWriter, to_host
from larvanet_tpu_torch.utils.torch_convert import (EXPORT_RULES, load_pth,
                                                    state_dict_from_jax_params)

DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}


def add_qat_flag(parser) -> None:
    """--qat (larvanet_tpu/models/base.py:57-84): train through
    ops/pairs.qat_pair, the straight-through fake-quant of the conv pairs
    with the int8 serving scheme (the same per-output-channel weight scales
    and 1.05 max activation headroom), so that --int8_trunk serving costs
    ~0 dB. Needs an even patch width; JAX also needs its --packed_trunk,
    whose explicit 0 `prepare` refuses as JAX does."""
    parser.add_argument("--qat", type=int, default=0,
                        help="Quantization-aware training: fake-quantize the conv "
                             "pairs with the int8 serving scheme (STE) so "
                             "--int8_trunk serving costs ~0 dB. Even patch width.")


def add_training_flags(parser, lr_domain: bool = True) -> None:
    """--packed_trunk, --lr_domain_loss, --qat and --remat of the families
    whose training graph is a walk of conv pairs (JAX's packed mixins:
    _add_packed_trunk_flag, add_lr_domain_flag and add_qat_flag,
    base.py:57-108); without `lr_domain` for a family whose loss is on
    the HR image (HRSR, whose HR blocks follow the shuffle)."""
    parser.add_argument("--packed_trunk", type=int, default=None,
                        help="The JAX package's width-packed trunk (an exact "
                             "reparametrisation the port does not run). Unset is JAX's 1; "
                             "0 trains the module graph, as JAX does.")
    if lr_domain:
        parser.add_argument("--lr_domain_loss", type=int, default=1,
                            help="With --packed_trunk (unset: on): compute the training L1 "
                                 "loss PRE-SHUFFLE in the LR domain (targets pixel-"
                                 "unshuffled instead; identical per-element grads). 0 = "
                                 "HR-domain loss.")
    add_qat_flag(parser)
    parser.add_argument("--remat", type=int, default=0,
                        help="Recompute each conv pair's activations in the backward "
                             "(torch.utils.checkpoint): a step's peak memory holds one "
                             "pair's, the same gradients.")


def qat_requested(model) -> bool:
    """True when the model was configured with --qat 1 (base.py:87-90)."""
    return bool(getattr(getattr(model, "args", None), "qat", 0))


def remat_requested(model) -> bool:
    """True when the model was configured with --remat 1
    (ops/packed/pairs.py:147-148)."""
    return bool(getattr(getattr(model, "args", None), "remat", 0))


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
    # the module has EDSR's linear upsample tail and forward(x, pair, tail)
    # hook, which ops/collapsed_tail bakes (EDSR, MAMNet)
    has_collapsed_tail = False
    # flags the inference CLIs call TPU-only that this family reads when it
    # serves (cli/common.note_ignored leaves them out of its notice)
    serving_flags: Tuple[str, ...] = ()

    def serves_collapsed_tail(self, args) -> bool:
        """Whether the inference CLIs serve through the collapsed tail
        (cli/common.maybe_collapse_tail): under --collapsed_tail, where the
        module has one."""
        return self.has_collapsed_tail and bool(getattr(args, "collapsed_tail", 0))

    def __init__(self):
        self.args = None
        self.module: Optional[nn.Module] = None
        self.scale = 4
        self.scale_list: List[int] = []
        self.device = torch.device("cpu")
        self.compute_dtype = torch.float32
        self.route = None
        self.route_remake = None
        self._serving_copy: Optional[nn.Module] = None
        self.global_step = 0
        self.total_volume = 0.0
        self.temp_volume = 0.0
        self.volume_per_step = 0
        self.is_training = False
        self.optimizer: Optional[torch.optim.Optimizer] = None
        self.ema: Optional[ParamEMA] = None
        # an evaluation restore's parameter average for use_ema_params: a
        # .ckpt's EMA subtree, or the state file beside a .pth (read on use)
        self._restored_ema: Optional[Dict[str, torch.Tensor]] = None
        self._ema_state_file: Optional[str] = None
        # set before prepare, as the train CLI does
        self.ema_decay = 0.0
        self.grad_accum = 1
        self.async_checkpoints = False
        self._ckpt_writer: Optional[AsyncCheckpointWriter] = None
        # --orbax_checkpoint: directory checkpoints (torch.distributed.checkpoint)
        self.orbax_checkpoints = False
        self._dir_saves: List = []
        # parallel/mesh.use_data_parallel's step
        self.data_parallel = None
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
        self.total_volume = 0.0
        self.temp_volume = 0.0
        self.is_training = is_training
        self.optimizer = self.ema = None
        self.data_parallel = None
        if is_training and qat_requested(self) and getattr(self.args, "packed_trunk",
                                                           None) == 0:
            # JAX's check (base.py:383-388); the port's --packed_trunk is
            # otherwise accepted and ignored, and unset means JAX's default 1
            raise ValueError(
                "--qat 1 requires --packed_trunk 1: QAT fake-quantizes the "
                "packed conv pairs the int8 serving path runs "
                "(ops/pairs.qat_pair)")
        if is_training and remat_requested(self) and getattr(self.args, "packed_trunk",
                                                             None) == 0:
            # base.py:389-393
            raise ValueError(
                "--remat 1 requires --packed_trunk 1: rematerialization "
                "wraps the packed conv pairs (ops/pairs.remat_pair); "
                "the plain module graph would silently train without it")
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
        it. It clears `route_remake`, which a caller that can build the same
        route for a copy of the model on another device sets after it:
        `route_remake(replica)` -> the route, its baked tensors made on the
        replica's device (parallel/mesh.use_data_parallel_eval)."""
        self.route = forward
        self.route_remake = None

    def num_parameters(self) -> int:
        return sum(p.numel() for p in self.module.parameters())

    # ---- checkpoints -------------------------------------------------------

    def checkpoint_name(self) -> str:
        return "model_%d.pth" % (self.global_step,)

    def save(self, base_path: str) -> str:
        """Write `checkpoint_name()` (the module's bare state_dict, the
        reference's format) and, when training, its state file beside it
        (`state_path`: the step, `total_volume`, Adam's moments, the
        average, and `_train_state`'s additions). Returns the .pth path.
        With `async_checkpoints` set the tensors are snapshotted on the
        device and a worker thread writes the files
        (`wait_for_checkpoints`)."""
        os.makedirs(base_path, exist_ok=True)
        path = os.path.join(base_path, self.checkpoint_name())
        if self.orbax_checkpoints:
            return self._save_dir(path)
        files = [({k: v.detach() for k, v in self.module.state_dict().items()}, path)]
        if self.optimizer is not None:
            files.append((self._train_state(), state_path(path)))
        if self.async_checkpoints:
            if self._ckpt_writer is None:
                self._ckpt_writer = AsyncCheckpointWriter()
            self._ckpt_writer.submit(files, _save_atomic)
            return path
        for obj, file in files:
            _save_atomic(to_host(obj), file)
        return path

    def wait_for_checkpoints(self) -> None:
        """Block until every asynchronous save is on disk (a no-op for
        synchronous ones); raises the writer's errors (base.py:765-771)."""
        if self._ckpt_writer is not None:
            self._ckpt_writer.wait()
        pending, self._dir_saves = self._dir_saves, []
        for future in pending:
            future.result()

    def _save_dir(self, path: str) -> str:
        """`--orbax_checkpoint`: a directory at `path` (the name `save`
        gives a file), holding the module's state_dict and, when training,
        the state file's contents (utils/checkpoints.save_dir_checkpoint:
        torch.distributed.checkpoint, coordinated across the processes of an
        initialized group). Synchronous: written beside and swapped in.
        With `async_checkpoints`: the tensors are copied to the host here,
        the earlier directory save is waited for, and DCP's async_save
        writes; `wait_for_checkpoints` waits for it."""
        from larvanet_tpu_torch.utils.checkpoints import (dir_checkpoint_state,
                                                          save_dir_checkpoint)

        flat = dir_checkpoint_state(self.module.state_dict(),
                                    self._train_state() if self.optimizer is not None
                                    else None)
        if self.async_checkpoints:
            self.wait_for_checkpoints()
            self._dir_saves.append(save_dir_checkpoint(flat, path, asynchronous=True))
        else:
            save_dir_checkpoint(flat, path)
        return path

    def _train_state(self) -> dict:
        """What a resume needs beyond the weights. JAX saves no
        `temp_volume` (base.py:606-635): a checkpoint is written when it was
        just reset, and a resume restarts it at 0."""
        return {"global_step": self.global_step, "total_volume": self.total_volume,
                "optimizer": self.optimizer.state_dict(),
                "ema": None if self.ema is None else self.ema.average}

    def _load_train_state(self, state: dict) -> None:
        self.optimizer.load_state_dict(state["optimizer"])
        if self.ema is not None:
            self.ema.load(state["ema"])
        self.global_step = int(state["global_step"])
        self.total_volume = float(state.get("total_volume", self.total_volume))

    def restore(self, ckpt_path: str, strict: bool = True) -> None:
        """Restore a checkpoint, strict or partial (`load_state_dict`).

        A `.pth` state_dict; when training, also its state file
        (`state_path`) if it exists and the `.pth` covered every key of the
        module: the step, `total_volume`, Adam's moments and the average
        continue where the saved run stopped. Without one the moments
        restart and the average stays where `prepare` made it, from the
        weights the module had then, as the reference and JAX's
        `_restore_pth` leave them (larvanet_tpu/models/base.py:160-164,
        :786-852): the restored weights reach the average only through its
        updates. For evaluation the state file is only remembered, for
        `use_ema_params`.

        Any other file is a flax msgpack checkpoint, restored for
        evaluation as JAX's `restore` does (base.py:615-646, :775-785)."""
        from larvanet_tpu_torch.utils.checkpoints import is_dir_checkpoint

        self._restored_ema = self._ema_state_file = None
        if is_dir_checkpoint(ckpt_path):
            self._restore_dir(ckpt_path, strict)
            return
        if os.path.isdir(ckpt_path):
            raise ValueError(
                "%s is an orbax directory: restoring it needs orbax, which the port "
                "does not use; convert it to .pth with the JAX package "
                "(larvanet_tpu.utils.torch_convert.save_pth). See ROADMAP.md."
                % (ckpt_path,))
        if not ckpt_path.endswith((".pth", ".pt")):
            self._restore_msgpack(ckpt_path, strict)
            return
        complete = self.load_state_dict(load_pth(ckpt_path), strict=strict)
        saved = state_path(ckpt_path)
        if not os.path.exists(saved):
            return
        if self.optimizer is None:
            if complete:
                self._ema_state_file = saved
            return
        if not complete:
            print("restore: %s covers part of the model; its training state (%s) is "
                  "not loaded" % (ckpt_path, saved))
            return
        state = torch.load(saved, map_location=self.device, weights_only=True)
        if (state["ema"] is None) != (self.ema is None):
            raise ValueError(
                "%s was saved %s an EMA; --ema_decay must be consistent across a "
                "resumed run" % (saved, "without" if state["ema"] is None else "with"))
        self._load_train_state(state)

    def _restore_dir(self, ckpt_path: str, strict: bool) -> None:
        """A directory checkpoint of the port (`_save_dir`): the module's
        state_dict; when training, the training state it holds, as a
        `.pth`'s state file is loaded (only where the checkpoint covered
        every key); for evaluation its average, kept for `use_ema_params`."""
        from larvanet_tpu_torch.utils.checkpoints import read_dir_checkpoint

        module_state, state = read_dir_checkpoint(ckpt_path)
        complete = self.load_state_dict(module_state, strict=strict)
        if state is None or not complete:
            return
        if self.optimizer is None:
            if state.get("ema") is not None:
                names = [name for name, _ in self.module.named_parameters()]
                self._restored_ema = dict(zip(names, state["ema"]))
            return
        if (state["ema"] is None) != (self.ema is None):
            raise ValueError(
                "%s was saved %s an EMA; --ema_decay must be consistent across a "
                "resumed run" % (ckpt_path, "without" if state["ema"] is None else "with"))
        self._load_train_state(state)  # the optimizer and the average copy to the device

    def _restore_msgpack(self, ckpt_path: str, strict: bool) -> None:
        """A JAX `.ckpt` (flax msgpack): `params` through the port's copy of
        the export rules into `load_state_dict`, `global_step`,
        `total_volume`; for evaluation the EMA subtree (`ema_params`, or
        the {"ema": …} node in `opt_state`) kept for `use_ema_params`; when
        training, the optimizer state and the average
        (`_load_jax_opt_state`) and `_load_jax_train_extras`. JAX saves no
        `temp_volume`: it restarts at 0, as in JAX."""
        if self.registry_name not in EXPORT_RULES:
            raise ValueError("no conversion rules for the parameters of model %r"
                             % (self.registry_name,))
        with open(ckpt_path, "rb") as f:
            state = flax_msgpack.restore(f.read())
        if not isinstance(state, dict) or not isinstance(state.get("params"), dict):
            raise ValueError("%s holds no params tree" % (ckpt_path,))
        self.load_state_dict(self._from_jax_tree(state["params"]), strict=strict)
        self.global_step = int(state.get("global_step", self.global_step))
        self.total_volume = float(state.get("total_volume", self.total_volume))
        if self.optimizer is not None:
            if "opt_state" not in state:
                raise ValueError("%s holds no optimizer state to resume training from"
                                 % (ckpt_path,))
            self._load_jax_opt_state(state["opt_state"], state["params"], ckpt_path)
            self.temp_volume = 0.0
            self._load_jax_train_extras(state)
            return
        ema = state.get("ema_params") or find_ema_in_state_dict(state.get("opt_state", {}))
        if ema is not None:
            self._restored_ema = self._from_jax_tree(ema)

    def _load_jax_opt_state(self, opt_state, params_tree, ckpt_path: str) -> None:
        """optax's serialized state -> the optimizer's and the average's
        (base.py:619-670): the Adam node's `mu` and `nu` (parameter trees,
        or `--fused_opt`'s flat vectors in ravel_pytree's order: dict keys
        sorted, `_adapt_opt_layout`) through the export rules onto each
        parameter, `count` as its `step`; the {"ema": tree} node into
        `ParamEMA` (it must be there exactly when --ema_decay is set)."""
        adam = _find_adam_node(opt_state)
        if adam is None:
            raise ValueError("%s: no Adam state (mu, nu, count) in its opt_state"
                             % (ckpt_path,))
        mu, nu = (_unravel_like(adam[k], params_tree) for k in ("mu", "nu"))
        mu, nu = self._from_jax_tree(mu), self._from_jax_tree(nu)
        step = float(np.asarray(adam["count"]))
        names = [name for name, _ in self.module.named_parameters()]
        opt = {"state": {}, "param_groups": self.optimizer.state_dict()["param_groups"]}
        for i, name in enumerate(names):
            opt["state"][i] = {"step": torch.tensor(step, dtype=torch.float32),
                               "exp_avg": mu[name].to(self.device),
                               "exp_avg_sq": nu[name].to(self.device)}
        self.optimizer.load_state_dict(opt)
        ema = find_ema_in_state_dict(opt_state)
        if (ema is None) != (self.ema is None):
            raise ValueError(
                "%s was saved %s an EMA; --ema_decay must be consistent across a "
                "resumed run" % (ckpt_path, "without" if ema is None else "with"))
        if ema is not None:
            average = self._from_jax_tree(ema)
            self.ema.load([average[name].to(self.device) for name in names])

    def _load_jax_train_extras(self, state: dict) -> None:
        """What a subclass restores from a JAX checkpoint beyond the
        optimizer (LarvaNet: the plateau schedule)."""

    def _from_jax_tree(self, tree) -> Dict[str, torch.Tensor]:
        """A JAX parameter tree as read from a checkpoint (numpy leaves, or
        torch tensors where flax gives bfloat16) -> the port's state_dict."""
        def to_numpy(node):
            if isinstance(node, dict):
                return {k: to_numpy(v) for k, v in node.items()}
            if isinstance(node, torch.Tensor):
                return node.float().numpy()
            return np.asarray(node)
        return state_dict_from_jax_params(to_numpy(tree), self.registry_name)

    def use_ema_params(self) -> None:
        """Swap the parameter average into the module (the eval CLIs'
        `--ema`, larvanet_tpu/models/base.py:671-681): a restored `.ckpt`'s
        EMA subtree, else the `"ema"` of the state file beside a restored
        `.pth` (the average of `module.parameters()`, in their order). The
        serving copy is cast again; call it right after `restore`, before
        anything that reads the weights once (the CLIs' Winograd route)."""
        ema = self._restored_ema
        if ema is None and self._ema_state_file is not None:
            saved = torch.load(self._ema_state_file, map_location="cpu", weights_only=True)
            if saved.get("ema") is not None:
                names = [name for name, _ in self.module.named_parameters()]
                ema = dict(zip(names, saved["ema"]))
        if ema is None:
            raise ValueError("checkpoint has no EMA weights — train with --ema_decay")
        params = dict(self.module.named_parameters())
        missing = sorted(set(params) - set(ema))
        if missing:
            raise ValueError("the EMA weights miss parameters %s" % (missing,))
        with torch.no_grad():
            for name, p in params.items():
                if tuple(ema[name].shape) != tuple(p.shape):
                    raise ValueError("EMA shape mismatch at %r: model %s vs average %s"
                                     % (name, tuple(p.shape), tuple(ema[name].shape)))
                p.copy_(ema[name])
        if self._serving_copy is not None:
            self._serving_copy = self._cast_copy()

    def load_state_dict(self, state: Dict[str, torch.Tensor], strict: bool = True) -> bool:
        """Load a state_dict, every key's shape checked. strict: the keys
        must match exactly. Not strict (JAX's `_merge_partial`,
        base.py:889-921): the keys both have are loaded, the module's other
        keys keep their values, the checkpoint's extra keys are ignored.
        Returns whether the checkpoint covered every key of the module."""
        current = self.module.state_dict()
        missing = sorted(set(current) - set(state))
        unexpected = sorted(set(state) - set(current))
        if strict and (missing or unexpected):
            raise ValueError("checkpoint keys do not match model %s: missing %s, "
                             "unexpected %s" % (self.registry_name, missing,
                                                unexpected))
        state = {k: v for k, v in state.items() if k in current}
        for key, value in state.items():
            if tuple(value.shape) != tuple(current[key].shape):
                raise ValueError(
                    "checkpoint shape mismatch at %r: model %s vs checkpoint %s"
                    % (key, tuple(current[key].shape), tuple(value.shape)))
        if missing:
            print("restore: %d parameters are not in the checkpoint and keep their "
                  "init: %s" % (len(missing), missing))
        self.module.load_state_dict(state, strict=not missing)
        if self._serving_copy is not None:
            self._serving_copy = self._cast_copy()
        return not missing

    # ---- forward -----------------------------------------------------------

    @torch.no_grad()
    def fwd_runtime(self, x_nhwc: torch.Tensor) -> torch.Tensor:
        """The forward on an NHWC float batch already on the device; the
        result is f32 NHWC on the device, not synchronised."""
        x = x_nhwc.to(self.compute_dtype).contiguous()
        out = self.serving_module(x) if self.route is None else self.route(x)
        return out.float()

    def _input_to_device(self, images) -> torch.Tensor:
        """A host batch -> NHWC f32 batch on the device. A list is always
        CHW frames; a 4-D array is NHWC when its last axis is 3, else NCHW
        when its axis 1 is 3 (chw_list_to_nhwc, larvanet_tpu/models/
        base.py:117-135; the queue loaders return NHWC).

        uint8 frames are pushed as uint8 and cast on the device; any
        other frames are pushed as f32 (the reference contract)."""
        if isinstance(images, (list, tuple)):
            if not images:
                raise ValueError("expected a non-empty list of CHW frames")
            if all(getattr(im, "dtype", None) == np.uint8 for im in images):
                x8 = np.stack([np.asarray(im) for im in images])
                x8 = np.ascontiguousarray(x8.transpose(0, 2, 3, 1))
                return torch.from_numpy(x8).to(self.device).float()
            arr = np.stack([np.asarray(im, np.float32) for im in images]).transpose(0, 2, 3, 1)
        else:
            arr = np.asarray(images, np.float32)
            if arr.ndim != 4:
                raise ValueError("expected a batch of images, got shape %s" % (arr.shape,))
            if arr.shape[-1] != 3:
                if arr.shape[1] != 3:
                    raise ValueError("cannot infer the layout of a batch of shape %s"
                                     % (arr.shape,))
                arr = arr.transpose(0, 2, 3, 1)
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

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

    def _optimizer_step(self, inputs: torch.Tensor, targets: torch.Tensor,
                        lr: float) -> torch.Tensor:
        """The loss and its gradients, then the optimizer's step at `lr` and
        the average's update. Returns the loss, on the device."""
        if self.optimizer is None:
            raise RuntimeError("training needs prepare(..., is_training=True)")
        for group in self.optimizer.param_groups:
            group["lr"] = lr
        self.optimizer.zero_grad(set_to_none=True)
        dp = self.data_parallel
        if dp is None:
            loss = self._loss_and_grads(inputs, targets)
        else:  # the shards' mean gradients (parallel/mesh.DataParallelTrain)
            loss = dp.loss_and_grads(inputs, targets)
        self.optimizer.step()
        if self.ema is not None:
            self.ema.update()
        if dp is not None:
            dp.copy_out()
        return loss

    def train_step(self, input_list, scale, truth_list, summary=None) -> float:
        """One optimizer step on a host batch (reference models/base.py:65-76
        contract; `_input_to_device` takes its layouts). Returns the loss."""
        inputs = self._input_to_device(input_list)
        targets = self._input_to_device(truth_list)
        lr = self.get_learning_rate()
        loss_val = float(self._optimizer_step(inputs, targets, lr))
        self.global_step += 1
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

    def psnr_on_device(self, input_chw: np.ndarray, truth_chw: np.ndarray) -> float:
        """The challenge protocol's RGB PSNR of the forward of one CHW frame
        against its truth, on the device, one scalar read back
        (larvanet_tpu/models/base.py:580-599): the forward `fwd_runtime`
        runs, through the exit the module takes by default."""
        out = self.fwd_runtime(self._input_to_device([input_chw]))
        return float(psnr_rgb_device(out, self._input_to_device([truth_chw])))


def _find_adam_node(sd):
    """The serialized ScaleByAdamState ({"count", "mu", "nu"}) inside an
    optax state, or None."""
    if isinstance(sd, dict):
        if {"count", "mu", "nu"} <= set(sd.keys()):
            return sd
        for v in sd.values():
            found = _find_adam_node(v)
            if found is not None:
                return found
    return None


def _unravel_like(node, params_tree):
    """A moment as a parameter tree: itself when it is one, or
    `--fused_opt`'s flat vector cut into the leaves of `params_tree` in
    ravel_pytree's order (jax's tree order: dict keys sorted)."""
    if isinstance(node, dict):
        return node
    flat = np.asarray(node.float().numpy() if isinstance(node, torch.Tensor) else node
                      ).reshape(-1)
    offset = 0

    def cut(tree):
        nonlocal offset
        if isinstance(tree, dict):
            return {k: cut(tree[k]) for k in sorted(tree)}
        shape = tuple(tree.shape)
        size = int(np.prod(shape))
        leaf = flat[offset:offset + size].reshape(shape)
        offset += size
        return leaf

    out = cut(params_tree)
    if offset != flat.size:
        raise ValueError("a flat optimizer moment of %d values for parameters of %d"
                         % (flat.size, offset))
    return out


def find_ema_in_state_dict(sd):
    """The parameter average inside a serialized optax state, or None: flax
    writes an `EmaState` as a one-key {"ema": tree} dict
    (larvanet_tpu/models/base.py:193-205)."""
    if isinstance(sd, dict):
        if set(sd.keys()) == {"ema"}:
            return sd["ema"]
        for v in sd.values():
            found = find_ema_in_state_dict(v)
            if found is not None:
                return found
    return None


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


class SchedulerStateMixin:
    """A training schedule, the attribute `scheduler_attr` names (None when
    not training), in the training state file and from a JAX `.ckpt`
    (JAX's `state["scheduler"]`, its numpy scalars as Python numbers)."""

    scheduler_attr = "scheduler"

    def _train_state(self) -> dict:
        state = super()._train_state()
        schedule = getattr(self, self.scheduler_attr)
        if schedule is not None:
            state["scheduler"] = schedule.state_dict()
        return state

    def _load_train_state(self, state: dict) -> None:
        super()._load_train_state(state)
        schedule = getattr(self, self.scheduler_attr)
        if schedule is not None and "scheduler" in state:
            schedule.load_state_dict(state["scheduler"])

    def _load_jax_train_extras(self, state: dict) -> None:
        schedule = getattr(self, self.scheduler_attr)
        if schedule is not None and "scheduler" in state:
            schedule.load_state_dict({k: v.item() if hasattr(v, "item") else v
                                      for k, v in state["scheduler"].items()})


class TrainedMeanShiftMixin:
    """A restore of MeanShift buffers that are not the intended +/-mean (a
    trained reference checkpoint; the module applies its own buffers on
    every route): JAX's restore lines, the affines named as JAX names
    its overrides (ms_affine, mis_affine), and --packed_trunk off, so that
    training runs the module graph, as JAX's does (base.py:808-839). The
    graphs that bake the intended shift (the int8 forwards) refuse such a
    module themselves."""

    def load_state_dict(self, state, strict: bool = True) -> bool:
        complete = super().load_state_dict(state, strict=strict)
        trained = sorted(field for name, field in (("mean_shift", "ms_affine"),
                                                   ("mean_inverse_shift", "mis_affine"))
                         if hasattr(self.module, name)
                         and not getattr(self.module, name).intended())
        if trained:
            print("restore: installed the checkpoint's trained MeanShift affines on the "
                  "module (%s) — the reference trains around its randomly-initialized "
                  "frozen shifts" % ", ".join(trained))
            # a family with no --packed_trunk (MAMNet) has nothing to turn off
            if hasattr(self.args, "packed_trunk") and self.args.packed_trunk != 0:
                self.args.packed_trunk = 0
                print("restore: disabled --packed_trunk — the packed graphs bake the "
                      "intended mean shifts, not this checkpoint's trained affines; "
                      "running the exact module graph")
        return complete
