"""The volume-driven training loop of the train_larva CLIs (reference
train_larva.py; larvanet_tpu/models/larvanet.py:339-402), shared by the
LarvaNet family, msrr_reduced and TreeNet, which JAX gives the same loop
(larvanet_tpu/models/msrr.py:455-479 borrows LarvaNetBase's; TreeNet's is
its own copy with another schedule, models/treenet.py:185-218).

AdamW, `train_step_larva` (one step; every --val_volume bytes of input
pixels: validation, a checkpoint, the summary), `validate_for_train`, and
the schedule's state in the checkpoint's state file and in a JAX `.ckpt`
resume. Two schedules:

  PlateauVolumeMixin  a ReduceLROnPlateau on the validation PSNR (made by
                      `prepare` when training, from --lr, --lr_decay,
                      --patience, --cooldown, --threshold and --min_lr),
                      stepped by each validation; a validation after step
                      1 too; the checkpoint `model_step<N>_vol<G>G.pth`.
  StepVolumeMixin     TreeNet's StepLR (from --lr, --lr_step and
                      --lr_decay, its count at the starting step) stepped
                      after every batch; no validation after step 1, and
                      the validation steps no schedule; the checkpoint
                      keeps SRModel's `model_<step>.pth`, as JAX's TreeNet
                      keeps its `checkpoint_name` (base.py:683).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from larvanet_tpu_torch.models.base import SchedulerStateMixin
from larvanet_tpu_torch.train.schedules import ReduceLROnPlateau, StepLR

# the scale validation asks the val loader for: the LarvaNet family's x4,
# which JAX's borrowed validate_for_train keeps for msrr_reduced too
VAL_SCALE = 4


class _VolumeLoop(SchedulerStateMixin):
    """AdamW and the volume-driven step, before SRModel in a wrapper's
    bases; the schedule is a subclass's (`scheduler`, `_make_scheduler`,
    `get_learning_rate` and the two hooks), its state saved and restored
    by SchedulerStateMixin (larvanet.py:399-402, treenet.py:251-261)."""

    optimizer_kind = "adamw"
    validate_at_step_1 = True

    def __init__(self):
        super().__init__()
        self.scheduler = None

    def prepare(self, scales, device="cuda", seed=0, is_training=False, global_step=0):
        super().prepare(scales, device=device, seed=seed, is_training=is_training,
                        global_step=global_step)
        self.scheduler = self._make_scheduler(global_step) if is_training else None

    def _make_scheduler(self, global_step: int):
        raise NotImplementedError

    def _after_batch(self) -> None:
        """The schedule's step after every optimizer step (StepLR's)."""

    def _after_validation(self, psnr: float) -> None:
        """The schedule's step after a validation (the plateau's)."""

    def train_step_larva(self, args, val_dataloader, input_batch, truth_batch,
                         summary=None) -> float:
        """One step (larvanet.py:340-369, treenet.py:185-203): the step count
        and the volume first, then the optimizer at the current lr and
        `_after_batch`; validation after step 1 where `validate_at_step_1`;
        and once `temp_volume` reaches --val_volume, the volume is banked,
        then validation, a checkpoint in args.train_path and the summary's
        loss and lr. Returns the loss."""
        inputs = self._input_to_device(input_batch)
        targets = self._input_to_device(truth_batch)
        self.global_step += 1
        self.temp_volume += self.volume_per_step
        lr = self.get_learning_rate()
        loss = float(self._optimizer_step(inputs, targets, lr))
        self._after_batch()

        if self.validate_at_step_1 and self.global_step == 1 and val_dataloader is not None:
            self.validate_for_train(args, val_dataloader)

        if self.temp_volume >= self.args.val_volume:
            self.total_volume += self.temp_volume
            self.temp_volume = 0
            if val_dataloader is not None:
                self.validate_for_train(args, val_dataloader)
            if args is not None and getattr(args, "train_path", None):
                self.save(base_path=args.train_path)
                print("saved a model checkpoint at volume %.0fG" % (self.total_volume / 1e9,))
            if summary is not None:
                summary.scalar("loss", loss, self.global_step)
                summary.scalar("lr", lr, self.global_step)
        return loss

    def validate_for_train(self, args, dataloader) -> float:
        """The val set's mean RGB PSNR, each frame scored on the device, then
        `_after_validation` with it (larvanet.py:371-388, treenet.py:205-218)."""
        psnr_list = []
        for idx in range(dataloader.get_num_images()):
            input_image, truth_image, _ = dataloader.get_image_pair(image_index=idx,
                                                                    scale=VAL_SCALE)
            psnr_list.append(self.psnr_on_device(input_image, truth_image))
        average_psnr = float(np.mean(psnr_list))
        print("step %d, volume %.0fG, psnr=%.8f, lr = %.8f"
              % (self.global_step, self.total_volume / 1e9, average_psnr,
                 self.get_learning_rate()))
        if self.scheduler is not None:
            self._after_validation(average_psnr)
        return average_psnr



class PlateauVolumeMixin(_VolumeLoop):
    """The plateau schedule on the validation PSNR (LarvaNet, msrr_reduced)."""

    scheduler: Optional[ReduceLROnPlateau]

    def _make_scheduler(self, global_step: int) -> ReduceLROnPlateau:
        return ReduceLROnPlateau(
            lr=self.args.lr, factor=self.args.lr_decay, patience=self.args.patience,
            cooldown=getattr(self.args, "cooldown", 0), threshold=self.args.threshold,
            min_lr=self.args.min_lr, mode="max")

    def get_learning_rate(self) -> float:
        return self.scheduler.lr if self.scheduler is not None else self.args.lr

    def _after_validation(self, psnr: float) -> None:
        self.scheduler.step(psnr)

    def checkpoint_name(self) -> str:
        return "model_step%d_vol%.0fG.pth" % (self.global_step, self.total_volume / 1e9)


class StepVolumeMixin(_VolumeLoop):
    """TreeNet's StepLR, stepped after every batch (treenet.py:139-147)."""

    validate_at_step_1 = False
    scheduler: Optional[StepLR]

    def _make_scheduler(self, global_step: int) -> StepLR:
        return StepLR(base_lr=self.args.lr, step_size=self.args.lr_step,
                      gamma=self.args.lr_decay, last_epoch=global_step)

    def get_learning_rate(self) -> float:
        return self.scheduler.get_lr() if self.scheduler is not None else self.args.lr

    def _after_batch(self) -> None:
        self.scheduler.step()
