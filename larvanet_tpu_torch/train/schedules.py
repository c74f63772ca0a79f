"""Learning-rate schedules (larvanet_tpu/train/schedules.py), host control.

  * ReduceLROnPlateau - torch's semantics as the JAX package writes them
    (schedules.py:29-83), stepped with the validation PSNR in `max` mode
    and an absolute threshold (reference models/LarvaNet.py:90-92, :161):
    `best` moves when the metric beats best + threshold; otherwise a bad
    epoch counts unless a cooldown runs; past `patience` bad epochs the lr
    is multiplied by `factor`, floored at `min_lr`, and skipped when the
    change is `eps` or less; a cooldown of `cooldown` steps follows.
  * StepLR - torch's StepLR stepped per batch (reference models/TreeNet.py:92).

Both are plain dataclasses with `state_dict` / `load_state_dict`, which
the training state file carries.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass, field
from typing import Dict


@dataclass
class ReduceLROnPlateau:
    lr: float
    factor: float = 0.5
    patience: int = 3
    cooldown: int = 6
    threshold: float = 1e-3
    min_lr: float = 1e-8
    mode: str = "max"
    eps: float = 1e-8  # torch: an update of eps or less is skipped
    # state
    best: float = field(default=None)  # type: ignore[assignment]
    num_bad_epochs: int = 0
    cooldown_counter: int = 0

    def __post_init__(self):
        if self.best is None:
            self.best = float("-inf") if self.mode == "max" else float("inf")

    def _is_better(self, metric: float) -> bool:
        if self.mode == "max":
            return metric > self.best + self.threshold
        return metric < self.best - self.threshold

    def step(self, metric: float) -> float:
        """Record a metric; returns the lr, reduced or not."""
        if self._is_better(metric):
            self.best = metric
            self.num_bad_epochs = 0
        elif self.cooldown_counter <= 0:
            self.num_bad_epochs += 1
        if self.cooldown_counter > 0:
            self.cooldown_counter -= 1
            self.num_bad_epochs = 0
        if self.num_bad_epochs > self.patience:
            new_lr = max(self.lr * self.factor, self.min_lr)
            if self.lr - new_lr > self.eps:
                print("ReduceLROnPlateau: reducing lr to %.8e" % (new_lr,))
                self.lr = new_lr
            self.cooldown_counter = self.cooldown
            self.num_bad_epochs = 0
        return self.lr

    def state_dict(self) -> Dict:
        return asdict(self)

    def load_state_dict(self, state: Dict) -> None:
        for k, v in state.items():
            setattr(self, k, v)


@dataclass
class StepLR:
    """lr = base_lr * gamma^(last_epoch // step_size), stepped per batch."""

    base_lr: float
    step_size: int
    gamma: float = 0.5
    last_epoch: int = 0

    def step(self) -> float:
        self.last_epoch += 1
        return self.get_lr()

    def get_lr(self) -> float:
        return self.base_lr * (self.gamma ** (self.last_epoch // self.step_size))

    def state_dict(self) -> Dict:
        return asdict(self)

    def load_state_dict(self, state: Dict) -> None:
        for k, v in state.items():
            setattr(self, k, v)
