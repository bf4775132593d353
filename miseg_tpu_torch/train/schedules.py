"""Learning-rate schedules, stepped per epoch on the host (counterpart of
`miseg_tpu/train/schedules.py`):
  * `warmup_cosine`: linear warm-up for `warmup_epochs`, then a cosine
    over the rest with `cycles` (MONAI `WarmupCosineSchedule`);
  * `cosine`: `CosineAnnealingLR(t_max)`;
  * `reduce_on_plateau`: factor 0.1 after `patience_scheduler` epochs
    without a better `val/loss/avg`;
  * `none`: the configured lr.
The engine writes the value into the optimizer's param groups
(`train.optim.set_learning_rate`).
"""

from __future__ import annotations

import math


def warmup_cosine(epoch: int, *, lr: float, warmup_epochs: int, t_total: int,
                  cycles: float = 0.5) -> float:
    if warmup_epochs and epoch < warmup_epochs:
        return lr * float(epoch) / float(max(1, warmup_epochs))
    progress = float(epoch - warmup_epochs) / float(max(1, t_total - warmup_epochs))
    return lr * max(0.0, 0.5 * (1.0 + math.cos(math.pi * cycles * 2.0 * progress)))


def cosine_annealing(epoch: int, *, lr: float, t_max: int, eta_min: float = 0.0) -> float:
    return eta_min + (lr - eta_min) * (1 + math.cos(math.pi * epoch / t_max)) / 2


class PlateauScheduler:
    """ReduceLROnPlateau (torch defaults: factor=0.1, mode=min)."""

    def __init__(self, lr: float, patience: int = 3, factor: float = 0.1,
                 mode: str = "min", min_lr: float = 0.0, threshold: float = 1e-4):
        self.lr = lr
        self.patience = patience
        self.factor = factor
        self.mode = mode
        self.min_lr = min_lr
        self.threshold = threshold
        self.best: float | None = None
        self.num_bad = 0

    def step(self, metric: float) -> float:
        better = (self.best is None or
                  (self.mode == "min" and metric < self.best * (1 - self.threshold)) or
                  (self.mode == "max" and metric > self.best * (1 + self.threshold)))
        if better:
            self.best = metric
            self.num_bad = 0
        else:
            self.num_bad += 1
            if self.num_bad > self.patience:
                self.lr = max(self.lr * self.factor, self.min_lr)
                self.num_bad = 0
        return self.lr

    def state_dict(self) -> dict:
        return {"lr": self.lr, "best": self.best, "num_bad": self.num_bad}

    def load_state_dict(self, d: dict) -> None:
        self.lr, self.best, self.num_bad = d["lr"], d["best"], d["num_bad"]


def scheduler_from_config(cfg):
    """`cfg` -> a callable `(epoch, plateau_metric=None) -> lr`; the
    plateau schedule carries its state as the callable's `plateau`."""
    name = cfg.scheduler
    if name == "warmup_cosine":
        return lambda epoch, metric=None: warmup_cosine(
            epoch, lr=cfg.lr, warmup_epochs=cfg.warmup_epochs,
            t_total=cfg.max_epochs, cycles=cfg.cycles)
    if name == "cosine":
        return lambda epoch, metric=None: cosine_annealing(
            epoch, lr=cfg.lr, t_max=cfg.t_max)
    if name == "reduce_on_plateau":
        plateau = PlateauScheduler(cfg.lr, patience=cfg.patience_scheduler)

        def sched(epoch, metric=None):
            return plateau.step(metric) if metric is not None else plateau.lr

        sched.plateau = plateau
        return sched
    if name in ("none", None):
        return lambda epoch, metric=None: cfg.lr
    raise ValueError(f"Scheduler {name} not implemented, please chose another scheduler.")
