"""Learning-rate schedules.

Counterpart of ``espresso_tpu/train/lr_schedulers.py``, every name of its
``build_lr_schedule``: espresso's ``noam`` (factor · d^-0.5 · min(n^-0.5,
n·w^-1.5) with a final_lr floor), fairseq's ``fixed``, ``inverse_sqrt``,
``tri_stage``, ``cosine``, ``polynomial``, ``triangular``, ``step`` and
``pass_through``, and the epoch-driven ``reduce_lr_on_plateau``,
``reduce_lr_on_plateau_v2`` and ``manual``, whose lr the train loop moves
between epochs through ``ManualScheduler`` and ``PlateauScheduler``.

A schedule maps the count of applied updates (an int or an integer tensor,
on any device) to an f32 tensor on that device, so the train step reads it
without a host sync. The epoch-driven names return an ``EpochLR``: its lr
is a host number that ``set_lr`` changes between epochs, filled on the
step's device at each update, so that a new lr reaches the next update
without rebuilding the optimizer or resetting its state.
"""

from __future__ import annotations

import math
from typing import Callable, Optional, Union

import torch

from espresso_tpu_torch.config import LRSchedulerConfig, OptimizationConfig

Step = Union[int, torch.Tensor]

EPOCH_DRIVEN = ("reduce_lr_on_plateau", "reduce_lr_on_plateau_v2", "manual")


class EpochLR:
    """The schedule of an epoch-driven name: the lr the train loop set."""

    def __init__(self, lr: float):
        self.lr = float(lr)

    def set_lr(self, lr: float) -> None:
        self.lr = float(lr)

    def __call__(self, step: Step) -> torch.Tensor:
        return torch.full((), self.lr, dtype=torch.float32, device=torch.as_tensor(step).device)


def build_lr_schedule(
    cfg: LRSchedulerConfig, opt_cfg: OptimizationConfig
) -> Callable[[Step], torch.Tensor]:
    base_lr = opt_cfg.lr[0]
    name = cfg.name
    f32 = lambda step: torch.as_tensor(step).float()

    if name == "fixed":
        w = max(cfg.warmup_updates, 1)
        init = cfg.warmup_init_lr if cfg.warmup_init_lr >= 0 else base_lr

        def sched(step: Step) -> torch.Tensor:
            step = torch.as_tensor(step)
            warm = init + (base_lr - init) * step / w
            return torch.where(step < cfg.warmup_updates, warm, base_lr).float()

    elif name == "noam":
        w = max(cfg.warmup_updates, 1)
        factor = base_lr * cfg.model_size ** -0.5

        def sched(step: Step) -> torch.Tensor:
            n = torch.as_tensor(step).clamp(min=1).float()
            lr = factor * torch.minimum(n ** -0.5, n * w ** -1.5)
            return lr.clamp(min=cfg.final_lr)

    elif name == "inverse_sqrt":
        w = max(cfg.warmup_updates, 1)
        init = cfg.warmup_init_lr if cfg.warmup_init_lr >= 0 else 0.0

        def sched(step: Step) -> torch.Tensor:
            step = torch.as_tensor(step)
            stepf = step.clamp(min=1).float()
            warm = init + (base_lr - init) * stepf / w
            decay = base_lr * (w ** 0.5) * stepf ** -0.5
            return torch.where(step < w, warm, decay)

    elif name == "tri_stage":
        # warmup -> hold -> exponential decay -> final floor
        if cfg.phase_ratio is not None and cfg.total_num_update > 0:
            warmup, hold, decay = (int(cfg.total_num_update * r) for r in cfg.phase_ratio[:3])
        else:
            warmup, hold, decay = cfg.warmup_updates, cfg.hold_steps, cfg.decay_steps
        init_lr = cfg.init_lr_scale * base_lr
        final_lr = cfg.final_lr_scale * base_lr
        factor = -math.log(cfg.final_lr_scale) / max(decay, 1)

        def sched(step: Step) -> torch.Tensor:
            stepf = f32(step)
            warm = init_lr + (base_lr - init_lr) * stepf / max(warmup, 1)
            step3 = stepf - warmup - hold
            decayed = base_lr * torch.exp(-factor * step3.clamp(min=0.0))
            final = torch.where(step3 <= decay, decayed, final_lr)
            return torch.where(stepf < warmup, warm, torch.where(stepf < warmup + hold, base_lr, final))

    elif name == "cosine":
        w = cfg.warmup_updates
        init = cfg.warmup_init_lr if cfg.warmup_init_lr >= 0 else 0.0
        total = max(cfg.total_num_update - w, 1)
        min_lr = cfg.final_lr

        def sched(step: Step) -> torch.Tensor:
            stepf = f32(step)
            warm = init + (base_lr - init) * stepf / max(w, 1)
            t = torch.clamp(stepf - w, max=total)
            cos_lr = min_lr + 0.5 * (base_lr - min_lr) * (1 + torch.cos(math.pi * t / total))
            return torch.where((w > 0) & (stepf < w), warm, cos_lr)

    elif name == "polynomial":
        w = cfg.warmup_updates
        total = max(cfg.total_num_update, 1)
        span = max(total - w, 1)

        def sched(step: Step) -> torch.Tensor:
            stepf = f32(step)
            warm = base_lr * stepf / max(w, 1)
            remaining = torch.clamp(1 - (stepf - w) / span, 0.0, 1.0)
            poly = (base_lr - cfg.final_lr) * remaining ** cfg.power + cfg.final_lr
            lr = torch.where((w > 0) & (stepf < w), warm, poly)
            return torch.where(stepf >= total, cfg.final_lr, lr)

    elif name == "triangular":
        # cyclical between base_lr and max_lr with period lr_period_updates;
        # max shrinks by lr_shrink each full cycle
        assert cfg.max_lr > base_lr and cfg.lr_period_updates > 0
        period = float(cfg.lr_period_updates)

        def sched(step: Step) -> torch.Tensor:
            stepf = f32(step)
            cycle = torch.floor(stepf / (2 * period))
            max_lr = cfg.max_lr * cfg.lr_shrink ** cycle
            x = torch.abs(stepf / period - 2 * cycle - 1)
            return base_lr + (max_lr - base_lr) * torch.clamp(1 - x, min=0.0)

    elif name == "step":
        # staircase decay: lr * lr_shrink^(elapsed / decay_steps) after warmup
        w = cfg.warmup_updates
        init = cfg.warmup_init_lr if cfg.warmup_init_lr >= 0 else 0.0

        def sched(step: Step) -> torch.Tensor:
            stepf = f32(step)
            warm = init + (base_lr - init) * stepf / max(w, 1)
            n_dec = torch.floor((stepf - w).clamp(min=0.0) / max(cfg.decay_steps, 1))
            decay = base_lr * cfg.lr_shrink ** n_dec
            return torch.where((w > 0) & (stepf < w), warm, decay)

    elif name == "pass_through":
        # the reference delegates to the optimizer's own schedule; the
        # optimizers here are schedule-driven, so this is a constant lr
        def sched(step: Step) -> torch.Tensor:
            return torch.full((), base_lr, dtype=torch.float32, device=torch.as_tensor(step).device)

    elif name in EPOCH_DRIVEN:
        return EpochLR(base_lr)

    else:
        raise ValueError(f"unknown lr scheduler {name!r}")
    return sched


class ManualScheduler:
    """Per-epoch lr table (fairseq manual_lr_scheduler's epoch2lr): entry
    ``manual_lr[epoch-1]`` applies to that epoch; the last entry persists."""

    def __init__(self, cfg: LRSchedulerConfig, opt_cfg: OptimizationConfig):
        self.table = list(cfg.manual_lr or list(opt_cfg.lr))
        self.lr = self.table[0]

    def step_epoch(self, epoch: int, val_metric: Optional[float]) -> float:
        """Called at the end of ``epoch``: the lr for epoch + 1."""
        self.lr = float(self.table[min(max(epoch, 0), len(self.table) - 1)])
        return self.lr

    def state_dict(self):
        return {"lr": self.lr}

    def load_state_dict(self, d):
        self.lr = d["lr"]


class PlateauScheduler:
    """reduce_lr_on_plateau_v2 (espresso/optim/lr_scheduler/
    reduce_lr_on_plateau_v2.py): shrink the lr by ``lr_shrink`` when the
    valid metric stops improving, but never before ``start_reduce_lr_epoch``."""

    def __init__(self, cfg: LRSchedulerConfig, opt_cfg: OptimizationConfig):
        self.cfg = cfg
        self.lr = opt_cfg.lr[0]
        self.best: Optional[float] = None
        self.num_bad_epochs = 0
        self.patience = 0  # the reference's default patience for v2

    def step_epoch(self, epoch: int, val_metric: Optional[float]) -> float:
        if val_metric is None:
            return self.lr
        if epoch < self.cfg.start_reduce_lr_epoch:
            self.best = None  # the reference resets comparisons before the start
            return self.lr
        if self.best is None or val_metric < self.best - self.cfg.lr_threshold:
            self.best = val_metric
            self.num_bad_epochs = 0
        else:
            self.num_bad_epochs += 1
            if self.num_bad_epochs > self.patience:
                self.lr *= self.cfg.lr_shrink
                self.num_bad_epochs = 0
        return self.lr

    def state_dict(self):
        return {"lr": self.lr, "best": self.best, "num_bad_epochs": self.num_bad_epochs}

    def load_state_dict(self, d):
        self.lr = d["lr"]
        self.best = d["best"]
        self.num_bad_epochs = d["num_bad_epochs"]


def build_epoch_scheduler(cfg: LRSchedulerConfig, opt_cfg: OptimizationConfig):
    """The epoch scheduler of an epoch-driven name, else None."""
    if cfg.name.startswith("reduce_lr_on_plateau"):
        return PlateauScheduler(cfg, opt_cfg)
    if cfg.name == "manual":
        return ManualScheduler(cfg, opt_cfg)
    return None
