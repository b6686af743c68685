"""Learning-rate schedules.

Counterpart of ``espresso_tpu/train/lr_schedulers.py::build_lr_schedule``
for ``fixed`` (the flagship bench point) and ``noam`` (the recipe's,
``examples/asr_librispeech/conformer_transducer_librispeech.yaml:41-44``),
lr_schedulers.py:30-47. A schedule maps the count of applied updates (an
int or an integer tensor, on any device) to an f32 tensor on that device, so
the train step reads it without a host sync. The other schedulers wait for
later slices.
"""

from __future__ import annotations

from typing import Callable, Union

import torch

from espresso_tpu_torch.config import LRSchedulerConfig, OptimizationConfig

Step = Union[int, torch.Tensor]


def build_lr_schedule(
    cfg: LRSchedulerConfig, opt_cfg: OptimizationConfig
) -> Callable[[Step], torch.Tensor]:
    base_lr = opt_cfg.lr[0]
    w = max(cfg.warmup_updates, 1)

    if cfg.name == "fixed":
        init = cfg.warmup_init_lr if cfg.warmup_init_lr >= 0 else base_lr

        def sched(step: Step) -> torch.Tensor:
            step = torch.as_tensor(step)
            warm = init + (base_lr - init) * step / w
            return torch.where(step < cfg.warmup_updates, warm, base_lr).float()

    elif cfg.name == "noam":
        # factor * d^-0.5 * min(n^-0.5, n * w^-1.5), floored at final_lr
        factor = base_lr * cfg.model_size ** -0.5

        def sched(step: Step) -> torch.Tensor:
            n = torch.as_tensor(step).clamp(min=1).float()
            lr = factor * torch.minimum(n ** -0.5, n * w ** -1.5)
            return lr.clamp(min=cfg.final_lr)

    else:
        raise NotImplementedError(f"lr scheduler {cfg.name!r}")
    return sched
