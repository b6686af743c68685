"""Config sections the train step reads.

The port's own copy of the fields of ``espresso_tpu/config.py`` that the
flagship train path reads, with the same names and defaults:
``CommonConfig.dtype``, ``OptimizationConfig`` (lr, clip, EMA),
``OptimizerConfig`` (adam), ``LRSchedulerConfig`` (fixed, noam) and
``CriterionSection`` (the transducer criterion's path). Other sections and
fields wait for the slices that read them: ``update_freq`` for the data
loader that groups microbatches (the train step takes the batch's leading
axis), ``criterion.name`` for a second criterion. The CLI's parsing of
``key.path=value`` overrides is not ported.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Tuple


@dataclass
class CommonConfig:
    # numeric precision of the compute path; params are kept fp32
    dtype: str = "bfloat16"  # float32 | bfloat16


@dataclass
class OptimizationConfig:
    lr: List[float] = field(default_factory=lambda: [0.001])
    clip_norm: float = 0.0
    # EMA of the fp32 params; 0 = off. Before ema_start_update updates the EMA
    # copies the params; it is touched every ema_update_freq-th update.
    ema_decay: float = 0.0
    ema_start_update: int = 0
    ema_update_freq: int = 1


@dataclass
class OptimizerConfig:
    name: str = "adam"
    adam_betas: Tuple[float, float] = (0.9, 0.999)
    adam_eps: float = 1e-8
    weight_decay: float = 0.0


@dataclass
class LRSchedulerConfig:
    name: str = "fixed"
    warmup_updates: int = 0
    warmup_init_lr: float = -1.0
    # noam
    model_size: int = 512
    final_lr: float = 0.0


@dataclass
class CriterionSection:
    # the lattice-free fused RNNT loss; only the fused path is ported
    fused_transducer: bool = True


@dataclass
class EspressoConfig:
    common: CommonConfig = field(default_factory=CommonConfig)
    optimization: OptimizationConfig = field(default_factory=OptimizationConfig)
    optimizer: OptimizerConfig = field(default_factory=OptimizerConfig)
    lr_scheduler: LRSchedulerConfig = field(default_factory=LRSchedulerConfig)
    criterion: CriterionSection = field(default_factory=CriterionSection)
