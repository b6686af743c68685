"""Metrics aggregation and progress logging.

The port's own copy of ``espresso_tpu/train/metrics.py``: sum/average meters
with derived metrics (ppl), interval logging in the simple or json format,
and optional tensorboard (``torch.utils.tensorboard``), wandb and aim sinks,
each skipped with a warning when its package is absent. Aggregation is on
the host over the summed scalars the train loop flushes from the device
once a log interval.
"""

from __future__ import annotations

import json
import logging
import math
import time
from collections import defaultdict
from typing import Any, Dict, Optional

logger = logging.getLogger(__name__)


def get_perplexity(nll_per_token: float) -> float:
    try:
        return min(math.exp(nll_per_token), float("inf"))
    except OverflowError:
        return float("inf")


class MetricsAggregator:
    """Accumulates summed logging outputs; derives averages at report time."""

    def __init__(self):
        self.sums: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self._start = time.perf_counter()
        self._n_updates = 0

    def update(self, logging_output: Dict[str, Any]) -> None:
        for k, v in logging_output.items():
            self.sums[k] += float(v)
            self.counts[k] += 1
        self._n_updates += 1

    def update_sums(self, sums: Dict[str, Any], n_steps: int) -> None:
        """Fold in metrics pre-summed over n_steps updates (device-side
        accumulation: one host transfer per log interval, not per step)."""
        for k, v in sums.items():
            self.sums[k] += float(v)
            self.counts[k] += n_steps
        self._n_updates += n_steps

    def reset(self) -> None:
        self.sums.clear()
        self.counts.clear()
        self._start = time.perf_counter()
        self._n_updates = 0

    def smoothed(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        size = max(self.sums.get("sample_size", 0.0), 1.0)
        if "loss" in self.sums:
            out["loss"] = self.sums["loss"] / size
        if "nll_loss" in self.sums:
            ntok = max(self.sums.get("ntokens", size), 1.0)
            out["nll_loss"] = self.sums["nll_loss"] / ntok
            out["ppl"] = get_perplexity(out["nll_loss"])
        if "gnorm" in self.sums:
            out["gnorm"] = self.sums["gnorm"] / max(self._n_updates, 1)
        if "overflow" in self.sums:
            out["overflow"] = self.sums["overflow"]
        if "wer" in self.sums and self.sums.get("word_count", 0) > 0:
            out["wer"] = 100.0 * self.sums["wer"] / self.sums["word_count"]
        if "cer" in self.sums and self.sums.get("char_count", 0) > 0:
            out["cer"] = 100.0 * self.sums["cer"] / self.sums["char_count"]
        elapsed = max(time.perf_counter() - self._start, 1e-6)
        out["ups"] = self._n_updates / elapsed
        if "ntokens" in self.sums:
            out["wps"] = self.sums["ntokens"] / elapsed
        return out


class ProgressLogger:
    """Interval logging in simple/json formats with optional tensorboard
    (reference progress_bar.py)."""

    def __init__(
        self,
        log_interval: int = 100,
        log_format: str = "simple",
        tensorboard_logdir: Optional[str] = None,
        tag: str = "train",
        wandb_project: Optional[str] = None,
        aim_repo: Optional[str] = None,
    ):
        self.log_interval = log_interval
        self.log_format = log_format
        self.tag = tag
        self._tb = None
        if tensorboard_logdir:
            try:
                from torch.utils.tensorboard import SummaryWriter

                self._tb = SummaryWriter(tensorboard_logdir)
            except Exception:
                logger.warning("tensorboard unavailable; skipping sink")
        # optional experiment trackers (reference progress_bar.py
        # WandBProgressBarWrapper / AimProgressBarWrapper) — gated on the
        # packages being installed; silently skipped otherwise
        self._wandb = None
        if wandb_project:
            try:
                import wandb

                if wandb.run is None:
                    wandb.init(project=wandb_project, reinit=False)
                self._wandb = wandb
            except ImportError:
                logger.warning("wandb not available; skipping sink")
        self._aim = None
        if aim_repo:
            try:
                from aim import Run as AimRun

                self._aim = AimRun(repo=aim_repo)
            except ImportError:
                logger.warning("aim not available; skipping sink")

    def log(self, stats: Dict[str, float], step: int, epoch: int) -> None:
        if self.log_format == "json":
            payload = {"epoch": epoch, "update": step}
            payload.update({k: round(v, 4) for k, v in stats.items()})
            logger.info(json.dumps(payload))
        else:
            parts = [f"epoch {epoch:03d}", f"updates {step}"]
            parts += [f"{k} {v:.4g}" for k, v in stats.items()]
            logger.info(" | ".join([self.tag] + parts))
        if self._tb is not None:
            for k, v in stats.items():
                self._tb.add_scalar(f"{self.tag}/{k}", v, step)
        if self._wandb is not None:
            self._wandb.log(
                {f"{self.tag}/{k}": v for k, v in stats.items()}, step=step
            )
        if self._aim is not None:
            for k, v in stats.items():
                self._aim.track(
                    v, name=k, step=step, epoch=epoch, context={"tag": self.tag}
                )

    def print_epoch(self, stats: Dict[str, float], epoch: int) -> None:
        parts = [f"end of epoch {epoch:03d}"]
        parts += [f"{k} {v:.4g}" for k, v in stats.items()]
        logger.info(" | ".join([self.tag] + parts))
