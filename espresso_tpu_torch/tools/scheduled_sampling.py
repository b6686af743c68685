"""Scheduled sampling rate scheduler.

Counterpart of ``espresso_tpu/tools/scheduled_sampling.py`` (:14-33): maps
an epoch to the probability of feeding the teacher token (1.0 = pure
teacher forcing). ``probs`` is one value or a decreasing schedule that
advances one entry an epoch from ``start_epoch`` on. The train CLI asks it
for each epoch's rate (``task.scheduled_sampling``) and the train step
hands the rate to the speech LSTM's decoder.
"""

from __future__ import annotations

from typing import Sequence


class ScheduledSamplingRateScheduler:
    def __init__(
        self,
        scheduled_sampling_probs: Sequence[float] = (1.0,),
        start_scheduled_sampling_epoch: int = 1,
    ):
        self.probs = list(scheduled_sampling_probs)
        self.start_epoch = start_scheduled_sampling_epoch

    def step(self, epoch: int) -> float:
        if (len(self.probs) > 1 or self.probs[0] < 1.0) and epoch >= self.start_epoch:
            return self.probs[min(epoch - self.start_epoch, len(self.probs) - 1)]
        return 1.0
