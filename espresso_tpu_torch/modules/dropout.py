"""Dropout with flax ``nn.Dropout`` semantics and an explicit generator.

``keep ~ Bernoulli(1 - rate)``; kept values are divided by ``1 - rate`` in
their own dtype, dropped ones are 0; identity in eval mode or at rate 0. The
draw comes from ``self.generator`` (a ``torch.Generator`` on the inputs'
device; ``None`` = the device's default generator), which
``set_dropout_generator`` sets on every dropout of a model. torch and JAX
draw different bits from one seed, so the tests compare the two at rate 0
and check the distribution otherwise.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn


class Dropout(nn.Module):
    def __init__(self, rate: float):
        super().__init__()
        self.rate = float(rate)
        self.generator: Optional[torch.Generator] = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training or self.rate <= 0.0:
            return x
        u = torch.rand(x.shape, device=x.device, generator=self.generator)
        return torch.where(u < 1.0 - self.rate, x / (1.0 - self.rate), torch.zeros_like(x))

    def extra_repr(self) -> str:
        return f"rate={self.rate}"


def set_dropout_generator(model: nn.Module, generator: Optional[torch.Generator]) -> None:
    """Make every :class:`Dropout` of ``model`` draw from ``generator``."""
    for m in model.modules():
        if isinstance(m, Dropout):
            m.generator = generator
