"""Batch norm with flax ``nn.BatchNorm``'s train-mode semantics.

torch's ``BatchNorm`` differs from flax's in train mode: it keeps 0.9 of the
old running statistic (flax 0.99) and updates the running variance with the
*unbiased* batch variance (flax the biased one). This class normalises with
the biased batch variance, computed as flax computes it (``mean(x^2) -
mean(x)^2`` in f32, clipped at 0), and updates the running statistics as
``0.99 * old + 0.01 * batch`` (torch ``momentum=0.01``) from that biased
variance; epsilon 1e-5 as in both. Eval mode normalises with the running
statistics: torch's own where the input, the weights and the statistics
share a dtype (a model cast whole, as the decoders run it); otherwise (the
train state's bf16 compute weights beside its f32 statistics, as the valid
step runs them) as flax does, in f32. Channels are axis 1 (torch's layout).

In train mode, and in eval mode with mixed dtypes, the output is normalised
in f32 (flax promotes to its f32 statistics) and cast back to the input's
dtype, where the JAX modules re-anchor it (conformer.py:69,
conv_frontend.py:51).
"""

from __future__ import annotations

import torch
from torch import nn

FLAX_MOMENTUM = 0.01  # torch convention: the weight of the new batch statistic
EPS = 1e-5


class BatchNorm(nn.modules.batchnorm._BatchNorm):
    def __init__(self, num_features: int):
        super().__init__(num_features, eps=EPS, momentum=FLAX_MOMENTUM)

    def _check_input_dim(self, x: torch.Tensor) -> None:
        if x.dim() < 2:
            raise ValueError(f"BatchNorm: expected at least 2 dims, got {x.dim()}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        shape = [1, -1] + [1] * (x.dim() - 2)
        xf = x.float()
        if not self.training:
            if x.dtype == self.weight.dtype == self.running_mean.dtype:
                return super().forward(x)
            mean, var = self.running_mean.float(), self.running_var.float()
        else:
            dims = [0] + list(range(2, x.dim()))
            mean = xf.mean(dims)
            var = ((xf * xf).mean(dims) - mean * mean).clamp(min=0.0)
            with torch.no_grad():
                m = self.momentum
                self.running_mean.mul_(1.0 - m).add_(m * mean.to(self.running_mean.dtype))
                self.running_var.mul_(1.0 - m).add_(m * var.to(self.running_var.dtype))
        mul = torch.rsqrt(var + self.eps) * self.weight.float()
        y = (xf - mean.view(shape)) * mul.view(shape) + self.bias.float().view(shape)
        return y.to(x.dtype)
