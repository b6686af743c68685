"""2D convolutional feature frontend (time subsampling).

Counterpart of ``espresso_tpu/modules/conv_frontend.py::ConvFrontend``:
stacked Conv2d -> BatchNorm -> ReLU over the (time, freq) plane. The JAX
module convolves NHWC over (T, F); here the layout is NCHW ``[B, C, T, F]``
and the output is flattened the same way, ``[B, T', C * F']`` with the
channel major. Only the batch norm (the flagship's) is ported.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn


class ConvFrontend(nn.Module):
    def __init__(
        self,
        out_channels: Sequence[int] = (64, 64, 128, 128),
        kernel_sizes: Sequence[Tuple[int, int]] = ((3, 3),) * 4,
        strides: Sequence[Tuple[int, int]] = ((1, 1), (2, 2), (1, 1), (2, 2)),
        norm_type: str = "batch",
    ):
        super().__init__()
        if norm_type != "batch":
            raise NotImplementedError(f"conv frontend norm {norm_type!r}")
        if any(k % 2 == 0 for ks in kernel_sizes for k in ks):
            # the JAX frontend pads even kernels asymmetrically
            raise NotImplementedError("even conv frontend kernels")
        self.kernel_sizes = tuple(tuple(k) for k in kernel_sizes)
        self.strides = tuple(tuple(s) for s in strides)
        chans = (1,) + tuple(out_channels)
        self.convs = nn.ModuleList(
            nn.Conv2d(
                chans[i],
                chans[i + 1],
                kernel_size=ks,
                stride=st,
                padding=((ks[0] - 1) // 2, (ks[1] - 1) // 2),
            )
            for i, (ks, st) in enumerate(zip(self.kernel_sizes, self.strides))
        )
        # flax BatchNorm's epsilon is 1e-5, the same as torch's
        self.norms = nn.ModuleList(nn.BatchNorm2d(c) for c in out_channels)

    def forward(
        self, x: torch.Tensor, lengths: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """x: [B, T, F] -> ([B, T', C_out * F'], [B] new lengths)."""
        h = x[:, None]  # [B, 1, T, F]
        for conv, norm in zip(self.convs, self.norms):
            h = F.relu(norm(conv(h)))
        B, C, T, Fo = h.shape
        out = h.permute(0, 2, 1, 3).reshape(B, T, C * Fo).to(x.dtype)
        return out, self.output_lengths(lengths)

    def output_lengths(self, lengths: torch.Tensor) -> torch.Tensor:
        out = lengths
        for ks, st in zip(self.kernel_sizes, self.strides):
            total_pad = (ks[0] - 1) // 2 + ks[0] // 2
            out = torch.div(out + total_pad - ks[0], st[0], rounding_mode="floor") + 1
        return out
