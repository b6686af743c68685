"""Relative sinusoidal positional table.

Counterpart of ``espresso_tpu/modules/positional.py``
(``relative_sinusoidal_positions`` and ``RelativePositionalEmbedding``,
espnet RelPositionalEncoding layout). Only the sinusoidal table is ported;
the learned table waits for a later slice.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def relative_sinusoidal_positions(length: int, dim: int) -> np.ndarray:
    """[2*length-1, dim] float64 table for offsets length-1 .. -(length-1)
    (freq_k = 10000^(-2k/dim), sin on even columns, cos on odd)."""
    half = dim // 2
    emb_scale = math.log(10000.0) / half if half > 0 else 1.0
    inv_freq = np.exp(np.arange(half, dtype=np.float64) * -emb_scale)
    pos = np.arange(length - 1, -length, -1, dtype=np.float64)[:, None]
    args = pos * inv_freq[None, :]
    table = np.zeros((2 * length - 1, dim))
    table[:, 0::2] = np.sin(args)
    table[:, 1::2] = np.cos(args)
    return table


class RelativePositionalEmbedding(nn.Module):
    """Sinusoidal relative position table; ``forward(length)`` returns the
    central [2*min(length, max_size)-1, D] window in float32."""

    def __init__(self, embed_dim: int, max_size: int):
        super().__init__()
        self.embed_dim = embed_dim
        self.max_size = max_size
        # built once in float64 like the reference, kept as a float32 buffer
        # (non-persistent: it is a function of the config, not a weight)
        table = relative_sinusoidal_positions(max_size, embed_dim)
        self.register_buffer(
            "table", torch.from_numpy(table.astype(np.float32)), persistent=False
        )

    def forward(self, length: int) -> torch.Tensor:
        L = min(length, self.max_size)
        center = self.max_size - 1
        return self.table[center - (L - 1) : center + L]
