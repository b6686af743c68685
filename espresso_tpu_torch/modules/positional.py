"""Sinusoidal positional tables, absolute and relative.

Counterpart of ``espresso_tpu/modules/positional.py``:
``sinusoidal_positions`` (the fairseq table: sin and cos halves) and
``relative_sinusoidal_positions`` / ``RelativePositionalEmbedding`` (the
espnet RelPositionalEncoding layout, interleaved columns). Both are built
in float64. The learned table and rotary positions wait for a later slice.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch import nn


def sinusoidal_positions(length: int, dim: int, offset: int = 0) -> np.ndarray:
    """[length, dim] float64 table of positions offset .. offset+length-1
    (fairseq: sin on the first half, cos on the second, freq_k =
    10000^(-k / (half - 1)); an odd dim gets a zero last column)."""
    half = dim // 2
    emb_scale = math.log(10000.0) / (half - 1) if half > 1 else 1.0
    inv_freq = np.exp(np.arange(half, dtype=np.float64) * -emb_scale)
    pos = np.arange(offset, offset + length, dtype=np.float64)[:, None]
    args = pos * inv_freq[None, :]
    table = np.concatenate([np.sin(args), np.cos(args)], axis=1)
    if dim % 2 == 1:
        table = np.concatenate([table, np.zeros((length, 1))], axis=1)
    return table


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


class SinusoidalPositions(nn.Module):
    """The fairseq table's first ``rows`` rows as a float32 buffer
    (non-persistent, like the relative table); ``forward(length)`` returns
    its first ``length`` rows, growing the table from the host past them."""

    def __init__(self, embed_dim: int, rows: int):
        super().__init__()
        self.embed_dim = embed_dim
        table = sinusoidal_positions(rows, embed_dim)
        self.register_buffer("table", torch.from_numpy(table.astype(np.float32)), persistent=False)

    def forward(self, length: int) -> torch.Tensor:
        if length > self.table.shape[0]:
            table = sinusoidal_positions(length, self.embed_dim).astype(np.float32)
            self.table = torch.from_numpy(table).to(self.table.device, self.table.dtype)
        return self.table[:length]
