"""Sequence masking utilities.

Counterpart of ``espresso_tpu/ops/masking.py``: the -1e8 attention fill and
the length mask the encoder uses. Chunk-streaming and limited-context masks
wait for a later slice.
"""

from __future__ import annotations

import torch

NEG_INF = -1.0e8  # reference -1e8 attention fill: fully masked rows stay finite


def sequence_mask(lengths: torch.Tensor, maxlen: int) -> torch.Tensor:
    """[B] lengths -> [B, maxlen] bool mask (True = valid)."""
    return torch.arange(maxlen, device=lengths.device)[None, :] < lengths[:, None]
