"""LSTM gate nonlinearity (counterpart of ``espresso_tpu/modules/lstm.py``).

The full sequence LSTM layers wait for the train slice; decode needs only the
single-step gates.
"""

from __future__ import annotations

from typing import Tuple

import torch


def lstm_gates(
    pre: torch.Tensor, h: torch.Tensor, c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the (i, f, g, o) gate nonlinearity to preactivations [..., 4H].
    ``h`` is unused (kept for the JAX signature)."""
    i, f, g, o = pre.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new
