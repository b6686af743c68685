"""LSTM layers over padded sequences (counterpart of ``espresso_tpu/modules/lstm.py``).

* ``lstm_gates``: the (i, f, g, o) gate nonlinearity, which decode and the
  transducer's prediction net apply;
* ``reverse_padded``: each row reversed within its own length (JAX
  ``_reverse_padded``, :23-33), so the backward direction never reads a
  padded frame;
* ``LSTMLayer``: one direction of one layer over a padded sequence
  (:66-116);
* ``LSTM``: the stacked (bi)LSTM with dropout between layers and optional
  residual sums (:118-164), the speech LSTM's encoder.

The flax layer keeps one bias, on the input product, and its recurrent
kernel as a [H, 4H] parameter ``hh_kernel``; the port keeps that name in
torch's [4H, H] layout, which cuDNN takes (the bridge transposes it as it
does a Dense kernel). JAX scans the recurrence; here each direction of
each layer is one ``torch.lstm`` call (cuDNN on the card, ATen's loop on
the CPU) with the recurrent bias a zero vector. Past a row's length JAX freezes the state and
zeroes the output; the output is causal in time, so running the padded
sequence and zeroing the output past each length gives JAX's outputs at
every position. The final states, which no caller reads in either package,
are not returned.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch import nn

from espresso_tpu_torch.modules.dropout import Dropout
from espresso_tpu_torch.ops.masking import sequence_mask


def lstm_gates(
    pre: torch.Tensor, h: torch.Tensor, c: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the (i, f, g, o) gate nonlinearity to preactivations [..., 4H].
    ``h`` is unused (kept for the JAX signature)."""
    i, f, g, o = pre.chunk(4, dim=-1)
    c_new = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
    h_new = torch.sigmoid(o) * torch.tanh(c_new)
    return h_new, c_new


def reverse_padded(x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """Reverse each row of [B, T, ...] within its valid length; the
    positions past it stay where they are."""
    T = x.shape[1]
    t = torch.arange(T, device=x.device)[None, :]
    L = lengths.to(t.dtype)[:, None]
    idx = torch.where(t < L, L - 1 - t, t)
    idx = idx.reshape(idx.shape + (1,) * (x.ndim - 2)).expand_as(x)
    return torch.gather(x, 1, idx)


class LSTMLayer(nn.Module):
    """One direction of one layer: ``ih`` (the input product and the bias)
    and ``hh_kernel`` [4H, H]."""

    def __init__(self, input_size: int, hidden_size: int):
        super().__init__()
        self.hidden_size = hidden_size
        self.ih = nn.Linear(input_size, 4 * hidden_size)
        self.hh_kernel = nn.Parameter(torch.empty(4 * hidden_size, hidden_size))
        nn.init.normal_(self.hh_kernel, std=hidden_size ** -0.5)  # flax's lecun_normal scale

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """x [B, T, D] -> the hidden states [B, T, H] from a zero state, 0
        past each row's length."""
        h0 = x.new_zeros(1, x.shape[0], self.hidden_size)
        params = [self.ih.weight, self.hh_kernel, self.ih.bias, torch.zeros_like(self.ih.bias)]
        # train mode lets cuDNN keep what its backward needs
        out, _, _ = torch.lstm(x, (h0, h0), params, True, 1, 0.0, self.training, False, True)
        return out * sequence_mask(lengths, x.shape[1])[..., None].to(out.dtype)


class LSTM(nn.Module):
    """Multi-layer (bi)LSTM: layers ``fwd_{i}`` (and ``bwd_{i}``), their
    outputs concatenated, ``out + input`` from the second layer on where
    ``residual`` and the shapes agree, dropout between layers in train
    mode."""

    def __init__(
        self,
        input_size: int,
        hidden_size: int,
        num_layers: int = 1,
        bidirectional: bool = False,
        dropout: float = 0.0,
        residual: bool = False,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.bidirectional = bidirectional
        self.residual = residual
        out = hidden_size * (2 if bidirectional else 1)
        for i in range(num_layers):
            d = input_size if i == 0 else out
            self.add_module(f"fwd_{i}", LSTMLayer(d, hidden_size))
            if bidirectional:
                self.add_module(f"bwd_{i}", LSTMLayer(d, hidden_size))
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        """x [B, T, D] -> [B, T, H or 2H], 0 past each row's length."""
        h = x
        for i in range(self.num_layers):
            out = getattr(self, f"fwd_{i}")(h, lengths)
            if self.bidirectional:
                bwd = getattr(self, f"bwd_{i}")(reverse_padded(h, lengths), lengths)
                bwd = reverse_padded(bwd, lengths)
                out = torch.cat([out, bwd], dim=-1)
            if self.residual and i > 0 and out.shape == h.shape:
                out = out + h
            if i < self.num_layers - 1:
                out = self.dropout(out)
            h = out
        return h
