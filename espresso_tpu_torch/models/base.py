"""Model base types (counterpart of ``espresso_tpu/models/base.py``)."""

from __future__ import annotations

from dataclasses import dataclass

import torch


@dataclass
class EncoderOut:
    """Padded encoder output + validity info."""

    encoder_out: torch.Tensor  # [B, T, C]
    encoder_padding_mask: torch.Tensor  # [B, T] True = valid
    src_lengths: torch.Tensor  # [B]
