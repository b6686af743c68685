"""Model base types (counterpart of ``espresso_tpu/models/base.py``)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch


@dataclass
class EncoderOut:
    """Padded encoder output + validity info."""

    encoder_out: torch.Tensor  # [B, T, C]
    encoder_padding_mask: torch.Tensor  # [B, T] True = valid
    src_lengths: torch.Tensor  # [B]
    # the attention's key projection of encoder_out, computed once per
    # utterance (models/speech_lstm.py); None for the other models
    attention_keys: Optional[torch.Tensor] = None  # [B, T, A]
