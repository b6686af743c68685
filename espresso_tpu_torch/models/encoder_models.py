"""Encoder-only models with an output layer (CTC).

Counterpart of ``espresso_tpu/models/encoder_models.py`` (:26-105):

* ``SpeechTransformerEncoderModel``, registered as
  ``speech_transformer_encoder_model``: the speech transformer's encoder
  (``models/speech_transformer.py``; its relative self-attention on B1 in
  eval, B2/B3 in training) and ``fc_out``, a Linear to the vocabulary;
* ``SpeechLSTMEncoderModel``, registered as ``speech_lstm_encoder_model``:
  the speech LSTM's encoder (``models/speech_lstm.py``) and ``fc_out``;
* the architecture ``transformer_ctc_librispeech`` (12 layers of 512, ffn
  2048, 8 heads).

``forward(src_frames, src_lengths, prev_output_tokens=None)`` returns
(logits [B, T', V], the encoder's output); ``prev_output_tokens`` is taken
and unused, as in JAX. JAX's flax trees (``encoder/...``, the Dense
``fc_out``) load with ``bridge.load_jax_variables``.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Optional, Tuple

import torch
from torch import nn

from espresso_tpu_torch.models.base import EncoderOut
from espresso_tpu_torch.models.speech_lstm import SpeechLSTMConfig, SpeechLSTMEncoder
from espresso_tpu_torch.models.speech_transformer import SpeechTransformerConfig, SpeechTransformerEncoder
from espresso_tpu_torch.registry import MODELS, register_architecture


class _EncoderModel(nn.Module):
    """An encoder and ``fc_out`` from its output width to the vocabulary."""

    def __init__(self, encoder: nn.Module, width: int, vocab_size: int):
        super().__init__()
        self.encoder = encoder
        self.fc_out = nn.Linear(width, vocab_size)

    def forward(
        self,
        src_frames: torch.Tensor,
        src_lengths: torch.Tensor,
        prev_output_tokens: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, EncoderOut]:
        enc = self.encoder(src_frames, src_lengths)
        return self.fc_out(enc.encoder_out), enc

    def encode(self, src_frames: torch.Tensor, src_lengths: torch.Tensor) -> EncoderOut:
        return self.encoder(src_frames, src_lengths)


@dataclass
class TransformerEncoderModelConfig:
    name: str = "speech_transformer_encoder_model"
    feat_dim: int = 80
    vocab_size: int = 0
    encoder: SpeechTransformerConfig = field(default_factory=SpeechTransformerConfig)
    pad_index: int = 1


@MODELS.register("speech_transformer_encoder_model", config=TransformerEncoderModelConfig)
class SpeechTransformerEncoderModel(_EncoderModel):
    def __init__(self, cfg: TransformerEncoderModelConfig):
        cfg.encoder.feat_dim = cfg.feat_dim  # as JAX's setup does
        super().__init__(SpeechTransformerEncoder(cfg.encoder), cfg.encoder.encoder_embed_dim,
                         cfg.vocab_size)
        self.cfg = cfg


@dataclass
class LSTMEncoderModelConfig:
    name: str = "speech_lstm_encoder_model"
    feat_dim: int = 80
    vocab_size: int = 0
    encoder: SpeechLSTMConfig = field(default_factory=SpeechLSTMConfig)
    pad_index: int = 1


@MODELS.register("speech_lstm_encoder_model", config=LSTMEncoderModelConfig)
class SpeechLSTMEncoderModel(_EncoderModel):
    def __init__(self, cfg: LSTMEncoderModelConfig):
        cfg.encoder.feat_dim = cfg.feat_dim
        encoder = SpeechLSTMEncoder(cfg.encoder)
        super().__init__(encoder, encoder.output_units(), cfg.vocab_size)
        self.cfg = cfg


@register_architecture("speech_transformer_encoder_model", "transformer_ctc_librispeech")
def _arch_ctc_librispeech(cfg: TransformerEncoderModelConfig) -> None:
    cfg.encoder.encoder_embed_dim = 512
    cfg.encoder.encoder_ffn_dim = 2048
    cfg.encoder.encoder_layers = 12
    cfg.encoder.encoder_heads = 8
