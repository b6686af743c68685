"""LSTM language model (``lstm_lm_espresso``).

Counterpart of ``espresso_tpu/models/lstm_lm.py``: the speech LSTM decoder in
LM mode (no attention, encoder_output_units = 0; ``models/speech_lstm.py``),
its sequence forward and single-step decode, and the named architectures
lstm_lm_{wsj,librispeech,swbd} and lstm_wordlm_wsj (lstm_lm.py:92-121), in
``ARCHITECTURES`` (the port has no registry). The JAX variables load with
``bridge.load_jax_variables``: the flax tree ``params/decoder/{embed_tokens,
cell{i}_ih, cell{i}_hh, additional_fc, fc_out}`` maps onto ``decoder``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch
from torch import nn

from espresso_tpu_torch.models.speech_lstm import Carry, DecoderStep, SpeechLSTMConfig


@dataclass
class LSTMLMConfig:
    name: str = "lstm_lm_espresso"
    vocab_size: int = 0
    embed_dim: int = 48
    hidden_size: int = 650
    out_embed_dim: int = 650
    num_layers: int = 2
    dropout: float = 0.35
    share_embed: bool = False
    is_wordlm: bool = False
    pad_index: int = 1


def _to_decoder_cfg(cfg: LSTMLMConfig) -> SpeechLSTMConfig:
    return SpeechLSTMConfig(
        vocab_size=cfg.vocab_size,
        decoder_embed_dim=cfg.embed_dim,
        decoder_hidden_size=cfg.hidden_size,
        decoder_out_embed_dim=cfg.out_embed_dim,
        decoder_layers=cfg.num_layers,
        attention_type="none",
        dropout=cfg.dropout,
        share_decoder_input_output_embed=cfg.share_embed,
        pad_index=cfg.pad_index,
    )


class LSTMLanguageModel(nn.Module):
    def __init__(self, cfg: LSTMLMConfig):
        super().__init__()
        self.cfg = cfg
        self.decoder = DecoderStep(_to_decoder_cfg(cfg))

    def init_carry(self, batch_size: int, dtype=None, device=None) -> Carry:
        """Zero (h, c), each [L, B, H], in the parameters' dtype and device
        unless given."""
        p = self.decoder.embed_tokens.weight
        return self.decoder.init_carry(batch_size, dtype or p.dtype, device or p.device)

    def forward(self, prev_output_tokens: torch.Tensor) -> torch.Tensor:
        """Teacher-forced logits: [B, U] -> [B, U, V] (lstm_lm.py:70-81)."""
        carry = self.init_carry(prev_output_tokens.shape[0])
        logits = []
        for u in range(prev_output_tokens.shape[1]):
            carry, lg = self.decoder(carry, prev_output_tokens[:, u])
            logits.append(lg)
        return torch.stack(logits, 1)

    def decode_step(self, tokens: torch.Tensor, carry: Carry):
        """One step: tokens [B] -> (logits [B, V], new carry) (lstm_lm.py:83-89)."""
        carry, logits = self.decoder(carry, tokens)
        return logits, carry


def _arch_lm_wsj(cfg: LSTMLMConfig) -> None:
    pass  # defaults


def _arch_wordlm_wsj(cfg: LSTMLMConfig) -> None:
    cfg.embed_dim = 1200
    cfg.hidden_size = 1200
    cfg.out_embed_dim = 1200
    cfg.num_layers = 3
    cfg.is_wordlm = True


def _arch_lm_librispeech(cfg: LSTMLMConfig) -> None:
    cfg.embed_dim = 800
    cfg.hidden_size = 800
    cfg.out_embed_dim = 800
    cfg.num_layers = 4
    cfg.dropout = 0.0


def _arch_lm_swbd(cfg: LSTMLMConfig) -> None:
    cfg.embed_dim = 1800
    cfg.hidden_size = 1800
    cfg.out_embed_dim = 1800
    cfg.num_layers = 3
    cfg.dropout = 0.3


# architecture name -> the function that sets its fields on a config
ARCHITECTURES: Dict[str, Callable[[LSTMLMConfig], None]] = {
    "lstm_lm_wsj": _arch_lm_wsj,
    "lstm_wordlm_wsj": _arch_wordlm_wsj,
    "lstm_lm_librispeech": _arch_lm_librispeech,
    "lstm_lm_swbd": _arch_lm_swbd,
}
