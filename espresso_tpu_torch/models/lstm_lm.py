"""LSTM language model (``lstm_lm_espresso``).

Counterpart of ``espresso_tpu/models/lstm_lm.py``: the speech LSTM decoder in
LM mode (no attention, encoder_output_units = 0; ``models/speech_lstm.py``),
its sequence forward and single-step decode, and the named architectures
lstm_lm_{wsj,librispeech,swbd} and lstm_wordlm_wsj (lstm_lm.py:92-121),
registered as ``lstm_lm_espresso`` and its presets in the port's registry
(``ARCHITECTURES`` here names the four presets). The JAX variables load with
``bridge.load_jax_variables``: the flax tree ``params/decoder/{embed_tokens,
cell{i}_ih, cell{i}_hh, additional_fc, fc_out}`` maps onto ``decoder``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Dict

import torch
from torch import nn

from espresso_tpu_torch.models.speech_lstm import Carry, DecoderStep, SpeechLSTMConfig
from espresso_tpu_torch.registry import ARCHITECTURES as PRESETS
from espresso_tpu_torch.registry import MODELS, register_architecture


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


@MODELS.register("lstm_lm_espresso", config=LSTMLMConfig)
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
        """Teacher-forced logits: [B, U] -> [B, U, V] (lstm_lm.py:70-81):
        the tokens embedded at once, the cell stack step by step, then the
        head once on the stacked outputs (the same products as an embedding
        and a head a step). In train mode every dropout draws from the
        generator ``set_dropout_generator`` set."""
        carry = self.init_carry(prev_output_tokens.shape[0])
        x = self.decoder.dropout(self.decoder.embed_tokens(prev_output_tokens))
        zero = torch.zeros_like(self.decoder.cells_ih[0].bias)
        outs = []
        for u in range(prev_output_tokens.shape[1]):
            carry, out = self.decoder.cells(carry, x[:, u], zero)
            outs.append(out)
        return self.decoder.head(torch.stack(outs, 1))

    def decode_step(self, tokens: torch.Tensor, carry: Carry):
        """One step: tokens [B] -> (logits [B, V], new carry) (lstm_lm.py:83-89)."""
        carry, logits = self.decoder(carry, tokens)
        return logits, carry


@register_architecture("lstm_lm_espresso", "lstm_lm_wsj")
def _arch_lm_wsj(cfg: LSTMLMConfig) -> None:
    pass  # defaults


@register_architecture("lstm_lm_espresso", "lstm_wordlm_wsj")
def _arch_wordlm_wsj(cfg: LSTMLMConfig) -> None:
    cfg.embed_dim = 1200
    cfg.hidden_size = 1200
    cfg.out_embed_dim = 1200
    cfg.num_layers = 3
    cfg.is_wordlm = True


@register_architecture("lstm_lm_espresso", "lstm_lm_librispeech")
def _arch_lm_librispeech(cfg: LSTMLMConfig) -> None:
    cfg.embed_dim = 800
    cfg.hidden_size = 800
    cfg.out_embed_dim = 800
    cfg.num_layers = 4
    cfg.dropout = 0.0


@register_architecture("lstm_lm_espresso", "lstm_lm_swbd")
def _arch_lm_swbd(cfg: LSTMLMConfig) -> None:
    cfg.embed_dim = 1800
    cfg.hidden_size = 1800
    cfg.out_embed_dim = 1800
    cfg.num_layers = 3
    cfg.dropout = 0.3


# the four presets of ``lstm_lm_espresso``: name -> the function that sets
# its fields on a config
ARCHITECTURES: Dict[str, Callable[[LSTMLMConfig], None]] = {
    name: fn for name, (model, fn) in PRESETS.items() if model == "lstm_lm_espresso"
}
