"""The LSTM decoder step of the speech LSTM model, in LM mode.

Counterpart of ``espresso_tpu/models/speech_lstm.py`` (:36-192) as far as the
LSTM language model uses it (``models/lstm_lm.py``): the decoder with no
encoder and no attention (``attention_type="none"``, encoder_output_units =
0). One step embeds the token, runs the stacked LSTM cells (gate order i, f,
g, o; the input projection carries the one bias), adds each layer's input
to its output from the second layer on under ``decoder_residual``, projects
through ``additional_fc`` when the output width differs from
``decoder_out_embed_dim``, and scores the vocab through ``fc_out`` or the
shared input embedding (flax ``Embed.attend``: no bias).

The carry is ``(h, c)``, each [L, B, H]; the JAX carry's empty input feed
and previous-token leaves are not kept. Attention, an encoder and scheduled
sampling raise ``NotImplementedError``: they come with the attention
encoder-decoder.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from espresso_tpu_torch.modules.dropout import Dropout
from espresso_tpu_torch.modules.lstm import lstm_gates

Carry = Tuple[torch.Tensor, torch.Tensor]


@dataclass
class SpeechLSTMConfig:
    """The decoder fields of the JAX ``SpeechLSTMConfig`` (speech_lstm.py:36-62)."""

    vocab_size: int = 0
    decoder_embed_dim: int = 48
    decoder_hidden_size: int = 512
    decoder_out_embed_dim: int = 960
    decoder_layers: int = 3
    decoder_residual: bool = False
    attention_type: str = "bahdanau"  # bahdanau | luong | none
    share_decoder_input_output_embed: bool = False
    dropout: float = 0.3
    pad_index: int = 1


class DecoderStep(nn.Module):
    """One step of the LSTM decoder (JAX ``_DecoderStep``, speech_lstm.py
    :99-192) in LM mode. Submodules carry the flax names: ``embed_tokens``,
    ``cells_ih.{i}`` / ``cells_hh.{i}`` (flax ``cell{i}_ih`` / ``cell{i}_hh``),
    ``additional_fc``, ``fc_out``."""

    def __init__(self, cfg: SpeechLSTMConfig, encoder_output_units: int = 0):
        super().__init__()
        if encoder_output_units != 0 or cfg.attention_type != "none":
            raise NotImplementedError(
                "the LSTM decoder with an encoder or attention is not ported (it comes with "
                "the attention encoder-decoder, ROADMAP queue A)"
            )
        self.cfg = cfg
        E, H, L = cfg.decoder_embed_dim, cfg.decoder_hidden_size, cfg.decoder_layers
        self.embed_tokens = nn.Embedding(cfg.vocab_size, E)
        self.cells_ih = nn.ModuleList(nn.Linear(E if i == 0 else H, 4 * H) for i in range(L))
        self.cells_hh = nn.ModuleList(nn.Linear(H, 4 * H, bias=False) for _ in range(L))
        self.additional_fc: Optional[nn.Linear] = None
        if H != cfg.decoder_out_embed_dim:
            self.additional_fc = nn.Linear(H, cfg.decoder_out_embed_dim)
        self.fc_out: Optional[nn.Linear] = None
        if not cfg.share_decoder_input_output_embed:
            self.fc_out = nn.Linear(cfg.decoder_out_embed_dim, cfg.vocab_size)
        self.dropout = Dropout(cfg.dropout)

    def init_carry(self, batch_size: int, dtype=torch.float32, device=None) -> Carry:
        shape = (self.cfg.decoder_layers, batch_size, self.cfg.decoder_hidden_size)
        return (
            torch.zeros(shape, dtype=dtype, device=device),
            torch.zeros(shape, dtype=dtype, device=device),
        )

    def head(self, out: torch.Tensor) -> torch.Tensor:
        """The top layer's output [..., H] -> vocab logits: ``additional_fc``
        when present, then ``fc_out`` or the shared embedding."""
        if self.additional_fc is not None:
            out = self.additional_fc(out)
        if self.fc_out is not None:
            return self.fc_out(out)
        return F.linear(out, self.embed_tokens.weight)

    def forward(
        self, carry: Carry, token: torch.Tensor, ss_prob: float = 1.0
    ) -> Tuple[Carry, torch.Tensor]:
        """carry (h, c) [L, B, H], token [B] -> (new carry, logits [B, V]).
        Dropout on the embedding and after each layer in train mode."""
        if ss_prob < 1.0:
            raise NotImplementedError("scheduled sampling is not ported")
        h_prev, c_prev = carry
        x = self.dropout(self.embed_tokens(token))
        hs, cs = [], []
        for i, (ih, hh) in enumerate(zip(self.cells_ih, self.cells_hh)):
            hidden, cell = lstm_gates(ih(x) + hh(h_prev[i]), h_prev[i], c_prev[i])
            hs.append(hidden)
            cs.append(cell)
            prev = x[:, : hidden.shape[1]]
            x = self.dropout(hidden)
            if self.cfg.decoder_residual and i > 0:
                x = x + prev
        return (torch.stack(hs), torch.stack(cs)), self.head(x)
