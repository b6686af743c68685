"""Attention-based LSTM encoder-decoder ASR model (``speech_lstm``).

Counterpart of ``espresso_tpu/models/speech_lstm.py``:

* ``SpeechLSTMConfig`` (:36-61), whole;
* ``SpeechLSTMEncoder`` (:63-97): the conv frontend with batch norm,
  dropout, then the stacked (bi)LSTM (``modules/lstm.py``);
* ``DecoderStep`` (JAX ``_DecoderStep``, :99-192): one output step of the
  stacked LSTM cells. With an encoder: input feeding (the previous step's
  context beside the embedded token), attention (``modules/
  speech_attention.py``) on layer 0's hidden state, ``[hidden, context]``
  into the next layer, the residual sum from the second layer on over the
  hidden half only, ``additional_fc`` when ``H + C`` differs from
  ``decoder_out_embed_dim``, and scheduled sampling (the teacher token
  where the coin falls under ``ss_prob``, else the previous step's
  argmax). Without one (the LSTM LM, ``models/lstm_lm.py``, and
  ``attention_type="none"``) the step is the LM-mode stack, ``cells``;
* ``SpeechLSTMModel`` (:214-300), registered as ``speech_lstm``:
  ``forward`` (teacher-forced logits), ``decode_sequence``, ``encode`` and
  ``decode_step``; and the architectures ``speech_conv_lstm_{wsj,
  librispeech,swbd}`` (:303-335).

JAX scans the step over U; here a Python loop over U runs it, each cell one
``torch.lstm_cell`` (gate order i, f, g, o; the flax cell's one bias on the
input product, the recurrent bias a zero vector). The attention's key
projection runs once per utterance in ``encode`` (JAX's runs inside the
step) and rides in ``EncoderOut.attention_keys``. The carry is ``(h, c,
input_feed, prev_pred)``: h and c [L, B, H], input_feed [B, C] in the
encoder output's dtype, prev_pred [B]; in LM mode ``(h, c)``. The weights
load from the flax tree with ``bridge.load_jax_variables``: ``encoder/conv``,
``encoder/lstm/{fwd,bwd}_{i}/{ih,hh_kernel}``, and the scanned decoder's
broadcast parameters ``decoder/{embed_tokens, attention/{query_proj,
key_proj, v, g, b}, cell{i}_ih, cell{i}_hh, additional_fc, fc_out}``.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from espresso_tpu_torch.models.base import EncoderOut
from espresso_tpu_torch.modules.conv_frontend import ConvFrontend
from espresso_tpu_torch.modules.dropout import Dropout
from espresso_tpu_torch.modules.lstm import LSTM
from espresso_tpu_torch.modules.speech_attention import BahdanauAttention, LuongAttention
from espresso_tpu_torch.ops.masking import sequence_mask
from espresso_tpu_torch.registry import MODELS, register_architecture

Carry = Tuple[torch.Tensor, ...]


@dataclass
class SpeechLSTMConfig:
    name: str = "speech_lstm"
    feat_dim: int = 80
    vocab_size: int = 0  # filled by the task
    # encoder conv front-end
    conv_channels: Tuple[int, ...] = (64, 64, 128, 128)
    conv_kernel_sizes: Tuple[Tuple[int, int], ...] = ((3, 3),) * 4
    conv_strides: Tuple[Tuple[int, int], ...] = ((1, 1), (2, 2), (1, 1), (2, 2))
    conv_norm_type: str = "batch"
    # encoder LSTM
    encoder_hidden_size: int = 512
    encoder_layers: int = 3
    encoder_bidirectional: bool = True
    encoder_residual: bool = False
    # decoder
    decoder_embed_dim: int = 48
    decoder_hidden_size: int = 512
    decoder_out_embed_dim: int = 960
    decoder_layers: int = 3
    decoder_residual: bool = False
    attention_type: str = "bahdanau"  # bahdanau | luong | none
    attention_dim: int = 320
    share_decoder_input_output_embed: bool = False
    dropout: float = 0.3
    pad_index: int = 1


class SpeechLSTMEncoder(nn.Module):
    def __init__(self, cfg: SpeechLSTMConfig):
        super().__init__()
        self.cfg = cfg
        self.conv = ConvFrontend(
            cfg.conv_channels, cfg.conv_kernel_sizes, cfg.conv_strides, cfg.conv_norm_type
        )
        f = cfg.feat_dim
        for ks, st in zip(cfg.conv_kernel_sizes, cfg.conv_strides):
            f = (f + (ks[1] - 1) // 2 + ks[1] // 2 - ks[1]) // st[1] + 1
        self.dropout = Dropout(cfg.dropout)
        self.lstm = LSTM(
            cfg.conv_channels[-1] * f,
            cfg.encoder_hidden_size,
            num_layers=cfg.encoder_layers,
            bidirectional=cfg.encoder_bidirectional,
            dropout=cfg.dropout,
            residual=cfg.encoder_residual,
        )

    def forward(self, src_frames: torch.Tensor, src_lengths: torch.Tensor) -> EncoderOut:
        x, lengths = self.conv(src_frames, src_lengths)
        x = self.lstm(self.dropout(x), lengths)
        return EncoderOut(
            encoder_out=x, encoder_padding_mask=sequence_mask(lengths, x.shape[1]), src_lengths=lengths
        )

    def output_units(self) -> int:
        return self.cfg.encoder_hidden_size * (2 if self.cfg.encoder_bidirectional else 1)


class DecoderStep(nn.Module):
    """One step of the LSTM decoder (JAX ``_DecoderStep``). Submodules carry
    the flax names: ``embed_tokens``, ``attention``, ``cells_ih.{i}`` /
    ``cells_hh.{i}`` (flax ``cell{i}_ih`` / ``cell{i}_hh``),
    ``additional_fc``, ``fc_out``. ``encoder_output_units`` C = 0 is LM
    mode: no input feeding, no attention."""

    def __init__(self, cfg: SpeechLSTMConfig, encoder_output_units: int = 0):
        super().__init__()
        self.cfg = cfg
        E, H, L, C = (
            cfg.decoder_embed_dim, cfg.decoder_hidden_size, cfg.decoder_layers, encoder_output_units
        )
        self.embed_tokens = nn.Embedding(cfg.vocab_size, E)
        self.attention: Optional[nn.Module] = None
        if C > 0 and cfg.attention_type == "bahdanau":
            self.attention = BahdanauAttention(H, C, cfg.attention_dim)
        elif C > 0 and cfg.attention_type == "luong":
            self.attention = LuongAttention(H, C)
        elif cfg.attention_type not in ("bahdanau", "luong", "none"):
            raise ValueError(f"unknown attention_type {cfg.attention_type!r}")
        self.cells_ih = nn.ModuleList(
            nn.Linear((E if i == 0 else H) + C, 4 * H) for i in range(L)
        )
        self.cells_hh = nn.ModuleList(nn.Linear(H, 4 * H, bias=False) for _ in range(L))
        self.additional_fc: Optional[nn.Linear] = None
        if H + C != cfg.decoder_out_embed_dim:
            self.additional_fc = nn.Linear(H + C, cfg.decoder_out_embed_dim)
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
        """The top layer's output [..., H (+ C)] -> vocab logits:
        ``additional_fc`` when present, then ``fc_out`` or the shared
        embedding."""
        if self.additional_fc is not None:
            out = self.additional_fc(out)
        if self.fc_out is not None:
            return self.fc_out(out)
        return F.linear(out, self.embed_tokens.weight)

    def forward(self, carry: Carry, token: torch.Tensor) -> Tuple[Carry, torch.Tensor]:
        """LM mode: carry (h, c) [L, B, H], token [B] -> (new carry, logits
        [B, V]). Dropout on the embedding and after each layer in train
        mode."""
        carry, out = self.cells(carry, self.dropout(self.embed_tokens(token)))
        return carry, self.head(out)

    def cells(
        self, carry: Carry, x: torch.Tensor, zero: Optional[torch.Tensor] = None
    ) -> Tuple[Carry, torch.Tensor]:
        """LM mode: the stack on one step's embedded input x [B, E] (after
        its dropout): (new carry, the top layer's output [B, H] after its
        dropout and residual), which ``head`` scores. Each layer is one
        ``torch.lstm_cell``: on the card the two products and one fused gate
        kernel (forward and backward), the gate order i, f, g, o and the
        arithmetic of ``modules/lstm.py::lstm_gates``; the fused cell takes a
        bias for each product and the flax cell has one, so the recurrent
        product's is ``zero`` (a [4H] zero vector, made here if not given)."""
        if zero is None:
            zero = torch.zeros_like(self.cells_ih[0].bias)
        h_prev, c_prev = carry
        hs, cs = [], []
        for i, (ih, hh) in enumerate(zip(self.cells_ih, self.cells_hh)):
            hidden, cell = torch.lstm_cell(x, (h_prev[i], c_prev[i]), ih.weight, hh.weight, ih.bias, zero)
            hs.append(hidden)
            cs.append(cell)
            prev = x[:, : hidden.shape[1]]
            x = self.dropout(hidden)
            if self.cfg.decoder_residual and i > 0:
                x = x + prev
        return (torch.stack(hs), torch.stack(cs)), x

    def attend_step(
        self,
        carry: Carry,
        token: torch.Tensor,
        enc: EncoderOut,
        coin: Optional[torch.Tensor] = None,
        ss_prob: float = 1.0,
        zero: Optional[torch.Tensor] = None,
        compute_logits: bool = True,
    ) -> Tuple[Carry, Optional[torch.Tensor], torch.Tensor, Optional[torch.Tensor]]:
        """The speech model's step: carry (h, c, input_feed, prev_pred), token [B],
        ``enc`` from ``SpeechLSTMModel.encode`` -> (new carry, logits [B, V]
        or None, the output [B, H + C] before ``head``, attention weights
        [B, T] or None). Where ``coin`` is given and ``ss_prob < 1`` the
        token is the teacher's where ``coin < ss_prob``, else the carry's
        previous prediction, and the new carry's prediction is the logits'
        argmax (so ``compute_logits`` must hold); otherwise it is the token.
        Without an encoder (``attention_type="none"``) the feed and the
        context are [B, 0] and the step is LM mode's stack."""
        h_prev, c_prev, input_feed, prev_pred = carry
        ss_active = coin is not None and ss_prob < 1.0
        if ss_active:
            token = torch.where(coin < ss_prob, token, prev_pred.to(token.dtype))
        if zero is None:
            zero = torch.zeros_like(self.cells_ih[0].bias)
        x = torch.cat([self.dropout(self.embed_tokens(token)), input_feed], dim=-1)
        context, attn = input_feed, None
        hs, cs = [], []
        for i, (ih, hh) in enumerate(zip(self.cells_ih, self.cells_hh)):
            hidden, cell = torch.lstm_cell(x, (h_prev[i], c_prev[i]), ih.weight, hh.weight, ih.bias, zero)
            hs.append(hidden)
            cs.append(cell)
            H = hidden.shape[1]
            prev = x[:, :H]
            if i == 0 and self.attention is not None:
                context, attn = self.attention(
                    hidden, enc.encoder_out, enc.encoder_padding_mask, enc.attention_keys
                )
            x = self.dropout(torch.cat([hidden, context], dim=-1))
            if self.cfg.decoder_residual and i > 0:
                x = torch.cat([x[:, :H] + prev, x[:, H:]], dim=-1)
        logits = self.head(x) if compute_logits else None
        if ss_active:
            new_pred = torch.argmax(logits, dim=-1).to(prev_pred.dtype)
        else:
            new_pred = token.to(prev_pred.dtype)
        return (torch.stack(hs), torch.stack(cs), context, new_pred), logits, x, attn


@MODELS.register("speech_lstm", config=SpeechLSTMConfig)
class SpeechLSTMModel(nn.Module):
    """Attention-based LSTM encoder-decoder (JAX ``SpeechLSTMModel``). In
    train mode the scheduled-sampling coins are drawn from ``generator``,
    which ``modules/dropout.py::set_dropout_generator`` sets to the step's
    generator."""

    draws_from_step_generator = True

    def __init__(self, cfg: SpeechLSTMConfig):
        super().__init__()
        self.cfg = cfg
        self.encoder = SpeechLSTMEncoder(cfg)
        units = self.encoder.output_units()
        self.encoder_units = units if cfg.attention_type != "none" else 0
        self.decoder = DecoderStep(cfg, self.encoder_units)
        self.generator: Optional[torch.Generator] = None

    def init_decoder_carry(self, batch_size: int, dtype=None, device=None) -> Carry:
        """The zero carry (h, c, input_feed [B, C], prev_pred [B] int32) in
        the parameters' dtype and device unless given (JAX
        ``init_decoder_carry``); C is 0 without attention."""
        p = self.decoder.embed_tokens.weight
        dtype, device = dtype or p.dtype, device or p.device
        return self.decoder.init_carry(batch_size, dtype, device) + (
            torch.zeros((batch_size, self.encoder_units), dtype=dtype, device=device),
            torch.zeros((batch_size,), dtype=torch.int32, device=device),
        )

    def encode(self, src_frames: torch.Tensor, src_lengths: torch.Tensor) -> EncoderOut:
        """The encoder's output, with the attention's key projection of it."""
        enc = self.encoder(src_frames, src_lengths)
        if self.decoder.attention is not None:
            enc.attention_keys = self.decoder.attention.project_keys(enc.encoder_out)
        return enc

    def forward(
        self,
        src_frames: torch.Tensor,
        src_lengths: torch.Tensor,
        prev_output_tokens: torch.Tensor,
        ss_prob: float = 1.0,
        coin: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, EncoderOut]:
        """Teacher-forced forward: (logits [B, U, V], encoder_out)."""
        enc = self.encode(src_frames, src_lengths)
        logits, _ = self.decode_sequence(prev_output_tokens, enc, ss_prob=ss_prob, coin=coin)
        return logits, enc

    def decode_sequence(
        self,
        prev_output_tokens: torch.Tensor,
        enc: EncoderOut,
        ss_prob: float = 1.0,
        coin: Optional[torch.Tensor] = None,
    ):
        """[B, U] tokens -> (logits [B, U, V], (carry, attention [B, U, T] or
        None)). Scheduled sampling runs where ``ss_prob < 1`` in train mode:
        the coins [U, B] are ``coin`` when given (a test replays JAX's),
        else drawn uniform from ``self.generator``; without it every step
        takes the teacher's token and the head runs once on the stacked
        outputs (the same products as a head a step)."""
        B, U = prev_output_tokens.shape
        dtype = enc.encoder_out.dtype
        carry = self.init_decoder_carry(B, dtype=dtype, device=prev_output_tokens.device)
        ss_active = ss_prob < 1.0 and self.training
        if ss_active and coin is None:
            coin = torch.rand((U, B), device=prev_output_tokens.device, generator=self.generator)
        zero = torch.zeros_like(self.decoder.cells_ih[0].bias)
        tokens = prev_output_tokens.to(torch.int32)
        outs, attns = [], []
        for u in range(U):
            step_coin = coin[u] if ss_active else None
            carry, logits, out, attn = self.decoder.attend_step(
                carry, tokens[:, u], enc, step_coin, ss_prob, zero, compute_logits=ss_active
            )
            outs.append(logits if ss_active else out)
            attns.append(attn)
        stacked = torch.stack(outs, 1)
        logits = stacked if ss_active else self.decoder.head(stacked)
        attn = torch.stack(attns, 1) if attns and attns[0] is not None else None
        return logits, (carry, attn)

    def decode_step(self, tokens: torch.Tensor, carry: Carry, enc: EncoderOut):
        """One incremental step: tokens [B] -> (logits [B, V], new carry,
        attention [B, T] or None)."""
        carry, logits, _, attn = self.decoder.attend_step(carry, tokens.to(torch.int32), enc)
        return logits, carry, attn


# -- named architectures (JAX speech_lstm.py:303-335) ------------------------


@register_architecture("speech_lstm", "speech_conv_lstm_wsj")
def _arch_wsj(cfg: SpeechLSTMConfig) -> None:
    cfg.encoder_hidden_size = 320
    cfg.encoder_layers = 3
    cfg.decoder_embed_dim = 48
    cfg.decoder_hidden_size = 320
    cfg.decoder_out_embed_dim = 960
    cfg.decoder_layers = 3
    cfg.attention_dim = 320


@register_architecture("speech_lstm", "speech_conv_lstm_librispeech")
def _arch_librispeech(cfg: SpeechLSTMConfig) -> None:
    cfg.encoder_hidden_size = 1024
    cfg.encoder_layers = 4
    cfg.decoder_embed_dim = 48
    cfg.decoder_hidden_size = 1024
    cfg.decoder_out_embed_dim = 3072
    cfg.decoder_layers = 3
    cfg.attention_dim = 512
    cfg.dropout = 0.4


@register_architecture("speech_lstm", "speech_conv_lstm_swbd")
def _arch_swbd(cfg: SpeechLSTMConfig) -> None:
    cfg.encoder_hidden_size = 640
    cfg.encoder_layers = 4
    cfg.decoder_embed_dim = 64
    cfg.decoder_hidden_size = 640
    cfg.decoder_out_embed_dim = 1920
    cfg.decoder_layers = 3
    cfg.attention_dim = 640
    cfg.dropout = 0.5
