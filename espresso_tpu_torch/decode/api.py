"""Incremental-decoder adapters: one step API over the models the beam
search drives.

Counterpart of ``espresso_tpu/decode/api.py`` (:23-101, :151-164): each
model's decode state is an explicit tuple of tensors, and a beam reorder is
one ``index_select`` a leaf along the leaf's batch(+beam) axis.
``LSTMDecoderAdapter`` drives ``SpeechLSTMModel``,
``TransformerDecoderAdapter`` ``SpeechTransformerModel`` (its state the
per-layer caches, a step at the loop's step index), ``LMAdapter`` the LSTM
LM fused by shallow fusion (the LM's plain step, as JAX's adapter runs
it). The transformer LM is not ported; ``make_adapter`` raises for it,
naming ROADMAP queue A. JAX's
``shard_for_decode`` spreads a decode over several devices and waits with
the rest of ``parallel/``.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from espresso_tpu_torch.models.base import EncoderOut
from espresso_tpu_torch.models.lstm_lm import LSTMLanguageModel
from espresso_tpu_torch.models.speech_lstm import SpeechLSTMModel
from espresso_tpu_torch.models.speech_transformer import SpeechTransformerModel


def repeat_encoder_out(enc: EncoderOut, beam: int) -> EncoderOut:
    """Replicate encoder rows beam times: [B, ...] -> [B*K, ...], the rows
    of an utterance together (the attention keys too, when present)."""
    rep = lambda x: None if x is None else torch.repeat_interleave(x, beam, dim=0)
    return EncoderOut(
        encoder_out=rep(enc.encoder_out),
        encoder_padding_mask=rep(enc.encoder_padding_mask),
        src_lengths=rep(enc.src_lengths),
        attention_keys=rep(enc.attention_keys),
    )


def _reorder_lstm(state: Tuple[torch.Tensor, ...], idx: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """(h [L, BK, H], c [L, BK, H], rest [BK, ...]...) gathered at ``idx``."""
    h, c, *rest = state
    return (h.index_select(1, idx), c.index_select(1, idx)) + tuple(x.index_select(0, idx) for x in rest)


class LSTMDecoderAdapter:
    """The speech LSTM's carry: (h [L,BK,H], c [L,BK,H], feed [BK,C], prev
    [BK])."""

    def __init__(self, model: SpeechLSTMModel):
        self.model = model

    def init_state(self, enc: EncoderOut, batch_k: int, max_len: int):
        return self.model.init_decoder_carry(batch_k, dtype=enc.encoder_out.dtype)

    def step(self, tokens, state, enc, step_idx):
        return self.model.decode_step(tokens, state, enc)

    def reorder(self, state, idx):
        return _reorder_lstm(state, idx)


class TransformerDecoderAdapter:
    """The transformer decoder's per-layer caches: {"self": {"k", "v"
    [BK, S, H, Dh]}, "cross": {"k_static", "v_static" [BK, T, H, Dh]}}."""

    def __init__(self, model: SpeechTransformerModel):
        self.model = model

    def init_state(self, enc: EncoderOut, batch_k: int, max_len: int):
        return self.model.init_cache(enc, max_len)

    def step(self, tokens, state, enc, step_idx: int):
        return self.model.decode_step(tokens, step_idx, state, enc)

    def reorder(self, state, idx):
        return [{part: {k: x.index_select(0, idx) for k, x in leaves.items()}
                 for part, leaves in layer.items()} for layer in state]


class LMAdapter:
    """The LSTM LM for shallow fusion: its carry (h, c), each [L, BK, H]."""

    def __init__(self, model: LSTMLanguageModel):
        self.model = model

    def init_state(self, enc: Optional[EncoderOut], batch_k: int, max_len: int):
        return self.model.init_carry(batch_k)

    def step(self, tokens, state, enc=None, step_idx=None):
        logits, state = self.model.decode_step(tokens, state)
        return logits, state, None

    def reorder(self, state, idx):
        return _reorder_lstm(state, idx)


def make_adapter(model):
    if isinstance(model, SpeechLSTMModel):
        return LSTMDecoderAdapter(model)
    if isinstance(model, SpeechTransformerModel):
        return TransformerDecoderAdapter(model)
    if isinstance(model, LSTMLanguageModel):
        return LMAdapter(model)
    name = type(model).__name__
    if "Transformer" in name:
        raise NotImplementedError(
            f"no incremental adapter for {name}: the transformer LM is not ported "
            "(ROADMAP queue A item 2)"
        )
    raise TypeError(f"no incremental adapter for {name}")
