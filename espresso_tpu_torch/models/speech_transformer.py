"""Speech Transformer / Conformer encoder-decoder (``speech_transformer``).

Counterpart of ``espresso_tpu/models/speech_transformer.py``:

* ``SpeechTransformerConfig`` (:46-107), whole, with JAX's defaults;
* ``SpeechTransformerEncoder`` (:156-274): ConvFrontend -> fc0 ->
  positions (``abs``: the sinusoidal table added after fc0, with no embed
  scale; ``relative``: the relative sinusoidal table each layer's attention
  takes; ``none``) -> (train mode: input dropout) -> N ``conformer`` or
  ``transformer`` layers (``modules/conformer.py``) -> final LayerNorm;
* ``TransformerDecoderLayer`` (:351-431): pre-norm causal self-attention,
  cross-attention on the encoder output (head-averaged weights), a relu
  FFN, with no residual dropout (JAX's layer, not fairseq's); its
  ``make_cache`` builds the incremental self-attention cache and the
  cross-attention's static keys and values;
* ``SpeechTransformerModel`` (:434-573), registered as
  ``speech_transformer``: ``forward`` (teacher-forced logits;
  ``ss_prob`` taken and ignored, as in JAX), ``encode``,
  ``decode_sequence`` (embedding x sqrt(d), the sinusoidal positions of U,
  dropout, the f32 causal mask, no target key-padding mask, decoder_norm,
  the output projection: the embedding's own table when shared, JAX's
  ``embed.attend``, else ``fc_out``), ``init_cache`` and ``decode_step``
  (the step's position row from a ``max_target_positions`` table, clamped
  to its last row as JAX's ``dynamic_slice`` clamps); and the
  architectures ``speech_transformer_{wsj,librispeech,swbd}`` (:579-607).

Train mode is ``nn.Module.train()``. The embedding has no pad row (flax's
``nn.Embed`` has none) and starts at flax's scale, 1/sqrt(d). Not ported
(``NotImplementedError``): rotary and learned positions, layer norm in the
frontend or the conv module, chunk-streaming and limited-context masks,
rematerialisation, pipeline stages, sequence parallelism, LayerDrop and
BASE layers.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any, Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from espresso_tpu_torch.models.base import EncoderOut
from espresso_tpu_torch.modules.attention import MultiheadAttention, scalar_in
from espresso_tpu_torch.modules.conformer import LN_EPS, ConformerEncoderLayer, TransformerEncoderLayer
from espresso_tpu_torch.modules.conv_frontend import ConvFrontend
from espresso_tpu_torch.modules.dropout import Dropout
from espresso_tpu_torch.modules.positional import RelativePositionalEmbedding, SinusoidalPositions
from espresso_tpu_torch.ops.masking import NEG_INF, sequence_mask
from espresso_tpu_torch.registry import MODELS, register_architecture

# rows of the encoder's absolute table built at construction (the attention
# kernels take T' <= 4096); a longer input grows it from the host
ENCODER_ABS_ROWS = 4096


@dataclass
class SpeechTransformerConfig:
    """JAX's fields in JAX's order, with JAX's defaults (so a
    ``model_cfg.json`` of either package loads in the other)."""

    name: str = "speech_transformer"
    feat_dim: int = 80
    vocab_size: int = 0
    # conv front-end
    conv_channels: Tuple[int, ...] = (64, 64, 128, 128)
    conv_kernel_sizes: Tuple[Tuple[int, int], ...] = ((3, 3),) * 4
    conv_strides: Tuple[Tuple[int, int], ...] = ((1, 1), (2, 2), (1, 1), (2, 2))
    conv_norm_type: str = "batch"
    # encoder
    encoder_embed_dim: int = 256
    encoder_ffn_dim: int = 1024
    encoder_layers: int = 12
    encoder_heads: int = 4
    encoder_layer_type: str = "transformer"  # transformer | conformer
    encoder_pos_type: str = "abs"  # abs | relative | rotary | none
    encoder_relative_max_size: int = 1024
    encoder_learned_pos: bool = False
    depthwise_conv_kernel_size: int = 31
    conformer_norm_type: str = "batch"
    # streaming / limited context
    chunk_size: int = 0
    chunk_left_window: int = 0
    chunk_right_window: int = 0
    context_left: int = -1  # -1 = unlimited
    context_right: int = -1
    remat: bool = False
    encoder_layerdrop: float = 0.0
    decoder_layerdrop: float = 0.0
    # decoder
    decoder_embed_dim: int = 256
    decoder_ffn_dim: int = 1024
    decoder_layers: int = 6
    decoder_heads: int = 4
    decoder_learned_pos: bool = False
    share_decoder_input_output_embed: bool = True
    max_target_positions: int = 1024
    base_layers: int = 0
    base_experts: int = 4
    base_sublayers: int = 1
    base_shuffle: bool = True
    dropout: float = 0.1
    pad_index: int = 1
    pipeline_stages: int = 1
    pipeline_microbatches: int = 4
    sequence_parallel: bool = False


def _unsupported(cfg: SpeechTransformerConfig):
    checks = (
        (cfg.encoder_layer_type not in ("conformer", "transformer"),
         f"layer type {cfg.encoder_layer_type!r}"),
        (cfg.encoder_pos_type not in ("abs", "relative", "none"),
         f"position type {cfg.encoder_pos_type!r}"),
        (cfg.encoder_learned_pos, "learned relative positions"),
        (cfg.conv_norm_type != "batch", f"frontend norm {cfg.conv_norm_type!r}"),
        (cfg.conformer_norm_type != "batch", f"conv module norm {cfg.conformer_norm_type!r}"),
        (cfg.chunk_size > 0 or cfg.chunk_left_window or cfg.chunk_right_window,
         "chunk-streaming masks"),
        (cfg.remat, "rematerialisation"),
        (cfg.base_layers > 0, "BASE layers"),
        (cfg.context_left >= 0 or cfg.context_right >= 0, "limited-context masks"),
        (cfg.encoder_layerdrop > 0.0, "LayerDrop"),
        (cfg.pipeline_stages > 1, "pipeline stages"),
        (cfg.sequence_parallel, "sequence parallelism"),
    )
    return [what for bad, what in checks if bad]


class SpeechTransformerEncoder(nn.Module):
    def __init__(self, cfg: SpeechTransformerConfig):
        super().__init__()
        missing = _unsupported(cfg)
        if missing:
            raise NotImplementedError("encoder options not ported: " + ", ".join(missing))
        self.cfg = cfg
        D = cfg.encoder_embed_dim
        self.conv = ConvFrontend(
            cfg.conv_channels, cfg.conv_kernel_sizes, cfg.conv_strides, cfg.conv_norm_type
        )
        f = cfg.feat_dim
        for ks, st in zip(cfg.conv_kernel_sizes, cfg.conv_strides):
            f = (f + (ks[1] - 1) // 2 + ks[1] // 2 - ks[1]) // st[1] + 1
        self.fc0 = nn.Linear(cfg.conv_channels[-1] * f, D)
        relative = cfg.encoder_pos_type == "relative"
        self.rel_pos = RelativePositionalEmbedding(D, cfg.encoder_relative_max_size) if relative else None
        self.abs_pos = SinusoidalPositions(D, ENCODER_ABS_ROWS) if cfg.encoder_pos_type == "abs" else None
        self.dropout = Dropout(cfg.dropout)
        if cfg.encoder_layer_type == "conformer":
            make = lambda: ConformerEncoderLayer(
                D, cfg.encoder_ffn_dim, cfg.encoder_heads, cfg.depthwise_conv_kernel_size,
                cfg.dropout, relative,
            )
        else:
            make = lambda: TransformerEncoderLayer(
                D, cfg.encoder_ffn_dim, cfg.encoder_heads, cfg.dropout, relative
            )
        self.layers = nn.ModuleList(make() for _ in range(cfg.encoder_layers))
        self.final_norm = nn.LayerNorm(D, eps=LN_EPS)

    def forward(self, src_frames: torch.Tensor, src_lengths: torch.Tensor) -> EncoderOut:
        x, lengths = self.conv(src_frames, src_lengths)
        x = self.fc0(x)
        T = x.shape[1]
        rel_pos = None
        if self.abs_pos is not None:
            x = x + self.abs_pos(T).to(x.dtype)
        elif self.rel_pos is not None:
            rel_pos = self.rel_pos(T).to(x.dtype)
        x = self.dropout(x)
        padding_mask = sequence_mask(lengths, T)
        for layer in self.layers:
            x = layer(x, padding_mask, rel_pos)
        x = self.final_norm(x)
        return EncoderOut(
            encoder_out=x, encoder_padding_mask=padding_mask, src_lengths=lengths
        )


class TransformerDecoderLayer(nn.Module):
    def __init__(
        self, embed_dim: int, ffn_dim: int, num_heads: int, dropout: float = 0.0,
        encoder_dim: Optional[int] = None,
    ):
        super().__init__()
        self.embed_dim, self.num_heads = embed_dim, num_heads
        self.self_attn = MultiheadAttention(embed_dim, num_heads, dropout, use_relative_pos=False)
        self.cross_attn = MultiheadAttention(
            embed_dim, num_heads, dropout, use_relative_pos=False, kdim=encoder_dim
        )
        self.self_attn_layer_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.cross_attn_layer_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.final_layer_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.fc1 = nn.Linear(embed_dim, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, embed_dim)

    def forward(
        self,
        x: torch.Tensor,  # [B, U, D]
        enc_out: torch.Tensor,  # [B, T, C]
        enc_mask: torch.Tensor,  # [B, T] True = valid
        self_attn_mask: Optional[torch.Tensor] = None,  # additive [U, U]
        cache: Optional[Dict[str, Any]] = None,
        cache_index: Optional[int] = None,
        need_weights: bool = True,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """(x [B, U, D], the cross-attention's head-averaged weights [B, U,
        T] or None). With ``cache`` (``make_cache``) this is one step at
        ``cache_index``: its self-attention cache is written in place."""
        h = self.self_attn_layer_norm(x)
        h, _ = self.self_attn(
            h, h, h, attn_mask=self_attn_mask, cache=cache["self"] if cache else None,
            cache_index=cache_index,
        )
        x = x + h
        h = self.cross_attn_layer_norm(x)
        h, attn = self.cross_attn(
            h, enc_out, enc_out, key_padding_mask=enc_mask, need_weights=need_weights,
            cache=cache["cross"] if cache else None,
        )
        x = x + h
        return x + self.fc2(F.relu(self.fc1(self.final_layer_norm(x)))), attn

    def make_cache(self, B: int, max_len: int, enc_out: torch.Tensor) -> Dict[str, Any]:
        """{"self": {"k", "v"} zeros [B, max_len, H, Dh], "cross": the
        encoder's keys and values}, in the encoder output's dtype."""
        shape = (B, max_len, self.num_heads, self.embed_dim // self.num_heads)
        zeros = lambda: torch.zeros(shape, dtype=enc_out.dtype, device=enc_out.device)
        return {
            "self": {"k": zeros(), "v": zeros()},
            "cross": self.cross_attn.make_cross_attention_cache(enc_out),
        }


@MODELS.register("speech_transformer", config=SpeechTransformerConfig)
class SpeechTransformerModel(nn.Module):
    def __init__(self, cfg: SpeechTransformerConfig):
        super().__init__()
        if cfg.decoder_layerdrop > 0.0:
            raise NotImplementedError("decoder options not ported: LayerDrop")
        self.cfg = cfg
        D = cfg.decoder_embed_dim
        self.encoder = SpeechTransformerEncoder(cfg)
        self.embed_tokens = nn.Embedding(cfg.vocab_size, D)
        nn.init.normal_(self.embed_tokens.weight, std=D ** -0.5)  # flax nn.Embed's scale
        # flax declayer{i}
        self.decoder_layers = nn.ModuleList(
            TransformerDecoderLayer(
                D, cfg.decoder_ffn_dim, cfg.decoder_heads, cfg.dropout, cfg.encoder_embed_dim
            )
            for _ in range(cfg.decoder_layers)
        )
        self.decoder_norm = nn.LayerNorm(D, eps=LN_EPS)
        self.dropout = Dropout(cfg.dropout)
        self.positions = SinusoidalPositions(D, cfg.max_target_positions)
        self.fc_out = None if cfg.share_decoder_input_output_embed else nn.Linear(D, cfg.vocab_size)

    def forward(
        self,
        src_frames: torch.Tensor,
        src_lengths: torch.Tensor,
        prev_output_tokens: torch.Tensor,
        ss_prob: float = 1.0,
    ) -> Tuple[torch.Tensor, EncoderOut]:
        """Teacher-forced forward: (logits [B, U, V], encoder_out)."""
        enc = self.encode(src_frames, src_lengths)
        return self.decode_sequence(prev_output_tokens, enc), enc

    def encode(self, src_frames: torch.Tensor, src_lengths: torch.Tensor) -> EncoderOut:
        return self.encoder(src_frames, src_lengths)

    def _embed(self, tokens: torch.Tensor) -> torch.Tensor:
        x = self.embed_tokens(tokens)
        return x * scalar_in(self.cfg.decoder_embed_dim ** 0.5, x.dtype)

    def decode_sequence(self, prev_output_tokens: torch.Tensor, enc: EncoderOut) -> torch.Tensor:
        """[B, U] tokens -> logits [B, U, V]."""
        U = prev_output_tokens.shape[1]
        x = self._embed(prev_output_tokens)
        x = self.dropout(x + self.positions(U).to(x.dtype))
        causal = torch.full((U, U), NEG_INF, device=x.device).triu(1)
        for layer in self.decoder_layers:
            x, _ = layer(
                x, enc.encoder_out, enc.encoder_padding_mask, self_attn_mask=causal,
                need_weights=False,
            )
        return self.output_projection(self.decoder_norm(x))

    def output_projection(self, x: torch.Tensor) -> torch.Tensor:
        if self.fc_out is None:
            return F.linear(x, self.embed_tokens.weight)
        return self.fc_out(x)

    def init_cache(self, enc: EncoderOut, max_len: int) -> List[Dict[str, Any]]:
        B = enc.encoder_out.shape[0]
        return [layer.make_cache(B, max_len, enc.encoder_out) for layer in self.decoder_layers]

    def decode_step(
        self, tokens: torch.Tensor, step_index: int, cache: List[Dict[str, Any]], enc: EncoderOut
    ):
        """One incremental step at ``step_index`` (the loop's Python int):
        tokens [B] -> (logits [B, V], the cache, written in place, the last
        layer's cross-attention weights [B, T])."""
        x = self._embed(tokens)[:, None]
        row = min(step_index, self.cfg.max_target_positions - 1)
        x = x + self.positions.table[row].to(x.dtype)
        attn = None
        for layer, layer_cache in zip(self.decoder_layers, cache):
            x, attn = layer(
                x, enc.encoder_out, enc.encoder_padding_mask, cache=layer_cache,
                cache_index=step_index,
            )
        logits = self.output_projection(self.decoder_norm(x))[:, 0]
        return logits, cache, (attn[:, 0] if attn is not None else None)


# -- named architectures (JAX speech_transformer.py:579-607) -----------------


@register_architecture("speech_transformer", "speech_transformer_wsj")
def _arch_st_wsj(cfg: SpeechTransformerConfig) -> None:
    pass  # the base defaults are wsj's


@register_architecture("speech_transformer", "speech_transformer_librispeech")
def _arch_st_librispeech(cfg: SpeechTransformerConfig) -> None:
    cfg.encoder_embed_dim = 512
    cfg.encoder_ffn_dim = 2048
    cfg.encoder_layers = 12
    cfg.encoder_heads = 8
    cfg.decoder_embed_dim = 512
    cfg.decoder_ffn_dim = 2048
    cfg.decoder_layers = 6
    cfg.decoder_heads = 8
    cfg.dropout = 0.1


@register_architecture("speech_transformer", "speech_transformer_swbd")
def _arch_st_swbd(cfg: SpeechTransformerConfig) -> None:
    cfg.encoder_embed_dim = 512
    cfg.encoder_ffn_dim = 2048
    cfg.encoder_layers = 12
    cfg.encoder_heads = 8
    cfg.decoder_embed_dim = 512
    cfg.decoder_ffn_dim = 2048
    cfg.decoder_layers = 6
    cfg.decoder_heads = 8
    cfg.dropout = 0.15
