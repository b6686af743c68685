"""Speech Conformer encoder.

Counterpart of ``espresso_tpu/models/speech_transformer.py``:
``SpeechTransformerConfig`` (the fields the encoder reads) and
``SpeechTransformerEncoder`` (speech_transformer.py:156-274) for the
conformer layer type with relative positions, in eval mode. ConvFrontend ->
fc0 -> relative sinusoidal table -> N conformer layers -> final LayerNorm.

Not ported yet (the constructor raises ``NotImplementedError``): transformer
layers, absolute/rotary/learned positions, layer norm in the frontend or the
conv module, chunk-streaming and limited-context masks, pipeline stages,
sequence parallelism and LayerDrop.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import torch
from torch import nn

from espresso_tpu_torch.models.base import EncoderOut
from espresso_tpu_torch.modules.conformer import LN_EPS, ConformerEncoderLayer
from espresso_tpu_torch.modules.conv_frontend import ConvFrontend
from espresso_tpu_torch.modules.positional import RelativePositionalEmbedding
from espresso_tpu_torch.ops.masking import sequence_mask


@dataclass
class SpeechTransformerConfig:
    feat_dim: int = 80
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
    encoder_layer_type: str = "conformer"
    encoder_pos_type: str = "relative"
    encoder_relative_max_size: int = 1024
    encoder_learned_pos: bool = False
    depthwise_conv_kernel_size: int = 31
    conformer_norm_type: str = "batch"
    # streaming / limited context
    chunk_size: int = 0
    context_left: int = -1  # -1 = unlimited
    context_right: int = -1
    encoder_layerdrop: float = 0.0
    pipeline_stages: int = 1
    sequence_parallel: bool = False


def _unsupported(cfg: SpeechTransformerConfig):
    checks = (
        (cfg.encoder_layer_type != "conformer", f"layer type {cfg.encoder_layer_type!r}"),
        (cfg.encoder_pos_type != "relative", f"position type {cfg.encoder_pos_type!r}"),
        (cfg.encoder_learned_pos, "learned relative positions"),
        (cfg.conv_norm_type != "batch", f"frontend norm {cfg.conv_norm_type!r}"),
        (cfg.conformer_norm_type != "batch", f"conv module norm {cfg.conformer_norm_type!r}"),
        (cfg.chunk_size > 0, "chunk-streaming masks"),
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
        self.rel_pos = RelativePositionalEmbedding(D, cfg.encoder_relative_max_size)
        self.layers = nn.ModuleList(
            ConformerEncoderLayer(
                D, cfg.encoder_ffn_dim, cfg.encoder_heads, cfg.depthwise_conv_kernel_size
            )
            for _ in range(cfg.encoder_layers)
        )
        self.final_norm = nn.LayerNorm(D, eps=LN_EPS)

    def forward(self, src_frames: torch.Tensor, src_lengths: torch.Tensor) -> EncoderOut:
        x, lengths = self.conv(src_frames, src_lengths)
        x = self.fc0(x)
        T = x.shape[1]
        rel_pos = self.rel_pos(T).to(x.dtype)
        padding_mask = sequence_mask(lengths, T)
        for layer in self.layers:
            x = layer(x, padding_mask, rel_pos)
        x = self.final_norm(x)
        return EncoderOut(
            encoder_out=x, encoder_padding_mask=padding_mask, src_lengths=lengths
        )
