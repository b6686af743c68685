"""Encoder layers: the conformer (macaron FFN + MHSA + depthwise conv) and
the pre-norm transformer layer.

Counterpart of ``espresso_tpu/modules/conformer.py`` (FeedForwardModule,
ConvolutionModule, ConformerEncoderLayer, conformer.py:22-138;
TransformerEncoderLayer, :141-190). The conformer:
FFN(x0.5) -> MHSA(+rel-pos) -> ConvModule(pointwise -> GLU -> masked
depthwise k=31 -> batch norm -> swish -> pointwise) -> FFN(x0.5) -> final
LayerNorm -> output masked. Activations stay [B, T, D]; the depthwise conv
and its batch norm run channels-first inside the module.

In train mode dropout acts where JAX puts it: after the FFN activation and
after its output projection (conformer.py:33-37), on the attention weights
(in the kernel) and after the attention block (:120-121), and after the
conv module's last projection (:74-75); the batch norm follows flax
(``modules/batch_norm.py``).

The transformer layer: self_attn_layer_norm -> self-attention -> dropout ->
residual; final_layer_norm -> fc1 (flax ``Dense_0``) -> relu -> dropout ->
fc2 (``Dense_1``) -> dropout -> residual; its output is not masked. Either
layer's attention is relative (the table passed in) or plain.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from espresso_tpu_torch.modules.attention import MultiheadAttention
from espresso_tpu_torch.modules.batch_norm import BatchNorm
from espresso_tpu_torch.modules.dropout import Dropout

LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon (torch's default is 1e-5)


def _mask_rows(x: torch.Tensor, padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if padding_mask is None:
        return x
    return x * padding_mask[..., None].to(x.dtype)


class FeedForwardModule(nn.Module):
    def __init__(self, embed_dim: int, ffn_dim: int, dropout: float = 0.0):
        super().__init__()
        self.layer_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.fc1 = nn.Linear(embed_dim, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, embed_dim)
        self.dropout = Dropout(dropout)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = self.dropout(F.silu(self.fc1(self.layer_norm(x))))
        return self.dropout(self.fc2(h))


class ConvolutionModule(nn.Module):
    def __init__(self, embed_dim: int, kernel_size: int = 31, dropout: float = 0.0):
        super().__init__()
        if kernel_size % 2 == 0:
            # flax "SAME" pads an even kernel asymmetrically
            raise NotImplementedError("even depthwise kernel sizes")
        self.layer_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.pointwise_conv1 = nn.Linear(embed_dim, 2 * embed_dim)
        self.depthwise_conv = nn.Conv1d(
            embed_dim,
            embed_dim,
            kernel_size,
            padding=kernel_size // 2,
            groups=embed_dim,
        )
        self.batch_norm = BatchNorm(embed_dim)
        self.pointwise_conv2 = nn.Linear(embed_dim, embed_dim)
        self.dropout = Dropout(dropout)

    def forward(
        self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        h = F.glu(self.pointwise_conv1(self.layer_norm(x)), dim=-1)
        h = _mask_rows(h, padding_mask)
        h = self.batch_norm(self.depthwise_conv(h.transpose(1, 2))).to(x.dtype)
        return self.dropout(self.pointwise_conv2(F.silu(h.transpose(1, 2))))


class ConformerEncoderLayer(nn.Module):
    def __init__(
        self,
        embed_dim: int,
        ffn_dim: int,
        num_heads: int,
        depthwise_kernel_size: int = 31,
        dropout: float = 0.0,
        use_relative_pos: bool = True,
    ):
        super().__init__()
        self.ffn1 = FeedForwardModule(embed_dim, ffn_dim, dropout)
        self.self_attn_layer_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.self_attn = MultiheadAttention(embed_dim, num_heads, dropout, use_relative_pos)
        self.attn_dropout = Dropout(dropout)
        self.conv_module = ConvolutionModule(embed_dim, depthwise_kernel_size, dropout)
        self.ffn2 = FeedForwardModule(embed_dim, ffn_dim, dropout)
        self.final_layer_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(
        self,
        x: torch.Tensor,  # [B, T, D]
        padding_mask: Optional[torch.Tensor],  # [B, T] True = valid
        rel_pos: Optional[torch.Tensor] = None,  # [2L-1, D], or None
    ) -> torch.Tensor:
        x = x + 0.5 * self.ffn1(x)
        h = self.self_attn_layer_norm(x)
        h, _ = self.self_attn(h, h, h, rel_pos, key_padding_mask=padding_mask)
        x = x + self.attn_dropout(h)
        x = x + self.conv_module(x, padding_mask)
        x = x + 0.5 * self.ffn2(x)
        return _mask_rows(self.final_layer_norm(x), padding_mask)


class TransformerEncoderLayer(nn.Module):
    def __init__(
        self,
        embed_dim: int,
        ffn_dim: int,
        num_heads: int,
        dropout: float = 0.0,
        use_relative_pos: bool = False,
    ):
        super().__init__()
        self.self_attn_layer_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.self_attn = MultiheadAttention(embed_dim, num_heads, dropout, use_relative_pos)
        self.final_layer_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.fc1 = nn.Linear(embed_dim, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, embed_dim)
        self.dropout = Dropout(dropout)

    def forward(
        self,
        x: torch.Tensor,  # [B, T, D]
        padding_mask: Optional[torch.Tensor],  # [B, T] True = valid
        rel_pos: Optional[torch.Tensor] = None,  # [2L-1, D], or None
    ) -> torch.Tensor:
        h = self.self_attn_layer_norm(x)
        h, _ = self.self_attn(h, h, h, rel_pos, key_padding_mask=padding_mask)
        x = x + self.dropout(h)
        h = self.dropout(F.relu(self.fc1(self.final_layer_norm(x))))
        return x + self.dropout(self.fc2(h))
