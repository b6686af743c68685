"""Conformer encoder layer (macaron FFN + rel-pos MHSA + depthwise conv).

Counterpart of ``espresso_tpu/modules/conformer.py`` (FeedForwardModule,
ConvolutionModule, ConformerEncoderLayer, conformer.py:22-138), inference
only: FFN(x0.5) -> MHSA(+rel-pos) -> ConvModule(pointwise -> GLU -> masked
depthwise k=31 -> batch norm -> swish -> pointwise) -> FFN(x0.5) -> final
LayerNorm -> output masked. Activations stay [B, T, D]; the depthwise conv
and its batch norm run channels-first inside the module.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from espresso_tpu_torch.modules.attention import MultiheadAttention

LN_EPS = 1e-6  # flax nn.LayerNorm's epsilon (torch's default is 1e-5)


def _mask_rows(x: torch.Tensor, padding_mask: Optional[torch.Tensor]) -> torch.Tensor:
    if padding_mask is None:
        return x
    return x * padding_mask[..., None].to(x.dtype)


class FeedForwardModule(nn.Module):
    def __init__(self, embed_dim: int, ffn_dim: int):
        super().__init__()
        self.layer_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.fc1 = nn.Linear(embed_dim, ffn_dim)
        self.fc2 = nn.Linear(ffn_dim, embed_dim)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(F.silu(self.fc1(self.layer_norm(x))))


class ConvolutionModule(nn.Module):
    def __init__(self, embed_dim: int, kernel_size: int = 31):
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
        self.batch_norm = nn.BatchNorm1d(embed_dim)
        self.pointwise_conv2 = nn.Linear(embed_dim, embed_dim)

    def forward(
        self, x: torch.Tensor, padding_mask: Optional[torch.Tensor] = None
    ) -> torch.Tensor:
        h = F.glu(self.pointwise_conv1(self.layer_norm(x)), dim=-1)
        h = _mask_rows(h, padding_mask)
        h = self.batch_norm(self.depthwise_conv(h.transpose(1, 2))).to(x.dtype)
        return self.pointwise_conv2(F.silu(h.transpose(1, 2)))


class ConformerEncoderLayer(nn.Module):
    def __init__(
        self,
        embed_dim: int,
        ffn_dim: int,
        num_heads: int,
        depthwise_kernel_size: int = 31,
    ):
        super().__init__()
        self.ffn1 = FeedForwardModule(embed_dim, ffn_dim)
        self.self_attn_layer_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)
        self.self_attn = MultiheadAttention(embed_dim, num_heads)
        self.conv_module = ConvolutionModule(embed_dim, depthwise_kernel_size)
        self.ffn2 = FeedForwardModule(embed_dim, ffn_dim)
        self.final_layer_norm = nn.LayerNorm(embed_dim, eps=LN_EPS)

    def forward(
        self,
        x: torch.Tensor,  # [B, T, D]
        padding_mask: Optional[torch.Tensor],  # [B, T] True = valid
        rel_pos: torch.Tensor,  # [2T-1, D]
    ) -> torch.Tensor:
        x = x + 0.5 * self.ffn1(x)
        h = self.self_attn_layer_norm(x)
        h, _ = self.self_attn(h, h, h, rel_pos, key_padding_mask=padding_mask)
        x = x + h
        x = x + self.conv_module(x, padding_mask)
        x = x + 0.5 * self.ffn2(x)
        return _mask_rows(self.final_layer_norm(x), padding_mask)
