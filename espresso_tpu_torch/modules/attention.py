"""Multi-head self-attention with espnet-style relative positions.

Counterpart of ``espresso_tpu/modules/attention.py::MultiheadAttention``,
reduced to the conformer encoder's inference use: relative-position
self-attention with a key-padding mask. Square self-attention without
weights or an additive mask goes through the fused kernel
(``ops/attention_kernels.rel_attention``, the JAX dispatch conditions of
attention.py:237-245); everything else takes the deterministic gather path
(attention.py:349-373, 398-417). Caches, rotary positions, dropout and the
training skew wait for later slices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from espresso_tpu_torch.ops.attention_kernels import rel_attention
from espresso_tpu_torch.ops.masking import NEG_INF


def gather_p_shift(p: torch.Tensor, Tq: int, Tk: int) -> torch.Tensor:
    """p [2L-1, H, d] -> p_shift [Tq, Tk, H, d] with
    p_shift[q, k] = p[clip(k - q + L - 1)] (espnet rel-pos convention)."""
    L = (p.shape[0] + 1) // 2
    qi = torch.arange(Tq, device=p.device)[:, None]
    kj = torch.arange(Tk, device=p.device)[None, :]
    return p[((L - 1) + kj - qi).clamp(0, p.shape[0] - 1)]


class MultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int):
        super().__init__()
        assert embed_dim % num_heads == 0
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(embed_dim, embed_dim)
        self.v_proj = nn.Linear(embed_dim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        self.pos_proj = nn.Linear(embed_dim, embed_dim, bias=False)
        self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, self.head_dim))
        self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, self.head_dim))

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], x.shape[1], self.num_heads, self.head_dim)

    def forward(
        self,
        query: torch.Tensor,  # [B, Tq, D]
        key: torch.Tensor,  # [B, Tk, D]
        value: torch.Tensor,  # [B, Tk, D]
        rel_pos: torch.Tensor,  # [2L-1, D] table
        key_padding_mask: Optional[torch.Tensor] = None,  # [B, Tk] True=valid
        attn_mask: Optional[torch.Tensor] = None,  # additive [Tq, Tk] or [B, Tq, Tk]
        need_weights: bool = False,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Returns (out [B, Tq, D], head-averaged weights or None)."""
        if self.training:
            raise NotImplementedError("training attention (dropout, rel-shift skew)")
        B, Tq, D = query.shape
        Tk = key.shape[1]
        H = self.num_heads
        q = self.q_proj(query)
        k = self.k_proj(key)
        v = self.v_proj(value)
        p_flat = self.pos_proj(rel_pos)  # [2L-1, D]
        L = (p_flat.shape[0] + 1) // 2
        scale = self.head_dim ** -0.5

        if not need_weights and attn_mask is None and key is query and Tq == Tk == L:
            kv_mask = (
                key_padding_mask
                if key_padding_mask is not None
                else torch.ones(B, Tq, dtype=torch.bool, device=q.device)
            )
            ctx = rel_attention(
                q + self.pos_bias_u.reshape(D),
                q + self.pos_bias_v.reshape(D),
                k,
                v,
                p_flat,
                kv_mask,
                H,
                scale,
            )
            return self.out_proj(ctx), None

        q, k, v = self._split(q), self._split(k), self._split(v)
        p = p_flat.reshape(-1, H, self.head_dim)
        ac = torch.einsum("bqhd,bkhd->bhqk", q + self.pos_bias_u, k)
        bd = torch.einsum(
            "bqhd,qkhd->bhqk", q + self.pos_bias_v, gather_p_shift(p, Tq, Tk)
        )
        scores = (ac + bd) * torch.tensor(scale, dtype=q.dtype, device=q.device)
        if attn_mask is not None:
            scores = scores + (
                attn_mask[None, None] if attn_mask.dim() == 2 else attn_mask[:, None]
            )
        if key_padding_mask is not None:
            scores = scores.masked_fill(~key_padding_mask[:, None, None, :], NEG_INF)
        weights = torch.softmax(scores.float(), dim=-1).to(q.dtype)
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(B, Tq, D)
        return self.out_proj(out), (weights.mean(dim=1) if need_weights else None)
