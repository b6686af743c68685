"""Multi-head self-attention with espnet-style relative positions.

Counterpart of ``espresso_tpu/modules/attention.py::MultiheadAttention``,
reduced to the conformer encoder's use: relative-position self-attention
with a key-padding mask.

* Eval mode: square self-attention without weights or an additive mask goes
  through the fused inference kernel (``ops/attention_kernels.rel_attention``,
  the JAX dispatch conditions of attention.py:237-245); everything else takes
  the deterministic gather path (attention.py:349-373, 384-387, 398-417).
* Train mode: square self-attention without weights or an additive mask
  goes through the train kernels (``rel_attention_train``, attention.py
  :288-348), with dropout on the softmax weights at the layer's rate. The
  per-call seed is an int32 drawn on the device from the dropout generator,
  so no value reaches the host. Other train-mode attention raises
  ``NotImplementedError``: no caller of the port has it.
* A clipped table (``L < T``: the encoder's ``encoder_relative_max_size``
  below the length) takes the kernels too, in both modes: the projected
  table [2L-1, D] is expanded by an index gather to [2T-1, D] with row j =
  row clip(j - (T-1) + (L-1), 0, 2L-2), so that bd[q, k] = q_v . p[clip(k -
  q + L - 1)], the clipped shift JAX computes by the gather at inference
  (attention.py:384-387) and the clipped skew in training (:388-397); the
  gather's autograd sums dp back into the clipped rows.

Caches and rotary positions wait for later slices.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from espresso_tpu_torch.modules.dropout import Dropout
from espresso_tpu_torch.ops.attention_kernels import rel_attention, rel_attention_train
from espresso_tpu_torch.ops.masking import NEG_INF


def gather_p_shift(p: torch.Tensor, Tq: int, Tk: int) -> torch.Tensor:
    """p [2L-1, H, d] -> p_shift [Tq, Tk, H, d] with
    p_shift[q, k] = p[clip(k - q + L - 1)] (espnet rel-pos convention)."""
    L = (p.shape[0] + 1) // 2
    qi = torch.arange(Tq, device=p.device)[:, None]
    kj = torch.arange(Tk, device=p.device)[None, :]
    return p[((L - 1) + kj - qi).clamp(0, p.shape[0] - 1)]


def clipped_rows(L: int, T: int, device: torch.device) -> torch.Tensor:
    """The rows of a [2L-1] table that the rows of its expansion to [2T-1]
    take: row j <- clip(j - (T-1) + (L-1), 0, 2L-2), the clipped offset
    of relative position j - (T-1)."""
    j = torch.arange(2 * T - 1, device=device)
    return (j - (T - 1) + (L - 1)).clamp(0, 2 * L - 2)


class MultiheadAttention(nn.Module):
    def __init__(self, embed_dim: int, num_heads: int, dropout: float = 0.0):
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
        # holds the rate and the generator of the in-kernel weight dropout
        self.dropout = Dropout(dropout)

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
        B, Tq, D = query.shape
        Tk = key.shape[1]
        H = self.num_heads
        q = self.q_proj(query)
        k = self.k_proj(key)
        v = self.v_proj(value)
        p_flat = self.pos_proj(rel_pos)  # [2L-1, D]
        L = (p_flat.shape[0] + 1) // 2
        scale = self.head_dim ** -0.5

        # square self-attention; a table clipped below the length (L < T)
        # is expanded to the length's
        fused = not need_weights and attn_mask is None and key is query and Tq == Tk >= L
        if self.training and not fused:
            raise NotImplementedError("train-mode attention other than square self-attention")
        if fused:
            if L < Tq:
                # gathered in f32, so that the gather's backward sums the
                # clipped rows' gradients in f32
                p_flat = p_flat.float()[clipped_rows(L, Tq, p_flat.device)].to(p_flat.dtype)
            kv_mask = (
                key_padding_mask
                if key_padding_mask is not None
                else torch.ones(B, Tq, dtype=torch.bool, device=q.device)
            )
            q_u, q_v = q + self.pos_bias_u.reshape(D), q + self.pos_bias_v.reshape(D)
            if self.training:
                ctx = rel_attention_train(
                    q_u, q_v, k, v, p_flat, kv_mask, self._seed(q.device), H, scale,
                    self.dropout.rate,
                )
            else:
                ctx = rel_attention(q_u, q_v, k, v, p_flat, kv_mask, H, scale)
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

    def _seed(self, device: torch.device) -> torch.Tensor:
        """The dropout seed of one call: an int32 in [0, 2^31 - 1) drawn on
        ``device`` (0 at rate 0, as in JAX)."""
        if self.dropout.rate <= 0.0:
            return torch.zeros(1, dtype=torch.int32, device=device)
        return torch.randint(
            0, 2**31 - 1, (1,), generator=self.dropout.generator, device=device,
            dtype=torch.int32,
        )
