"""Multi-head attention: plain or with espnet-style relative positions, with
an additive mask, head-averaged weights and decode caches.

Counterpart of ``espresso_tpu/modules/attention.py::MultiheadAttention``
(attention.py:96-424), rotary positions and per-row cache positions aside.

* Square relative self-attention without weights, an additive mask or a
  cache goes through the kernels: the fused inference kernel in eval mode
  (``ops/attention_kernels.rel_attention``, the JAX dispatch conditions of
  attention.py:237-245), the train kernels in train mode
  (``rel_attention_train``, attention.py:288-348) with dropout on the
  softmax weights at the layer's rate. The per-call seed is an int32 drawn
  on the device from the dropout generator, so no value reaches the host.
* Everything else takes the plain path (attention.py:349-417): scores
  (relative ones through the gathered table), the additive ``attn_mask``
  [Tq, Tk] or [B, Tq, Tk], the key padding fill at ``NEG_INF``, an f32
  softmax cast back to q's dtype, and in train mode dropout on the weights
  from the layer's own generator (flax's semantics; torch cannot replay
  flax's draws, so the two agree at rate 0).
* A clipped table (``L < T``: the encoder's ``encoder_relative_max_size``
  below the length) takes the kernels too, in both modes: the projected
  table [2L-1, D] is expanded by an index gather to [2T-1, D] with row j =
  row clip(j - (T-1) + (L-1), 0, 2L-2), so that bd[q, k] = q_v . p[clip(k -
  q + L - 1)], the clipped shift JAX computes by the gather at inference
  (attention.py:384-387) and the clipped skew in training (:388-397); the
  gather's autograd sums dp back into the clipped rows.
* Decode caches (attention.py:152-218, :419-424): an incremental
  self-attention cache ``{"k", "v"}`` [B, S, H, Dh] takes this step's keys
  and values in place at row ``cache_index`` (a Python int: the decode
  loop's step, so no host sync), and the step attends to rows 0 ..
  cache_index only. JAX attends to all S rows with the later ones masked at
  ``NEG_INF``, whose weights are exact zeros in f32: the same sums up to
  their order (``tests/test_torch_speech_transformer.py``). A
  cross-attention cache ``{"k_static", "v_static"}`` holds the encoder's
  projected keys and values (``make_cross_attention_cache``).

Rotary positions are refused by the encoder's config; a per-row
``cache_index`` (the transformer LM inside the AES beam) raises
``NotImplementedError``.
"""

from __future__ import annotations

import functools
from typing import Dict, Optional, Tuple

import torch
from torch import nn

from espresso_tpu_torch.modules.dropout import Dropout
from espresso_tpu_torch.ops.attention_kernels import rel_attention, rel_attention_train
from espresso_tpu_torch.ops.masking import NEG_INF

Cache = Dict[str, torch.Tensor]


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


@functools.lru_cache(maxsize=None)
def scalar_in(value: float, dtype: torch.dtype) -> float:
    """``value`` rounded to ``dtype`` on the host: a tensor times it rounds
    once, as XLA's product with a weakly typed constant does (a bf16 tensor
    times the bf16 constant)."""
    return float(torch.tensor(value, dtype=dtype))


class MultiheadAttention(nn.Module):
    def __init__(
        self,
        embed_dim: int,
        num_heads: int,
        dropout: float = 0.0,
        use_relative_pos: bool = True,
        kdim: Optional[int] = None,
    ):
        """``kdim``: the width of the keys and values (the encoder's, for
        cross-attention), ``embed_dim`` unless given."""
        super().__init__()
        assert embed_dim % num_heads == 0
        kdim = kdim or embed_dim
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.head_dim = embed_dim // num_heads
        self.use_relative_pos = use_relative_pos
        self.q_proj = nn.Linear(embed_dim, embed_dim)
        self.k_proj = nn.Linear(kdim, embed_dim)
        self.v_proj = nn.Linear(kdim, embed_dim)
        self.out_proj = nn.Linear(embed_dim, embed_dim)
        if use_relative_pos:
            self.pos_proj = nn.Linear(embed_dim, embed_dim, bias=False)
            self.pos_bias_u = nn.Parameter(torch.zeros(num_heads, self.head_dim))
            self.pos_bias_v = nn.Parameter(torch.zeros(num_heads, self.head_dim))
        # the rate and the generator of the weights' dropout (in the train
        # kernel, or on the plain path's weights)
        self.dropout = Dropout(dropout)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        return x.reshape(x.shape[0], x.shape[1], self.num_heads, self.head_dim)

    def forward(
        self,
        query: torch.Tensor,  # [B, Tq, D]
        key: torch.Tensor,  # [B, Tk, kdim]
        value: torch.Tensor,  # [B, Tk, kdim]
        rel_pos: Optional[torch.Tensor] = None,  # [2L-1, D] table
        key_padding_mask: Optional[torch.Tensor] = None,  # [B, Tk] True=valid
        attn_mask: Optional[torch.Tensor] = None,  # additive [Tq, Tk] or [B, Tq, Tk]
        need_weights: bool = False,
        cache: Optional[Cache] = None,
        cache_index: Optional[int] = None,
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        """Returns (out [B, Tq, D], head-averaged weights [B, Tq, Tk] or
        None). With a self-attention ``cache`` the keys are its rows 0 ..
        ``cache_index`` after this call's are written there."""
        B, Tq, D = query.shape
        H = self.num_heads
        q = self.q_proj(query)
        use_rel = self.use_relative_pos and rel_pos is not None
        p_flat = self.pos_proj(rel_pos) if use_rel else None  # [2L-1, D]
        if cache is not None and "k" in cache and key is query:
            if isinstance(cache_index, torch.Tensor) and cache_index.dim() > 0:
                raise NotImplementedError(
                    "a per-row cache_index (the transformer LM in the AES beam) is not ported "
                    "(ROADMAP queue A item 2)"
                )
            step = int(cache_index)
            end = step + Tq
            cache["k"][:, step:end] = self._split(self.k_proj(key)).to(cache["k"].dtype)
            cache["v"][:, step:end] = self._split(self.v_proj(value)).to(cache["v"].dtype)
            k, v = cache["k"][:, :end], cache["v"][:, :end]
            if key_padding_mask is not None:
                key_padding_mask = key_padding_mask[:, :end]
        elif cache is not None and "k_static" in cache:
            k, v = cache["k_static"], cache["v_static"]
        else:
            k = self.k_proj(key)
            v = self.v_proj(value)
            # square relative self-attention; a table clipped below the
            # length (L < T) is expanded to the length's
            if (use_rel and not need_weights and attn_mask is None and key is query
                    and Tq == key.shape[1] >= (p_flat.shape[0] + 1) // 2):
                return self._fused(q, k, v, p_flat, key_padding_mask), None
            k, v = self._split(k), self._split(v)
        q = self._split(q)
        Tk = k.shape[1]
        if use_rel:
            p = p_flat.reshape(-1, H, self.head_dim)
            ac = torch.einsum("bqhd,bkhd->bhqk", q + self.pos_bias_u, k)
            bd = torch.einsum("bqhd,qkhd->bhqk", q + self.pos_bias_v, gather_p_shift(p, Tq, Tk))
            scores = (ac + bd) * scalar_in(self.head_dim ** -0.5, q.dtype)
        else:
            scores = torch.einsum("bqhd,bkhd->bhqk", q, k) * scalar_in(self.head_dim ** -0.5, q.dtype)
        if attn_mask is not None:
            scores = scores + (attn_mask[None, None] if attn_mask.dim() == 2 else attn_mask[:, None])
        if key_padding_mask is not None:
            scores = scores.masked_fill(~key_padding_mask[:, None, None, :], NEG_INF)
        weights = self.dropout(torch.softmax(scores.float(), dim=-1).to(q.dtype))
        out = torch.einsum("bhqk,bkhd->bqhd", weights, v).reshape(B, Tq, D)
        return self.out_proj(out), (weights.mean(dim=1) if need_weights else None)

    def _fused(self, q, k, v, p_flat, key_padding_mask) -> torch.Tensor:
        """Square relative self-attention through B1 (eval) or B2/B3
        (train)."""
        B, T, D = q.shape
        L = (p_flat.shape[0] + 1) // 2
        if L < T:
            # gathered in f32, so that the gather's backward sums the clipped
            # rows' gradients in f32
            p_flat = p_flat.float()[clipped_rows(L, T, p_flat.device)].to(p_flat.dtype)
        kv_mask = (
            key_padding_mask
            if key_padding_mask is not None
            else torch.ones(B, T, dtype=torch.bool, device=q.device)
        )
        q_u, q_v = q + self.pos_bias_u.reshape(D), q + self.pos_bias_v.reshape(D)
        scale = self.head_dim ** -0.5
        if self.training:
            ctx = rel_attention_train(
                q_u, q_v, k, v, p_flat, kv_mask, self._seed(q.device), self.num_heads, scale,
                self.dropout.rate,
            )
        else:
            ctx = rel_attention(q_u, q_v, k, v, p_flat, kv_mask, self.num_heads, scale)
        return self.out_proj(ctx)

    def make_cross_attention_cache(self, encoder_out: torch.Tensor) -> Cache:
        """The encoder's projected keys and values [B, T, H, Dh], once per
        utterance."""
        return {
            "k_static": self._split(self.k_proj(encoder_out)),
            "v_static": self._split(self.v_proj(encoder_out)),
        }

    def _seed(self, device: torch.device) -> torch.Tensor:
        """The dropout seed of one call: an int32 in [0, 2^31 - 1) drawn on
        ``device`` (0 at rate 0, as in JAX)."""
        if self.dropout.rate <= 0.0:
            return torch.zeros(1, dtype=torch.int32, device=device)
        return torch.randint(
            0, 2**31 - 1, (1,), generator=self.dropout.generator, device=device,
            dtype=torch.int32,
        )
