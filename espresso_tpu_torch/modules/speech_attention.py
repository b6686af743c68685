"""Bahdanau and Luong attention for the LSTM decoder.

Counterpart of ``espresso_tpu/modules/speech_attention.py`` (:20-78):
single-query attention over the encoder frames, returning (context,
normalised weights). Scores at padded keys become ``NEG_INF``; the softmax
runs in f32 and is cast back to the keys' dtype.

The key projection depends on the encoder output alone. JAX applies it
inside the scanned decoder step, so at every output step; here
``project_keys`` runs once per utterance (``SpeechLSTMModel.encode``) and
each step takes its result: the same product in the same dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from espresso_tpu_torch.ops.masking import NEG_INF


def _attend(
    scores: torch.Tensor, keys: torch.Tensor, key_padding_mask: Optional[torch.Tensor]
) -> Tuple[torch.Tensor, torch.Tensor]:
    if key_padding_mask is not None:
        scores = torch.where(key_padding_mask, scores, torch.full_like(scores, NEG_INF))
    weights = torch.softmax(scores.float(), dim=-1).to(keys.dtype)
    context = torch.bmm(weights[:, None, :], keys)[:, 0]
    return context, weights


class BahdanauAttention(nn.Module):
    """score = v^T tanh(W_q q + W_k k + b), v weight-normalised (``g * v /
    ||v||``); flax ``query_proj``, ``key_proj``, ``v``, ``g``, ``b``."""

    def __init__(self, query_dim: int, key_dim: int, embed_dim: int):
        super().__init__()
        self.query_proj = nn.Linear(query_dim, embed_dim, bias=False)
        self.key_proj = nn.Linear(key_dim, embed_dim, bias=False)
        self.v = nn.Parameter(0.1 * torch.randn(embed_dim))
        self.g = nn.Parameter(torch.ones(()))
        self.b = nn.Parameter(torch.zeros(embed_dim))

    def project_keys(self, keys: torch.Tensor) -> torch.Tensor:
        """[B, T, Dk] -> [B, T, A]."""
        return self.key_proj(keys)

    def forward(
        self,
        query: torch.Tensor,  # [B, Dq]
        keys: torch.Tensor,  # [B, T, Dk]
        key_padding_mask: Optional[torch.Tensor] = None,  # [B, T] True = valid
        projected_keys: Optional[torch.Tensor] = None,  # project_keys(keys)
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        q = self.query_proj(query)
        k = self.project_keys(keys) if projected_keys is None else projected_keys
        vn = self.g * self.v / torch.clamp(torch.linalg.vector_norm(self.v), min=1e-8)
        scores = torch.tanh(q[:, None, :] + k + self.b) @ vn
        return _attend(scores, keys, key_padding_mask)


class LuongAttention(nn.Module):
    """score = g * q^T (W_k k); flax ``key_proj``, ``g``."""

    def __init__(self, query_dim: int, key_dim: int):
        super().__init__()
        self.key_proj = nn.Linear(key_dim, query_dim, bias=False)
        self.g = nn.Parameter(torch.ones(()))

    def project_keys(self, keys: torch.Tensor) -> torch.Tensor:
        """[B, T, Dk] -> [B, T, Dq]."""
        return self.key_proj(keys)

    def forward(
        self,
        query: torch.Tensor,
        keys: torch.Tensor,
        key_padding_mask: Optional[torch.Tensor] = None,
        projected_keys: Optional[torch.Tensor] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        k = self.project_keys(keys) if projected_keys is None else projected_keys
        scores = self.g * torch.bmm(k, query[:, :, None])[..., 0]
        return _attend(scores, keys, key_padding_mask)
