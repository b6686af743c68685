"""Cross-entropy losses with label smoothing (uniform / unigram / temporal).

Counterpart of ``espresso_tpu/ops/losses.py``, the semantics of espresso's
label_smoothed_cross_entropy_v2:
  * uniform — eps_i = eps/(V-1); loss = (1-eps-eps_i)*nll + eps_i*(-sum lp)
  * unigram — smoothing distribution proportional to token unigram counts
    with a pseudo-count
  * temporal — probability mass on target-sequence neighbors at distance
    ±1/±2 with a 5:2 ratio (arXiv:1612.02695)

Every function takes padded [B, U, V] logits with a [B, U] validity mask
and computes in f32 whatever the logits' dtype.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F


def log_softmax(logits: torch.Tensor, dim: int = -1) -> torch.Tensor:
    return torch.log_softmax(logits.float(), dim=dim)


def _nll(lprobs: torch.Tensor, target: torch.Tensor) -> torch.Tensor:
    return -lprobs.gather(-1, target.long().unsqueeze(-1)).squeeze(-1)


def cross_entropy_loss(
    logits: torch.Tensor, target: torch.Tensor, mask: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Summed NLL over valid positions. Returns (loss_sum, nll_sum)."""
    nll = torch.where(mask.bool(), _nll(log_softmax(logits), target), 0.0)
    total = nll.sum()
    return total, total


def temporal_smoothing_weights(
    target: torch.Tensor, vocab_size: int, pad_index: int
) -> torch.Tensor:
    """[B, U, V] neighbor smoothing distribution: weights 2, 5, 5, 2 on the
    targets at offsets -2, -1, +1, +2 (pad beyond the ends), none on pad,
    normalised per position (by at least 1)."""
    B, U = target.shape
    target = target.long()
    pad = lambda n: torch.full((B, n), pad_index, dtype=target.dtype, device=target.device)
    weights = torch.zeros((B, U, vocab_size), dtype=torch.float32, device=target.device)
    for offset, w in ((-2, 2.0), (-1, 5.0), (1, 5.0), (2, 2.0)):
        if offset < 0:
            idx = torch.cat([pad(-offset), target[:, :offset]], 1)
        else:
            idx = torch.cat([target[:, offset:], pad(offset)], 1)
        weights = weights + w * F.one_hot(idx, vocab_size).float()
    weights[:, :, pad_index] = 0.0
    return weights / weights.sum(-1, keepdim=True).clamp(min=1.0)


def label_smoothed_cross_entropy(
    logits: torch.Tensor,
    target: torch.Tensor,
    mask: torch.Tensor,
    epsilon: float,
    smoothing_type: str = "uniform",
    pad_index: int = 0,
    unigram_probs: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Summed label-smoothed CE. Returns (loss_sum, nll_sum).

    logits: [B, U, V]; target: [B, U] int; mask: [B, U] bool/float.
    """
    lprobs = log_softmax(logits)
    V = lprobs.shape[-1]
    nll = _nll(lprobs, target)
    if smoothing_type == "uniform":
        smooth = -lprobs.sum(-1)
        eps_i = epsilon / (V - 1)
        coeff_nll, coeff_smooth = 1.0 - epsilon - eps_i, eps_i
    elif smoothing_type == "unigram":
        assert unigram_probs is not None
        smooth = -(lprobs @ unigram_probs.to(lprobs.dtype))
        coeff_nll, coeff_smooth = 1.0 - epsilon, epsilon
    elif smoothing_type == "temporal":
        probs = temporal_smoothing_weights(target, V, pad_index)
        smooth = -(lprobs * probs).sum(-1)
        coeff_nll, coeff_smooth = 1.0 - epsilon, epsilon
    else:
        raise ValueError(f"unsupported smoothing type {smoothing_type!r}")
    m = mask.to(lprobs.dtype)
    nll_sum = (nll * m).sum()
    smooth_sum = (smooth * m).sum()
    loss = coeff_nll * nll_sum + coeff_smooth * smooth_sum
    return loss, nll_sum


def unigram_probs_from_counts(
    counts: np.ndarray, pseudo_count: float, pad_index: int
) -> np.ndarray:
    """Unigram smoothing distribution from dictionary counts."""
    c = np.asarray(counts, dtype=np.float64) + pseudo_count
    c[pad_index] = 0.0
    return (c / c.sum()).astype(np.float32)
