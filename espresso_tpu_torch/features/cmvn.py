"""Cepstral mean/variance normalization.

Counterpart of ``espresso_tpu/features/cmvn.py``: global CMVN from an
``.npz`` of ``mean``/``std`` (``GlobalCMVN``), the host accumulation of
those stats (``compute_global_cmvn_stats``, float64 as JAX) and
utterance-level CMVN over the valid frames (``utterance_cmvn``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch


class GlobalCMVN:
    def __init__(self, stats_npz_path: str):
        stats = np.load(stats_npz_path)
        self.mean = torch.from_numpy(np.asarray(stats["mean"], np.float32))
        self.std = torch.from_numpy(np.asarray(stats["std"], np.float32))

    def to(self, device) -> "GlobalCMVN":
        """Move the stats to ``device``; to the card from pinned memory with
        non-blocking copies, so the first batch's step makes no host sync
        either."""
        if torch.device(device).type == "cuda":
            self.mean, self.std = (
                t.pin_memory().to(device, non_blocking=True) for t in (self.mean, self.std)
            )
        else:
            self.mean, self.std = self.mean.to(device), self.std.to(device)
        return self

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        return (x - self.mean) / self.std


def compute_global_cmvn_stats(frames_iter) -> dict:
    """Accumulate mean/std in float64 over an iterator of [T, F] arrays or
    tensors (espresso/tools/compute_global_cmvn_stats.py semantics)."""
    count = 0
    total = total_sq = None
    for mat in frames_iter:
        if isinstance(mat, torch.Tensor):
            mat = mat.detach().cpu().numpy()
        mat = np.asarray(mat, dtype=np.float64)
        if total is None:
            total = mat.sum(axis=0)
            total_sq = (mat ** 2).sum(axis=0)
        else:
            total += mat.sum(axis=0)
            total_sq += (mat ** 2).sum(axis=0)
        count += mat.shape[0]
    mean = total / count
    var = total_sq / count - mean ** 2
    return {
        "mean": mean.astype(np.float32),
        "std": np.sqrt(np.maximum(var, 1e-10)).astype(np.float32),
    }


def utterance_cmvn(
    x: torch.Tensor,
    lengths: Optional[torch.Tensor] = None,
    norm_means: bool = True,
    norm_vars: bool = False,
) -> torch.Tensor:
    """Per-utterance CMVN over valid frames. x: [B, T, F] or [T, F]."""
    squeeze = x.dim() == 2
    if squeeze:
        x = x[None]
    B, T, F = x.shape
    if lengths is None:
        mask = torch.ones(B, T, 1, dtype=x.dtype, device=x.device)
        denom = torch.full((B, 1, 1), T, dtype=x.dtype, device=x.device)
    else:
        mask = (torch.arange(T, device=x.device)[None, :] < lengths[:, None]).to(x.dtype)[..., None]
        denom = torch.clamp(lengths[:, None, None].to(x.dtype), min=1.0)
    mean = torch.sum(x * mask, dim=1, keepdim=True) / denom
    out = (x - mean) * mask if norm_means else x
    if norm_vars:
        var = torch.sum(((x - mean) * mask) ** 2, dim=1, keepdim=True) / denom
        out = out / torch.sqrt(torch.clamp(var, min=1e-10))
        out = out * mask
    return out[0] if squeeze else out
