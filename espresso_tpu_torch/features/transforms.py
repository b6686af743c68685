"""Feature transforms on the device.

Counterpart of ``delta_deltas`` in ``espresso_tpu/features/transforms.py``
(transforms.py:20-40). The host data-path transforms there (speed
perturbation, ``delta_deltas_np``, noise augmentation) are not ported.
"""

from __future__ import annotations

import torch


def delta_deltas(features: torch.Tensor, win: int = 2) -> torch.Tensor:
    """Append delta and delta-delta coefficients: [..., T, F] -> [..., T, 3F].
    Kaldi-style regression deltas with window ``win`` and edge replication."""
    denom = 2.0 * sum(i * i for i in range(1, win + 1))

    def delta(x):
        T = x.shape[-2]
        t = torch.arange(T, device=x.device)
        out = torch.zeros_like(x)
        for i in range(1, win + 1):
            plus = x.index_select(-2, torch.clamp(t + i, max=T - 1))
            minus = x.index_select(-2, torch.clamp(t - i, min=0))
            out = out + i * (plus - minus)
        return out / denom

    d1 = delta(features)
    d2 = delta(d1)
    return torch.cat([features, d1, d2], dim=-1)
