"""SpecAugment on the device: frequency and time masks, adaptive time-mask
multiplicities, and time warp.

Counterpart of ``espresso_tpu/features/specaugment.py``. The JAX function
draws its random numbers from a key inside ``apply_specaugment``; here the
two halves are apart:

* ``draw_specaugment`` makes every random number on the device from a
  ``torch.Generator``, with JAX's distributions and bounds (specaugment.py
  :62-116 and :119-161): the warp anchor's uniform and the warp distance in
  [-W, W]; the frequency masks' widths in [0, F] and starts in
  [0, max(F - 1, 1)) (the top excluded, as JAX's ``randint``); the time
  masks' two uniforms per mask;
* ``apply_specaugment`` is deterministic given those draws, so the tests
  hold it to JAX given JAX's own draws.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Dict, Optional

import torch


@dataclass(frozen=True)
class SpecAugmentConfig:
    freq_mask_width: int = 27  # F
    num_freq_masks: int = 2
    time_mask_width: int = 100  # T (max width, static cap)
    num_time_masks: int = 2  # static cap on count
    time_mask_p: float = 1.0  # p: max fraction of frames one mask may cover
    time_warp_w: int = 0  # W (0 = off)
    # adaptive (espresso): if set, #masks = floor(pm * len), width = ps * len
    time_mask_pm: Optional[float] = None
    time_mask_ps: Optional[float] = None
    max_time_masks: int = 20  # static bound for the adaptive count

    @classmethod
    def from_string(cls, config) -> "SpecAugmentConfig":
        d = ast.literal_eval(config) if isinstance(config, str) else dict(config)
        return cls(
            freq_mask_width=d.get("F", d.get("freq_mask_F", 27)),
            num_freq_masks=d.get("num_freq_masks", d.get("freq_mask_N", 2)),
            time_mask_width=d.get("T", d.get("time_mask_T", 100)),
            num_time_masks=d.get("num_time_masks", d.get("time_mask_N", 2)),
            time_mask_p=d.get("p", d.get("time_mask_p", 1.0)),
            time_warp_w=d.get("W", d.get("time_warp_W", 0)),
            time_mask_pm=d.get("time_mask_pm"),
            time_mask_ps=d.get("time_mask_ps"),
        )

    @property
    def time_mask_cap(self) -> int:
        return self.max_time_masks if self.time_mask_pm is not None else self.num_time_masks


def draw_specaugment(
    B: int, F: int, cfg: SpecAugmentConfig, generator: torch.Generator, device
) -> Dict[str, torch.Tensor]:
    """Every random number of one SpecAugment call on [B, T, F] features,
    drawn on ``device`` without a host sync."""
    rand = lambda *s: torch.rand(*s, generator=generator, device=device)
    randint = lambda lo, hi, s: torch.randint(lo, hi, s, generator=generator, device=device)
    draws = {}
    if cfg.time_warp_w > 0:
        W = cfg.time_warp_w
        draws["warp_u"] = rand(B)  # the anchor w0 in [W, len - W)
        draws["warp_w"] = randint(-W, W + 1, (B,))
    if cfg.num_freq_masks > 0 and cfg.freq_mask_width > 0:
        n = cfg.num_freq_masks
        draws["freq_widths"] = randint(0, cfg.freq_mask_width + 1, (B, n))
        draws["freq_starts"] = randint(0, max(F - 1, 1), (B, n))
    if cfg.time_mask_cap > 0:
        draws["time_u"] = rand(B, cfg.time_mask_cap)
        draws["time_starts_u"] = rand(B, cfg.time_mask_cap)
    return draws


def _interval_mask(length: int, starts: torch.Tensor, widths: torch.Tensor) -> torch.Tensor:
    """OR of [start, start+width) intervals. starts/widths: [B, N] -> [B, length]."""
    pos = torch.arange(length, device=starts.device)[None, None, :]
    inside = (pos >= starts[..., None]) & (pos < (starts + widths)[..., None])
    return inside.any(1)


def apply_specaugment(
    x: torch.Tensor,
    lengths: torch.Tensor,
    draws: Dict[str, torch.Tensor],
    cfg: SpecAugmentConfig,
    mask_value: float = 0.0,
) -> torch.Tensor:
    """SpecAugment of a padded batch x [B, T, F] with lengths [B], given
    the draws of :func:`draw_specaugment` (specaugment.py:62-116)."""
    B, T, F = x.shape
    lengths = lengths.to(torch.int32)
    fill = torch.full((), mask_value, dtype=x.dtype, device=x.device)
    if cfg.time_warp_w > 0:
        x = _time_warp(x, lengths, draws["warp_u"], draws["warp_w"], cfg.time_warp_w)

    if cfg.num_freq_masks > 0 and cfg.freq_mask_width > 0:
        starts = draws["freq_starts"].to(torch.int32)
        widths = torch.minimum(draws["freq_widths"].to(torch.int32), F - starts)
        x = torch.where(_interval_mask(F, starts, widths)[:, None, :], fill, x)

    n_cap = cfg.time_mask_cap
    if n_cap > 0:
        lens_f = lengths.float()
        if cfg.time_mask_pm is not None:
            num_masks = torch.clamp(torch.floor(cfg.time_mask_pm * lens_f).to(torch.int32), 0, n_cap)
            max_width = torch.clamp((cfg.time_mask_ps * lens_f).to(torch.int32), min=1)
        else:
            num_masks = torch.full((B,), cfg.num_time_masks, dtype=torch.int32, device=x.device)
            max_width = torch.full((B,), cfg.time_mask_width, dtype=torch.int32, device=x.device)
        # cap each mask to p * length (the reference's specaugment.py)
        max_width = torch.minimum(
            max_width, torch.clamp((cfg.time_mask_p * lens_f).to(torch.int32), min=1)
        )
        widths = (draws["time_u"] * (max_width[:, None] + 1).float()).to(torch.int32)
        room = torch.clamp(lengths[:, None] - widths, min=0)
        starts = (draws["time_starts_u"] * (room + 1).float()).to(torch.int32)
        active = torch.arange(n_cap, device=x.device)[None, :] < num_masks[:, None]
        widths = torch.where(active, widths, 0)
        x = torch.where(_interval_mask(T, starts, widths)[:, :, None], fill, x)
    return x


def _time_warp(
    x: torch.Tensor, lengths: torch.Tensor, u: torch.Tensor, w: torch.Tensor, W: int
) -> torch.Tensor:
    """Piecewise-linear time warp (specaugment.py:119-161): the anchor w0 in
    [W, len - W) moves to w0 + w, frames re-sampled linearly on each side;
    only where len > 2W + 1."""
    B, T, F = x.shape
    ok = lengths > 2 * W + 1
    hi = torch.clamp(lengths - W, min=W + 1)
    w0 = W + (u * (hi - W).float()).to(torch.int32)
    new_anchor = torch.minimum(torch.clamp(w0 + w.to(torch.int32), min=1),
                               torch.clamp(lengths - 1, min=1))

    t = torch.arange(T, device=x.device)[None, :].float()  # output positions
    anchor = new_anchor[:, None].float()
    w0f = w0[:, None].float()
    lenf = lengths[:, None].float()
    # left segment [0, anchor) maps from [0, w0); right from [w0, len)
    src = torch.where(
        t < anchor,
        t * w0f / torch.clamp(anchor, min=1.0),
        w0f + (t - anchor) * (lenf - w0f) / torch.clamp(lenf - anchor, min=1.0),
    )
    src = torch.minimum(torch.clamp(src, min=0.0), lenf - 1.0)
    lo = torch.floor(src).to(torch.int64)
    frac = (src - lo.float())[..., None]
    # the gather reads frame indices: keep them inside [0, T)
    lo = torch.clamp(lo, 0, T - 1)
    hi_idx = torch.clamp(lo + 1, max=T - 1)
    gathered = (
        torch.gather(x, 1, lo[..., None].expand(B, T, F)) * (1 - frac)
        + torch.gather(x, 1, hi_idx[..., None].expand(B, T, F)) * frac
    )
    out = torch.where((t < lenf)[..., None], gathered, x)
    return torch.where(ok[:, None, None], out, x)
