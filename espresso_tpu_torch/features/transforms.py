"""Feature transforms: delta-deltas on the device, and the host data
path's waveform and feature transforms.

Counterpart of ``espresso_tpu/features/transforms.py``: ``delta_deltas``
(transforms.py:20-40) on torch tensors; ``speed_perturb`` (:43),
``choose_speed_rate`` (:61), ``delta_deltas_np`` (:70) and ``NoiseAugment``
(:87) in numpy, as the reference, every draw keyed on ``(seed, epoch,
index)`` by ``np.random.default_rng``, so that a batch is the same whichever
worker collates it.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
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


def speed_perturb(
    waveform: np.ndarray,
    rate: float,
) -> np.ndarray:
    """Resample a waveform by ``rate`` (>1 = faster/shorter) with linear
    interpolation (host-side; the reference uses sox via torchaudio)."""
    if rate == 1.0:
        return waveform
    n_out = int(round(len(waveform) / rate))
    src = np.linspace(0.0, len(waveform) - 1, n_out)
    lo = np.floor(src).astype(np.int64)
    hi = np.minimum(lo + 1, len(waveform) - 1)
    frac = (src - lo).astype(np.float32)
    return (
        waveform[lo] * (1.0 - frac) + waveform[hi] * frac
    ).astype(np.float32)


def choose_speed_rate(
    rates: Sequence[float], seed: int, epoch: int, index: int
) -> float:
    """Per-(seed, epoch, index) deterministic rate choice (reference
    transform seeding, feat_text_dataset.py:151-153)."""
    rng = np.random.default_rng([seed, epoch, index])
    return float(rates[rng.integers(0, len(rates))])


def delta_deltas_np(features: np.ndarray, win: int = 2) -> np.ndarray:
    """NumPy twin of ``delta_deltas`` for the host loading path."""
    denom = 2.0 * sum(i * i for i in range(1, win + 1))

    def delta(x):
        xp = np.pad(x, ((win, win), (0, 0)), mode="edge")
        T = x.shape[0]
        out = np.zeros_like(x)
        for i in range(1, win + 1):
            out += i * (xp[win + i : win + i + T] - xp[win - i : win - i + T])
        return out / denom

    d1 = delta(features)
    d2 = delta(d1)
    return np.concatenate([features, d1, d2], axis=-1).astype(np.float32)


class NoiseAugment:
    """Additive noise from a directory of .wav samples at a random SNR
    (rebuild of fairseq/data/audio/waveform_transforms/noiseaugment.py:20:
    pick a random file, tile/crop to length, mix at U(snr_min, snr_max) dB
    with probability ``rate``). Deterministic per (seed, epoch, index)."""

    def __init__(
        self,
        samples_path: str,
        snr_min: float = 5.0,
        snr_max: float = 15.0,
        rate: float = 0.25,
        seed: int = 1,
    ):
        import glob
        import os

        assert samples_path, "noise_augment_path required"
        self.paths = sorted(
            glob.glob(os.path.join(samples_path, "**", "*.wav"), recursive=True)
        )
        assert self.paths, f"no .wav files under {samples_path}"
        assert snr_max >= snr_min, (snr_min, snr_max)
        self.snr_min, self.snr_max, self.rate = snr_min, snr_max, rate
        self.seed = seed

    def __call__(
        self, wav: np.ndarray, sample_rate: int, epoch: int, index: int
    ) -> np.ndarray:
        rng = np.random.default_rng([self.seed + 17, epoch, index])
        if rng.random() > self.rate:
            return wav
        from espresso_tpu_torch.data.audio import read_audio

        path = self.paths[int(rng.integers(0, len(self.paths)))]
        noise, _ = read_audio(path, "wave")
        if len(noise) == 0:
            return wav
        n_rep = -(-len(wav) // len(noise))
        tiled = np.tile(noise, n_rep)
        start = int(rng.integers(0, len(tiled) - len(wav) + 1))
        noise = tiled[start : start + len(wav)]
        p_src = float(np.mean(wav.astype(np.float64) ** 2))
        p_noise = float(np.mean(noise.astype(np.float64) ** 2))
        if p_noise <= 0:
            return wav
        snr = float(rng.uniform(self.snr_min, self.snr_max))
        scl = np.sqrt(p_src / (10.0 ** (snr / 10.0) * p_noise))
        return (wav + scl * noise).astype(np.float32)
