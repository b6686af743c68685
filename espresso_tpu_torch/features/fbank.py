"""Host helpers of the Kaldi log-mel front (numpy, float64 tables).

The port's own copy of what ``espresso_tpu/features/fbank.py`` gives the
on-device front: the log floor ``_EPS``, Kaldi's frame count
(fbank.py:36), ``_next_power_of_two`` (:53), the povey window (:57), the
mel scale (:63) and the Kaldi triangular mel banks (:67). The host data
path's ``fbank_numpy``, ``mfcc_numpy`` and the rfft ``fbank`` (:224) are not
ported.
"""

from __future__ import annotations

import math

import numpy as np

_EPS = 1.1920928955078125e-07  # float32 machine epsilon (Kaldi log floor)
MILLISECONDS_TO_SECONDS = 0.001


def num_samples_to_num_frames(
    num_samples: int,
    sample_rate: float = 16000.0,
    frame_length: float = 25.0,
    frame_shift: float = 10.0,
    snip_edges: bool = True,
) -> int:
    """Kaldi frame count (feature-window.cc:42)."""
    window_shift = round(sample_rate * MILLISECONDS_TO_SECONDS * frame_shift)
    if snip_edges:
        window_size = round(sample_rate * MILLISECONDS_TO_SECONDS * frame_length)
        if num_samples < window_size:
            return 0
        return int(1 + (num_samples - window_size) // window_shift)
    return int((num_samples + window_shift // 2) // window_shift)


def _next_power_of_two(n: int) -> int:
    return 1 if n == 0 else 2 ** (n - 1).bit_length()


def povey_window(window_size: int) -> np.ndarray:
    n = np.arange(window_size, dtype=np.float64)
    hann = 0.5 - 0.5 * np.cos(2.0 * math.pi * n / (window_size - 1))
    return (hann ** 0.85).astype(np.float32)


def mel_scale(freq):
    return 1127.0 * np.log(1.0 + freq / 700.0)


def get_mel_banks(
    num_bins: int,
    padded_window_size: int,
    sample_rate: float,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
) -> np.ndarray:
    """Kaldi triangular mel filterbank matrix, [num_bins, nfft//2 + 1]; the
    last (Nyquist) column is zero, as in torchaudio's layout."""
    nyquist = 0.5 * sample_rate
    if high_freq <= 0.0:
        high_freq = nyquist + high_freq
    assert 0.0 <= low_freq < high_freq <= nyquist
    num_fft_bins = padded_window_size // 2
    fft_bin_width = sample_rate / padded_window_size
    mel_low = mel_scale(low_freq)
    mel_high = mel_scale(high_freq)
    mel_delta = (mel_high - mel_low) / (num_bins + 1)

    bin_idx = np.arange(num_bins, dtype=np.float64)[:, None]
    left_mel = mel_low + bin_idx * mel_delta
    center_mel = mel_low + (bin_idx + 1.0) * mel_delta
    right_mel = mel_low + (bin_idx + 2.0) * mel_delta

    freqs = fft_bin_width * np.arange(num_fft_bins, dtype=np.float64)[None, :]
    mel = mel_scale(freqs)
    up = (mel - left_mel) / (center_mel - left_mel)
    down = (right_mel - mel) / (right_mel - center_mel)
    banks = np.maximum(0.0, np.minimum(up, down))
    banks = np.concatenate([banks, np.zeros((num_bins, 1), dtype=banks.dtype)], axis=1)
    return banks.astype(np.float32)
