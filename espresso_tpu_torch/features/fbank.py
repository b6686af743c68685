"""Host helpers of the Kaldi log-mel front (numpy, float64 tables), and
the host data path's Kaldi fbank and MFCC.

The port's own copy of ``espresso_tpu/features/fbank.py`` without its jnp
path: the log floor ``_EPS``, Kaldi's frame count (fbank.py:36),
``_next_power_of_two`` (:53), the povey window (:57), the mel scale (:63)
and the Kaldi triangular mel banks (:67), which the on-device front reads;
and ``_frame_and_preprocess_numpy`` (:110), ``fbank_numpy`` (:139),
``mfcc_numpy`` (:168) and ``_dct_matrix`` (:196), which the dataset runs on
the host for ``feature_type`` ``fbank`` and ``mfcc``. The jnp ``fbank``
(:224) is the reference's plain front; the port's is
``fbank_kernels.fbank_plain``.
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


# ---------------------------------------------------------------------------
# The host path: the NumPy Kaldi fbank and MFCC
# ---------------------------------------------------------------------------


def _frame_and_preprocess_numpy(
    waveform: np.ndarray,
    window_size: int,
    window_shift: int,
    preemphasis: float,
    remove_dc_offset: bool,
    dither: float,
) -> np.ndarray:
    num_frames = (
        1 + (len(waveform) - window_size) // window_shift
        if len(waveform) >= window_size
        else 0
    )
    idx = (
        np.arange(num_frames)[:, None] * window_shift
        + np.arange(window_size)[None, :]
    )
    frames = waveform[idx].astype(np.float32).copy()
    if dither > 0.0:
        frames += dither * np.random.randn(*frames.shape).astype(np.float32)
    if remove_dc_offset:
        frames -= frames.mean(axis=1, keepdims=True)
    if preemphasis != 0.0:
        offset = np.concatenate([frames[:, :1], frames[:, :-1]], axis=1)
        frames = frames - preemphasis * offset
    frames *= povey_window(window_size)[None, :]
    return frames


def fbank_numpy(
    waveform: np.ndarray,
    sample_rate: float = 16000.0,
    num_mel_bins: int = 80,
    frame_length: float = 25.0,
    frame_shift: float = 10.0,
    preemphasis: float = 0.97,
    remove_dc_offset: bool = True,
    low_freq: float = 20.0,
    high_freq: float = 0.0,
    dither: float = 0.0,
) -> np.ndarray:
    """Host-side Kaldi fbank oracle: [num_samples] -> [T, num_mel_bins]."""
    waveform = np.asarray(waveform, dtype=np.float32).reshape(-1)
    window_size = round(sample_rate * MILLISECONDS_TO_SECONDS * frame_length)
    window_shift = round(sample_rate * MILLISECONDS_TO_SECONDS * frame_shift)
    padded = _next_power_of_two(window_size)
    frames = _frame_and_preprocess_numpy(
        waveform, window_size, window_shift, preemphasis, remove_dc_offset, dither
    )
    if frames.shape[0] == 0:
        return np.zeros((0, num_mel_bins), dtype=np.float32)
    frames = np.pad(frames, ((0, 0), (0, padded - window_size)))
    spectrum = np.abs(np.fft.rfft(frames, axis=1)) ** 2
    banks = get_mel_banks(num_mel_bins, padded, sample_rate, low_freq, high_freq)
    mel = spectrum @ banks.T
    return np.log(np.maximum(mel, _EPS)).astype(np.float32)


def mfcc_numpy(
    waveform: np.ndarray,
    sample_rate: float = 16000.0,
    num_mel_bins: int = 80,
    num_ceps: int = 40,
    low_freq: float = 20.0,
    high_freq: float = -400.0,
    cepstral_lifter: float = 22.0,
    **kwargs,
) -> np.ndarray:
    """Kaldi MFCC (reference operating point espresso/tools/utils.py:443-449)."""
    logmel = fbank_numpy(
        waveform,
        sample_rate=sample_rate,
        num_mel_bins=num_mel_bins,
        low_freq=low_freq,
        high_freq=high_freq,
        **kwargs,
    )
    dct = _dct_matrix(num_ceps, num_mel_bins)
    feats = logmel @ dct.T
    if cepstral_lifter != 0.0:
        i = np.arange(num_ceps, dtype=np.float64)
        lifter = 1.0 + 0.5 * cepstral_lifter * np.sin(math.pi * i / cepstral_lifter)
        feats *= lifter.astype(np.float32)[None, :]
    return feats.astype(np.float32)


def _dct_matrix(num_ceps: int, num_mel_bins: int) -> np.ndarray:
    """Orthonormal DCT-II matrix, Kaldi convention (row 0 scaled)."""
    n = np.arange(num_mel_bins, dtype=np.float64)
    k = np.arange(num_ceps, dtype=np.float64)[:, None]
    dct = np.cos(math.pi / num_mel_bins * (n + 0.5) * k)
    dct *= math.sqrt(2.0 / num_mel_bins)
    dct[0] *= 1.0 / math.sqrt(2.0)
    return dct.astype(np.float32)
