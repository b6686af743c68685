"""Fused Kaldi log-mel fbank on the device (Hopper).

Counterpart of ``espresso_tpu/features/pallas_fbank.py``. Its TPU kernel,
``fbank_pallas`` (pallas_fbank.py:177-237), and the production twin it
shadows, ``fbank_fused`` (:91-137), compute the same function; here it is
the hand-written CUDA C++ kernel ``csrc/fbank.cu`` for ``sm_90a``:

    waveforms [B, S] f32 (int16 scale), num_samples [B] int32
    -> log-mel frames [B, T, M] f32, lengths [B] int32

with T = max(1 + (S - window) // shift, 1) from the static S, so the front
makes no host sync. The recipe's 25 ms window and 10 ms shift are fixed
(400 and 160 samples at 16 kHz). Per frame: DC removal,
pre-emphasis 0.97 (x[0] paired with itself), the povey window, the power
spectrum by cos/sin DFT products over the 512-point DFT's bins in full fp32,
the Kaldi mel product and ``log(max(mel, _EPS))``. Lengths are
``1 + (n - window) // shift`` (0 under one window), clipped to T; frames
past a length are zero.

``fbank_plain`` is the torch composition of JAX ``fbank_fused``
(chunk-concat framing, fp32 matmuls). On a CPU tensor ``fbank_fused`` runs
it; on a CUDA tensor it launches the kernel or raises, and counts its
launches (``fbank_fused.launches``).
"""

from __future__ import annotations

import ctypes
import functools
import math
from typing import Dict, Tuple

import numpy as np
import torch

from espresso_tpu_torch.features.fbank import (
    _EPS,
    _next_power_of_two,
    get_mel_banks,
    num_samples_to_num_frames,
    povey_window,
)

LIBRARIES = {"fbank": ("fbank.cu",)}
PREEMPHASIS = 0.97
FRAME_LENGTH_MS, FRAME_SHIFT_MS = 25.0, 10.0


@functools.lru_cache(maxsize=8)
def _dft_mel_matrices(window_size: int, padded: int, num_mel_bins: int, sample_rate: float):
    """Real-DFT cos/sin bases [window, padded//2+1] (the zero-padded rows
    dropped) and the mel banks transposed [padded//2+1, M], float64 tables
    rounded to f32 (pallas_fbank.py:47-64)."""
    n = np.arange(padded)[:, None]
    k = np.arange(padded // 2 + 1)[None, :]
    ang = 2.0 * math.pi * n * k / padded
    cos = np.cos(ang)[:window_size]
    sin = -np.sin(ang)[:window_size]
    banks = get_mel_banks(num_mel_bins, padded, sample_rate)  # [M, padded//2+1]
    return (
        cos.astype(np.float32),
        sin.astype(np.float32),
        np.ascontiguousarray(banks.T).astype(np.float32),
    )


def _geometry(S: int, sample_rate: float):
    window = round(sample_rate * 1e-3 * FRAME_LENGTH_MS)
    shift = round(sample_rate * 1e-3 * FRAME_SHIFT_MS)
    padded = _next_power_of_two(window)
    T = max(num_samples_to_num_frames(S, sample_rate, FRAME_LENGTH_MS, FRAME_SHIFT_MS), 1)
    return window, shift, padded, T


@functools.lru_cache(maxsize=16)
def _tables(
    device: torch.device, window: int, padded: int, M: int, sample_rate: float
) -> Dict[str, torch.Tensor]:
    """The tables on ``device``, copied there once per device and geometry.
    The bases keep the padded//2 bins below Nyquist (the mel banks' Nyquist
    row is zero, so that bin adds exactly 0), and each mel bin gets the
    range of DFT bins where its weights are not zero (for the kernel)."""
    cos, sin, mel_t = _dft_mel_matrices(window, padded, M, float(sample_rate))
    nb = padded // 2
    assert not mel_t[nb].any(), "the mel banks' Nyquist row must be zero"
    nz = mel_t[:nb] != 0  # [nb, M]
    lo = np.where(nz.any(0), nz.argmax(0), 0).astype(np.int32)
    hi = np.where(nz.any(0), nb - nz[::-1].argmax(0), 0).astype(np.int32)
    host = dict(
        cos=np.ascontiguousarray(cos[:, :nb]), sin=np.ascontiguousarray(sin[:, :nb]),
        mel_t=np.ascontiguousarray(mel_t[:nb]), window=povey_window(window),
        mel_lo=lo, mel_hi=hi,
    )
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


def fbank_lengths(num_samples: torch.Tensor, window: int, shift: int, T: int) -> torch.Tensor:
    lengths = torch.where(
        num_samples >= window, 1 + torch.div(num_samples - window, shift, rounding_mode="floor"), 0
    )
    return torch.clamp(lengths, max=T).to(torch.int32)


def fbank_plain(
    waveforms: torch.Tensor,
    num_samples: torch.Tensor,
    sample_rate: float = 16000.0,
    num_mel_bins: int = 80,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain version of :func:`fbank_fused` (pallas_fbank.py:91-137): the
    torch composition, fp32 throughout (on the card TF32 must be off)."""
    B, S = waveforms.shape
    window, shift, padded, T = _geometry(S, sample_rate)
    assert window <= 3 * shift, "chunk-concat framing needs window <= 3*shift"
    tab = _tables(waveforms.device, window, padded, num_mel_bins, float(sample_rate))
    x = waveforms.float()
    need = (T + 2) * shift
    if S < need:
        x = torch.nn.functional.pad(x, (0, need - S))
    chunks = x[:, :need].reshape(B, T + 2, shift)
    parts = [chunks[:, :T], chunks[:, 1 : T + 1]]
    if window > 2 * shift:
        parts.append(chunks[:, 2 : T + 2, : window - 2 * shift])
    frames = torch.cat(parts, -1)[:, :, :window]  # [B, T, window]
    frames = frames - frames.mean(-1, keepdim=True)
    offset = torch.cat([frames[..., :1], frames[..., :-1]], -1)
    frames = (frames - PREEMPHASIS * offset) * tab["window"]
    re = frames @ tab["cos"]
    im = frames @ tab["sin"]
    mel = (re * re + im * im) @ tab["mel_t"]
    logmel = torch.log(torch.clamp(mel, min=_EPS))
    lengths = fbank_lengths(num_samples, window, shift, T)
    valid = torch.arange(T, device=x.device)[None, :] < lengths[:, None]
    return torch.where(valid[..., None], logmel, 0.0), lengths


_P, _I = ctypes.c_void_p, ctypes.c_int


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    from espresso_tpu_torch.ops import cuda_build

    lib = cuda_build.load("fbank", LIBRARIES["fbank"])
    # wave, num_samples, cos, sin, window, mel_t, mel_lo, mel_hi, out, lengths;
    # B, S, T, window, shift, n_bins, M, device; stream
    lib.fbank_f32.argtypes = [_P] * 10 + [_I] * 8 + [_P]
    lib.fbank_f32.restype = _I
    return lib


def fbank_fused(
    waveforms: torch.Tensor,
    num_samples: torch.Tensor,
    sample_rate: float = 16000.0,
    num_mel_bins: int = 80,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, S] waveforms and [B] sample counts -> ([B, T, M] f32 log-mel
    frames, [B] int32 lengths)."""
    if waveforms.device.type == "cpu":
        return fbank_plain(waveforms, num_samples, sample_rate, num_mel_bins)
    if waveforms.device.type != "cuda":
        raise ValueError(f"fbank_fused: unsupported device {waveforms.device}")
    if waveforms.dim() != 2 or num_samples.shape != (waveforms.shape[0],):
        raise ValueError(
            f"fbank_fused: waveforms {tuple(waveforms.shape)} must be [B, S] and "
            f"num_samples {tuple(num_samples.shape)} [B]"
        )
    if num_samples.device != waveforms.device:
        raise ValueError(f"fbank_fused: num_samples must be on {waveforms.device}")
    B, S = waveforms.shape
    window, shift, padded, T = _geometry(S, sample_rate)
    n_bins = padded // 2
    if n_bins % 4 or n_bins > 256 or window > 512:
        raise ValueError(f"fbank_fused: the kernel takes up to 256 bins and a 512-sample "
                         f"window, not {n_bins} bins and {window}")
    tab = _tables(waveforms.device, window, padded, num_mel_bins, float(sample_rate))
    x = waveforms.float().contiguous()
    ns = num_samples.to(torch.int32).contiguous()
    out = torch.empty(B, T, num_mel_bins, dtype=torch.float32, device=x.device)
    lengths = torch.empty(B, dtype=torch.int32, device=x.device)
    device = x.device.index
    rc = _lib().fbank_f32(
        x.data_ptr(), ns.data_ptr(), tab["cos"].data_ptr(), tab["sin"].data_ptr(),
        tab["window"].data_ptr(), tab["mel_t"].data_ptr(), tab["mel_lo"].data_ptr(),
        tab["mel_hi"].data_ptr(), out.data_ptr(), lengths.data_ptr(),
        B, S, T, window, shift, n_bins, num_mel_bins, device,
        torch.cuda.current_stream(device).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"fbank_fused launch failed: CUDA error {rc}")
    fbank_fused.launches += 1
    return out, lengths


fbank_fused.launches = 0
