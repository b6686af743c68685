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
spectrum of the 512-point DFT (no TF32 or bf16 anywhere), the Kaldi mel
product and ``log(max(mel, _EPS))``. Lengths are ``1 + (n - window) //
shift`` (0 under one window), clipped to T; frames past a length are zero.

The kernel computes the power spectrum by a real FFT: the frame packed as
256 complex points, a 256-point FFT in three stages (8 x 8 x 4, the
twiddles of :func:`fft_twiddles`; the first stage in f32, the rest in
f64), and the split into the 256 bins below Nyquist. Its host tables: the
window zero-padded to 512, the twiddles, and the mel banks as a schedule
of rounds of 32 lanes (:func:`mel_schedule`). Windows of up to 256 samples
(8 kHz: 200) run the same kernel on its tables: the frame is zero past the
window, so a smaller DFT's bins are the 512-point FFT's bins at a stride,
and the mel schedule reads those (:func:`kernel_mel_banks`). Windows of
513 to 8192 samples (22.05 to 192 kHz) run the kernel's 1024-, 2048-,
4096- and 8192-point instances: a first radix-R stage in f32 (R = 2, 4, 8,
16), then R 256-point FFTs in f64. Windows past 8192 samples (352.8 and 384
kHz: a 16384-point DFT; any larger power of two) run the large instance: a
persistent grid of one block an SM, a block on one frame at a time, a
radix-2 FFT whose first stage is f32 and the rest f64, its workspace in
shared memory at 16384 points and in a global buffer of a slice a block
above (:func:`large_workspace_bytes`; it does not grow with the frames).
Any shift takes the kernel (44.1 kHz: 441 samples).

``fbank_plain`` is the torch composition of JAX ``fbank_fused``
(chunk-concat framing, fp32 matmuls with the cos/sin DFT bases). On a CPU
tensor ``fbank_fused`` runs it; on a CUDA tensor it launches the kernel or
raises, and counts its launches (``fbank_fused.launches``).
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
    n = np.arange(window_size)[:, None]  # the zero-padded rows add nothing
    k = np.arange(padded // 2 + 1)[None, :]
    ang = 2.0 * math.pi * n * k / padded
    cos = np.cos(ang)
    sin = -np.sin(ang)
    return cos.astype(np.float32), sin.astype(np.float32), _mel_matrix(padded, num_mel_bins, sample_rate)


@functools.lru_cache(maxsize=8)
def _mel_matrix(padded: int, num_mel_bins: int, sample_rate: float) -> np.ndarray:
    """The mel banks transposed [padded//2+1, M], rounded to f32 (the third
    of :func:`_dft_mel_matrices`, without the DFT bases the kernel does not
    read)."""
    banks = get_mel_banks(num_mel_bins, padded, sample_rate)  # [M, padded//2+1]
    return np.ascontiguousarray(banks.T).astype(np.float32)


def _geometry(S: int, sample_rate: float):
    window = round(sample_rate * 1e-3 * FRAME_LENGTH_MS)
    shift = round(sample_rate * 1e-3 * FRAME_SHIFT_MS)
    padded = _next_power_of_two(window)
    # no frame count without a shift: the caller refuses that framing
    T = 1
    if shift >= 1:
        T = max(num_samples_to_num_frames(S, sample_rate, FRAME_LENGTH_MS, FRAME_SHIFT_MS), 1)
    return window, shift, padded, T


@functools.lru_cache(maxsize=16)
def _tables(
    device: torch.device, window: int, padded: int, M: int, sample_rate: float
) -> Dict[str, torch.Tensor]:
    """The plain version's tables on ``device``, copied there once per
    device and geometry. The bases keep the padded//2 bins below Nyquist
    (the mel banks' Nyquist row is zero, so that bin adds exactly 0)."""
    cos, sin, mel_t = _dft_mel_matrices(window, padded, M, float(sample_rate))
    nb = padded // 2
    assert not mel_t[nb].any(), "the mel banks' Nyquist row must be zero"
    host = dict(
        cos=np.ascontiguousarray(cos[:, :nb]), sin=np.ascontiguousarray(sin[:, :nb]),
        mel_t=np.ascontiguousarray(mel_t[:nb]), window=povey_window(window),
    )
    return {k: torch.from_numpy(v).to(device) for k, v in host.items()}


# the kernel's FFT: 512 real points as FFT_POINTS complex ones, 8 x 8 x 4;
# its larger instances take up to MAX_FFT_SIZE points, the large instance
# any power of two above
FFT_SIZE = 512
FFT_POINTS = FFT_SIZE // 2
TW3 = 32  # where the split's twiddles start in fft_twiddles()[1]
MAX_FFT_SIZE = 8192
KERNEL_FFT_SIZES = (512, 1024, 2048, 4096, 8192)
# the large instance's workspace a block (NZ f64 points and NZ f32 powers)
# lives in shared memory up to this many points, in a global buffer above
LARGE_SMEM_FFT_SIZE = 16384
# the larger instances' f64 table: w256^(l k1) at 32 k1 + l, w32^(l1 k2a)
# from TWL_32, w_N^k from TWL_SPLIT
TWL_32, TWL_SPLIT = 256, 288


@functools.lru_cache(maxsize=None)
def fft_twiddles(nfft: int = FFT_SIZE) -> Tuple[np.ndarray, np.ndarray]:
    """The kernel's twiddles for an ``nfft``-point real FFT as (real,
    imaginary) pairs of float64 values, w_N = exp(-2 pi i / N).

    At 512 points:

    * tw1 [256, 2] rounded to f32: w256^(l k1) at 32 k1 + l (k1 < 8, l <
      32), after the first 8-point DFT (over j of n = l + 32 j), which
      runs in f32;
    * tw23 [161, 2] f64: w32^(l1 k2a) at 4 k2a + l1 (k2a < 8, l1 < 4),
      after the second (over l2 of l = l1 + 4 l2), then w512^k for k =
      0..128 from TW3 on, for the split of the packed transform Z into
      the real one X.

    Past MAX_FFT_SIZE (the large instance), NZ = nfft / 2 packed points:

    * tw1 [NZ / 2, 2] rounded to f32: w_NZ^p, the first radix-2 stage's;
    * tw23 [NZ + 1, 2] f64: w_NZ^k for k < NZ / 2 (the later stages'),
      then w_nfft^k for k <= NZ / 2 (the split's).

    At nfft = 512 R (R = 2, 4, 8, 16), NZ = 256 R packed points:

    * tw1 [257 R, 2] rounded to f32, the first (radix-R) stage's: w_NZ^(m
      q) at 256 q + m (q < R, m < 256), then w_R^j at 256 R + j;
    * tw23 [288 + NZ, 2] f64: w256^(l k1) at 32 k1 + l, w32^(l1 k2a) at
      TWL_32 + 4 k2a + l1, w_nfft^k for k < NZ at TWL_SPLIT + k.
    """
    assert nfft in KERNEL_FFT_SIZES or (nfft > MAX_FFT_SIZE and nfft & (nfft - 1) == 0), nfft
    pair = lambda w: np.stack([w.real, w.imag], 1)
    if nfft > MAX_FFT_SIZE:
        NZ = nfft // 2
        w1 = np.exp(-2j * np.pi * np.arange(NZ // 2) / NZ)
        wd = np.concatenate([w1, np.exp(-2j * np.pi * np.arange(NZ // 2 + 1) / nfft)])
        return pair(w1).astype(np.float32), pair(wd)
    k1, lane = np.arange(8)[:, None], np.arange(32)[None, :]
    k2a, l1 = np.arange(8)[:, None], np.arange(4)[None, :]
    w256 = np.exp(-2j * np.pi * k1 * lane / 256).reshape(-1)
    w32 = np.exp(-2j * np.pi * k2a * l1 / 32).reshape(-1)
    if nfft == FFT_SIZE:
        w23 = np.concatenate([w32, np.exp(-2j * np.pi * np.arange(FFT_POINTS // 2 + 1) / FFT_SIZE)])
        return pair(w256).astype(np.float32), pair(w23)
    R, NZ = nfft // FFT_SIZE, nfft // 2
    q, m = np.arange(R)[:, None], np.arange(256)[None, :]
    wa = np.concatenate([np.exp(-2j * np.pi * q * m / NZ).reshape(-1),
                         np.exp(-2j * np.pi * np.arange(R) / R)])
    wd = np.concatenate([w256, w32, np.exp(-2j * np.pi * np.arange(NZ) / nfft)])
    return pair(wa).astype(np.float32), pair(wd)


def kernel_fft_size(padded: int) -> int:
    """The kernel instance that computes a ``padded``-point DFT: 512 points
    for any smaller one (its bins are the 512-point bins at a stride), the
    DFT's own size above."""
    return max(FFT_SIZE, padded)


def mel_rounds(mel_t: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """The schedule of :func:`mel_schedule` with each lane's mel bin and
    first DFT bin apart: (weights, bins [R, 32] int32 (-1 for a lane without
    a bin), k0 [R, 32] int32, L [R] int32)."""
    nb, M = mel_t.shape
    nz = mel_t != 0
    lo = np.where(nz.any(0), nz.argmax(0), 0)
    hi = np.where(nz.any(0), nb - nz[::-1].argmax(0), 0)
    order = np.argsort(-(hi - lo), kind="stable")
    R = -(-M // 32)
    lens = np.array([(hi - lo)[order[32 * r : 32 * r + 32]].max() for r in range(R)], np.int32)
    weights = np.zeros((int(lens.sum()), 32), np.float32)
    bins = np.full((R, 32), -1, np.int32)
    k0s = np.zeros((R, 32), np.int32)
    row = 0
    for r in range(R):
        for lane, m in enumerate(order[32 * r : 32 * r + 32]):
            k0 = min(int(lo[m]), nb - int(lens[r]))
            weights[row : row + lens[r], lane] = mel_t[k0 : k0 + lens[r], m]
            bins[r, lane], k0s[r, lane] = m, k0
        row += int(lens[r])
    return weights, bins, k0s, lens


def mel_schedule(mel_t: np.ndarray) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """The kernel's mel product for the banks ``mel_t`` [nb, M] (DFT bins
    below Nyquist by mel bins). The bins go longest non-zero DFT range
    first, 32 to a round, a lane each; all lanes of round r take L_r steps,
    its longest range: the lane of bin m sums P[k0 + i] * w[i] for i < L_r,
    k0 = min(lo_m, nb - L_r), with w the bin's weights over those bins.
    Outside the bin's range w is zero, and a zero term adds exactly 0, so
    the sum is the range's sum in DFT-bin order. Returns the weights
    [sum L_r, 32] f32 (round r's step i at row sum_{r' < r} L_r' + i),
    meta [R, 32] int32 (m << 16 | k0; -1 << 16 for a lane without a bin)
    and the steps L [R] int32 (k0 must fit in 16 bits: up to 131072
    points; the large instance takes :func:`mel_rounds`' pairs)."""
    weights, bins, k0s, lens = mel_rounds(mel_t)
    assert k0s.max(initial=0) < 1 << 16, "the packed schedule holds k0 in 16 bits"
    meta = np.where(bins >= 0, (bins.astype(np.int64) << 16) | k0s, -1 << 16).astype(np.int32)
    return weights, meta, lens


def kernel_mel_banks(window: int, padded: int, M: int, sample_rate: float) -> np.ndarray:
    """The mel banks over the kernel's power bins (those below its FFT's
    Nyquist), [kernel_fft_size(padded) / 2, M]: the padded-point banks as
    they are at 512 points and above; below 512 points (8 kHz: 256) each
    DFT bin k's row at the kernel's bin k 512 / padded and zero rows
    between, so that the mel product sums the smaller DFT's powers in bin
    order (a zero term adds exactly 0)."""
    assert padded & (padded - 1) == 0, padded
    mel_t = _mel_matrix(padded, M, float(sample_rate))
    nb = padded // 2
    assert not mel_t[nb].any(), "the mel banks' Nyquist row must be zero"
    nfft = kernel_fft_size(padded)
    out = np.zeros((nfft // 2, M), np.float32)
    out[:: nfft // padded] = mel_t[:nb]
    return out


@functools.lru_cache(maxsize=16)
def _kernel_tables(
    device: torch.device, window: int, M: int, sample_rate: float
) -> Dict[str, torch.Tensor]:
    """The kernel's tables on ``device``, once per device and geometry: the
    window zero-padded to the kernel's FFT size, the twiddles, the mel
    schedule; ``nfft`` the kernel instance's size."""
    padded = _next_power_of_two(window)
    nfft = kernel_fft_size(padded)
    banks = kernel_mel_banks(window, padded, M, sample_rate)
    if nfft > MAX_FFT_SIZE:
        # the large instance: each lane's (mel bin, first DFT bin) as a pair
        mel_w, bins, k0s, mel_len = mel_rounds(banks)
        mel_meta = np.stack([bins, k0s], -1)
    else:
        mel_w, mel_meta, mel_len = mel_schedule(banks)
    win = np.zeros(nfft, np.float32)
    win[:window] = povey_window(window)
    tw1, tw23 = fft_twiddles(nfft)
    host = dict(window=win, tw1=tw1, tw23=tw23, mel_w=mel_w, mel_meta=mel_meta, mel_len=mel_len)
    out = {k: torch.from_numpy(np.ascontiguousarray(v)).to(device) for k, v in host.items()}
    out["mel_steps"] = int(mel_len.sum())
    out["nfft"] = nfft
    return out


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
    # wave, num_samples, window, tw1, tw23, mel_w, mel_meta, mel_len, out,
    # lengths; B, S, T, window, shift, M, mel_steps, nfft, device; stream
    lib.fbank_f32.argtypes = [_P] * 10 + [_I] * 9 + [_P]
    lib.fbank_f32.restype = _I
    # the same tables (mel_meta as pairs), out, lengths, work; B, S, T,
    # window, shift, M, nfft, grid, device; stream
    lib.fbank_large_f32.argtypes = [_P] * 11 + [_I] * 9 + [_P]
    lib.fbank_large_f32.restype = _I
    return lib


def large_grid(device: torch.device, frames: int) -> int:
    """The large instance's persistent grid: one block an SM, at most one a
    frame."""
    return max(1, min(torch.cuda.get_device_properties(device).multi_processor_count, frames))


def large_workspace_bytes(nfft: int, grid: int) -> int:
    """The large instance's global workspace: none where a block's (NZ f64
    points and NZ f32 powers, NZ = nfft / 2) fits in shared memory, else that
    slice for each block of the grid: a bound set by the card, not by the
    number of frames."""
    return 0 if nfft <= LARGE_SMEM_FFT_SIZE else grid * (nfft // 2) * 20


def fbank_fused(
    waveforms: torch.Tensor,
    num_samples: torch.Tensor,
    sample_rate: float = 16000.0,
    num_mel_bins: int = 80,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """[B, S] waveforms and [B] sample counts -> ([B, T, M] f32 log-mel
    frames, [B] int32 lengths). On the card any window of 1 to
    MAX_FFT_SIZE (8192) samples and any shift of at least 1 (with the
    plain version's framing, window <= 3 * shift) take the kernel: up to
    512 points its 512-point instance (a smaller DFT's bins are its bins at
    a stride: 8 kHz), above it the 1024-, 2048-, 4096- and 8192-point
    instances (22.05 to 192 kHz), past them the large instance (352.8 kHz
    and up). Only a framing the plain version refuses raises."""
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
    if window < 1 or shift < 1 or window > 3 * shift:
        raise ValueError(
            f"fbank_fused: window {window} and shift {shift} at {sample_rate} Hz: the framing "
            "needs 1 <= window <= 3 * shift"
        )
    tab = _kernel_tables(waveforms.device, window, num_mel_bins, float(sample_rate))
    x = waveforms.float().contiguous()
    ns = num_samples.to(torch.int32).contiguous()
    out = torch.empty(B, T, num_mel_bins, dtype=torch.float32, device=x.device)
    lengths = torch.empty(B, dtype=torch.int32, device=x.device)
    device = x.device.index
    stream = torch.cuda.current_stream(device).cuda_stream
    tables = (x.data_ptr(), ns.data_ptr(), tab["window"].data_ptr(), tab["tw1"].data_ptr(),
              tab["tw23"].data_ptr(), tab["mel_w"].data_ptr(), tab["mel_meta"].data_ptr(),
              tab["mel_len"].data_ptr(), out.data_ptr(), lengths.data_ptr())
    if tab["nfft"] > MAX_FFT_SIZE:
        grid = large_grid(x.device, B * T)
        n_work = large_workspace_bytes(tab["nfft"], grid)
        work = torch.empty(n_work, dtype=torch.uint8, device=x.device) if n_work else None
        rc = _lib().fbank_large_f32(
            *tables, None if work is None else work.data_ptr(), B, S, T, window, shift,
            num_mel_bins, tab["nfft"], grid, device, stream,
        )
    else:
        rc = _lib().fbank_f32(
            *tables, B, S, T, window, shift, num_mel_bins, tab["mel_steps"], tab["nfft"], device,
            stream,
        )
    if rc != 0:
        raise RuntimeError(f"fbank_fused launch failed: CUDA error {rc}")
    fbank_fused.launches += 1
    return out, lengths


fbank_fused.launches = 0
