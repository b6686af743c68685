"""Inputs and checks that hold the feature front's fbank kernel and the w8a8
kernel against their plain versions on the card, shared by
``tests/test_torch_cuda.py`` and ``chip_smoke.py``.

``waveform_inputs`` and ``int8_inputs`` make seeded inputs at a given shape
on a given device; each ``check_*`` runs the wrapper (which must launch its
kernel once) and the plain version on the same inputs, raises
``AssertionError`` on a disagreement beyond the stated bound, and returns
the error.
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np
import torch

from espresso_tpu_torch.features import fbank_kernels as fk
from espresso_tpu_torch.ops import quantization as qz

# fbank: the goldens' rule (tests/test_features.py): bins within 70 dB of
# their frame's peak agree to 5e-4 in log, every bin to 5e-5 of the frame's
# peak energy in linear. Both sides run fp32 products summed in other
# orders; quieter bins are spectral leakage with unbounded relative error.
FBANK_LOG_TOL = 5e-4
FBANK_LIN_TOL = 5e-5
DB70 = 70 * math.log(10) / 10

Tensors = Dict[str, torch.Tensor]


def waveform_inputs(
    num_samples: Sequence[int], S: int, seed: int, dev, sample_rate: float = 16000.0
) -> Tensors:
    """int16-scale noise plus two tones per utterance below Nyquist, zero
    past each count: ``waveforms`` [B, S] f32 and ``num_samples`` [B] int32."""
    rng = np.random.default_rng(seed)
    B = len(num_samples)
    t = torch.arange(S, dtype=torch.float64) / sample_rate
    g = torch.Generator().manual_seed(seed)
    wav = torch.randn(B, S, generator=g, dtype=torch.float64) * 2000.0
    for b in range(B):
        f1, f2 = rng.uniform(100, sample_rate / 2 - 100, 2)
        wav[b] += 8000 * torch.sin(2 * math.pi * f1 * t) + 3000 * torch.sin(2 * math.pi * f2 * t)
    ns = torch.tensor(list(num_samples), dtype=torch.int32)
    wav[torch.arange(S)[None, :] >= ns[:, None].long()] = 0.0
    return {"waveforms": wav.float().to(dev), "num_samples": ns.to(dev)}


def check_fbank(a: Tensors, num_mel_bins: int = 80, sample_rate: float = 16000.0) -> Dict[str, float]:
    """Kernel vs plain version by the goldens' rule; lengths equal and the
    frames past each length exactly zero. Returns the worst log error on
    the loud bins and the worst linear error relative to the frame's peak."""
    before = fk.fbank_fused.launches
    out, lengths = fk.fbank_fused(a["waveforms"], a["num_samples"], sample_rate, num_mel_bins)
    torch.cuda.synchronize()
    assert fk.fbank_fused.launches == before + 1
    ref, ref_len = fk.fbank_plain(a["waveforms"], a["num_samples"], sample_rate, num_mel_bins)
    assert out.shape == ref.shape, (tuple(out.shape), tuple(ref.shape))
    assert torch.equal(lengths, ref_len), (lengths.tolist(), ref_len.tolist())
    T = out.shape[1]
    valid = (torch.arange(T, device=out.device)[None, :] < lengths[:, None])[..., None]
    assert not bool((out.masked_select(~valid.expand_as(out)) != 0).any()), "tails not zero"
    assert bool(torch.isfinite(out).all())
    out, ref = out.double(), ref.double()
    loud = (ref - ref.amax(-1, keepdim=True) >= -DB70) & valid
    log_err = (out - ref).abs().masked_select(loud).max().item() if bool(loud.any()) else 0.0
    lin = (out.exp() - ref.exp()).abs() / ref.exp().amax(-1, keepdim=True)
    lin_err = lin.masked_select(valid.expand_as(lin)).max().item() if bool(valid.any()) else 0.0
    assert log_err < FBANK_LOG_TOL and lin_err < FBANK_LIN_TOL, (log_err, lin_err)
    return {"log": log_err, "linear": lin_err}


def fbank_float64(
    waveforms: torch.Tensor, num_samples: torch.Tensor, sample_rate: float = 16000.0,
    num_mel_bins: int = 80,
) -> torch.Tensor:
    """``fbank_plain``'s composition in float64 on the inputs' device, with
    the same tables (rounded to f32, as JAX's function defines them): the
    function itself, near exactly, for holding the kernel and the plain
    version each against it. Returns [B, T, M] float64 log-mel frames."""
    B, S = waveforms.shape
    window, shift, padded, T = fk._geometry(S, sample_rate)
    tab = {k: v.double() for k, v in fk._tables(
        waveforms.device, window, padded, num_mel_bins, float(sample_rate)).items()}
    x = waveforms.double()
    need = (T + 2) * shift
    if S < need:
        x = torch.nn.functional.pad(x, (0, need - S))
    chunks = x[:, :need].reshape(B, T + 2, shift)
    parts = [chunks[:, :T], chunks[:, 1 : T + 1]]
    if window > 2 * shift:
        parts.append(chunks[:, 2 : T + 2, : window - 2 * shift])
    frames = torch.cat(parts, -1)[:, :, :window]
    frames = frames - frames.mean(-1, keepdim=True)
    offset = torch.cat([frames[..., :1], frames[..., :-1]], -1)
    frames = (frames - fk.PREEMPHASIS * offset) * tab["window"]
    re, im = frames @ tab["cos"], frames @ tab["sin"]
    mel = (re * re + im * im) @ tab["mel_t"]
    return torch.log(torch.clamp(mel, min=fk._EPS))


def fbank_error_sources(a: Tensors, num_mel_bins: int = 80, sample_rate: float = 16000.0) -> Dict[str, float]:
    """The kernel and the plain version each against :func:`fbank_float64`
    on the bins within 70 dB of their frame's peak: the worst log error of
    each, and of the two against each other. Raises if the kernel is past
    FBANK_LOG_TOL from the float64 function."""
    out, lengths = fk.fbank_fused(a["waveforms"], a["num_samples"], sample_rate, num_mel_bins)
    plain, _ = fk.fbank_plain(a["waveforms"], a["num_samples"], sample_rate, num_mel_bins)
    ref = fbank_float64(a["waveforms"], a["num_samples"], sample_rate, num_mel_bins)
    T = out.shape[1]
    valid = (torch.arange(T, device=out.device)[None, :] < lengths[:, None])[..., None]
    loud = (ref - ref.amax(-1, keepdim=True) >= -DB70) & valid
    err = lambda x, r: (x.double() - r.double()).abs().masked_select(loud).max().item()
    res = {"kernel_vs_f64": err(out, ref), "plain_vs_f64": err(plain, ref), "kernel_vs_plain": err(out, plain)}
    if not res["kernel_vs_f64"] < FBANK_LOG_TOL:
        raise AssertionError(f"fbank at {sample_rate} Hz against the float64 function: {res}")
    return res


def int8_inputs(M: int, K: int, N: int, seed: int, dev, dtype=torch.float32) -> Tensors:
    """x [M, K] at a LayerNorm-like scale (row 0 all zero, to take the scale
    floor), and a [K, N] f32 weight quantized per output channel; ``w_q`` is
    the transposed view of the [N, K] int8 tensor (the card's layout)."""
    g = torch.Generator().manual_seed(seed)
    x = torch.randn(M, K, generator=g) * 2.0
    x[0] = 0.0
    w = torch.randn(N, K, generator=g) / math.sqrt(max(K, 1))  # nn.Linear layout
    q, s = qz.quantize_int8(w.numpy(), axis=0)
    return {
        "x": x.to(dev, dtype),
        "w_q": torch.from_numpy(q).to(dev).t(),
        "w_scale": torch.from_numpy(s).to(dev),
    }


def check_int8_matmul(a: Tensors) -> float:
    """Kernel vs plain version, bit for bit; returns the max abs error (0)."""
    before = qz.int8_matmul.launches
    out = qz.int8_matmul(a["x"], a["w_q"], a["w_scale"])
    torch.cuda.synchronize()
    assert qz.int8_matmul.launches == before + 1
    ref = qz.int8_matmul_plain(a["x"], a["w_q"], a["w_scale"])
    assert out.shape == ref.shape and bool(torch.isfinite(out).all())
    err = (out - ref).abs().max().item() if out.numel() else 0.0
    n_diff = int((out != ref).sum())
    assert n_diff == 0, f"int8_matmul differs from its plain version in {n_diff} outputs ({err})"
    return err
