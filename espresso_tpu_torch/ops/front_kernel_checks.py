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
