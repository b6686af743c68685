"""Time B8 (``aes_merge``), B9 (``aes_backtrace``) and B10 (``fbank``) on one
NVIDIA H100, and count the device kernels of a profiled beam batch, in any
checkout of the port.

    cd <checkout> && python3 <this repo>/chip_merge_fbank.py

Imports ``espresso_tpu_torch`` from the current directory, so the same script
times any checkout (a parent unpacked by ``git archive`` beside the change;
``chip_compare.sh`` runs it in turns after each ``chip_smoke.py``), and the
timing helpers from the ``chip_smoke.py`` beside it. Prints one JSON line:

- B8 at B=256, K=10: device ms a call (profiler, ``aes_merge_kernel``),
  and the wrapper's host us a call (median of 200 calls with no sync), for
  the blank add and the call on its sum (``merge_unfused_host_us``, the
  beam decoder's call before the add was folded in) and, where the wrapper
  takes ``blank_lp``, for the call with it (``merge_host_us``);
- B9's device ms a call (profiler, ``aes_backtrace_kernel``) at the
  flagship beam batch's backtrace (T'=156, B=256, K=10, n_exp=2);
- B10's device ms at the serving batch (B=256, S=100,080) and at the
  PCM-fed train point (B=16, S=164,080);
- one flagship beam batch (B=256, T=624, beam 10) under the profiler after
  a warm-up batch: its device kernels, busy ms, and B8's ms and launches.

Then the card's name and power limit. Exits nonzero without a card.
"""

from __future__ import annotations

import importlib.util
import json
import os
import sys

import torch

sys.path.insert(0, os.getcwd())


def _chip_smoke():
    here = os.path.dirname(os.path.abspath(__file__))
    spec = importlib.util.spec_from_file_location("chip_smoke", os.path.join(here, "chip_smoke.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def merge_inputs(B: int, K: int, dev) -> dict:
    """Seeded B8 inputs that take only the wrapper's oldest arguments: live
    and dead scores, duplicate hashes, and a blank log-prob [B, K]."""
    g = torch.Generator().manual_seed(K)
    pool = -20 * torch.rand(B, K, generator=g)
    pool[:, K - K // 3:] = -1.0e9
    ints = lambda hi: torch.randint(0, hi, (B, K), generator=g, dtype=torch.int32).to(dev)
    return dict(
        pool_scores=pool.to(dev), blank_scores=(-20 * torch.rand(B, K, generator=g)).to(dev),
        pool_hash=ints(K // 2), exp_hash=ints(K // 2), pool_ver=ints(3), pool_slot=ints(K),
        blank_lp=(-torch.rand(B, K, generator=g)).to(dev),
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_merge_fbank: no CUDA card available", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    from espresso_tpu_torch.data.dictionary import AsrDictionary
    from espresso_tpu_torch.decode.transducer_beam import TransducerBeamSearchDecoder
    from espresso_tpu_torch.features import fbank_kernels as fk
    from espresso_tpu_torch.ops import decode_kernels as dk
    from espresso_tpu_torch.ops import front_kernel_checks as fc
    from espresso_tpu_torch.ops import kernel_checks as kc
    from espresso_tpu_torch.ops.backend import require_cuda

    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    out = {"checkout": os.getcwd()}

    m = merge_inputs(256, 10, dev)
    pre = {k: v for k, v in m.items() if k != "blank_lp"}
    pre["blank_scores"] = (m["blank_scores"] + m["blank_lp"]).contiguous()
    out["merge_ms"] = cs.device_ms(lambda: dk.aes_merge(**pre, round_j=1), kernel="aes_merge_kernel",
                                   per_call=1)
    hosts = cs.merge_host_us(dk, m)
    out["merge_unfused_host_us"] = hosts["unfused_host_us"]
    out["merge_host_us"] = hosts.get("host_us")

    b = kc.backtrace_inputs(156, 256, 10, 2, V=cs.FLAGSHIP["VOCAB"], seed=156, dev=dev)
    out["backtrace_ms"] = cs.device_ms(lambda: dk.aes_backtrace(**b, n_exp=2),
                                       kernel="aes_backtrace_kernel", per_call=1)
    del b

    S = (cs.FLAGSHIP["T_FRAMES"] - 1) * cs.SHIFT + cs.WINDOW
    a = fc.waveform_inputs(cs.serving_num_samples().tolist(), S, seed=0, dev=dev)
    out["fbank_ms"] = cs.device_ms(lambda: fk.fbank_fused(a["waveforms"], a["num_samples"]),
                                   kernel="fbank_kernel", per_call=1)
    St, Bt = (cs.TRAIN["T_FRAMES"] - 1) * cs.SHIFT + cs.WINDOW, cs.TRAIN["B"]
    at = fc.waveform_inputs([St] * Bt, St, seed=2, dev=dev)
    out["fbank_train_ms"] = cs.device_ms(lambda: fk.fbank_fused(at["waveforms"], at["num_samples"]),
                                         kernel="fbank_kernel", per_call=1)
    del a, at

    model, batch = cs.flagship_model(dev), cs.flagship_batch(dev)
    decoder = TransducerBeamSearchDecoder(model, AsrDictionary(enable_bos=True), **cs.BEAM)
    decoder.decode(batch)
    torch.cuda.synchronize()
    prof = cs.profile_batch(decoder, batch)
    out["beam_device_kernels"] = prof["device_kernels"]
    out["beam_busy_ms"] = prof["device_busy_ms"]
    out["beam_merge_ms_launches"] = prof["decode_kernels"]["aes_merge_kernel"]
    print(json.dumps(out), flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
