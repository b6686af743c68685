"""Time the train-step kernels B5 (``rnnt_joint_bwd``), B3 (the
``rel_attention_train`` backward) and B2 (its forward) on one NVIDIA H100,
kernel by kernel.

    cd <checkout> && python3 <this repo>/chip_train_kernels.py [--yardsticks]

Imports ``espresso_tpu_torch`` from the current directory, so the same script
times any checkout of the port (a parent unpacked by ``git archive`` beside
the change), and the timing helpers from the ``chip_smoke.py`` beside it. At
the flagship train shapes (B5: B=16, T'=256, U1=101, J=512, V=1024; B3 and
B2: B=16, T'=256, H=8, d=64, dropout 0.1) it prints, per kernel, one JSON
line:
the device ms per call of the kernels whose names carry the wrapper's name
(``ms``, the filter ``chip_smoke.py`` uses), of every kernel the call runs
(``ms_all``, the wrapper's own ``torch`` allocations and fills included),
CUDA-event ms of back-to-back calls (``ms_events``), and the split by
kernel name; with ``--yardsticks`` also cuBLAS's time for B5's three
products alone and ``scaled_dot_product_attention``'s backward at B3's
shape and its forward with the same dropout at B2's. With ``--train-step``
it times the flagship train step instead (``chip_smoke.run_train``: 10
steps after a warm-up, host clock, then a profiled step), so that repeated
runs of two checkouts in turns resolve the step's spread. With
``--peak-memory`` it prints the bytes one B5 call allocates above what was
allocated before it (its outputs and its workspace) at the flagship lattice
(T'=256) and at the transducer recipe's lattice budget
(``conformer_transducer_librispeech.yaml``'s max_tokens 590,000 cells:
B=16, T'=365, U1=101), then the flagship train step's peak allocated bytes
(``chip_smoke.run_train``). Then the card's name and power limit. Exits
nonzero without a card.
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


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_train_kernels: no CUDA card available", file=sys.stderr)
        return 1
    cs = _chip_smoke()
    from espresso_tpu_torch.ops import attention_kernels as ak
    from espresso_tpu_torch.ops import cuda_build
    from espresso_tpu_torch.ops import rnnt_kernels as rk
    from espresso_tpu_torch.ops import train_kernel_checks as tc
    from espresso_tpu_torch.ops.backend import require_cuda

    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    if "--train-step" in sys.argv[1:]:
        t = cs.run_train(dev)
        print(json.dumps({"train_ms_per_step": t["ms_per_step"],
                          "profile": {k: v for k, v in t["profile"].items() if k != "top_kernels"}}))
        print(cs.card_line())
        return 0
    if "--peak-memory" in sys.argv[1:]:
        row = {}
        for T in (256, 365):
            r = tc.rnnt_inputs(16, T, 100, 512, 1024, seed=1024 + T, dev=dev, blank=0)
            ja = (r["enc_proj"], r["dec_proj"], r["fc_kernel"], r["fc_bias"], r["targets"])
            lpb, lpl, lse = rk.rnnt_joint_lp_reference(*ja, 0)
            ob, ol = tc.occupancy_grads(r, lpb, lpl)
            rk.rnnt_joint_bwd(*ja, lse, ob, ol, 0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats(dev)
            base = torch.cuda.memory_allocated(dev)
            out = rk.rnnt_joint_bwd(*ja, lse, ob, ol, 0)
            torch.cuda.synchronize()
            row[f"rnnt_joint_bwd_T{T}_call_bytes"] = torch.cuda.max_memory_allocated(dev) - base
            del r, ja, lpb, lpl, lse, ob, ol, out
            torch.cuda.empty_cache()
        t = cs.run_train(dev)
        row.update(train_peak_gb=t["peak_gb"], train_ms_per_step=t["ms_per_step"])
        print(json.dumps(row))
        print(cs.card_line())
        return 0
    yardsticks = "--yardsticks" in sys.argv[1:]
    libs = {"rnnt_joint_bwd": rk.LIBRARIES["rnnt_joint_bwd"],
            "rel_attention_train": ak.LIBRARIES["rel_attention_train"]}
    cuda_build.build_many(libs.items())
    for name, srcs in libs.items():
        cs.log(cuda_build.build_log(name, srcs))

    def report(name, fn, kernel, **extra):
        row = dict(kernel=name, ms=cs.device_ms(fn, kernel=kernel), ms_all=cs.device_ms(fn),
                   ms_events=cs.median_ms(fn), split=cs.device_split(fn), **extra)
        print(json.dumps(row), flush=True)

    B, T, U, J, V = 16, 256, 100, 512, 1024
    r = tc.rnnt_inputs(B, T, U, J, V, seed=V + T, dev=dev, blank=0)
    ja = (r["enc_proj"], r["dec_proj"], r["fc_kernel"], r["fc_bias"], r["targets"])
    lpb, lpl, lse = rk.rnnt_joint_lp_reference(*ja, 0)
    ob, ol = tc.occupancy_grads(r, lpb, lpl)
    extra = {"cublas_products_ms": cs.rnnt_bwd_cublas_ms(B, T, U + 1, J, V, dev)} if yardsticks else {}
    report("rnnt_joint_bwd", lambda: rk.rnnt_joint_bwd(*ja, lse, ob, ol, 0), "rnnt_joint_bwd", **extra)
    del r, ja, lpb, lpl, lse, ob, ol
    torch.cuda.empty_cache()

    H, rate = 8, 0.1
    a = tc.attention_train_inputs(B, T, seed=T, dev=dev)
    args = (a["q_u"], a["q_v"], a["k"], a["v"], a["p"], a["key_valid"])
    extra = {"sdpa_bwd_ms": cs.sdpa_bwd_ms(B, T, H, ak.HEAD_DIM, rate, dev)} if yardsticks else {}
    report("rel_attention_train_bwd",
           lambda: ak.rel_attention_train_bwd(*args, a["seed"], a["g"], H, ak.HEAD_DIM ** -0.5, rate),
           "rel_attention_train_bwd", **extra)
    extra = ({"sdpa_fwd_dropout_ms": cs.sdpa_fwd_ms(B, T, H, ak.HEAD_DIM, dev, rate)}
             if yardsticks else {})
    report("rel_attention_train_fwd",
           lambda: ak.rel_attention_train_fwd(*args, a["seed"], H, ak.HEAD_DIM ** -0.5, rate),
           "rel_attention_train_fwd", **extra)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
