"""Where B5 (``rnnt_joint_bwd``) and B3 (the ``rel_attention_train``
backward) spend their time on one NVIDIA H100: each kernel timed with one
part of it left out.

    python3 chip_kernel_ablation.py

Copies ``espresso_tpu_torch/csrc`` into ``_checkout/ablation/csrc_<n>``
(gitignored) for each variant n, inserts a guard ``EXP`` at the part it
leaves out (in the copy only: the sources are not changed), lets the
wrapper build its library from there with ``-DEXP=<n>`` and times it at the flagship train shapes (B5:
B=16, T'=256, U1=101, J=512, V=1024; B3: B=16, T'=256, H=8, d=64, dropout
0.1) by the profiler's device time per kernel. A variant computes wrong
gradients; only its time is read. Prints one JSON line per variant, then
the card's name and power limit. Exits nonzero without a card.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# (source, variant, what is left out, [(anchor, replacement), ...])
VARIANTS = [
    ("rnnt_joint_bwd.cu", 1, "rows: the end-of-tile mask and sums (g_enc, g_dec)", [(
        "      // mask by pre > 0: gp[4 j + 2 h + e]",
        "      if (EXP == 1) continue;\n      // mask by pre > 0: gp[4 j + 2 h + e]")]),
    ("rnnt_joint_bwd.cu", 2, "both: the exp and bias of the glog epilogue", [(
        "                                const RowRegs& rr, int h) {\n",
        "                                const RowRegs& rr, int h) {\n"
        "  if (EXP == 2) return logit * rr.ob[h];\n")]),
    ("rnnt_joint_bwd.cu", 3, "both: the second product (g_pre, g_W)", [
        ("        half_product<J>(gp, gt,", "        if (EXP != 3) half_product<J>(gp, gt,"),
        ("        half_product<J>(gw, gt,", "        if (EXP != 3) half_product<J>(gw, gt,")]),
    ("rnnt_joint_bwd.cu", 4, "both: the logits' product", [
        ("        logits32<J>(acc, base + L::pre, wtile, w);",
         "        if (EXP != 4) logits32<J>(acc, base + L::pre, wtile, w);\n"
         "        else for (int z = 0; z < 16; ++z) acc[z] = 0.f;"),
        ("        logits32<J>(acc, pre, base + L::w, w);",
         "        if (EXP != 4) logits32<J>(acc, pre, base + L::w, w);\n"
         "        else for (int z = 0; z < 16; ++z) acc[z] = 0.f;")]),
    ("rnnt_joint_bwd.cu", 5, "cols: the producer's stores of the joint hidden", [(
        "        tf.store(smem + L::ring", "        if (EXP != 5) tf.store(smem + L::ring")]),
    ("rnnt_joint_bwd.cu", 6, "rows: the consumers' stores of the joint hidden", [(
        "      tf.store(smem + L::pre", "      if (EXP != 6) tf.store(smem + L::pre")]),
    ("rnnt_joint_bwd.cu", 7, "rows: the consumers' waits for the W tiles", [(
        "        mbar_wait(&full[slot], (it / S) & 1);\n        float acc[16];",
        "        if (EXP != 7) mbar_wait(&full[slot], (it / S) & 1);\n        float acc[16];")]),
    ("rel_attention_train.cu", 11, "query pass: the dp atomics", [(
        "    add_dp(dp, dpc, j0, T, D, h, qr, f.q);",
        "    if (EXP != 11) add_dp(dp, dpc, j0, T, D, h, qr, f.q);")]),
    ("rel_attention_train.cu", 12, "query pass: the statistics' arithmetic", [(
        "    if (t == 0) refill(it + S);  // every product of the stage is done\n",
        "    if (t == 0) refill(it + S);  // every product of the stage is done\n"
        "    if (EXP == 12) { m[0] = m[1] = s[0]; l[0] = l[1] = 1.f; continue; }\n")]),
    ("rel_attention_train.cu", 13, "query pass: the first sweep's products", [(
        "    float s[32], dw[32];\n    scores(slot, s, dw);\n    if (t == 0) refill(it + S);",
        "    float s[32], dw[32];\n    if (EXP != 13) scores(slot, s, dw);\n"
        "    else { zero(s); zero(dw); named_sync(1, THREADS); }\n    if (t == 0) refill(it + S);")]),
    ("rel_attention_train.cu", 14, "key pass: the w and ds arithmetic (hash, exp)", [(
        "#pragma unroll\n    for (int n = 0; n < 8; ++n)\n#pragma unroll\n      for (int e2 = 0; e2 < 2; ++e2) {",
        "#pragma unroll\n    for (int n = 0; n < 8 * (EXP != 14); ++n)\n#pragma unroll\n"
        "      for (int e2 = 0; e2 < 2; ++e2) {")]),
]


def variant_sources(dst: str, src_name: str, exp: int) -> None:
    """csrc/ copied to dst with the guards of variant ``exp`` in ``src_name``
    (the other variants' guards are not inserted)."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "espresso_tpu_torch", "csrc"), dst,
                    ignore=shutil.ignore_patterns("build"))
    path = os.path.join(dst, src_name)
    with open(path) as f:
        s = "#ifndef EXP\n#define EXP 0\n#endif\n" + f.read()
    for src, n, _, edits in VARIANTS:
        if src != src_name or n != exp:
            continue
        for anchor, replacement in edits:
            if s.count(anchor) != 1:
                raise RuntimeError(f"variant {n}: anchor not found once in {src}: {anchor!r}")
            s = s.replace(anchor, replacement)
    with open(path, "w") as f:
        f.write(s)


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_kernel_ablation: no CUDA card available", file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import chip_smoke as cs
    from espresso_tpu_torch.ops import attention_kernels as ak
    from espresso_tpu_torch.ops import cuda_build
    from espresso_tpu_torch.ops import rnnt_kernels as rk
    from espresso_tpu_torch.ops import train_kernel_checks as tc
    from espresso_tpu_torch.ops.backend import require_cuda

    dev = require_cuda()
    torch.backends.cuda.matmul.allow_tf32 = False
    root = os.path.join(HERE, "_checkout", "ablation")
    base_flags = cuda_build.NVCC_FLAGS
    B, T, U, J, V = 16, 256, 100, 512, 1024
    r = tc.rnnt_inputs(B, T, U, J, V, seed=V + T, dev=dev, blank=0)
    ja = (r["enc_proj"], r["dec_proj"], r["fc_kernel"], r["fc_bias"], r["targets"])
    lpb, lpl, lse = rk.rnnt_joint_lp_reference(*ja, 0)
    ob, ol = tc.occupancy_grads(r, lpb, lpl)
    a = tc.attention_train_inputs(B, T, seed=T, dev=dev)
    args = (a["q_u"], a["q_v"], a["k"], a["v"], a["p"], a["key_valid"])
    calls = {
        "rnnt_joint_bwd.cu": lambda: rk.rnnt_joint_bwd(*ja, lse, ob, ol, 0),
        "rel_attention_train.cu": lambda: ak.rel_attention_train_bwd(
            *args, a["seed"], a["g"], 8, ak.HEAD_DIM ** -0.5, 0.1),
    }
    runs = [(src, 0, "nothing") for src in calls]
    runs += [(src, n, what) for src, n, what, _ in VARIANTS]
    for src_name, exp, what in sorted(runs, key=lambda x: (x[0] != "rnnt_joint_bwd.cu", x[1])):
        # the wrappers build and load their library from these on first use
        csrc = os.path.join(root, f"csrc_{exp}")
        variant_sources(csrc, src_name, exp)
        cuda_build.CSRC_DIR, cuda_build.BUILD_DIR = csrc, os.path.join(csrc, "build")
        cuda_build.NVCC_FLAGS = base_flags + (f"-DEXP={exp}",)
        rk._lib.cache_clear()
        ak._train_lib.cache_clear()
        split = cs.device_split(calls[src_name])
        kernels = {}
        for name, ms in split.items():
            m = re.search(r"(rnnt_joint_bwd_\w+?_kernel|rel_attention_train_bwd_\w+?_kernel)", name)
            if m:
                kernels[m.group(1)] = ms
        print(json.dumps({"source": src_name, "variant": exp, "left_out": what, "ms": kernels}),
              flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
