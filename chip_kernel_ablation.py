"""Where B1 (``rel_attention``), B4 (``rnnt_joint_lp``), B5
(``rnnt_joint_bwd``), B3 (the ``rel_attention_train`` backward), B8
(``aes_merge``) and B10 (``fbank``) spend their time on one NVIDIA H100:
each kernel timed with one part of it left out.

    python3 chip_kernel_ablation.py [SOURCE ...]

Copies ``espresso_tpu_torch/csrc`` into ``_checkout/ablation/csrc_<n>``
(gitignored) for each variant n, inserts a guard ``EXP`` at the part it
leaves out (in the copy only: the sources are not changed), lets the
wrapper build its library from there with ``-DEXP=<n>`` and times it at the flagship shapes (B1:
B=256, T'=156, H=8, d=64; B4 and B5: B=16, T'=256, U1=101, J=512, V=1024;
B3: B=16, T'=256, H=8, d=64, dropout 0.1; B8: B=256, K=10 with the blank
add; B10: the serving batch, B=256, S=100,080) by the profiler's device
time per
kernel. A variant computes wrong outputs; only its time is read. With
source file names as arguments (e.g. ``rel_attention.cu``), only their
variants run. Prints one JSON line per variant, then the card's name and
power limit. Exits nonzero without a card.
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
    ("rel_attention.cu", 22, "the bd window (its stores and skewed reads)", [
        ("    for (int j = 0; j < 16; ++j)\n#pragma unroll\n      for (int hh = 0; hh < 2; ++hh)\n"
         "        *reinterpret_cast<uint32_t*>(win + qr[hh] * WLD",
         "    for (int j = 0; j < 16 * (EXP != 22); ++j)\n#pragma unroll\n      for (int hh = 0; hh < 2; ++hh)\n"
         "        *reinterpret_cast<uint32_t*>(win + qr[hh] * WLD"),
        ("          bdp.x = bdr[0];\n          bdp.y = bdr[1];\n",
         "          bdp = __float2bfloat162_rn(0.f);\n"
         "          if (EXP != 22) {\n          bdp.x = bdr[0];\n          bdp.y = bdr[1];\n          }\n")]),
    ("rel_attention.cu", 23, "the softmax's exp (both passes)", [(
        "__device__ inline float e_of(float x, float m) { return expf(x - m); }",
        "__device__ inline float e_of(float x, float m) { return EXP == 23 ? x - m : expf(x - m); }")]),
    ("rel_attention.cu", 24, "the bd product (the [64 x 128] window)", [(
        "      wgmma_ss_n128<0, 0>(bd, wgmma_desc(base + Layout::qv + 32 * k),",
        "      if (EXP != 24) wgmma_ss_n128<0, 0>(bd, wgmma_desc(base + Layout::qv + 32 * k),")]),
    ("rel_attention.cu", 25, "the PV products (their w fragments kept)", [(
        "        wgmma_rs_n64<1>(o, a[kk],",
        "        if (EXP == 25) o[kk] += __uint_as_float(a[kk][0] ^ a[kk][1] ^ a[kk][2] ^ a[kk][3]);\n"
        "        else wgmma_rs_n64<1>(o, a[kk],")]),
    ("rel_attention.cu", 26, "the scores' scalar work (skewed reads, roundings, max)", [(
        "    if (live) {\n#pragma unroll\n      for (int j = 0; j < 8; ++j) {",
        "    if (live && EXP != 26) {\n#pragma unroll\n      for (int j = 0; j < 8; ++j) {")]),
    ("rnnt_joint_lp.cu", 31, "the consumers' waits for the W stages", [(
        "    mbar_wait(&full[slot], (it / S) & 1);\n    const uint32_t st = base + L::ring + slot * STAGE;",
        "    if (EXP != 31) mbar_wait(&full[slot], (it / S) & 1);\n"
        "    const uint32_t st = base + L::ring + slot * STAGE;")]),
    ("rnnt_joint_lp.cu", 32, "the epilogue's exp", [(
        "    float add = 0.f;\n#pragma unroll\n    for (int j = 0; j < 16; ++j)",
        "    float add = 0.f;\n#pragma unroll\n    for (int j = 0; j < 16 * (EXP != 32); ++j)")]),
    ("rnnt_joint_lp.cu", 33, "the whole epilogue (bias, max, exp, picks)", [(
        "                            const float* __restrict__ bias, int q, RowState& rs) {\n",
        "                            const float* __restrict__ bias, int q, RowState& rs) {\n"
        "  if (EXP == 33) { rs.m[0] += acc[0]; rs.m[1] += acc[63]; return; }\n")]),
    ("rnnt_joint_lp.cu", 34, "the consumers' stores of the joint hidden", [(
        "      jh.store(smem + (pre - base)", "      if (EXP != 34) jh.store(smem + (pre - base)")]),
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
    ("aes_merge.cu", 41, "the dedup (each column keeps its own score)", [
        ("  // exact duplicate merge: logaddexp", "  if (EXP != 41) {\n  // exact duplicate merge: logaddexp"),
        ("  // rank select: slot r", "  } else {\n    for (int c = lane; c < K2; c += 32) comb[c] = merged[c];\n"
         "    __syncwarp();\n  }\n  // rank select: slot r")]),
    ("aes_merge.cu", 42, "the rank select (column c writes slot c mod K)", [(
        "    if (rank < K) {\n      const size_t o = row + rank;",
        "    if (EXP == 42) rank = c < K ? c : K;\n    if (rank < K) {\n      const size_t o = row + rank;")]),
    ("fbank.cu", 31, "the FFT (its three stages and two transposes; z goes to the split as Z)", [
        ("    // stage 1 (f32): 8-point DFT over j", "    if (EXP != 31) {\n    // stage 1 (f32): 8-point DFT over j"),
        ("    // the real spectrum from Z[k] and Z[256 - k], k = lane + 32 i (i < 4),",
         "    } else {\n#pragma unroll\n      for (int j = 0; j < 8; ++j) u[j] = make_double2(z[j].x, z[j].y);\n"
         "    }\n    // the real spectrum from Z[k] and Z[256 - k], k = lane + 32 i (i < 4),")]),
    ("fbank.cu", 33, "the split (|Z[k]|^2 for X[k], no mirror shuffles, no f64 split)", [
        ("    double2 zm[4];\n", "    if (EXP != 33) {\n    double2 zm[4];\n"),
        ("    if (lane == 0) P[NZ / 2] = (float)fma(ZI(4).x, ZI(4).x, ZI(4).y * ZI(4).y);\n",
         "    if (lane == 0) P[NZ / 2] = (float)fma(ZI(4).x, ZI(4).x, ZI(4).y * ZI(4).y);\n    } else {\n"
         "#pragma unroll\n      for (int i = 0; i < 8; ++i) P[lane + 32 * i] = (float)fma(ZI(i).x, ZI(i).x, ZI(i).y * ZI(i).y);\n"
         "    }\n")]),
    ("fbank.cu", 34, "the waveform's copy into shared memory (its cp.async)", [(
        "  for (int i = tid; i < span; i += NTHREADS) {\n    const bool valid",
        "  for (int i = tid; i < span * (EXP != 34); i += NTHREADS) {\n    const bool valid")]),
    ("fbank.cu", 35, "the output stores (the mel bins' logs still formed)", [(
        "      if (meta >= 0) orow[meta >> 16] = logf(fmaxf(acc, kEps));",
        "      const float v = logf(fmaxf(acc, kEps));\n"
        "      if (meta >= 0 && (EXP != 35 || v == 12345.f)) orow[meta >> 16] = v;")]),
    ("fbank.cu", 32, "the mel product (each mel bin reads one power value)", [(
        "      for (int i = 0; i < L; ++i) acc = fmaf(pk[i], wr[32 * i], acc);",
        "      if (EXP == 32) acc = pk[0] * wr[0];\n      else\n"
        "      for (int i = 0; i < L; ++i) acc = fmaf(pk[i], wr[32 * i], acc);")]),
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
    from espresso_tpu_torch.features import fbank_kernels as fk
    from espresso_tpu_torch.ops import attention_kernels as ak
    from espresso_tpu_torch.ops import decode_kernels as dk
    from espresso_tpu_torch.ops import front_kernel_checks as fc
    from espresso_tpu_torch.ops import kernel_checks as kc
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
    b1 = cs.attn_inputs(256, 156, seed=0, dev=dev) + (8, ak.HEAD_DIM ** -0.5)
    S = (cs.FLAGSHIP["T_FRAMES"] - 1) * cs.SHIFT + cs.WINDOW
    w = fc.waveform_inputs(cs.serving_num_samples().tolist(), S, seed=0, dev=dev)
    mi = kc.merge_inputs(256, 10, seed=10, dev=dev, blank_lp=True)
    calls = {
        "rel_attention.cu": lambda: ak.rel_attention(*b1),
        "rnnt_joint_lp.cu": lambda: rk.rnnt_joint_lp(*ja, 0),
        "rnnt_joint_bwd.cu": lambda: rk.rnnt_joint_bwd(*ja, lse, ob, ol, 0),
        "rel_attention_train.cu": lambda: ak.rel_attention_train_bwd(
            *args, a["seed"], a["g"], 8, ak.HEAD_DIM ** -0.5, 0.1),
        "aes_merge.cu": lambda: dk.aes_merge(**mi, round_j=1),
        "fbank.cu": lambda: fk.fbank_fused(w["waveforms"], w["num_samples"]),
    }
    only = set(sys.argv[1:]) or set(calls)
    runs = [(src, 0, "nothing") for src in calls]
    runs += [(src, n, what) for src, n, what, _ in VARIANTS]
    for src_name, exp, what in sorted(runs, key=lambda x: (list(calls).index(x[0]), x[1])):
        if src_name not in only:
            continue
        # the wrappers build and load their library from these on first use
        csrc = os.path.join(root, f"csrc_{exp}")
        variant_sources(csrc, src_name, exp)
        cuda_build.CSRC_DIR, cuda_build.BUILD_DIR = csrc, os.path.join(csrc, "build")
        cuda_build.NVCC_FLAGS = base_flags + (f"-DEXP={exp}",)
        rk._lib.cache_clear()
        ak._lib.cache_clear()
        ak._train_lib.cache_clear()
        fk._lib.cache_clear()
        dk._fn.cache_clear()
        split = cs.device_split(calls[src_name])
        kernels = {}
        for name, ms in split.items():
            m = re.search(r"(rnnt_joint_\w+?_kernel|rel_attention\w*?_kernel|aes_merge_kernel|fbank_kernel)", name)
            if m:
                kernels[m.group(1)] = ms
        print(json.dumps({"source": src_name, "variant": exp, "left_out": what, "ms": kernels}),
              flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
