"""Where B1 (``rel_attention``), B4 (``rnnt_joint_lp``), B5
(``rnnt_joint_bwd``), B3 and B2 (the ``rel_attention_train`` backward and
forward), B8 (``aes_merge``), B9 (``aes_backtrace``), B10 (``fbank``) and
B11 (``int8_matmul``) spend their time on one NVIDIA H100: each kernel timed with one part of it
left out, or with another setting of one of its constants.

    python3 chip_kernel_ablation.py [TARGET ...]

Copies ``espresso_tpu_torch/csrc`` into ``_checkout/ablation/csrc_<n>``
(gitignored) for each variant n, inserts a guard ``EXP`` at the part it
leaves out (in the copy only: the sources are not changed), lets the
wrapper build its library from there with ``-DEXP=<n>`` and times it at the
flagship shapes (B1: B=256, T'=156, H=8, d=64; B4 and B5: B=16, T'=256,
U1=101, J=512, V=1024; B3 and B2: B=16, T'=256, H=8, d=64, dropout 0.1; B8:
B=256, K=10 with the blank add; B9: T'=156, B=256, K=10, n_exp=2; B10: the
serving batch, B=256, S=100,080; B11: 39,936 x 512 . 512 x 2048; B1 also
in its long-row mode at B=4, T'=1500) by the profiler's device time per
kernel.
A variant computes wrong outputs; only its time is read, as the mean device
time of one launch over a trace of 20 calls. A target is the
source it times (``rel_attention.cu``; ``rel_attention_train.cu`` for B3)
or ``rel_attention_train_fwd`` for B2; with targets as arguments only
their variants run. B1's and B2's blocks share ``rel_attention_fwd.cuh``, so
some of their variants patch it. Prints one JSON line per variant, then the
card's name and power limit. Exits nonzero without a card.
"""

from __future__ import annotations

import json
import os
import re
import shutil
import sys

import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# the source a target's variants patch, where it is not the target itself
TARGET_FILES = {"rel_attention_train_fwd": "rel_attention_train.cu"}
FWD = "rel_attention_fwd.cuh"  # the block B1 and B2 share
# (target, variant, what is left out, [(anchor, replacement) in the target's
# source, or (file, anchor, replacement), ...])
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
        (FWD, "    for (int j = 0; j < 16; ++j)\n#pragma unroll\n      for (int hh = 0; hh < 2; ++hh)\n"
         "        *reinterpret_cast<uint32_t*>(win + qr[hh] * WLD",
         "    for (int j = 0; j < 16 * (EXP != 22); ++j)\n#pragma unroll\n      for (int hh = 0; hh < 2; ++hh)\n"
         "        *reinterpret_cast<uint32_t*>(win + qr[hh] * WLD"),
        (FWD, "          bdp.x = bdr[0];\n          bdp.y = bdr[1];\n",
         "          bdp = __float2bfloat162_rn(0.f);\n"
         "          if (EXP != 22) {\n          bdp.x = bdr[0];\n          bdp.y = bdr[1];\n          }\n")]),
    ("rel_attention.cu", 23, "the softmax's exp (both passes)", [(
        FWD, "__device__ inline float e_of(float x, float m) { return expf(x - m); }",
        "__device__ inline float e_of(float x, float m) { return EXP == 23 ? x - m : expf(x - m); }")]),
    ("rel_attention.cu", 24, "the bd product (the [64 x 128] window)", [(
        FWD, "      wgmma_ss_n128<0, 0>(bd, wgmma_desc(base + Layout::qv + 32 * k),",
        "      if (EXP != 24) wgmma_ss_n128<0, 0>(bd, wgmma_desc(base + Layout::qv + 32 * k),")]),
    ("rel_attention.cu", 25, "the PV products (their w fragments kept)", [(
        FWD, "        wgmma_rs_n64<1>(o, a[kk],",
        "        if (EXP == 25) o[kk] += __uint_as_float(a[kk][0] ^ a[kk][1] ^ a[kk][2] ^ a[kk][3]);\n"
        "        else wgmma_rs_n64<1>(o, a[kk],")]),
    ("rel_attention.cu", 26, "the scores' scalar work (skewed reads, roundings, max)", [(
        FWD, "    if (live) {\n#pragma unroll\n      for (int j = 0; j < 8; ++j) {",
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
    ("rel_attention_train.cu", 11, "query pass: the dp band stores", [(
        "    store_dp(band, dpc, k0, D, h, qr, f.q);",
        "    if (EXP != 11) store_dp(band, dpc, k0, D, h, qr, f.q);")]),
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
    ("rel_attention_train_fwd", 51, "the dropout hash (every weight kept)", [(
        "    const uint32_t km = (uint32_t)k * kKeyMul;\n",
        "    if (EXP == 51) return w * inv_keep;\n    const uint32_t km = (uint32_t)k * kKeyMul;\n")]),
    ("rel_attention_train_fwd", 52, "the softmax's exps (both passes)", [(
        FWD, "__device__ inline float e_of(float x, float m) { return expf(x - m); }",
        "__device__ inline float e_of(float x, float m) { return EXP == 52 ? x - m : expf(x - m); }")]),
    ("rel_attention_train_fwd", 53, "the PV products (their w fragments kept)", [(
        FWD, "        wgmma_rs_n64<1>(o, a[kk],",
        "        if (EXP == 53) o[kk] += __uint_as_float(a[kk][0] ^ a[kk][1] ^ a[kk][2] ^ a[kk][3]);\n"
        "        else wgmma_rs_n64<1>(o, a[kk],")]),
    ("rel_attention_train_fwd", 54, "another setting: the fourth key tile's e in registers too (FWD_NE = 4)", [(
        "constexpr int FWD_NE = 3;", "constexpr int FWD_NE = EXP == 54 ? 4 : 3;")]),
    ("rel_attention_train_fwd", 55, "another setting: B1's (FWD_NR = 2; T' <= 1344 only)", [(
        "constexpr int FWD_NR = 3;", "constexpr int FWD_NR = EXP == 55 ? 2 : 3;")]),
    ("aes_backtrace.cu", 61, "the staging copies (tables from whatever shared memory holds)", [(
        "        for (int f = f0; f < nf; f += fstep)\n          cp_async4(dst + f * PF + j,",
        "        for (int f = f0; f < nf * (EXP != 61); f += fstep)\n          cp_async4(dst + f * PF + j,")]),
    ("aes_backtrace.cu", 62, "the walk's dependent loads (each walker keeps its slot)", [(
        "          e = nxt[e];", "          if (EXP != 62) e = nxt[e];\n          else e -= K1;")]),
    ("aes_backtrace.cu", 63, "the tables' gathers (each frame passes every slot through)", [(
        "          bool cont = fr[P] > 0;\n",
        "          if (EXP == 63) {\n            nxt[f * K1 + s] = (f - 1) * K1 + s;\n"
        "            lvl[f * K1 + s] = fr[P];\n            continue;\n          }\n"
        "          bool cont = fr[P] > 0;\n")]),
    ("aes_backtrace.cu", 64, "the output stores", [(
        "          a.toks[o] = tokv[rr * TC * K1 + e];\n          a.valid[o] = lvl[e] >= r;",
        "          const int tv = tokv[rr * TC * K1 + e], lv = lvl[e] >= r;\n"
        "          if (EXP != 64 || tv == -12345) {\n            a.toks[o] = tv;\n            a.valid[o] = lv;\n          }")]),
    ("aes_backtrace.cu", 65, "the skip of the frames past the last active one (Tu = T)", [(
        "  const int Tu = last_active + 1;", "  const int Tu = EXP == 65 ? T : last_active + 1;")]),
    ("aes_backtrace.cu", 66, "another setting: one producer warp", [(
        "constexpr int kProducerWarps = 2;", "constexpr int kProducerWarps = EXP == 66 ? 1 : 2;")]),
    ("aes_backtrace.cu", 69, "another setting: four producer warps", [(
        "constexpr int kProducerWarps = 2;", "constexpr int kProducerWarps = EXP == 69 ? 4 : 2;")]),
    ("aes_backtrace.cu", 70, "another setting: chunks of 8 KB", [(
        "constexpr int kChunkBytes = 16 * 1024;", "constexpr int kChunkBytes = (EXP == 70 ? 8 : 16) * 1024;")]),
    ("aes_backtrace.cu", 71, "another setting: three worker warps", [(
        "constexpr int kWorkerWarps = 6;", "constexpr int kWorkerWarps = EXP == 71 ? 3 : 6;")]),
    ("aes_backtrace.cu", 67, "another setting: two staging buffers", [(
        "  for (int nb = kBufs; nb >= 1; --nb) {", "  for (int nb = EXP == 67 ? 2 : kBufs; nb >= 1; --nb) {")]),
    ("aes_backtrace.cu", 68, "another setting: twice the worker warps (12)", [(
        "constexpr int kWorkerWarps = 6;", "constexpr int kWorkerWarps = EXP == 68 ? 12 : 6;")]),
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
    ("rel_attention.cu", 27, "the long-row mode at T' = 1500: the second pass's PV products", [(
        FWD, "        wgmma_rs_n64<1>(o, af[kk],",
        "        if (EXP == 27) o[kk] += __uint_as_float(af[kk][0] ^ af[kk][1] ^ af[kk][2] ^ af[kk][3]);\n"
        "        else wgmma_rs_n64<1>(o, af[kk],")]),
    ("rel_attention.cu", 28, "the long-row mode at T' = 1500: the first pass (row statistics from one tile)", [(
        FWD, "  for (int it = 0; it < nk; ++it) {\n    float x[32];\n    score_tile(it, x);",
        "  for (int it = 0; it < nk; ++it) {\n    float x[32];\n    score_tile(it, x);\n"
        "    if (EXP == 28 && it > 0) continue;")]),
    ("int8_matmul.cu", 81, "the product's TMA stores (the tile still staged)", [(
        "          tma_store_2d(&tm_out, dst,", "          if (EXP != 81) tma_store_2d(&tm_out, dst,")]),
    ("int8_matmul.cu", 82, "the products (the epilogue reads unset accumulators)", [(
        "        wgmma_s8_n256(acc,", "        if (EXP != 82) wgmma_s8_n256(acc,")]),
    ("int8_matmul.cu", 83, "the epilogue's staging in shared memory", [(
        "            *reinterpret_cast<float2*>(smem + (dst - base) + box_offset(r, cc)) =",
        "            if (EXP != 83) *reinterpret_cast<float2*>(smem + (dst - base) + box_offset(r, cc)) =")]),
    ("int8_matmul.cu", 84, "another setting: a ring of 3 stages", [(
        "constexpr int STAGES = 4;", "constexpr int STAGES = EXP == 84 ? 3 : 4;")]),
    ("int8_matmul.cu", 85, "another setting: the row pass one element at a time", [(
        "    if (x_vec) QROWS(__nv_bfloat16, true);", "    if (x_vec && EXP != 85) QROWS(__nv_bfloat16, true);"),
        ("    if (x_vec) QROWS(float, true);", "    if (x_vec && EXP != 85) QROWS(float, true);")]),
]


def variant_sources(dst: str, target: str, exp: int) -> None:
    """csrc/ copied to dst with the guards of variant ``exp`` of ``target``
    (the other variants' guards are not inserted)."""
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(os.path.join(HERE, "espresso_tpu_torch", "csrc"), dst,
                    ignore=shutil.ignore_patterns("build"))
    files = {}
    for tgt, n, _, edits in VARIANTS:
        if tgt != target or n != exp:
            continue
        for edit in edits:
            name, anchor, replacement = edit if len(edit) == 3 else (
                TARGET_FILES.get(tgt, tgt), *edit)
            if name not in files:
                with open(os.path.join(dst, name)) as f:
                    files[name] = "#ifndef EXP\n#define EXP 0\n#endif\n" + f.read()
            if files[name].count(anchor) != 1:
                raise RuntimeError(f"variant {n}: anchor not found once in {name}: {anchor!r}")
            files[name] = files[name].replace(anchor, replacement)
    for name, s in files.items():
        with open(os.path.join(dst, name), "w") as f:
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
    b1_long = tc.long_attention_inputs(4, 1500, seed=1, dev=dev, H=8)
    q8 = fc.int8_inputs(*cs.INT8_SHAPES[0], seed=cs.INT8_SHAPES[0][1], dev=dev)
    mi = kc.merge_inputs(256, 10, seed=10, dev=dev, blank_lp=True)
    bt = kc.backtrace_inputs(156, 256, 10, 2, V=cs.FLAGSHIP["VOCAB"], seed=156, dev=dev)
    from espresso_tpu_torch.ops import quantization as qz

    calls = {
        "rel_attention.cu": lambda: (ak.rel_attention(*b1), ak.rel_attention(*b1_long)),
        "rnnt_joint_lp.cu": lambda: rk.rnnt_joint_lp(*ja, 0),
        "rnnt_joint_bwd.cu": lambda: rk.rnnt_joint_bwd(*ja, lse, ob, ol, 0),
        "rel_attention_train.cu": lambda: ak.rel_attention_train_bwd(
            *args, a["seed"], a["g"], 8, ak.HEAD_DIM ** -0.5, 0.1),
        "rel_attention_train_fwd": lambda: ak.rel_attention_train_fwd(
            *args, a["seed"], 8, ak.HEAD_DIM ** -0.5, 0.1),
        "aes_merge.cu": lambda: dk.aes_merge(**mi, round_j=1),
        "aes_backtrace.cu": lambda: dk.aes_backtrace(**bt, n_exp=2),
        "fbank.cu": lambda: fk.fbank_fused(w["waveforms"], w["num_samples"]),
        "int8_matmul.cu": lambda: qz.int8_matmul(q8["x"], q8["w_q"], q8["w_scale"]),
    }
    only = set(sys.argv[1:]) or set(calls)
    runs = [(src, 0, "nothing") for src in calls]
    runs += [(src, n, what) for src, n, what, _ in VARIANTS]
    for target, exp, what in sorted(runs, key=lambda x: (list(calls).index(x[0]), x[1])):
        if target not in only:
            continue
        # the wrappers build and load their library from these on first use
        csrc = os.path.join(root, f"csrc_{exp}")
        variant_sources(csrc, target, exp)
        cuda_build.CSRC_DIR, cuda_build.BUILD_DIR = csrc, os.path.join(csrc, "build")
        cuda_build.NVCC_FLAGS = base_flags + (f"-DEXP={exp}",)
        rk._lib.cache_clear()
        ak._lib.cache_clear()
        ak._train_lib.cache_clear()
        fk._lib.cache_clear()
        dk._fn.cache_clear()
        qz._lib.cache_clear()
        # each kernel's mean time a launch (each launches once a call): a
        # trace that dropped some launches' records reads it as it is
        split = cs.device_split(calls[target], calls=20, per_launch=True)
        kernels = {}
        for name, ms in split.items():
            m = re.search(r"(rnnt_joint_\w+?_kernel|rel_attention\w*?_kernel|aes_merge_kernel|"
                          r"aes_backtrace_kernel|fbank_kernel|quantize_rows_kernel|"
                          r"int8_gemm_kernel)", name)
            if m:
                kernels[m.group(1)] = ms
        print(json.dumps({"source": target, "variant": exp, "left_out": what, "ms": kernels}),
              flush=True)
    print(cs.card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
