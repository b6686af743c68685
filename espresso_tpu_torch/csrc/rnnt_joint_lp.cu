// RNNT joint forward: blank and target log-probs of every lattice cell,
// bf16 in, f32 out, sm_90a. The [B, T, U1, V] logits are never written.
//
// Replaces the TPU kernel espresso_tpu/ops/rnnt_pallas.py::rnnt_joint_lp
// (Pallas, :83-208). Per lattice row (b, t, u):
//
//   pre    = bf16(relu(enc_proj[b, t] + dec_proj[b, u]))     (f32 sum)
//   logits = pre . W[v] + bias[v]                             (f32)
//   lse    = logsumexp_v logits   (online over the V tiles)
//   lp_blank = logits[blank] - lse;  lp_label = logits[tgt[u]] - lse,
//   NEG_INF at u = U1 - 1 (no label from the last row)
//
// What bounds it on an H100: at the flagship (B=16, T'=256, U1=101, J=512,
// V=1024) the logits product is 2 B T' U1 J V = 433.8 GFLOP against ~50 MB
// of inputs and outputs: far above the bf16 ridge, so the tensor cores bound
// it (0.44 ms at 989 TFLOP/s). Next come the reads of W from L2, once per
// block of rows, and the epilogue's scalar work (bias, max, exp, sum and the
// two picks, ~10 instructions a logit).
//
// Design: a persistent kernel, a block per SM, over units of two tiles of
// 64 lattice rows (the backward's tiles and tile order, rnnt_joint_common.cuh:
// unit k = tiles 2k and 2k + 1), each block a contiguous share of the
// units. A block is two consumer warpgroups, each forming and owning one
// tile's joint hidden (bf16, [64 x J] in shared memory, 128-byte swizzled),
// and a producer warpgroup whose one thread streams W [V, J] (the
// transposed view of the nn.Linear weight) by TMA in [128 v x 64 k] boxes
// (rows past V zero) into a ring of S stages guarded by mbarriers; the
// producer gives most of its registers to the consumers (setmaxnreg). Both
// consumer warpgroups read every W stage, so W comes from L2 once per 128
// rows (3.4 GB at the flagship). Each consumer warpgroup runs the logits of
// a V tile of 128 columns on wgmma m64n128k16 (K = J, A = its joint hidden,
// B = W K-major), one commit group per stage, into one of two accumulator
// sets: the epilogue of V tile n (bias, online max and sum, the blank and
// target picks, by select: a divergent branch over wgmma's registers would
// make ptxas serialise every wgmma) runs while the first P stages of tile n +
// 1 are in the tensor cores. V is padded to an even number of tiles (a tile
// past V reloads the last one and is masked to -inf by its bias), so that
// the two accumulator sets alternate without a branch. exp is ex2.approx of
// the log2e-scaled difference, within a few f32 ulps of expf, below the
// differences of the products' summation order.
//
// What holds it back (chip_kernel_ablation.py on an H100 at the flagship,
// ~0.92 ms in all): the epilogue, ~0.38 ms (its exp ~0.18), which the two
// stages issued before it cover only in part, since both warpgroups fold
// at the same time (the ring refills a stage only once both have released
// it, so the two run in step); the joint hidden formed between the units'
// products, ~0.13 ms; and spills of 30-160 bytes a thread under the
// launch's 168 registers. The waits for W are not the limit.
//
// C entry: rnnt_joint_lp_bf16(...) returns the CUDA error of the launch; it
// launches on the given stream and does not synchronise.

#include "rnnt_joint_common.cuh"
#include <math.h>

namespace {

using namespace rnnt;

constexpr int VTL = 128;             // vocab columns a V tile: the logits' N
constexpr int STAGE = VTL * 128;     // a [128 v x 64 k] W box (16 KB)
constexpr int S = 6;                 // ring stages
constexpr int NCONS = 256;           // two consumer warpgroups
constexpr int NTHREADS = NCONS + 128;
constexpr int PROD_REGS = 40, CONS_REGS = 232;
constexpr float kNegInf = -1.0e30f;  // NEG_INF of ops/rnnt.py
constexpr float kLog2e = 1.4426950408889634f;

template <int J>
struct Layout {
  static constexpr uint32_t pre = 0;                       // 2 tiles x J/64 blocks
  static constexpr uint32_t ring = 2 * J * 128;            // S x [128 x 64]
  static constexpr uint32_t bars = ring + S * STAGE;       // full[S], empty[S]
  static constexpr uint32_t total = bars + 2 * S * 8;
};

__device__ inline float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// the lane's two rows (16 warp + g + 8 hh of its warpgroup's tile): online
// max and sum of the logits, the blank and target logits where the lane
// holds them (0 elsewhere), the target column (-1 for a row past T or U1)
struct RowState {
  float m[2], s[2], lb[2], lt[2];
  int tg[2];
};

// fold the logits of V tile `vt` (columns 128 vt + 8 j + 2 q + e) into the
// rows' state: the maxima and picks, then the sums
__device__ inline void fold(const float (&acc)[64], int vt, int V, int blank,
                            const float* __restrict__ bias, int q, RowState& rs) {
  float2 bv[16];
  float tm[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    const int v = vt * VTL + 8 * j + 2 * q;
    // past V: -inf, whatever the product holds
    bv[j] = make_float2(v < V ? __ldg(bias + v) : -INFINITY,
                        v + 1 < V ? __ldg(bias + v + 1) : -INFINITY);
    const bool b0 = v == blank, b1 = v + 1 == blank;
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float x0 = acc[4 * j + 2 * hh] + bv[j].x, x1 = acc[4 * j + 2 * hh + 1] + bv[j].y;
      tm[hh] = fmaxf(tm[hh], fmaxf(x0, x1));
      rs.lb[hh] = b0 ? x0 : (b1 ? x1 : rs.lb[hh]);
      rs.lt[hh] = v == rs.tg[hh] ? x0 : (v + 1 == rs.tg[hh] ? x1 : rs.lt[hh]);
    }
  }
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const float nm = fmaxf(rs.m[hh], tm[hh]);  // finite: a tile holds a column below V
    float add = 0.f;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      add += exp2_approx((acc[4 * j + 2 * hh] + bv[j].x - nm) * kLog2e) +
             exp2_approx((acc[4 * j + 2 * hh + 1] + bv[j].y - nm) * kLog2e);
    rs.s[hh] = rs.s[hh] * exp2_approx((rs.m[hh] - nm) * kLog2e) + add;
    rs.m[hh] = nm;
  }
}

template <int J>
__global__ void __launch_bounds__(NTHREADS, 1)
rnnt_joint_lp_kernel(const __grid_constant__ CUtensorMap tm_w, const bf16* __restrict__ enc,
                     const bf16* __restrict__ dec, const float* __restrict__ bias,
                     const int* __restrict__ tgt, float* __restrict__ lpb,
                     float* __restrict__ lpl, float* __restrict__ lse_out, Tiles tl, int V,
                     int blank) {
  using L = Layout<J>;
  constexpr int KB = J / 64;          // W stages a V tile
  constexpr int P = KB < 2 ? KB : 2;  // stages of the next tile issued before an epilogue
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + S;
  // an even number of V tiles: a tile past V (V / 128 even) is masked
  const int NV = 2 * ((V + 2 * VTL - 1) / (2 * VTL)), vlast = (V - 1) / VTL;
  const long long units = (tl.n + 1) / 2;
  const long long lo = units * blockIdx.x / gridDim.x, hi = units * (blockIdx.x + 1) / gridDim.x;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrive per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= NCONS) {
    // ---- producer: every W stage of every V tile, unit after unit
    setmaxnreg_dec<PROD_REGS>();
    if (threadIdx.x == NCONS) {
      int it = 0;
      for (long long un = lo; un < hi; ++un)
        for (int vt = 0; vt < NV; ++vt)
          for (int kb = 0; kb < KB; ++kb, ++it) {
            const int slot = it % S;
            mbar_wait(&empty[slot], ((it / S) & 1) ^ 1);
            mbar_arrive_expect_tx(&full[slot], STAGE);
            tma_load_2d(base + L::ring + slot * STAGE, &tm_w, &full[slot], kb * 64,
                        (vt < vlast ? vt : vlast) * VTL);
          }
    }
    return;
  }

  setmaxnreg_inc<CONS_REGS>();
  const int w = threadIdx.x / 128, wt = threadIdx.x % 128;
  const int warp = wt / 32, g = (wt % 32) / 4, q = wt % 4;
  const uint32_t pre = base + L::pre + w * (J * 128);
  int it = 0, rel = 0;  // stages issued, stages released
  auto release_to = [&](int n) {
    for (; rel < n; ++rel)
      if (wt == 0) mbar_arrive(&empty[rel % S]);
  };
  // the logits of V tile vt into cur, a commit group per stage
  auto issue = [&](float (&cur)[64], int kb) {
    const int slot = it % S;
    mbar_wait(&full[slot], (it / S) & 1);
    const uint32_t st = base + L::ring + slot * STAGE;
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_ss_n128<0, 0>(cur, wgmma_desc(pre + kb * BOX + 32 * k), wgmma_desc(st + 32 * k),
                          kb + k > 0);
    wgmma_commit();
    ++it;
  };
  // V tile vt into cur while the previous tile's logits (prev) are folded:
  // P stages go to the tensor cores first, then the fold, then the rest,
  // each stage released as soon as its group is done
  RowState rs;
  auto tile_and_fold = [&](float (&cur)[64], float (&prev)[64], int vt) {
#pragma unroll
    for (int kb = 0; kb < P; ++kb) issue(cur, kb);
    wgmma_wait<P>();
    release_to(it - P);
    fold(prev, vt - 1, V, blank, bias, q, rs);
    for (int kb = P; kb < KB; ++kb) {
      issue(cur, kb);
      wgmma_wait<1>();
      release_to(it - 1);
    }
  };

  float accA[64], accB[64];
  for (long long un = lo; un < hi; ++un) {
    // ---- this warpgroup's tile of the unit: its joint hidden and rows
    const long long ti = 2 * un + w;
    const bool live = ti < tl.n;  // the second tile of an odd count has no rows
    int b, ug, ts;
    tile_of(tl, live ? ti : 0, b, ug, ts);
    {
      JointHidden<J, 128> jh;
      jh.load(enc, dec, tl, b, ug, ts, wt, live);
      jh.store(smem + (pre - base), tl, ug, ts, wt);
    }
    fence_proxy_async();
    named_sync(1 + w, 128);
    bool ok[2];
    size_t cell[2];
    int u[2];
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      u[hh] = ug * UT + 2 * warp + hh;
      const int t = ts * FT + g;
      ok[hh] = live && t < tl.T && u[hh] < tl.U1;
      cell[hh] = ((size_t)b * tl.T + (ok[hh] ? t : 0)) * tl.U1 + (ok[hh] ? u[hh] : 0);
      rs.tg[hh] = ok[hh] ? __ldg(tgt + (size_t)b * tl.U1 + u[hh]) : -1;
      rs.m[hh] = -INFINITY;
      rs.s[hh] = rs.lb[hh] = rs.lt[hh] = 0.f;
    }

    // ---- the V tiles in pairs: accA holds the even ones, accB the odd
    for (int kb = 0; kb < KB; ++kb) {
      issue(accA, kb);
      wgmma_wait<1>();
      release_to(it - 1);
    }
    tile_and_fold(accB, accA, 1);
    for (int vt = 2; vt < NV; vt += 2) {
      tile_and_fold(accA, accB, vt);
      tile_and_fold(accB, accA, vt + 1);
    }
    wgmma_wait<0>();
    release_to(it);
    fold(accB, NV - 1, V, blank, bias, q, rs);

    // ---- merge the 4 lanes of each row; lse and the two log-probs
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        const float om = __shfl_xor_sync(0xffffffffu, rs.m[hh], off);
        const float os = __shfl_xor_sync(0xffffffffu, rs.s[hh], off);
        const float nm = fmaxf(rs.m[hh], om);
        rs.s[hh] = rs.s[hh] * expf(rs.m[hh] - nm) + os * expf(om - nm);
        rs.m[hh] = nm;
        rs.lb[hh] += __shfl_xor_sync(0xffffffffu, rs.lb[hh], off);
        rs.lt[hh] += __shfl_xor_sync(0xffffffffu, rs.lt[hh], off);
      }
      if (q == 0 && ok[hh]) {
        const float z = rs.m[hh] + logf(rs.s[hh]);
        lse_out[cell[hh]] = z;
        lpb[cell[hh]] = rs.lb[hh] - z;
        lpl[cell[hh]] = u[hh] == tl.U1 - 1 ? kNegInf : rs.lt[hh] - z;
      }
    }
  }
}

template <int J>
int launch(const void* w, const bf16* enc, const bf16* dec, const float* bias, const int* tgt,
           float* lpb, float* lpl, float* lse, Tiles tl, int V, int blank, int device,
           cudaStream_t s) {
  alignas(64) CUtensorMap tm;
  const int rc = encode_tmap_bf16(&tm, w, (uint64_t)V, (uint64_t)J, VTL);
  if (rc != 0) return rc;
  const int smem = Layout<J>::total + 1024;
  cudaError_t err = cudaFuncSetAttribute(rnnt_joint_lp_kernel<J>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return (int)err;
  const long long units = (tl.n + 1) / 2;
  const int n_sm = sm_count(device);
  const int grid = (int)(units < n_sm ? units : n_sm);
  rnnt_joint_lp_kernel<J><<<grid, NTHREADS, smem, s>>>(tm, enc, dec, bias, tgt, lpb, lpl, lse,
                                                       tl, V, blank);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// enc [B, T, J], dec [B, U1, J], w [V, J]: bf16, contiguous, 16-byte
// aligned; bias [V] f32; tgt [B, U1] int32 (the target of row u, 0 at u =
// U1 - 1); outputs lp_blank, lp_label, lse [B, T, U1] f32; all on card
// `device`. J: 128, 256 or 512. A block per SM (at most one per unit of two
// 64-row tiles).
int rnnt_joint_lp_bf16(const void* enc, const void* dec, const void* w, const void* bias,
                       const void* tgt, void* lp_blank, void* lp_label, void* lse, int B,
                       int T, int U1, int J, int V, int blank, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Tiles tl;
  tl.T = T;
  tl.U1 = U1;
  tl.nu = (U1 + UT - 1) / UT;
  tl.nt = (T + FT - 1) / FT;
  tl.n = (long long)B * tl.nu * tl.nt;
#define RNNT_LP_ARGS                                                                        \
  w, static_cast<const bf16*>(enc), static_cast<const bf16*>(dec),                          \
      static_cast<const float*>(bias), static_cast<const int*>(tgt),                        \
      static_cast<float*>(lp_blank), static_cast<float*>(lp_label), static_cast<float*>(lse), \
      tl, V, blank, device, (cudaStream_t)stream
  switch (J) {
    case 128: return launch<128>(RNNT_LP_ARGS);
    case 256: return launch<256>(RNNT_LP_ARGS);
    case 512: return launch<512>(RNNT_LP_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RNNT_LP_ARGS
}

}  // extern "C"
