// Device code of the RNNT joint forward kernel (rnnt_joint_lp.cu; the
// backward, rnnt_joint_bwd.cu, is built on hopper_sm90.cuh): the joint hidden
// staged in shared memory, the
// vocabulary tiles of the output weights, and the tensor-core product of a
// warp's 16 rows with a V tile.
//
// Rows are (b, t, u) triples of the lattice; the joint hidden of a row is
// pre = bf16(relu(enc_proj[b, t] + dec_proj[b, u])), summed in f32 and
// rounded to bf16 as the TPU kernel rounds it (rnnt_pallas.py:128-133).
// The output weights are read in the nn.Linear layout W [V, J]; a V tile is
// VT = 64 rows of it, rows past V are zero (the ragged tail of the vocab).

#pragma once

#include "bf16_mma.cuh"

namespace rnnt {

constexpr int VT = 64;                 // vocab columns per tile
constexpr float kNegInf = -1.0e30f;    // NEG_INF of ops/rnnt.py

__host__ __device__ inline int pre_ld(int J) { return J + 8; }  // bf16 row stride

// Stage nrows joint-hidden rows into dst (row stride pre_ld(J)): row i is
// (b, t, u) = row_of(i) and is zero when row_of says it is not valid.
template <typename RowOf>
__device__ inline void stage_pre(bf16* dst, const bf16* __restrict__ enc,
                                 const bf16* __restrict__ dec, int nrows, int T, int U1,
                                 int J, RowOf row_of) {
  const int ld = pre_ld(J), cpr = J / 8;
  for (int i = threadIdx.x; i < nrows * cpr; i += blockDim.x) {
    const int r = i / cpr, c = (i % cpr) * 8;
    int b, t, u;
    uint4 out = make_uint4(0u, 0u, 0u, 0u);
    if (row_of(r, b, t, u)) {
      const uint4 e = *reinterpret_cast<const uint4*>(enc + ((size_t)b * T + t) * J + c);
      const uint4 d = *reinterpret_cast<const uint4*>(dec + ((size_t)b * U1 + u) * J + c);
      const bf16* ep = reinterpret_cast<const bf16*>(&e);
      const bf16* dp = reinterpret_cast<const bf16*>(&d);
      bf16* op = reinterpret_cast<bf16*>(&out);
#pragma unroll
      for (int k = 0; k < 8; ++k)
        op[k] = __float2bfloat16(fmaxf(__bfloat162float(ep[k]) + __bfloat162float(dp[k]), 0.f));
    }
    *reinterpret_cast<uint4*>(dst + r * ld + c) = out;
  }
}

// Stage W rows [v0, v0 + VT) (zero past V) into dst (row stride pre_ld(J)).
__device__ inline void stage_w_tile(bf16* dst, const bf16* __restrict__ w, int v0, int V,
                                    int J) {
  const int ld = pre_ld(J), cpr = J / 8;
  for (int i = threadIdx.x; i < VT * cpr; i += blockDim.x) {
    const int r = i / cpr, c = (i % cpr) * 8;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (v0 + r < V) x = *reinterpret_cast<const uint4*>(w + (size_t)(v0 + r) * J + c);
    *reinterpret_cast<uint4*>(dst + r * ld + c) = x;
  }
}

// acc[nt] = pre[rows] . W_tile[cols]^T for the 16 rows at `pre_rows` and the
// NT * 8 tile columns starting at `w_rows` (both row stride pre_ld(J)),
// summed over J in f32.
template <int NT>
__device__ inline void warp_logits(float (&acc)[NT][4], const bf16* pre_rows,
                                   const bf16* w_rows, int J, int g, int t) {
  const int ld = pre_ld(J);
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
  for (int k0 = 0; k0 < J; k0 += 16) {
    uint32_t a[4];
    load_a(a, pre_rows + k0, ld, g, t);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const bf16* wb = w_rows + (nt * 8 + g) * ld + k0 + 2 * t;
      mma_bf16(acc[nt], a, ld32(wb), ld32(wb + 8));
    }
  }
}

}  // namespace rnnt
