// Tiling of the mma.sync training forward (rel_attention_train.cu): a
// block owns QT query rows of one (utterance, head), 16 per warp, and
// stages 64-wide rows of q, k, v and p in shared memory. (The inference
// kernel, rel_attention.cu, is built on hopper_sm90.cuh.)

#pragma once

#include "bf16_mma.cuh"

constexpr int HD = 64;             // head dim
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int QT = NWARPS * 16;    // query rows per block (16 per warp)
constexpr int KT = 64;             // keys per tile
constexpr int PW = QT + KT;        // p rows staged per key tile (QT + KT - 1 used)
constexpr int LDH = HD + 8;        // bf16 row stride of 64-wide tiles (144 B)
constexpr int BDW = 80;            // bd window columns per warp (79 used)
constexpr int LDB = BDW + 8;       // its row stride
constexpr float kMaskFill = -1.0e8f;

__host__ __device__ inline int padded_len(int T) { return (T + KT - 1) / KT * KT; }

// Stage rows [r0, r0 + nrows) of one head of a [*, D] bf16 matrix into
// shared memory (row stride LDH) with 16-byte loads; rows outside
// [0, nvalid) are zero.
__device__ inline void stage_rows(bf16* dst, const bf16* src, size_t src_row0, int r0,
                                  int nrows, int nvalid, int D, int col0) {
  for (int i = threadIdx.x; i < nrows * (HD / 8); i += NTHREADS) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    const int gr = r0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (gr >= 0 && gr < nvalid)
      x = *reinterpret_cast<const uint4*>(src + (src_row0 + gr) * D + col0 + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = x;
  }
}
