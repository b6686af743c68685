// Tensor-core helpers shared by the bf16 kernels (rel_attention.cu,
// rel_attention_train.cu, fused_joint_topk.cu, lstm_step_reorder.cu and the
// RNNT joint kernels): register fragments of mma.sync m16n8k16 (bf16 in,
// fp32 accumulate) loaded from shared-memory tiles, and bf16 rounding.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

__device__ inline float round_bf16(float x) { return __bfloat162float(__float2bfloat16(x)); }

__device__ inline uint32_t ld32(const bf16* ptr) {
  return *reinterpret_cast<const uint32_t*>(ptr);
}

__device__ inline uint32_t pack2(bf16 lo, bf16 hi) {
  return (uint32_t)__bfloat16_as_ushort(lo) | ((uint32_t)__bfloat16_as_ushort(hi) << 16);
}

__device__ inline uint32_t pack2f(float lo, float hi) {
  return pack2(__float2bfloat16(lo), __float2bfloat16(hi));
}

// d += a (16x16, row-major fragment) * b (16x8, column fragment), fp32.
__device__ inline void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment of the 16 x 16 tile at `base` (row stride ld): lane (g, t) holds
// rows g and g+8, columns 2t, 2t+1 and 2t+8, 2t+9.
__device__ inline void load_a(uint32_t (&a)[4], const bf16* base, int ld, int g, int t) {
  a[0] = ld32(base + g * ld + 2 * t);
  a[1] = ld32(base + (g + 8) * ld + 2 * t);
  a[2] = ld32(base + g * ld + 2 * t + 8);
  a[3] = ld32(base + (g + 8) * ld + 2 * t + 8);
}

// B fragment (k = rows of `base`, n = its columns) of a row-major [k][n]
// tile whose k pairs are not contiguous: rows 2t, 2t+1 and 2t+8, 2t+9 of
// column g.
__device__ inline void load_b_rows(uint32_t& b0, uint32_t& b1, const bf16* base, int ld,
                                   int g, int t) {
  const bf16* p = base + (2 * t) * ld + g;
  b0 = pack2(p[0], p[ld]);
  b1 = pack2(p[8 * ld], p[9 * ld]);
}
