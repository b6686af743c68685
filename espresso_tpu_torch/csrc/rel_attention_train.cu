// Relative-position self-attention for training, bf16 in and out, sm_90a:
// the forward with in-kernel dropout of the softmax weights, and its
// backward.
//
// Replaces the TPU kernels espresso_tpu/ops/attention_kernels.py::
// rel_attention_train (Pallas, `_build_train_kernels` :444-575): the forward
// `fwd_kernel` (:480-498) and the backward `bwd_kernel` (:500-573). Per
// (utterance b, head h), flattened heads [B, T, H*64]:
//
//   s  = bf16(bf16(bf16(ac) + bf16(bd)) * bf16(scale)) + mask   (mask 0 / -1e8)
//   w  = softmax_f32(s);  w_used = w * keep / (1 - rate)        (f32)
//   out = bf16(sum_k bf16(w_used) v)
//   backward: dw = (g v^T) * keep/(1-rate); ds = w (dw - sum(dw w)) * scale;
//   dv = bf16(w_used)^T g; dq_u = bf16(ds) k; dk = bf16(ds)^T q_u;
//   dq_v, dp from the skewed dbd[q, T-1+k-q] = bf16(ds)[q, k]; dp summed over
//   the batch in f32.
//
// The dropout draw is the TPU kernel's counter hash (attention_kernels.py
// :312-362): uint32 wrapping arithmetic, the murmur3 finalizer `imix`, the
// (seed, item, head) triple finalized before the row index enters; a weight
// is kept when the 31-bit draw is below round((1 - rate) (2^31 - 1)). So the
// backward regenerates the forward's mask, and `dropout_keep_mask` replays it.
//
// What bounds them on an H100 at the flagship train shape (B=16, T'=256,
// H=8, d=64): the forward moves ~21.5 MB (q_u, q_v, k, v, out at 4.2 MB,
// p) and does ~3.2 GFLOP, the backward ~39 MB and ~8.6 GFLOP: both below
// the card's bf16 ridge, so memory traffic bounds them (~6.4 and ~11.7 us).
//
// Design: the forward is the inference kernel (rel_attention.cu) with the
// hash applied where w is formed: a block owns 64 query rows of one (b, h)
// (4 warps of 16), keeps their bf16 score rows in shared memory, and runs
// ac, the [16, 80] window product of the relative shift, and PV on the
// tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate). The backward
// is three kernels:
//   1. rows: per 64 query rows, recompute s, the softmax and sum(dw w) (one
//      pass over the key tiles for each), then form ds tile by tile in the
//      product's registers: dq_u += ds k there, and dq_v += W p where W is
//      the warp's ds written skewed into a [16, 80] window; ds and
//      bf16(w_used) go to a [B, H, T, T] bf16 scratch;
//   2. keys: per 64 keys, dv = w_used^T g and dk = ds^T q_u over all query
//      tiles, from the scratch;
//   3. positions: per 64 rows of p, dp = sum over (b, q) of the skewed
//      ds^T q_v, reading each skewed row of the scratch contiguously; the
//      sum over the batch stays in registers, so dp needs no atomics.
// The scratch costs ~100 MB of traffic a call at the flagship (the TPU
// kernel keeps it in VMEM); fusing passes 2 and 3 into 1 is later work, as
// are cp.async/TMA pipelining and wgmma.
//
// C entries: rel_attention_train_{fwd,bwd}_bf16(...) return the CUDA error
// of the launches; they launch on the given stream and do not synchronise.

#include "rel_attention_common.cuh"

namespace {

constexpr uint32_t kGold = 0x9E3779B1u, kHeadMul = 0x27D4EB2Fu, kKeyMul = 0x165667B1u;

__device__ inline uint32_t imix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

struct Dropout {
  int on;             // rate > 0
  uint32_t thresh;    // keep when the 31-bit draw is below it
  float inv_keep;     // 1 / (1 - rate)
  // the keep factor of key k in the row whose hash state is `row`
  __device__ inline float factor(uint32_t row, int k) const {
    if (!on) return 1.f;
    return (imix(row ^ ((uint32_t)k * kKeyMul)) >> 1) < thresh ? inv_keep : 0.f;
  }
};

// the row hash states of the lane's rows q0r + g and q0r + g + 8
__device__ inline void row_hashes(uint32_t (&hr)[2], uint32_t seed, int b, int h, int qrow) {
  const uint32_t base = imix(seed + (uint32_t)b * kGold + (uint32_t)h * kHeadMul);
  hr[0] = imix(base + (uint32_t)qrow * kGold);
  hr[1] = imix(base + (uint32_t)(qrow + 8) * kGold);
}

// Shared memory of the score pass: mask, one K/V tile, the p window, the
// warps' bd windows and the score rows.
struct ScoreSmem {
  float* mask;  // [Tp]
  bf16* kv;     // [KT][LDH]
  bf16* p;      // [PW][LDH]
  bf16* bd;     // [NWARPS][16][LDB]
  bf16* s;      // [QT][Tp + 8]
};

__host__ __device__ inline size_t score_smem_bytes(int T, int extra_tiles) {
  const int Tp = padded_len(T);
  return sizeof(float) * Tp +
         sizeof(bf16) * ((1 + extra_tiles) * KT * LDH + PW * LDH + NWARPS * 16 * LDB +
                         QT * (Tp + 8));
}

__device__ inline ScoreSmem carve(float* smem, int T, int extra_tiles) {
  const int Tp = padded_len(T);
  ScoreSmem s;
  s.mask = smem;
  s.kv = reinterpret_cast<bf16*>(s.mask + Tp);
  s.p = s.kv + (1 + extra_tiles) * KT * LDH;
  s.bd = s.p + PW * LDH;
  s.s = s.bd + NWARPS * 16 * LDB;
  return s;
}

// The score pass shared by the forward and the backward: s = bf16(bf16(
// bf16(ac) + bf16(bd)) * bf16(scale)) into the score rows, and the row maxima
// of s + mask of the lane's rows g and g + 8 (combined over the 4 lanes of
// a row). au / av: the warp's q+u / q+v rows as A fragments.
__device__ inline void score_pass(const ScoreSmem& sm, const uint32_t (&au)[4][4],
                                  const uint32_t (&av)[4][4], const bf16* kmat,
                                  const bf16* p, size_t row0, int q0, int T, int D,
                                  int col0, float scale, float (&mrow)[2]) {
  const int Tp = padded_len(T), LDS = Tp + 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  bf16* bdw = sm.bd + warp * 16 * LDB;
  bf16* srows = sm.s + warp * 16 * LDS;
  // block row r = 16 warp + rl and key k0 + c need p-window row
  // c - r + QT - 1 = wb + (c - rl + 15), with the warp's window base wb
  const int wb = QT - 16 - 16 * warp;
  mrow[0] = mrow[1] = -__int_as_float(0x7f800000);
  for (int k0 = 0; k0 < Tp; k0 += KT) {
    __syncthreads();  // the previous tile's readers are done
    stage_rows(sm.kv, kmat, row0, k0, KT, T, D, col0);
    // p-window row j <-> table row k0 - q0 - (QT - 1) + (T - 1) + j
    stage_rows(sm.p, p, 0, k0 - q0 - (QT - 1) + (T - 1), PW, 2 * T - 1, D, col0);
    __syncthreads();
    {  // window[rl, j] = (q+v)[rl] . p_window[wb + j], rounded to bf16
      float acc[BDW / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int nt = 0; nt < BDW / 8; ++nt) {
          const bf16* pb = sm.p + (wb + nt * 8 + g) * LDH + kk * 16 + 2 * t;
          mma_bf16(acc[nt], av[kk], ld32(pb), ld32(pb + 8));
        }
      }
#pragma unroll
      for (int nt = 0; nt < BDW / 8; ++nt) {
        *reinterpret_cast<uint32_t*>(bdw + g * LDB + nt * 8 + 2 * t) =
            pack2f(acc[nt][0], acc[nt][1]);
        *reinterpret_cast<uint32_t*>(bdw + (g + 8) * LDB + nt * 8 + 2 * t) =
            pack2f(acc[nt][2], acc[nt][3]);
      }
    }
    float ac[KT / 8][4] = {};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
      for (int nt = 0; nt < KT / 8; ++nt) {
        const bf16* kb = sm.kv + (nt * 8 + g) * LDH + kk * 16 + 2 * t;
        mma_bf16(ac[nt], au[kk], ld32(kb), ld32(kb + 8));
      }
    }
    __syncwarp();  // the window is written by the whole warp
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = g + 8 * half, c = nt * 8 + 2 * t;
        float s[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float bd = __bfloat162float(bdw[rl * LDB + c + e - rl + 15]);
          s[e] = round_bf16(round_bf16(round_bf16(ac[nt][2 * half + e]) + bd) * scale);
          if (k0 + c + e < T) mrow[half] = fmaxf(mrow[half], s[e] + sm.mask[k0 + c + e]);
        }
        *reinterpret_cast<uint32_t*>(srows + rl * LDS + k0 + c) = pack2f(s[0], s[1]);
      }
    }
    __syncwarp();  // the window is read before the next tile rewrites it
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mrow[half] = fmaxf(mrow[half], __shfl_xor_sync(0xffffffffu, mrow[half], 1));
    mrow[half] = fmaxf(mrow[half], __shfl_xor_sync(0xffffffffu, mrow[half], 2));
  }
}

// 1 / sum_k exp(s + mask - m) of the lane's rows, from the score rows.
__device__ inline void softmax_sums(const ScoreSmem& sm, int T, const float (&mrow)[2],
                                    float (&zinv)[2]) {
  const int LDS = padded_len(T) + 8;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const bf16* srow = sm.s + (warp * 16 + g + 8 * half) * LDS;
    float z = 0.f;
    for (int c0 = 0; c0 < T; c0 += 16) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = c0 + 2 * t + (j & 1) + 8 * (j >> 1);
        if (k < T) z += expf(__bfloat162float(srow[k]) + sm.mask[k] - mrow[half]);
      }
    }
    z += __shfl_xor_sync(0xffffffffu, z, 1);
    z += __shfl_xor_sync(0xffffffffu, z, 2);
    zinv[half] = 1.f / z;
  }
}

// the softmax weight of key k in the lane's row `half`
__device__ inline float weight(const ScoreSmem& sm, int LDS, int rowl, int k, int T,
                               float m, float zinv) {
  if (k >= T) return 0.f;
  return expf(__bfloat162float(sm.s[rowl * LDS + k]) + sm.mask[k] - m) * zinv;
}

__device__ inline void stage_mask(float* mask, const uint8_t* key_valid, size_t row0,
                                  int T) {
  for (int k = threadIdx.x; k < padded_len(T); k += NTHREADS)
    mask[k] = (k < T && key_valid[row0 + k]) ? 0.f : kMaskFill;
}

// ---------------------------------------------------------------------------
// forward
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NTHREADS)
rel_attention_train_fwd_kernel(const bf16* __restrict__ qu, const bf16* __restrict__ qv,
                               const bf16* __restrict__ kmat, const bf16* __restrict__ vmat,
                               const bf16* __restrict__ p, const uint8_t* __restrict__ key_valid,
                               const int* __restrict__ seed, bf16* __restrict__ out, int T,
                               int H, float scale_f, Dropout drop) {
  extern __shared__ float smem[];
  const ScoreSmem sm = carve(smem, T, 0);
  const int LDS = padded_len(T) + 8;
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int D = H * HD, col0 = h * HD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t row0 = (size_t)b * T;
  const float scale = round_bf16(scale_f);

  // q+u and q+v are read once into registers, staged in the p window's space
  stage_rows(sm.p, qu, row0, q0, QT, T, D, col0);
  stage_rows(sm.p + QT * LDH, qv, row0, q0, QT, T, D, col0);
  stage_mask(sm.mask, key_valid, row0, T);
  __syncthreads();
  uint32_t au[4][4], av[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    load_a(au[kk], sm.p + warp * 16 * LDH + kk * 16, LDH, g, t);
    load_a(av[kk], sm.p + QT * LDH + warp * 16 * LDH + kk * 16, LDH, g, t);
  }
  float mrow[2], zinv[2];
  score_pass(sm, au, av, kmat, p, row0, q0, T, D, col0, scale, mrow);
  softmax_sums(sm, T, mrow, zinv);
  uint32_t hr[2];
  row_hashes(hr, (uint32_t)seed[0], b, h, q0 + warp * 16 + g);

  // out = bf16(w_used) @ v; w_used formed in the A fragments from s
  float o[HD / 8][4] = {};
  for (int k0 = 0; k0 < T; k0 += KT) {
    __syncthreads();  // the previous V tile is consumed
    stage_rows(sm.kv, vmat, row0, k0, KT, T, D, col0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t a[4];  // rows g, g+8 (r & 1) by columns 2t, 2t+1 (+8 for r >= 2)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int half = r & 1, k = k0 + kk * 16 + 2 * t + 8 * (r >> 1);
        const int rowl = warp * 16 + g + 8 * half;
        float w[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          w[e] = weight(sm, LDS, rowl, k + e, T, mrow[half], zinv[half]) *
                 drop.factor(hr[half], k + e);
        a[r] = pack2f(w[0], w[1]);
      }
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        uint32_t b0, b1;
        load_b_rows(b0, b1, sm.kv + (kk * 16) * LDH + nt * 8, LDH, g, t);
        mma_bf16(o[nt], a, b0, b1);
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = q0 + warp * 16 + g + 8 * half;
    if (q < T) {
      bf16* orow = out + (row0 + q) * D + col0;
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt)
        *reinterpret_cast<uint32_t*>(orow + nt * 8 + 2 * t) =
            pack2f(o[nt][2 * half], o[nt][2 * half + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// backward 1: the query side
// ---------------------------------------------------------------------------

// dwu[nt] = (g v^T) of the warp's rows and the staged V tile's 64 keys
__device__ inline void gv_product(float (&dwu)[KT / 8][4], const uint32_t (&ag)[4][4],
                                  const bf16* sv, int g, int t) {
#pragma unroll
  for (int nt = 0; nt < KT / 8; ++nt) dwu[nt][0] = dwu[nt][1] = dwu[nt][2] = dwu[nt][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) {
      const bf16* vb = sv + (nt * 8 + g) * LDH + kk * 16 + 2 * t;
      mma_bf16(dwu[nt], ag[kk], ld32(vb), ld32(vb + 8));
    }
  }
}

__global__ void __launch_bounds__(NTHREADS)
rel_attention_train_bwd_rows_kernel(
    const bf16* __restrict__ qu, const bf16* __restrict__ qv, const bf16* __restrict__ kmat,
    const bf16* __restrict__ vmat, const bf16* __restrict__ p,
    const uint8_t* __restrict__ key_valid, const int* __restrict__ seed,
    const bf16* __restrict__ gmat, bf16* __restrict__ dqu, bf16* __restrict__ dqv,
    bf16* __restrict__ ds_out, bf16* __restrict__ w_out, int T, int H, float scale_f,
    Dropout drop) {
  extern __shared__ float smem[];
  const ScoreSmem sm = carve(smem, T, 1);
  bf16* sv = sm.kv + KT * LDH;  // the second tile: V (K is in sm.kv)
  const int LDS = padded_len(T) + 8;
  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int D = H * HD, col0 = h * HD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t row0 = (size_t)b * T;
  const size_t scratch0 = ((size_t)b * H + h) * T;  // row (b, h, 0) of [B, H, T, T]

  // the warp's rows of g as A fragments (staged in the V tile's space), and
  // of q+u / q+v for the score pass (staged in the p window's space)
  stage_rows(sm.p, qu, row0, q0, QT, T, D, col0);
  stage_rows(sm.p + QT * LDH, qv, row0, q0, QT, T, D, col0);
  stage_rows(sv, gmat, row0, q0, QT, T, D, col0);
  stage_mask(sm.mask, key_valid, row0, T);
  __syncthreads();
  uint32_t ag[4][4];
  float mrow[2], zinv[2];
  {
    uint32_t au[4][4], av[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      load_a(au[kk], sm.p + warp * 16 * LDH + kk * 16, LDH, g, t);
      load_a(av[kk], sm.p + QT * LDH + warp * 16 * LDH + kk * 16, LDH, g, t);
      load_a(ag[kk], sv + warp * 16 * LDH + kk * 16, LDH, g, t);
    }
    score_pass(sm, au, av, kmat, p, row0, q0, T, D, col0, round_bf16(scale_f), mrow);
  }
  softmax_sums(sm, T, mrow, zinv);
  uint32_t hr[2];
  row_hashes(hr, (uint32_t)seed[0], b, h, q0 + warp * 16 + g);

  // pass 2: sum_k dw w of the lane's rows
  float dsum[2] = {0.f, 0.f};
  for (int k0 = 0; k0 < T; k0 += KT) {
    __syncthreads();
    stage_rows(sv, vmat, row0, k0, KT, T, D, col0);
    __syncthreads();
    float dwu[KT / 8][4];
    gv_product(dwu, ag, sv, g, t);
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int half = j >> 1, k = k0 + nt * 8 + 2 * t + (j & 1);
        const float w = weight(sm, LDS, warp * 16 + g + 8 * half, k, T, mrow[half], zinv[half]);
        dsum[half] += dwu[nt][j] * drop.factor(hr[half], k) * w;
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    dsum[half] += __shfl_xor_sync(0xffffffffu, dsum[half], 1);
    dsum[half] += __shfl_xor_sync(0xffffffffu, dsum[half], 2);
  }

  // pass 3: ds per key tile -> scratch, dq_u += ds k, dq_v += W p
  float oqu[HD / 8][4] = {}, oqv[HD / 8][4] = {};
  bf16* win = sm.bd + warp * 16 * LDB;
  const int wb = QT - 16 - 16 * warp;
  for (int k0 = 0; k0 < T; k0 += KT) {
    __syncthreads();
    stage_rows(sm.kv, kmat, row0, k0, KT, T, D, col0);
    stage_rows(sv, vmat, row0, k0, KT, T, D, col0);
    stage_rows(sm.p, p, 0, k0 - q0 - (QT - 1) + (T - 1), PW, 2 * T - 1, D, col0);
    for (int i = lane; i < 16 * LDB / 2; i += 32) reinterpret_cast<uint32_t*>(win)[i] = 0u;
    __syncthreads();
    float dwu[KT / 8][4];
    gv_product(dwu, ag, sv, g, t);
    // ds (bf16) in the C layout of the product: dsb[nt][j], row g + 8 (j >> 1),
    // key nt * 8 + 2t + (j & 1)
    uint32_t dsb[KT / 8][2];
#pragma unroll
    for (int nt = 0; nt < KT / 8; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = g + 8 * half, c = nt * 8 + 2 * t;
        const int q = q0 + warp * 16 + rl;
        float dsv[2], wu[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = k0 + c + e;
          const float w = weight(sm, LDS, warp * 16 + rl, k, T, mrow[half], zinv[half]);
          const float keep = drop.factor(hr[half], k);
          dsv[e] = w * (dwu[nt][2 * half + e] * keep - dsum[half]) * scale_f;
          if (k >= T) dsv[e] = 0.f;
          wu[e] = w * keep;
        }
        const bf16 d0 = __float2bfloat16(dsv[0]), d1 = __float2bfloat16(dsv[1]);
        dsb[nt][half] = pack2(d0, d1);
        win[rl * LDB + c - rl + 15] = d0;
        win[rl * LDB + c + 1 - rl + 15] = d1;
        if (q < T) {
          const size_t o = (scratch0 + q) * T + k0 + c;
          if (k0 + c < T) {
            ds_out[o] = d0;
            w_out[o] = __float2bfloat16(wu[0]);
          }
          if (k0 + c + 1 < T) {
            ds_out[o + 1] = d1;
            w_out[o + 1] = __float2bfloat16(wu[1]);
          }
        }
      }
    }
    // dq_u += ds k: the C fragments of key tiles 2kk, 2kk+1 are the A fragment
    // of k-step kk
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      const uint32_t a[4] = {dsb[2 * kk][0], dsb[2 * kk][1], dsb[2 * kk + 1][0],
                             dsb[2 * kk + 1][1]};
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        uint32_t b0, b1;
        load_b_rows(b0, b1, sm.kv + (kk * 16) * LDH + nt * 8, LDH, g, t);
        mma_bf16(oqu[nt], a, b0, b1);
      }
    }
    __syncwarp();  // the window is complete
    // dq_v += W p_window: W [16, 80] (5 k-steps), p rows wb .. wb + 79
#pragma unroll
    for (int kk = 0; kk < BDW / 16; ++kk) {
      uint32_t a[4];
      load_a(a, win + kk * 16, LDB, g, t);
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        uint32_t b0, b1;
        load_b_rows(b0, b1, sm.p + (wb + kk * 16) * LDH + nt * 8, LDH, g, t);
        mma_bf16(oqv[nt], a, b0, b1);
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int q = q0 + warp * 16 + g + 8 * half;
    if (q < T) {
      bf16* ru = dqu + (row0 + q) * D + col0;
      bf16* rv = dqv + (row0 + q) * D + col0;
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        *reinterpret_cast<uint32_t*>(ru + nt * 8 + 2 * t) =
            pack2f(oqu[nt][2 * half], oqu[nt][2 * half + 1]);
        *reinterpret_cast<uint32_t*>(rv + nt * 8 + 2 * t) =
            pack2f(oqv[nt][2 * half], oqv[nt][2 * half + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward 2: the key side, dv = w_used^T g and dk = ds^T q_u
// ---------------------------------------------------------------------------

// Stage the [64 q][64 k] tile of a [T, T] scratch matrix (rows q0.., columns
// k0..), zero outside [0, T).
__device__ inline void stage_scratch(bf16* dst, const bf16* src, int q0, int k0, int T) {
  for (int i = threadIdx.x; i < QT * KT; i += NTHREADS) {
    const int r = i / KT, c = i % KT;
    const int q = q0 + r, k = k0 + c;
    dst[r * LDH + c] = (q < T && k < T) ? src[(size_t)q * T + k] : __float2bfloat16(0.f);
  }
}

__global__ void __launch_bounds__(NTHREADS)
rel_attention_train_bwd_keys_kernel(const bf16* __restrict__ qu, const bf16* __restrict__ gmat,
                                    const bf16* __restrict__ ds_in,
                                    const bf16* __restrict__ w_in, bf16* __restrict__ dk,
                                    bf16* __restrict__ dv, int T, int H) {
  __shared__ __align__(16) bf16 s_ds[QT * LDH], s_w[QT * LDH], s_q[QT * LDH], s_g[QT * LDH];
  const int k0 = blockIdx.x * KT, h = blockIdx.y, b = blockIdx.z;
  const int D = H * HD, col0 = h * HD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t row0 = (size_t)b * T;
  const size_t m0 = ((size_t)b * H + h) * T * T;
  float odk[HD / 8][4] = {}, odv[HD / 8][4] = {};
  const int kl = warp * 16;  // the warp's 16 keys within the tile
  for (int q0 = 0; q0 < T; q0 += QT) {
    __syncthreads();
    stage_scratch(s_ds, ds_in + m0, q0, k0, T);
    stage_scratch(s_w, w_in + m0, q0, k0, T);
    stage_rows(s_q, qu, row0, q0, QT, T, D, col0);
    stage_rows(s_g, gmat, row0, q0, QT, T, D, col0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < QT / 16; ++kk) {
      // A[m = key][k = query] = tile[query][key]: the transposed fragment
      uint32_t ad[4], aw[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int key = kl + g + 8 * (r & 1), q = kk * 16 + 2 * t + 8 * (r >> 1);
        ad[r] = pack2(s_ds[q * LDH + key], s_ds[(q + 1) * LDH + key]);
        aw[r] = pack2(s_w[q * LDH + key], s_w[(q + 1) * LDH + key]);
      }
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        uint32_t b0, b1;
        load_b_rows(b0, b1, s_q + (kk * 16) * LDH + nt * 8, LDH, g, t);
        mma_bf16(odk[nt], ad, b0, b1);
        load_b_rows(b0, b1, s_g + (kk * 16) * LDH + nt * 8, LDH, g, t);
        mma_bf16(odv[nt], aw, b0, b1);
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int k = k0 + kl + g + 8 * half;
    if (k < T) {
      bf16* rk = dk + (row0 + k) * D + col0;
      bf16* rv = dv + (row0 + k) * D + col0;
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        *reinterpret_cast<uint32_t*>(rk + nt * 8 + 2 * t) =
            pack2f(odk[nt][2 * half], odk[nt][2 * half + 1]);
        *reinterpret_cast<uint32_t*>(rv + nt * 8 + 2 * t) =
            pack2f(odv[nt][2 * half], odv[nt][2 * half + 1]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// backward 3: the position side, dp[j] = sum_(b, q) ds[b, q, j - (T-1) + q] q_v[b, q]
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(NTHREADS)
rel_attention_train_bwd_pos_kernel(const bf16* __restrict__ qv, const bf16* __restrict__ ds_in,
                                   float* __restrict__ dp, int B, int T, int H) {
  __shared__ __align__(16) bf16 s_a[QT * LDH], s_q[QT * LDH];
  const int j0 = blockIdx.x * QT, h = blockIdx.y;
  const int D = H * HD, col0 = h * HD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  float acc[HD / 8][4] = {};
  for (int b = 0; b < B; ++b) {
    const bf16* m = ds_in + ((size_t)b * H + h) * T * T;
    for (int q0 = 0; q0 < T; q0 += QT) {
      __syncthreads();
      // s_a[jj][qq] = ds[q0 + qq, j0 + jj - (T - 1) + q0 + qq]; consecutive
      // threads read consecutive keys of one row
      for (int i = threadIdx.x; i < QT * QT; i += NTHREADS) {
        const int qq = i / QT, jj = i % QT;
        const int q = q0 + qq, k = j0 + jj - (T - 1) + q;
        s_a[jj * LDH + qq] = (q < T && k >= 0 && k < T) ? m[(size_t)q * T + k]
                                                         : __float2bfloat16(0.f);
      }
      stage_rows(s_q, qv, (size_t)b * T, q0, QT, T, D, col0);
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < QT / 16; ++kk) {
        uint32_t a[4];
        load_a(a, s_a + warp * 16 * LDH + kk * 16, LDH, g, t);
#pragma unroll
        for (int nt = 0; nt < HD / 8; ++nt) {
          uint32_t b0, b1;
          load_b_rows(b0, b1, s_q + (kk * 16) * LDH + nt * 8, LDH, g, t);
          mma_bf16(acc[nt], a, b0, b1);
        }
      }
    }
  }
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = j0 + warp * 16 + g + 8 * half;
    if (j < 2 * T - 1) {
      float* row = dp + (size_t)j * D + col0;
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        row[nt * 8 + 2 * t] = acc[nt][2 * half];
        row[nt * 8 + 2 * t + 1] = acc[nt][2 * half + 1];
      }
    }
  }
}

Dropout make_dropout(int use_dropout, uint32_t thresh, float inv_keep) {
  Dropout d;
  d.on = use_dropout;
  d.thresh = thresh;
  d.inv_keep = inv_keep;
  return d;
}

}  // namespace

extern "C" {

// q_u, q_v, k, v, out: [B, T, H*64] bf16, contiguous, 16-byte aligned;
// p: [2T-1, H*64] bf16; key_valid: [B, T] bytes; seed: one int32; all on card
// `device`. The shared memory grows with T (64 x T bf16 score rows): T = 1024
// takes ~172 KB of the 227 KB a block may have.
int rel_attention_train_fwd_bf16(const void* q_u, const void* q_v, const void* k,
                                 const void* v, const void* p, const void* key_valid,
                                 const void* seed, void* out, int B, int T, int H,
                                 float scale, int use_dropout, uint32_t thresh,
                                 float inv_keep, int device, void* stream) {
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' card explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = score_smem_bytes(T, 0);
  err = cudaFuncSetAttribute(rel_attention_train_fwd_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + QT - 1) / QT, H, B);
  rel_attention_train_fwd_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q_u), static_cast<const bf16*>(q_v),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<const bf16*>(p),
      static_cast<const uint8_t*>(key_valid), static_cast<const int*>(seed),
      static_cast<bf16*>(out), T, H, scale, make_dropout(use_dropout, thresh, inv_keep));
  return (int)cudaGetLastError();
}

// The inputs as above plus g [B, T, H*64] bf16; outputs dq_u, dq_v, dk, dv
// [B, T, H*64] bf16 and dp [2T-1, H*64] f32; ds_scratch and w_scratch:
// [B, H, T, T] bf16 each. Three launches on `stream`, in order.
int rel_attention_train_bwd_bf16(const void* q_u, const void* q_v, const void* k,
                                 const void* v, const void* p, const void* key_valid,
                                 const void* seed, const void* g, void* dq_u, void* dq_v,
                                 void* dk, void* dv, void* dp, void* ds_scratch,
                                 void* w_scratch, int B, int T, int H, float scale,
                                 int use_dropout, uint32_t thresh, float inv_keep,
                                 int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  const size_t smem = score_smem_bytes(T, 1);
  err = cudaFuncSetAttribute(rel_attention_train_bwd_rows_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int nq = (T + QT - 1) / QT;
  rel_attention_train_bwd_rows_kernel<<<dim3(nq, H, B), NTHREADS, smem, s>>>(
      static_cast<const bf16*>(q_u), static_cast<const bf16*>(q_v),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<const bf16*>(p),
      static_cast<const uint8_t*>(key_valid), static_cast<const int*>(seed),
      static_cast<const bf16*>(g), static_cast<bf16*>(dq_u), static_cast<bf16*>(dq_v),
      static_cast<bf16*>(ds_scratch), static_cast<bf16*>(w_scratch), T, H, scale,
      make_dropout(use_dropout, thresh, inv_keep));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rel_attention_train_bwd_keys_kernel<<<dim3(nq, H, B), NTHREADS, 0, s>>>(
      static_cast<const bf16*>(q_u), static_cast<const bf16*>(g),
      static_cast<const bf16*>(ds_scratch), static_cast<const bf16*>(w_scratch),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), T, H);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rel_attention_train_bwd_pos_kernel<<<dim3((2 * T - 1 + QT - 1) / QT, H), NTHREADS, 0, s>>>(
      static_cast<const bf16*>(q_v), static_cast<const bf16*>(ds_scratch),
      static_cast<float*>(dp), B, T, H);
  return (int)cudaGetLastError();
}

}  // extern "C"
