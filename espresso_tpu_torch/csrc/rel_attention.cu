// Relative-position self-attention for inference, bf16 in and out, sm_90a.
//
// Replaces the TPU kernel espresso_tpu/ops/attention_kernels.py::
// rel_attention_fused (Pallas; the conformer encoder's attention at decode).
// Per (utterance b, head h), with flattened heads [B, T, H*64]:
//
//   ac[q,k] = (q+u)[q] . k[k]                    fp32 sum of bf16 products
//   bd[q,k] = (q+v)[q] . p[k - q + T - 1]        the espnet relative shift
//   s       = bf16(bf16(ac) + bf16(bd)) * bf16(scale), rounded to bf16
//   w       = bf16(softmax_fp32(s + mask))       mask 0 or -1e8 (not -inf)
//   out[q]  = bf16(sum_k w[q,k] v[k])            fp32 sum
//
// exactly the arithmetic of the Pallas kernel (attention_kernels.py:140-180).
//
// What bounds it on an H100: at the flagship decode shape (B=256, T'=156,
// H=8, d=64) one layer moves about 200 MB of bf16 I/O (q+u, q+v, k, v, out:
// 5*B*T*D*2 bytes) and does about 19 GFLOP (ac, bd and PV at ~6.4 each):
// ~95 FLOP a byte, below the card's bf16 ridge of ~295, so a kernel that
// keeps the [T, T] scores on chip is bounded by memory traffic.
//
// What the design does about it: one block owns QT=64 query rows of one
// (b, h) and keeps their whole score row block in shared memory (bf16,
// 64 x T), so nothing of size [B, H, T, T] reaches device memory and q/k/v/p
// are read once per block (k, v and the p window are re-read by the T/QT
// query tiles of a head, which the 50 MB L2 serves). The products run on
// the tensor cores (mma.sync m16n8k16, bf16 in, fp32 accumulate), each warp
// owning 16 query rows:
//   - ac: the warp's [16, 64] tile against a 64-key tile;
//   - bd: the TPU kernel's [T, 2T-1] bd_full matrix and its bit-decomposed
//     roll are not carried over. Per key tile the warp multiplies its rows
//     by the 80 rows of p its (row, key) pairs can reach, a [16, 80] window
//     product, rounds it to bf16 into shared memory, and reads
//     bd[r, c] = window[r, c - r + 15] back shifted;
//   - the softmax runs in fp32 over each full row without a pass of its own:
//     the row max comes from the score fragments in registers, one pass over
//     the stored s gives the sum, and w = bf16(e / z) is formed in the
//     A fragments of the last product (on an H100 at the flagship shape, a
//     first version with a separate per-row softmax pass spent 0.52 of its
//     0.91 ms there);
//   - out: w [16, T] times v, tile by tile.
// Loads are plain 16-byte loads without pipelining (cp.async / TMA and
// wgmma are later work).
//
// C entry: rel_attention_bf16(...) returns the CUDA error of the launch; it
// launches on the given stream and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

typedef __nv_bfloat16 bf16;

constexpr int HD = 64;             // head dim
constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int QT = NWARPS * 16;    // query rows per block (16 per warp)
constexpr int KT = 64;             // keys per tile
constexpr int PW = QT + KT;        // p rows staged per key tile (QT + KT - 1 used)
static_assert(2 * QT <= PW, "q+u and q+v are staged in the p window's space");
constexpr int LDH = HD + 8;        // bf16 row stride of q/k/v/p tiles (144 B)
constexpr int BDW = 80;            // bd window columns per warp (79 used)
constexpr int LDB = BDW + 8;       // its row stride
constexpr float kMaskFill = -1.0e8f;

__host__ __device__ inline int padded_len(int T) { return (T + KT - 1) / KT * KT; }

__host__ inline size_t smem_bytes(int T) {
  const int Tp = padded_len(T);
  return sizeof(float) * Tp +
         sizeof(bf16) * (KT * LDH + PW * LDH + NWARPS * 16 * LDB +
                         QT * (Tp + 8));
}

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

// Stage rows [r0, r0 + nrows) of one head of a [*, D] bf16 matrix into
// shared memory (row stride LDH) with 16-byte loads; rows outside
// [0, nvalid) are zero.
__device__ inline void stage_rows(bf16* dst, const bf16* src, size_t src_row0, int r0,
                                  int nrows, int nvalid, int D, int col0) {
  for (int i = threadIdx.x; i < nrows * (HD / 8); i += NTHREADS) {
    const int r = i / (HD / 8), c = (i % (HD / 8)) * 8;
    const int g = r0 + r;
    uint4 x = make_uint4(0u, 0u, 0u, 0u);
    if (g >= 0 && g < nvalid)
      x = *reinterpret_cast<const uint4*>(src + (src_row0 + g) * D + col0 + c);
    *reinterpret_cast<uint4*>(dst + r * LDH + c) = x;
  }
}

__global__ void __launch_bounds__(NTHREADS)
rel_attention_kernel(const bf16* __restrict__ qu, const bf16* __restrict__ qv,
                     const bf16* __restrict__ kmat, const bf16* __restrict__ vmat,
                     const bf16* __restrict__ p, const uint8_t* __restrict__ key_valid,
                     bf16* __restrict__ out, int T, int H, float scale_f) {
  extern __shared__ float smem[];
  const int Tp = padded_len(T), LDS = Tp + 8;
  float* sMask = smem;                                   // [Tp] additive key mask
  bf16* sKV = reinterpret_cast<bf16*>(sMask + Tp);       // [KT][LDH]: K, later V
  bf16* sP = sKV + KT * LDH;                             // [PW][LDH]: p window
  bf16* sBD = sP + PW * LDH;                             // [NWARPS][16][LDB]
  bf16* sS = sBD + NWARPS * 16 * LDB;                    // [QT][LDS]: scores s
  // q+u and q+v are read once into registers, so they are staged in the
  // p window's space before the first p tile arrives
  bf16* sQu = sP;                                        // [QT][LDH]
  bf16* sQv = sP + QT * LDH;                             // [QT][LDH]

  const int q0 = blockIdx.x * QT, h = blockIdx.y, b = blockIdx.z;
  const int D = H * HD, col0 = h * HD;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t row0 = (size_t)b * T;
  const float scale = round_bf16(scale_f);

  stage_rows(sQu, qu, row0, q0, QT, T, D, col0);
  stage_rows(sQv, qv, row0, q0, QT, T, D, col0);
  for (int k = threadIdx.x; k < Tp; k += NTHREADS)
    sMask[k] = (k < T && key_valid[row0 + k]) ? 0.f : kMaskFill;
  __syncthreads();

  // the warp's 16 query rows as A fragments, for the 4 k-steps of d = 64
  uint32_t au[4][4], av[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    load_a(au[kk], sQu + warp * 16 * LDH + kk * 16, LDH, g, t);
    load_a(av[kk], sQv + warp * 16 * LDH + kk * 16, LDH, g, t);
  }
  bf16* bdw = sBD + warp * 16 * LDB;
  bf16* srows = sS + warp * 16 * LDS;
  // block row r = 16*warp + rl and key k0 + c need p-window row
  // c - r + QT - 1 = wb + (c - rl + 15), with the warp's window base wb
  const int wb = QT - 16 - 16 * warp;
  // row maxima of s + mask for the lane's rows g and g + 8 (exact: max does
  // not depend on order), combined over the 4 lanes of a row below
  float mrow[2] = {-__int_as_float(0x7f800000), -__int_as_float(0x7f800000)};

  // ---- scores: s into shared memory (bf16), row maxima in registers
  for (int k0 = 0; k0 < Tp; k0 += KT) {
    __syncthreads();  // the previous tile's readers are done with sKV / sP
    stage_rows(sKV, kmat, row0, k0, KT, T, D, col0);
    // p-window row j <-> table row k0 - q0 - (QT - 1) + (T - 1) + j
    stage_rows(sP, p, 0, k0 - q0 - (QT - 1) + (T - 1), PW, 2 * T - 1, D, col0);
    __syncthreads();

    {  // window[rl, j] = (q+v)[rl] . p_window[wb + j], rounded to bf16
      float acc[BDW / 8][4] = {};
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
#pragma unroll
        for (int nt = 0; nt < BDW / 8; ++nt) {
          const bf16* pb = sP + (wb + nt * 8 + g) * LDH + kk * 16 + 2 * t;
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
        const bf16* kb = sKV + (nt * 8 + g) * LDH + kk * 16 + 2 * t;
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
          // a product of two bf16 values is exact in fp32; round it to bf16
          s[e] = round_bf16(round_bf16(round_bf16(ac[nt][2 * half + e]) + bd) * scale);
          if (k0 + c + e < T) mrow[half] = fmaxf(mrow[half], s[e] + sMask[k0 + c + e]);
        }
        *reinterpret_cast<uint32_t*>(srows + rl * LDS + k0 + c) = pack2f(s[0], s[1]);
      }
    }
  }
  __syncwarp();

  // ---- softmax, fp32 over each full row: the lane's fragment columns of its
  // rows (2t, 2t+1, 2t+8, 2t+9 of every 16), so the 4 lanes of a row
  // (t = 0..3) cover it and combine with two shuffles
  float z[2] = {0.f, 0.f};  // row sums, then their reciprocals
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    mrow[half] = fmaxf(mrow[half], __shfl_xor_sync(0xffffffffu, mrow[half], 1));
    mrow[half] = fmaxf(mrow[half], __shfl_xor_sync(0xffffffffu, mrow[half], 2));
    const bf16* srow = srows + (g + 8 * half) * LDS;
    for (int c0 = 0; c0 < T; c0 += 16) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = c0 + 2 * t + (j & 1) + 8 * (j >> 1);
        if (k < T) z[half] += expf(__bfloat162float(srow[k]) + sMask[k] - mrow[half]);
      }
    }
    z[half] += __shfl_xor_sync(0xffffffffu, z[half], 1);
    z[half] += __shfl_xor_sync(0xffffffffu, z[half], 2);
    // e * (1/z) is within an fp32 ulp of e / z before the bf16 rounding, and
    // a division per element cost 0.11 of 0.87 ms (H100, flagship shape)
    z[half] = 1.f / z[half];
  }

  // ---- out = w @ v, with w = bf16(e / z) formed in the A fragments from s.
  // Columns past T give w = 0 (and their V rows are staged as zeros).
  float o[HD / 8][4] = {};
  for (int k0 = 0; k0 < T; k0 += KT) {
    __syncthreads();  // the previous V tile is consumed
    stage_rows(sKV, vmat, row0, k0, KT, T, D, col0);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < KT / 16; ++kk) {
      uint32_t a[4];  // rows g, g+8 (r & 1) by columns 2t, 2t+1 (+8 for r >= 2)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int half = r & 1, k = k0 + kk * 16 + 2 * t + 8 * (r >> 1);
        const bf16* sp = srows + (g + 8 * half) * LDS + k;
        float w[2];
#pragma unroll
        for (int e = 0; e < 2; ++e)
          w[e] = k + e < T
                     ? expf(__bfloat162float(sp[e]) + sMask[k + e] - mrow[half]) * z[half]
                     : 0.f;
        a[r] = pack2f(w[0], w[1]);
      }
#pragma unroll
      for (int nt = 0; nt < HD / 8; ++nt) {
        // B[k][n] = v[key k][feature n]: rows 2t, 2t+1 and 2t+8, 2t+9
        const bf16* vb = sKV + (kk * 16 + 2 * t) * LDH + nt * 8 + g;
        mma_bf16(o[nt], a, pack2(vb[0], vb[LDH]), pack2(vb[8 * LDH], vb[9 * LDH]));
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

}  // namespace

extern "C" {

// q_u, q_v, k, v, out: [B, T, H*64] bf16, contiguous, 16-byte aligned;
// p: [2T-1, H*64] bf16; key_valid: [B, T] bytes (bool); all on card
// `device`. Launches on `stream` (a stream of that card); returns the CUDA
// error code of the first call that failed (0 on success). The shared
// memory grows with T (64 x T bf16 scores): T = 1024 takes ~171 KB of the
// 227 KB a block may have.
int rel_attention_bf16(const void* q_u, const void* q_v, const void* k,
                       const void* v, const void* p, const void* key_valid,
                       void* out, int B, int T, int H, float scale, int device,
                       void* stream) {
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' card explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(T);
  err = cudaFuncSetAttribute(
      rel_attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + QT - 1) / QT, H, B);
  rel_attention_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(q_u), static_cast<const bf16*>(q_v),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const bf16*>(p), static_cast<const uint8_t*>(key_valid),
      static_cast<bf16*>(out), T, H, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
