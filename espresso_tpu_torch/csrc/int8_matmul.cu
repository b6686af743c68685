// w8a8 matmul: per-row dynamic int8 quantization of x, int8 x int8 -> int32
// tensor-core products, dequantizing epilogue; sm_90a.
//
// Replaces the TPU kernel espresso_tpu/ops/quantization.py::int8_matmul
// (Pallas). For x [M, K] (f32 or bf16), w_q [K, N] int8 and w_scale [N] f32:
//
//   xs[m]     = max(max_k |x[m, k]|, 1e-8) * f32(1 / 127)
//   xq[m, k]  = clip(round_half_even(x[m, k] / xs[m]), -127, 127)  (IEEE division)
//   acc[m, n] = sum_k xq[m, k] * w_q[k, n]                 (int32, exact)
//   out[m, n] = float(acc[m, n]) * xs[m] * w_scale[n]      (in that order)
//
// bit for bit the TPU kernel's arithmetic as XLA runs it, at any M, K and N
// (the ragged edges are masked; the TPU kernel's dense fallback for
// unaligned shapes, which does not quantize x, is not reproduced). XLA folds
// the kernel's division by the constant 127 into a product with its f32
// reciprocal; an IEEE quotient there differs in the last bit of ~1.5 % of
// the outputs, so the scale takes the product too.
//
// What bounds it on an H100: at the flagship FFN shape (M = 39,936, K =
// 512, N = 2048) the 84 G int8 operations take 0.042 ms at 1979 TOP/s, the
// f32 x read and the f32 output written (409 MB) 0.122 ms: bytes.
//
// What the design does about it: two launches. A row pass (one warp per
// row) takes the row's amax and writes xq [M, Kp] int8, padded with zeros to
// Kp, a multiple of 64, and xs [M]. The product reads w_q in the nn.Linear
// layout [N, K] (k contiguous, as the tensor cores' B operand wants it),
// tiles 128 x 128 outputs per block of 8 warps (each 64 x 32, sixteen
// m16n8k32 s8 mma.sync per 32 of k) over 64-deep k steps staged by cp.async
// into two shared-memory buffers (rows padded to 80 bytes: the fragment
// loads hit 32 banks), and writes f32 through the epilogue. Fusing the
// quantization into the product, wgmma and TMA are for a later change.
//
// C entry: int8_matmul_f32(...) returns the CUDA error of the launches; it
// launches on the given stream and does not synchronise.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int LDS = BK + 16;  // bytes per staged row
constexpr int NTHREADS = 256;
constexpr int ROWS_PER_BLOCK = NTHREADS / 32;
constexpr float kInv127 = 1.0f / 127.0f;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T>
__global__ void __launch_bounds__(NTHREADS)
quantize_rows_kernel(const T* __restrict__ x, int M, int K, int Kp, int8_t* __restrict__ xq,
                     float* __restrict__ xs) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  float amax = 0.f;
  for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(to_f32(xr[k])));
#pragma unroll
  for (int o = 16; o; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = __fmul_rn(fmaxf(amax, 1e-8f), kInv127);
  if (lane == 0) xs[row] = s;
  int8_t* q = xq + (size_t)row * Kp;
  for (int k = lane; k < Kp; k += 32) {
    int v = 0;
    if (k < K) v = max(-127, min(127, __float2int_rn(__fdiv_rn(to_f32(xr[k]), s))));
    q[k] = (int8_t)v;
  }
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  const int n = pred ? 16 : 0;  // 0: zero-fill, read nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                       uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Stage k-step kt: A rows [bm, bm + BM) of xq (always 16-byte aligned, Kp a
// multiple of BK) and B rows [bn, bn + BN) of w [N, K] (row stride ldb).
// kAligned: w's rows and K are multiples of 16 bytes, so a 16-byte chunk is
// wholly in or out of range; otherwise bytes are read one by one.
template <bool kAligned>
__device__ __forceinline__ void load_tiles(const int8_t* __restrict__ xq,
                                           const int8_t* __restrict__ w, int8_t* As, int8_t* Bs,
                                           int bm, int bn, int kt, int M, int N, int K, int Kp,
                                           int ldb) {
  const int k0 = kt * BK;
  for (int c = threadIdx.x; c < BM * BK / 16; c += NTHREADS) {
    const int r = c / (BK / 16), col = (c % (BK / 16)) * 16;
    const bool ok = bm + r < M;
    cp_async16(As + r * LDS + col, ok ? xq + (size_t)(bm + r) * Kp + k0 + col : xq, ok);
  }
  for (int c = threadIdx.x; c < BN * BK / 16; c += NTHREADS) {
    const int r = c / (BK / 16), col = (c % (BK / 16)) * 16;
    const int n = bn + r, k = k0 + col;
    if (kAligned) {
      const bool ok = n < N && k < K;
      cp_async16(Bs + r * LDS + col, ok ? w + (size_t)n * ldb + k : w, ok);
    } else {
      int8_t* dst = Bs + r * LDS + col;
#pragma unroll
      for (int i = 0; i < 16; ++i)
        dst[i] = (n < N && k + i < K) ? w[(size_t)n * ldb + k + i] : (int8_t)0;
    }
  }
}

template <bool kAligned>
__global__ void __launch_bounds__(NTHREADS)
int8_gemm_kernel(const int8_t* __restrict__ xq, const int8_t* __restrict__ w,
                 const float* __restrict__ xs, const float* __restrict__ ws,
                 float* __restrict__ out, int M, int N, int K, int Kp, int ldb) {
  __shared__ __align__(16) int8_t As[2][BM * LDS];
  __shared__ __align__(16) int8_t Bs[2][BN * LDS];
  const int bm = blockIdx.y * BM, bn = blockIdx.x * BN;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const int wm = (warp & 1) * 64, wn = (warp >> 1) * 32;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[i][j][r] = 0;

  const int nk = Kp / BK;
  if (nk > 0) {
    load_tiles<kAligned>(xq, w, As[0], Bs[0], bm, bn, 0, M, N, K, Kp, ldb);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    const int cur = kt & 1;
    if (kt + 1 < nk) {
      load_tiles<kAligned>(xq, w, As[cur ^ 1], Bs[cur ^ 1], bm, bn, kt + 1, M, N, K, Kp, ldb);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int8_t* A = As[cur];
    const int8_t* Bt = Bs[cur];
#pragma unroll
    for (int kk = 0; kk < BK; kk += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int8_t* p = A + (wm + 16 * i + g) * LDS + kk + 4 * tq;
        a[i][0] = *reinterpret_cast<const uint32_t*>(p);
        a[i][1] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS);
        a[i][2] = *reinterpret_cast<const uint32_t*>(p + 16);
        a[i][3] = *reinterpret_cast<const uint32_t*>(p + 8 * LDS + 16);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int8_t* p = Bt + (wn + 8 * j + g) * LDS + kk + 4 * tq;
        b[j][0] = *reinterpret_cast<const uint32_t*>(p);
        b[j][1] = *reinterpret_cast<const uint32_t*>(p + 16);
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_s8(acc[i][j], a[i], b[j][0], b[j][1]);
    }
    __syncthreads();  // the buffer is refilled next step
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = bm + wm + 16 * i + g + 8 * h;
      if (m >= M) continue;
      const float sx = xs[m];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int n = bn + wn + 8 * j + 2 * tq + e;
          if (n < N)
            out[(size_t)m * N + n] =
                __fmul_rn(__fmul_rn(__int2float_rn(acc[i][j][2 * h + e]), sx), ws[n]);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// x [M, K] (f32, or bf16 when x_bf16), w [N, K] int8 with row stride ldb,
// w_scale [N] f32; scratch xq [M, Kp] int8 (Kp: K rounded up to 64) and
// xs [M] f32; out [M, N] f32. `aligned`: w's base address and ldb are
// multiples of 16 and so is K. Launches on `stream` of card `device`;
// returns the CUDA error code (0 on success).
int int8_matmul_f32(const void* x, int x_bf16, const void* w, const void* w_scale, void* xq,
                    void* xs, void* out, int M, int N, int K, int Kp, int ldb, int aligned,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M == 0 || N == 0) return 0;
  if (Kp % BK != 0 || Kp < K) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 qgrid((M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
  if (x_bf16)
    quantize_rows_kernel<__nv_bfloat16><<<qgrid, NTHREADS, 0, st>>>(
        static_cast<const __nv_bfloat16*>(x), M, K, Kp, static_cast<int8_t*>(xq),
        static_cast<float*>(xs));
  else
    quantize_rows_kernel<float><<<qgrid, NTHREADS, 0, st>>>(
        static_cast<const float*>(x), M, K, Kp, static_cast<int8_t*>(xq),
        static_cast<float*>(xs));
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  if (aligned)
    int8_gemm_kernel<true><<<grid, NTHREADS, 0, st>>>(
        static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w),
        static_cast<const float*>(xs), static_cast<const float*>(w_scale),
        static_cast<float*>(out), M, N, K, Kp, ldb);
  else
    int8_gemm_kernel<false><<<grid, NTHREADS, 0, st>>>(
        static_cast<const int8_t*>(xq), static_cast<const int8_t*>(w),
        static_cast<const float*>(xs), static_cast<const float*>(w_scale),
        static_cast<float*>(out), M, N, K, Kp, ldb);
  return (int)cudaGetLastError();
}

}  // extern "C"
