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
// (the TPU kernel's dense fallback for unaligned shapes, which does not
// quantize x, is not reproduced). XLA folds the kernel's division by the
// constant 127 into a product with its f32 reciprocal; an IEEE quotient
// there differs in the last bit of ~1.5 % of the outputs, so the scale
// takes the product too.
//
// What bounds it on an H100: at the flagship FFN shape (M = 39,936, K =
// 512, N = 2048) the 84 G int8 operations take 0.042 ms at 1979 TOP/s, the
// f32 x read and the f32 output written (409 MB) 0.122 ms: bytes. The
// output (327 MB there) is most of them.
//
// What the design does about it: two launches.
//   1. The row pass (a warp a row) reads x once by 16-byte loads (where
//      x's rows allow them; the row stays in registers up to K = 2048),
//      takes the row's amax, and writes xq [M, Kp]
//      (Kp: K rounded up to 128, zeros past K, so that every k-tile of the
//      product is one 128-byte TMA box) and xs [M]. It stays a launch of
//      its own: at K = 2048 and more than one N tile a fused quantization
//      would read x once per N tile.
//   2. The product is persistent, a block an SM, over 128 x 256 output
//      tiles taken N-inner (a row of tiles of xq reuses w from L2). A
//      producer warpgroup (its registers given away by setmaxnreg) has one
//      thread feed a 4-stage ring guarded by mbarriers with TMA k-tiles of
//      xq [128 rows x 128 B] and w [256 rows x 128 B] (both K-major, as s8
//      wgmma takes them, 128-byte swizzled, zeros past M, N and K); two
//      consumer warpgroups each run wgmma m64n256k32 s8 on their 64 rows
//      (128 s32 accumulators a thread), releasing each stage as the next
//      one's products are issued. The epilogue scales in the order above
//      and stages the tile in [64 x 32] f32 boxes, two a warpgroup in turn,
//      in shared memory (128-byte swizzled: no bank conflicts), which a
//      TMA store writes out (clipped at M and N) while the warpgroup fills
//      the next box; the producer has already brought the next tile's
//      k-tiles, so tile i's stores run under tile i + 1's main loop.
//   Edges: where w's rows are not 16-byte aligned (K = 200: a row stride
//   TMA cannot read), the wrapper passes a zero-padded [N, Kp] copy; where
//   N * 4 bytes is not a multiple of 16 (no f32 tensor map), the epilogue
//   stores each element through a predicate instead (kTmaStore = false).
//
// C entry: int8_matmul_f32(...) returns the CUDA error of the launches; it
// launches on the given stream and does not synchronise.

#include "hopper_sm90.cuh"

namespace {

using namespace sm90;

constexpr int BM = 128, BN = 256;  // output tile: two consumer warpgroups of 64 rows
constexpr int BK = 128;            // k bytes a ring stage (one 128-byte swizzle row)
constexpr int STAGES = 4;
constexpr int A_BYTES = BM * BK, B_BYTES = BN * BK;
constexpr int STAGE = A_BYTES + B_BYTES;  // 48 KB
constexpr int OUT_COLS = 32;              // f32 columns of a store box: 128 bytes a row
constexpr int OUT_BOX = 64 * OUT_COLS * 4;  // a warpgroup's [64 x 32] f32 box, 8 KB
constexpr int NTHREADS = 384;             // producer warpgroup + two consumer warpgroups
constexpr int ROW_THREADS = 256;          // the row pass: a warp a row
constexpr int ROWS_PER_BLOCK = ROW_THREADS / 32;
constexpr int ROW_ELEMS = 64;             // elements of x a lane keeps in registers
constexpr float kInv127 = 1.0f / 127.0f;

struct Layout {  // dynamic shared memory, bytes from the 1024-aligned base
  static constexpr uint32_t ring = 0;
  static constexpr uint32_t out = ring + STAGES * STAGE;  // [2 warpgroups][2 boxes]
  static constexpr uint32_t bars = out + 4 * OUT_BOX;     // full[STAGES], empty[STAGES]
  static constexpr uint32_t total = bars + 2 * STAGES * 8;
};
constexpr int SMEM_BYTES = Layout::total + 1024;
static_assert(SMEM_BYTES <= 232448, "the product's shared memory fits a block");

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

__device__ __forceinline__ int quantize(float v, float s) {
  return max(-127, min(127, __float2int_rn(__fdiv_rn(v, s))));
}

// E = 16 / sizeof(T) elements a 16-byte load
template <typename T>
struct alignas(16) Vec16 {
  static constexpr int E = 16 / sizeof(T);
  T v[E];
};

// the row's scale from the lane's amax (the warp's max), written by lane 0
__device__ __forceinline__ float row_scale(float amax, int lane, float* xs_row) {
#pragma unroll
  for (int o = 16; o; o >>= 1) amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, o));
  const float s = __fmul_rn(fmaxf(amax, 1e-8f), kInv127);
  if (lane == 0) *xs_row = s;
  return s;
}

// the E bytes of xq of a chunk (zeros for a chunk past K: !in_k)
template <typename T>
__device__ __forceinline__ void store_chunk(int8_t* q, const Vec16<T>& c, bool in_k, float s) {
  constexpr int E = Vec16<T>::E;
  uint32_t w[E / 4];
#pragma unroll
  for (int i = 0; i < E / 4; ++i) w[i] = 0;
  if (in_k)
#pragma unroll
    for (int e = 0; e < E; ++e)
      w[e / 4] |= (uint32_t)(uint8_t)(int8_t)quantize(to_f32(c.v[e]), s) << (8 * (e % 4));
  if (E == 4)
    *reinterpret_cast<uint32_t*>(q) = w[0];
  else
    *reinterpret_cast<uint2*>(q) = make_uint2(w[0], w[E / 4 - 1]);
}

// kVec: x's rows start on 16 bytes and K is a multiple of E, so a 16-byte
// load of E elements is wholly inside or past K; lane l takes the chunks l,
// l + 32, ... (a warp's loads are contiguous) and writes E bytes of xq
// each. Where the row fits in ROW_ELEMS elements a lane (K <= 2048), the
// chunks stay in registers between the amax and the quantization (64 f32
// or 32 words of bf16 a lane), all loads in flight at once, so that x is
// read once; longer rows read their chunks again (from L2). Otherwise
// (!kVec) one element at a time.
template <typename T, bool kVec>
__global__ void __launch_bounds__(ROW_THREADS)
quantize_rows_kernel(const T* __restrict__ x, int M, int K, int Kp, int8_t* __restrict__ xq,
                     float* __restrict__ xs) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * ROWS_PER_BLOCK + (threadIdx.x >> 5);
  if (row >= M) return;
  const T* xr = x + (size_t)row * K;
  int8_t* q = xq + (size_t)row * Kp;
  if (!kVec) {
    float amax = 0.f;
    for (int k = lane; k < K; k += 32) amax = fmaxf(amax, fabsf(to_f32(xr[k])));
    const float s = row_scale(amax, lane, xs + row);
    for (int k = lane; k < Kp; k += 32) q[k] = (int8_t)(k < K ? quantize(to_f32(xr[k]), s) : 0);
    return;
  }
  constexpr int E = Vec16<T>::E, ROW_CHUNKS = ROW_ELEMS / E;
  if (K <= 32 * ROW_ELEMS) {  // the same branch for every warp of the launch
    Vec16<T> c[ROW_CHUNKS];
    float amax = 0.f;
#pragma unroll
    for (int i = 0; i < ROW_CHUNKS; ++i) {
      const int k0 = (32 * i + lane) * E;
      if (k0 < K) c[i] = *reinterpret_cast<const Vec16<T>*>(xr + k0);
    }
#pragma unroll
    for (int i = 0; i < ROW_CHUNKS; ++i)
      if ((32 * i + lane) * E < K)
#pragma unroll
        for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(to_f32(c[i].v[e])));
    const float s = row_scale(amax, lane, xs + row);
    // Kp <= 32 ROW_ELEMS too (both are multiples of 128)
#pragma unroll
    for (int i = 0; i < ROW_CHUNKS; ++i) {
      const int k0 = (32 * i + lane) * E;
      if (k0 < Kp) store_chunk<T>(q + k0, c[i], k0 < K, s);
    }
    return;
  }
  float amax = 0.f;
  for (int k0 = lane * E; k0 < K; k0 += 32 * E) {
    const Vec16<T> c = *reinterpret_cast<const Vec16<T>*>(xr + k0);
#pragma unroll
    for (int e = 0; e < E; ++e) amax = fmaxf(amax, fabsf(to_f32(c.v[e])));
  }
  const float s = row_scale(amax, lane, xs + row);
  for (int k0 = lane * E; k0 < Kp; k0 += 32 * E) {
    Vec16<T> c;
    if (k0 < K) c = *reinterpret_cast<const Vec16<T>*>(xr + k0);
    store_chunk<T>(q + k0, c, k0 < K, s);
  }
}

// the f32 pair of row `r` (r < 64) and columns c, c + 1 (c even, < 32) of a
// [64 x 32] f32 box in the 128-byte swizzle: byte r * 128 + (chunk ^ (r %
// 8)) * 16 + the pair's offset in its 16-byte chunk
__device__ __forceinline__ uint32_t box_offset(int r, int c) {
  return (uint32_t)r * 128u + ((uint32_t)((c / 4) ^ (r & 7)) << 4) + (uint32_t)(c % 4) * 4u;
}

// kTmaStore: N * 4 is a multiple of 16 bytes, so the output has a tensor
// map and the tile leaves by TMA stores; otherwise element by element
// through a predicate.
template <bool kTmaStore>
__global__ void __launch_bounds__(NTHREADS, 1)
int8_gemm_kernel(const __grid_constant__ CUtensorMap tm_a, const __grid_constant__ CUtensorMap tm_b,
                 const __grid_constant__ CUtensorMap tm_out, const float* __restrict__ xs,
                 const float* __restrict__ ws, float* __restrict__ out, int M, int N, int Kp) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + Layout::bars);
  uint64_t* empty = full + STAGES;
  const int ntn = (N + BN - 1) / BN, tiles = (M + BM - 1) / BM * ntn, nk = Kp / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's expect_tx
      mbar_init(&empty[s], 2);  // one thread of each consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x < 128) {
    // ---- producer: its thread 0 keeps the ring full, tile after tile
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / ntn * BM, n0 = tile % ntn * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int slot = it % STAGES;
          mbar_wait(&empty[slot], ((it / STAGES) & 1) ^ 1);
          const uint32_t st = base + Layout::ring + slot * STAGE;
          mbar_arrive_expect_tx(&full[slot], STAGE);
          tma_load_2d(st, &tm_a, &full[slot], kt * BK, m0);
          tma_load_2d(st + A_BYTES, &tm_b, &full[slot], kt * BK, n0);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup cw takes rows 64 cw .. 64 cw + 63 of each tile
  setmaxnreg_inc<232>();
  const int cw = threadIdx.x / 128 - 1, t = threadIdx.x % 128;
  const int warp = t / 32, g = (t % 32) / 4, q = t % 4;
  const uint32_t obox = base + Layout::out + cw * 2 * OUT_BOX;
  int it = 0, box = 0;
  for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
    const int m0 = tile / ntn * BM, n0 = tile % ntn * BN;
    int acc[128];
    int prev = -1;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int slot = it % STAGES;
      mbar_wait(&full[slot], (it / STAGES) & 1);
      const uint32_t st = base + Layout::ring + slot * STAGE;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < BK / 32; ++k)
        wgmma_s8_n256(acc, wgmma_desc(st + cw * (A_BYTES / 2) + 32 * k),
                      wgmma_desc(st + A_BYTES + 32 * k), kt > 0 || k > 0);
      wgmma_commit();
      wgmma_wait<1>();  // the previous stage's products are done
      if (prev >= 0 && t == 0) mbar_arrive(&empty[prev]);
      prev = slot;
    }
    wgmma_wait<0>();
    if (t == 0) mbar_arrive(&empty[prev]);

    // ---- epilogue: out = f32(acc) * xs[row] * ws[col], in 32-column boxes
    const int r0 = m0 + 64 * cw + 16 * warp + g, r1 = r0 + 8;
    const float sx0 = xs[r0 < M ? r0 : 0], sx1 = xs[r1 < M ? r1 : 0];
#pragma unroll
    for (int c = 0; c < BN / OUT_COLS; ++c) {
      float v[16];
      bool okc[8];
#pragma unroll
      for (int jj = 0; jj < 4; ++jj) {
        const int j = 4 * c + jj, col = n0 + 8 * j + 2 * q;
        const float w0 = ws[col < N ? col : 0], w1 = ws[col + 1 < N ? col + 1 : 0];
        okc[2 * jj] = col < N;
        okc[2 * jj + 1] = col + 1 < N;
        v[4 * jj + 0] = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 0]), sx0), w0);
        v[4 * jj + 1] = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 1]), sx0), w1);
        v[4 * jj + 2] = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 2]), sx1), w0);
        v[4 * jj + 3] = __fmul_rn(__fmul_rn(__int2float_rn(acc[4 * j + 3]), sx1), w1);
      }
      if (kTmaStore) {
        const uint32_t dst = obox + (box & 1) * OUT_BOX;
        // the store that last read this box (two boxes ago) is done reading
        if (t == 0) bulk_wait_read<1>();
        named_sync(2 + cw, 128);
#pragma unroll
        for (int jj = 0; jj < 4; ++jj)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * warp + g + 8 * h, cc = 8 * jj + 2 * q;
            *reinterpret_cast<float2*>(smem + (dst - base) + box_offset(r, cc)) =
                make_float2(v[4 * jj + 2 * h], v[4 * jj + 2 * h + 1]);
          }
        fence_proxy_async();
        named_sync(2 + cw, 128);
        if (t == 0) {
          tma_store_2d(&tm_out, dst, n0 + OUT_COLS * c, m0 + 64 * cw);
          bulk_commit();
        }
        ++box;
      } else {
#pragma unroll
        for (int jj = 0; jj < 4; ++jj) {
          const int col = n0 + 8 * (4 * c + jj) + 2 * q;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = h ? r1 : r0;
            float* o = out + (size_t)(r < M ? r : 0) * N + (okc[2 * jj] ? col : 0);
            st_global_if(o, __float_as_uint(v[4 * jj + 2 * h]), r < M && okc[2 * jj]);
            st_global_if(o + 1, __float_as_uint(v[4 * jj + 2 * h + 1]), r < M && okc[2 * jj + 1]);
          }
        }
      }
    }
  }
  // the shared memory stays until the last stores have read it
  if (kTmaStore && t == 0) bulk_wait_read<0>();
}

}  // namespace

extern "C" {

// x [M, K] (f32, or bf16 when x_bf16), w [N, Kw] int8 with row stride ldb
// bytes (Kw = K, or Kp for a zero-padded copy; base and ldb multiples of
// 16), w_scale [N] f32; scratch xq [M, Kp] int8 (Kp: K rounded up to 128,
// at least 128) and xs [M] f32; out [M, N] f32; `x_vec`: x's base is 16-byte
// aligned and K a multiple of 16 / its element size. Launches on `stream`
// of card `device`; returns the CUDA error code (0 on success).
int int8_matmul_f32(const void* x, int x_bf16, int x_vec, const void* w, const void* w_scale,
                    void* xq, void* xs, void* out, int M, int N, int K, int Kp, int Kw, int ldb,
                    int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (M == 0 || N == 0) return 0;
  if (Kp % BK != 0 || Kp < K || Kp < BK || ldb % 16 != 0 || Kw < K) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const dim3 qgrid((M + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK);
#define QROWS(T, V)                                                                     \
  quantize_rows_kernel<T, V><<<qgrid, ROW_THREADS, 0, st>>>(                            \
      static_cast<const T*>(x), M, K, Kp, static_cast<int8_t*>(xq), static_cast<float*>(xs))
  if (x_bf16) {
    if (x_vec) QROWS(__nv_bfloat16, true); else QROWS(__nv_bfloat16, false);
  } else {
    if (x_vec) QROWS(float, true); else QROWS(float, false);
  }
#undef QROWS
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  CUtensorMap maps[3];
  memset(maps, 0, sizeof(maps));
  int rc = encode_tmap_2d(&maps[0], CU_TENSOR_MAP_DATA_TYPE_UINT8, xq, (uint64_t)M, (uint64_t)Kp,
                          (uint64_t)Kp, BK, BM);
  if (rc != 0) return rc;
  rc = encode_tmap_2d(&maps[1], CU_TENSOR_MAP_DATA_TYPE_UINT8, w, (uint64_t)N, (uint64_t)Kw,
                      (uint64_t)ldb, BK, BN);
  if (rc != 0) return rc;
  const bool tma_store = (N * 4) % 16 == 0;
  if (tma_store) {
    rc = encode_tmap_2d(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, out, (uint64_t)M, (uint64_t)N,
                        (uint64_t)N * 4, OUT_COLS, 64);
    if (rc != 0) return rc;
  }
  const auto kernel = tma_store ? int8_gemm_kernel<true> : int8_gemm_kernel<false>;
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_BYTES);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (M + BM - 1) / BM * ((N + BN - 1) / BN);
  const int sms = sm_count(device);
  const dim3 grid(tiles < sms ? tiles : sms);
  kernel<<<grid, NTHREADS, SMEM_BYTES, st>>>(maps[0], maps[1], maps[2],
                                            static_cast<const float*>(xs),
                                            static_cast<const float*>(w_scale),
                                            static_cast<float*>(out), M, N, Kp);
  return (int)cudaGetLastError();
}

}  // extern "C"
