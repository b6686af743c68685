// Beam reorder + L-layer LSTM step + live mask on the packed state, bf16,
// sm_90a.
//
// Replaces the TPU kernel espresso_tpu/ops/decode_kernels.py::
// lstm_step_reorder (Pallas; the AES prediction-net advance, two calls per
// frame). With the packed state S = [h_0..h_{L-1} | c_0..c_{L-1}] [BK, 2LH]
// and s = src[r], per destination row r and layer l:
//
//   pre    = bf16(x_l[r] @ W_ih[l] + S[s].h_l @ W_hh[l] + b_ih[l])   fp32 sum
//   i,f,o  = sig(pre_i,f,o), g = tnh(pre_g)
//   c'     = bf16(bf16(f * c_l) + bf16(i * g)), h' = bf16(o * tnh(c'))
//   out    = live[r] ? (h', c') : (S[s].h_l, S[s].c_l);  x_{l+1}[r] = h'
//
// with gate order (i, f, g, o) and the TPU kernel's bf16 op chains
// sig(v) = 1 / (1 + exp(-v)) and tnh(v) = 2 / (1 + exp(-2v)) - 1, each op
// rounded to bf16, as decode_kernels.py:585-609 evaluates them; dead rows
// still feed their computed h' to the next layer (:610-612).
//
// What bounds it on an H100: at the flagship frame step (BK = 2560, H =
// 512, L = 2) a call does ~21.5 GFLOP (per layer a [2560, 1024] x
// [1024, 2048] product): ~22 us at the bf16 tensor-core peak; it moves
// ~32 MB (the weights 8.4 MB, the state in and out 21 MB, x and the
// gathered rows 2.6 MB): ~10 us at 3.35 TB/s. Operations bound it. The
// earlier mma.sync design (no overlap of loads and products, every block
// re-reading its weight columns and A rows through L2 in 64 x 128 tiles)
// took 0.3156 ms on an NVIDIA H100 80GB HBM3 at 700 W, 6.9 % of that bound;
// this design takes 0.1023 ms there (chip_smoke.py, profiler device time).
//
// What the design does about it: a warp-specialised, persistent GEMM with
// a gather prologue and a gate epilogue, one launch per layer (layer l+1
// needs all of layer l's h'). Output tiles are 128 rows x 128 gate columns
// (32 hidden units x 4 gates): 20 x 16 = 320 tiles at the flagship, walked
// by one block per SM (132), i.e. 2.4 waves of tiles; 128 x 256 tiles would
// give 160 tiles, 1.2 waves, which balances worse, and 64-row tiles re-read
// the weights twice as often. A block has three warpgroups:
//   - the producer warpgroup fills a ring of 4 stages of [128 x 64] A and B
//     tiles. B, the weights, arrives by TMA (128-byte swizzle) on the
//     stage's mbarrier; A is gathered row by row with 16-byte cp.async
//     (x_l for the first K half, S[src[r]].h_l for the second; TMA's tiled
//     mode cannot gather rows by index), written in the same swizzle, and
//     handed over one stage late (cp.async.wait_group 1, a proxy fence, an
//     arrive), so two stages of copies stay in flight;
//   - two consumer warpgroups take 64 rows each: wgmma m64n128k16 from
//     shared memory into fp32 registers, one stage released as the next
//     one's products are issued. While they run the epilogue of one tile
//     the producer already fills the next tile's stages.
// The weights are laid out once per weight set (decode_kernels.py::
// lstm_kernel_layout): [W_ih; W_hh]^T with the gate columns interleaved, so
// that each 8-column group of a tile holds one gate of 8 units and the
// groups cycle i, f, g, o; a thread's wgmma accumulators then hold all four
// gates of its units, as the epilogue needs. The TMA tensor map of that
// layout is encoded once per weight set too (lstm_step_reorder_tmap).
// The gate chains cost more than the products once those run on wgmma:
// each takes a bf16 value, so the kernel tabulates sig and tnh over the
// 65,536 bf16 bit patterns once per process, with the same device code, and
// the epilogue looks them up: the same values, op for op. What bounds the
// kernel now is the main loop's L2 traffic (every stage brings 32 KB into
// each SM: the weights reach each row tile, the gathered rows each column
// tile) and the epilogue, which runs between two tiles' products.
//
// C entries: lstm_step_reorder_tmap(...) encodes the weights' tensor map;
// lstm_step_reorder_bf16(...) launches one kernel per layer and returns the
// CUDA error of the first failed launch; it launches on the given stream
// and does not synchronise.

#include "hopper_sm90.cuh"
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;                    // rows per tile
constexpr int BN = 128;                    // gate columns per tile (32 units)
constexpr int KC = 64;                     // K per stage
constexpr int STAGES = 4;
constexpr int TILE_BYTES = BM * KC * 2;    // A and B stage tiles, 16 KB each
constexpr int NTHREADS = 3 * 128;          // producer + two consumer warpgroups
constexpr int SMEM_BYTES = 2 * STAGES * TILE_BYTES + 2 * STAGES * 8 + 1024;

__device__ inline float rb(float x) { return __bfloat162float(__float2bfloat16(x)); }

// the TPU kernel's gate chains on bf16 values, every op rounded to bf16
__device__ inline float sig(float v) { return rb(1.f / rb(1.f + rb(expf(-v)))); }

__device__ inline float tnh(float v) { return rb(rb(2.f / rb(1.f + rb(expf(-2.f * v)))) - 1.f); }

// Every gate chain takes a bf16 value, so each is a function on the 65,536
// bf16 bit patterns: the chains above tabulated once per process on the
// card (gate_tables_kernel), and the epilogue looks them up.
__device__ bf16 g_sig[1 << 16], g_tnh[1 << 16];

__global__ void gate_tables_kernel() {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const float v = __bfloat162float(__ushort_as_bfloat16((unsigned short)i));
  g_sig[i] = __float2bfloat16(sig(v));
  g_tnh[i] = __float2bfloat16(tnh(v));
}

__device__ inline float sig_of(float v) {  // v holds a bf16 value
  return __bfloat162float(g_sig[__bfloat16_as_ushort(__float2bfloat16(v))]);
}

__device__ inline float tnh_of(float v) {
  return __bfloat162float(g_tnh[__bfloat16_as_ushort(__float2bfloat16(v))]);
}

__global__ void __launch_bounds__(NTHREADS, 1)
lstm_layer_kernel(const __grid_constant__ CUtensorMap wmap, const bf16* __restrict__ x,
                  const bf16* __restrict__ S, const int64_t* __restrict__ src,
                  const uint8_t* __restrict__ live, const float* __restrict__ b,
                  bf16* __restrict__ S_out, bf16* __restrict__ x_next, int BK, int H, int L,
                  int layer) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles need 1024-byte alignment
  uint8_t* smem = smem_raw + (base - raw);
  const uint32_t sA = base, sB = base + STAGES * TILE_BYTES;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + 2 * STAGES * TILE_BYTES);
  uint64_t* empty = full + STAGES;

  const int ntiles = 4 * H / BN, tiles = (BK + BM - 1) / BM * ntiles;
  const int kstages = 2 * H / KC;
  const size_t C = (size_t)2 * L * H;
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      sm90::mbar_init(&full[s], 128 + 1);  // the producers' copies + the TMA's bytes
      sm90::mbar_init(&empty[s], 2);       // one thread of each consumer warpgroup
    }

    sm90::fence_barrier_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128, t = threadIdx.x % 128;
  if (wg == 0) {
    // ---- producer: thread t copies 16-byte chunk t % 8 of rows t / 8 + 16 i
    const int c = t & 7, r0 = t >> 3;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = tile / ntiles * BM, n0 = tile % ntiles * BN;
      int64_t srow[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int grow = row0 + r0 + 16 * i;
        srow[i] = grow < BK ? src[grow] : -1;
      }
      for (int ks = 0; ks < kstages; ++ks, ++it) {
        const int slot = it % STAGES;
        sm90::mbar_wait(&empty[slot], ((it / STAGES) & 1) ^ 1);
        const bool from_x = ks * KC < H;
        const int k0 = (from_x ? ks * KC : ks * KC - H) + c * 8;
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          const int r = r0 + 16 * i, grow = row0 + r;
          const bool ok = srow[i] >= 0;
          const bf16* p = !ok ? x
                          : from_x ? x + (size_t)grow * H + k0
                                   : S + (size_t)srow[i] * C + (size_t)layer * H + k0;
          sm90::cp_async16(sA + slot * TILE_BYTES + sm90::swz(r, c), p, ok);
        }
        sm90::cp_async_commit();
        if (t == 0) {
          sm90::mbar_arrive_expect_tx(&full[slot], TILE_BYTES);
          sm90::tma_load_2d(sB + slot * TILE_BYTES, &wmap, &full[slot], ks * KC,
                            layer * 4 * H + n0);
        }
        if (it > 0) {  // the previous stage's rows have landed: hand them over
          sm90::cp_async_wait<1>();
          sm90::fence_proxy_async();
          sm90::mbar_arrive(&full[(it - 1) % STAGES]);
        }
      }
    }
    if (it > 0) {
      sm90::cp_async_wait<0>();
      sm90::fence_proxy_async();
      sm90::mbar_arrive(&full[(it - 1) % STAGES]);
    }
  } else {
    // ---- consumers: warpgroup cw owns rows 64 cw .. 64 cw + 63 of a tile
    const int cw = wg - 1;
    const int wi = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
    int it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int row0 = tile / ntiles * BM, u0 = tile % ntiles * (BN / 4);
      // the bias of this thread's 32 columns: n8 block j = 4 ub + gate holds
      // gate `gate` of units u0 + 8 ub + 2 q + e
      float bs[32];
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) bs[2 * j + e] = b[(j & 3) * H + u0 + (j >> 2) * 8 + 2 * q + e];
      float acc[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) acc[i] = 0.f;
      int prev = -1;
      for (int ks = 0; ks < kstages; ++ks, ++it) {
        const int slot = it % STAGES;
        sm90::mbar_wait(&full[slot], (it / STAGES) & 1);
        sm90::wgmma_fence();
        const uint32_t a = sA + slot * TILE_BYTES + cw * 64 * 128, bb = sB + slot * TILE_BYTES;
#pragma unroll
        for (int k = 0; k < KC / 16; ++k)
          sm90::wgmma_ss_n128<0, 0>(acc, sm90::wgmma_desc(a + 32 * k),
                                    sm90::wgmma_desc(bb + 32 * k), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // the previous stage's products are done
        if (prev >= 0 && t == 0) sm90::mbar_arrive(&empty[prev]);
        prev = slot;
      }
      sm90::wgmma_wait<0>();
      if (prev >= 0 && t == 0) sm90::mbar_arrive(&empty[prev]);

      // ---- gate epilogue: n8 block 4 ub + gate holds gate `gate` of units
      // u0 + 8 ub + 2 q + e, in rows g (d[.. + e]) and g + 8 (d[.. + 2 + e])
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int grow = row0 + cw * 64 + wi * 16 + g + 8 * half;
        if (grow >= BK) continue;
        const size_t srow = (size_t)src[grow] * C, orow = (size_t)grow * C;
        const bool alive = live[grow] != 0;
#pragma unroll
        for (int ub = 0; ub < 4; ++ub) {
          const int U = u0 + ub * 8 + 2 * q;
          const __nv_bfloat162 hg2 =
              *reinterpret_cast<const __nv_bfloat162*>(S + srow + (size_t)layer * H + U);
          const __nv_bfloat162 cg2 =
              *reinterpret_cast<const __nv_bfloat162*>(S + srow + (size_t)(L + layer) * H + U);
          bf16 hn2[2], cn2[2];
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int f = 2 * half + e;
            const float ig = sig_of(acc[4 * (4 * ub + 0) + f] + bs[2 * (4 * ub + 0) + e]);
            const float fg = sig_of(acc[4 * (4 * ub + 1) + f] + bs[2 * (4 * ub + 1) + e]);
            const float gg = tnh_of(acc[4 * (4 * ub + 2) + f] + bs[2 * (4 * ub + 2) + e]);
            const float og = sig_of(acc[4 * (4 * ub + 3) + f] + bs[2 * (4 * ub + 3) + e]);
            const float cg = __bfloat162float(e ? cg2.y : cg2.x);
            const float cn = rb(rb(fg * cg) + rb(ig * gg));
            const float hn = rb(og * tnh_of(cn));
            hn2[e] = __float2bfloat16(hn);
            cn2[e] = __float2bfloat16(cn);
          }
          const __nv_bfloat162 hn = __halves2bfloat162(hn2[0], hn2[1]);
          const __nv_bfloat162 cn = __halves2bfloat162(cn2[0], cn2[1]);
          *reinterpret_cast<__nv_bfloat162*>(S_out + orow + (size_t)layer * H + U) =
              alive ? hn : hg2;
          *reinterpret_cast<__nv_bfloat162*>(S_out + orow + (size_t)(L + layer) * H + U) =
              alive ? cn : cg2;
          *reinterpret_cast<__nv_bfloat162*>(x_next + (size_t)grow * H + U) = hn;
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// The tensor map of the kernel-layout weights `wk` [L * 4H, 2H] bf16
// (contiguous, 16-byte aligned; decode_kernels.py::lstm_kernel_layout),
// read in [128 x 64] boxes; writes 128 bytes to `out`. Returns a CUDA error
// code (0 on success).
int lstm_step_reorder_tmap(const void* wk, int L, int H, void* out) {
  return sm90::encode_tmap_bf16(out, wk, (uint64_t)L * 4 * H, (uint64_t)2 * H, BM);
}

// x [BK, H], S and out [BK, 2LH] bf16; src [BK] int64 (source rows); live
// [BK] bytes (bool); tmap: the 128-byte tensor map of the kernel-layout
// weights (lstm_step_reorder_tmap); b [L, 4H] fp32 (gate order i, f, g, o);
// scratch [2, BK, H] bf16 for the layers' hidden outputs. All contiguous
// and 16-byte aligned, H % 64 == 0. S and out must not overlap. Launches on
// `stream` of card `device`; returns the CUDA error code (0 on success).
int lstm_step_reorder_bf16(const void* x, const void* S, const void* src, const void* live,
                           const void* tmap, const void* b, void* out, void* scratch, int BK,
                           int H, int L, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H % KC != 0 || BK < 1) return (int)cudaErrorInvalidValue;
  static int smem_set = 0;  // once per process: the kernel's shared-memory limit
  if (!smem_set) {
    err = cudaFuncSetAttribute(lstm_layer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               SMEM_BYTES);
    if (err != cudaSuccess) return (int)err;
    smem_set = 1;
  }
  static bool tables[64] = {};  // per card: the gate tables, once per process
  if (device < 0 || device >= 64) return (int)cudaErrorInvalidDevice;
  if (!tables[device]) {
    gate_tables_kernel<<<(1 << 16) / 256, 256, 0, (cudaStream_t)stream>>>();
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    tables[device] = true;
  }
  CUtensorMap map;
  memcpy(&map, tmap, sizeof(map));
  const int tiles = (BK + BM - 1) / BM * (4 * H / BN);
  static int sms = 0;
  if (!sms) sms = sm90::sm_count(device);
  if (sms < 1) return (int)cudaErrorInvalidDevice;
  const int grid = tiles < sms ? tiles : sms;
  for (int l = 0; l < L; ++l) {
    const bf16* xin = l == 0 ? static_cast<const bf16*>(x)
                             : static_cast<const bf16*>(scratch) + (size_t)((l - 1) % 2) * BK * H;
    bf16* xout = static_cast<bf16*>(scratch) + (size_t)(l % 2) * BK * H;
    lstm_layer_kernel<<<grid, NTHREADS, SMEM_BYTES, (cudaStream_t)stream>>>(
        map, xin, static_cast<const bf16*>(S), static_cast<const int64_t*>(src),
        static_cast<const uint8_t*>(live), static_cast<const float*>(b) + (size_t)l * 4 * H,
        static_cast<bf16*>(out), xout, BK, H, L, l);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
