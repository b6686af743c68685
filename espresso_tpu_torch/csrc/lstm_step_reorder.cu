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
// 512, L = 2) a call does ~21.5 GFLOP (per layer two [2560, 512] x
// [512, 2048] products): ~22 us at the bf16 tensor-core peak; it moves
// ~32 MB (the weights 8.4 MB, the state in and out 21 MB, x and the
// gathered rows 2.6 MB): ~10 us at 3.35 TB/s. Operations bound it.
//
// What the design does about it: a GEMM with a gather prologue and a gate
// epilogue, one launch per layer (layer l+1 needs all of layer l's h').
// A block owns 64 rows and 32 hidden units, i.e. the 4 x 32 columns of the
// i, f, g and o gates of those units, so the epilogue finds all four gates
// of a unit in one thread's accumulators. The K loop runs over [x | h_l]
// (2H) in 64-wide chunks staged in shared memory with 16-byte loads: the A
// rows come from x or, gathered by src, from S; the B rows are the gate
// kernels' transposes [4H, H] (the nn.Linear layout), so each staged row is
// contiguous. Products on the tensor cores (mma.sync m16n8k16, bf16 in,
// fp32 sum), each warp owning 16 rows x 128 columns. The TPU kernel's
// one-hot matmul gather and its resident weight stack are not carried
// over: an H100 block cannot hold the 8 MB of weights, and a row gather is
// a plain indexed load here. No cp.async/TMA pipeline yet (later work).
//
// C entry: lstm_step_reorder_bf16(...) launches one kernel per layer and
// returns the CUDA error of the first failed launch; it launches on the
// given stream and does not synchronise.

#include "bf16_mma.cuh"
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int BM = NWARPS * 16;  // rows per block
constexpr int HU = 32;           // hidden units per block
constexpr int BN = 4 * HU;       // gate columns per block
constexpr int KC = 64;           // K chunk
constexpr int LDS = KC + 8;      // staged row stride (144 B)

__device__ inline float rb(float x) { return __bfloat162float(__float2bfloat16(x)); }

// the TPU kernel's gate chains on bf16 values, every op rounded to bf16
__device__ inline float sig(float v) { return rb(1.f / rb(1.f + rb(expf(-v)))); }

__device__ inline float tnh(float v) { return rb(rb(2.f / rb(1.f + rb(expf(-2.f * v)))) - 1.f); }

__global__ void __launch_bounds__(NTHREADS)
lstm_layer_kernel(const bf16* __restrict__ x, const bf16* __restrict__ S,
                  const int* __restrict__ src, const uint8_t* __restrict__ live,
                  const bf16* __restrict__ wihT, const bf16* __restrict__ whhT,
                  const float* __restrict__ b, bf16* __restrict__ S_out,
                  bf16* __restrict__ x_next, int BK, int H, int L, int layer) {
  __shared__ __align__(16) uint16_t sA_raw[BM * LDS];
  __shared__ __align__(16) uint16_t sB_raw[BN * LDS];
  bf16* sA = reinterpret_cast<bf16*>(sA_raw);
  bf16* sB = reinterpret_cast<bf16*>(sB_raw);
  __shared__ int sSrc[BM];

  const int u0 = blockIdx.x * HU, row0 = blockIdx.y * BM;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const size_t C = (size_t)2 * L * H;

  for (int r = threadIdx.x; r < BM; r += NTHREADS)
    sSrc[r] = row0 + r < BK ? src[row0 + r] : 0;

  float acc[BN / 8][4] = {};
  for (int kc = 0; kc < 2 * H; kc += KC) {
    __syncthreads();  // sSrc is written; the previous chunk is consumed
    const bool from_x = kc < H;
    const int k0 = from_x ? kc : kc - H;
    for (int i = threadIdx.x; i < BM * (KC / 8); i += NTHREADS) {
      const int r = i / (KC / 8), c = (i % (KC / 8)) * 8;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (row0 + r < BK) {
        const bf16* p = from_x ? x + (size_t)(row0 + r) * H + k0 + c
                               : S + (size_t)sSrc[r] * C + (size_t)layer * H + k0 + c;
        v = *reinterpret_cast<const uint4*>(p);
      }
      *reinterpret_cast<uint4*>(sA + r * LDS + c) = v;
    }
    const bf16* W = from_x ? wihT : whhT;
    for (int i = threadIdx.x; i < BN * (KC / 8); i += NTHREADS) {
      const int n = i / (KC / 8), c = (i % (KC / 8)) * 8;
      const int wrow = (n / HU) * H + u0 + (n % HU);  // gate n/HU, unit n%HU
      *reinterpret_cast<uint4*>(sB + n * LDS + c) =
          *reinterpret_cast<const uint4*>(W + (size_t)wrow * H + k0 + c);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < KC / 16; ++ks) {
      uint32_t a[4];
      const bf16* ab = sA + warp * 16 * LDS + ks * 16;
      a[0] = ld32(ab + g * LDS + 2 * t);
      a[1] = ld32(ab + (g + 8) * LDS + 2 * t);
      a[2] = ld32(ab + g * LDS + 2 * t + 8);
      a[3] = ld32(ab + (g + 8) * LDS + 2 * t + 8);
#pragma unroll
      for (int nt = 0; nt < BN / 8; ++nt) {
        const bf16* bb = sB + (nt * 8 + g) * LDS + ks * 16 + 2 * t;
        mma_bf16(acc[nt], a, ld32(bb), ld32(bb + 8));
      }
    }
  }

  // ---- gate epilogue: n-tile q (+4, +8, +12) holds gate i (f, g, o) of
  // units q*8 + 2t + e
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = warp * 16 + g + 8 * half;
    const int grow = row0 + r;
    if (grow >= BK) continue;
    const size_t srow = (size_t)sSrc[r] * C, orow = (size_t)grow * C;
    const bool alive = live[grow] != 0;
#pragma unroll
    for (int q = 0; q < HU / 8; ++q) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int U = u0 + q * 8 + 2 * t + e;
        const int f = 2 * half + e;
        const float pi = rb(acc[q][f] + b[U]);
        const float pf = rb(acc[HU / 8 + q][f] + b[H + U]);
        const float pg = rb(acc[2 * HU / 8 + q][f] + b[2 * H + U]);
        const float po = rb(acc[3 * HU / 8 + q][f] + b[3 * H + U]);
        const float ig = sig(pi), fg = sig(pf), gg = tnh(pg), og = sig(po);
        const bf16 hg = S[srow + (size_t)layer * H + U];
        const bf16 cg = S[srow + (size_t)(L + layer) * H + U];
        const float cn = rb(rb(fg * __bfloat162float(cg)) + rb(ig * gg));
        const float hn = rb(og * tnh(cn));
        S_out[orow + (size_t)layer * H + U] = alive ? __float2bfloat16(hn) : hg;
        S_out[orow + (size_t)(L + layer) * H + U] = alive ? __float2bfloat16(cn) : cg;
        x_next[(size_t)grow * H + U] = __float2bfloat16(hn);
      }
    }
  }
}

}  // namespace

extern "C" {

// x [BK, H], S and out [BK, 2LH] bf16; src [BK] int32 (source rows); live
// [BK] bytes (bool); wihT, whhT [L, 4H, H] bf16 (the gate kernels'
// transposes); b [L, 4H] fp32; scratch [2, BK, H] bf16 for the layers'
// hidden outputs. All contiguous and 16-byte aligned, H % 64 == 0. S and
// out must not overlap. Launches on `stream` of card `device`; returns the
// CUDA error code (0 on success).
int lstm_step_reorder_bf16(const void* x, const void* S, const void* src, const void* live,
                           const void* wihT, const void* whhT, const void* b, void* out,
                           void* scratch, int BK, int H, int L, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (H % KC != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid(H / HU, (BK + BM - 1) / BM);
  const size_t wsz = (size_t)4 * H * H;
  for (int l = 0; l < L; ++l) {
    const bf16* xin = l == 0 ? static_cast<const bf16*>(x)
                             : static_cast<const bf16*>(scratch) + (size_t)((l - 1) % 2) * BK * H;
    bf16* xout = static_cast<bf16*>(scratch) + (size_t)(l % 2) * BK * H;
    lstm_layer_kernel<<<grid, NTHREADS, 0, (cudaStream_t)stream>>>(
        xin, static_cast<const bf16*>(S), static_cast<const int*>(src),
        static_cast<const uint8_t*>(live), static_cast<const bf16*>(wihT) + l * wsz,
        static_cast<const bf16*>(whhT) + l * wsz, static_cast<const float*>(b) + (size_t)l * 4 * H,
        static_cast<bf16*>(out), xout, BK, H, L, l);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // extern "C"
