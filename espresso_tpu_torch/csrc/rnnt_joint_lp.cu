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
// it (0.44 ms at 989 TFLOP/s).
//
// Design: a block owns 128 lattice rows (rows flattened over (b, t, u); 8
// warps of 16) and stages their joint hidden once in shared memory (bf16,
// 128 x J); it then streams V in tiles of 64 rows of W [V, J] through shared
// memory, each warp taking the product of its 16 rows with the tile on the
// tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulate) and folding the
// 16 x 64 logits into each lane's online max and sum, picking the blank and
// target columns on the way; the 4 lanes of a row merge at the end. Every
// block reads all of W from L2 (~6.6 GB of L2 traffic at the flagship, 1 MB
// of W per block): the loads are plain 16-byte loads without pipelining;
// cp.async/TMA, wgmma and a persistent schedule are later work.
//
// C entry: rnnt_joint_lp_bf16(...) returns the CUDA error of the launch; it
// launches on the given stream and does not synchronise.

#include "rnnt_joint_common.cuh"

namespace {

using namespace rnnt;

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int ROWS = NWARPS * 16;  // lattice rows per block

size_t smem_bytes(int J) {
  return sizeof(bf16) * (size_t)(ROWS + VT) * pre_ld(J) + sizeof(int) * ROWS;
}

__global__ void __launch_bounds__(NTHREADS)
rnnt_joint_lp_kernel(const bf16* __restrict__ enc, const bf16* __restrict__ dec,
                     const bf16* __restrict__ w, const float* __restrict__ bias,
                     const int* __restrict__ tgt, float* __restrict__ lpb,
                     float* __restrict__ lpl, float* __restrict__ lse_out, int B, int T,
                     int U1, int J, int V, int blank) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int ld = pre_ld(J);
  bf16* s_pre = reinterpret_cast<bf16*>(smem_raw);
  bf16* s_w = s_pre + ROWS * ld;
  int* s_tgt = reinterpret_cast<int*>(s_w + VT * ld);
  const long long n_rows = (long long)B * T * U1;
  const long long r0 = (long long)blockIdx.x * ROWS;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  auto row_of = [&](int i, int& b, int& tt, int& u) {
    const long long r = r0 + i;
    if (r >= n_rows) return false;
    u = (int)(r % U1);
    const long long bt = r / U1;
    tt = (int)(bt % T);
    b = (int)(bt / T);
    return true;
  };
  stage_pre(s_pre, enc, dec, ROWS, T, U1, J, row_of);
  for (int i = threadIdx.x; i < ROWS; i += NTHREADS) {
    int b, tt, u;
    s_tgt[i] = row_of(i, b, tt, u) ? tgt[(size_t)b * U1 + u] : -1;
  }
  __syncthreads();

  // per lane, for its rows g and g + 8: online max and sum over its columns,
  // and the blank and target logits where it holds them
  float m[2] = {kNegInf, kNegInf}, s[2] = {0.f, 0.f}, lb[2] = {0.f, 0.f}, lt[2] = {0.f, 0.f};
  const int tg[2] = {s_tgt[warp * 16 + g], s_tgt[warp * 16 + g + 8]};
  for (int v0 = 0; v0 < V; v0 += VT) {
    __syncthreads();  // the previous tile is consumed
    stage_w_tile(s_w, w, v0, V, J);
    __syncthreads();
    float acc[VT / 8][4];
    warp_logits<VT / 8>(acc, s_pre + warp * 16 * ld, s_w, J, g, t);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      float x[VT / 8][2];
      float tm = kNegInf;
#pragma unroll
      for (int nt = 0; nt < VT / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int v = v0 + nt * 8 + 2 * t + e;
          x[nt][e] = v < V ? acc[nt][2 * half + e] + bias[v] : kNegInf;
          tm = fmaxf(tm, x[nt][e]);
          if (v == blank) lb[half] = x[nt][e];
          if (v == tg[half]) lt[half] = x[nt][e];
        }
      }
      const float nm = fmaxf(m[half], tm);
      float add = 0.f;
#pragma unroll
      for (int nt = 0; nt < VT / 8; ++nt) add += expf(x[nt][0] - nm) + expf(x[nt][1] - nm);
      s[half] = s[half] * expf(m[half] - nm) + add;
      m[half] = nm;
    }
  }
  // merge the 4 lanes of each row
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int off = 1; off <= 2; off <<= 1) {
      const float om = __shfl_xor_sync(0xffffffffu, m[half], off);
      const float os = __shfl_xor_sync(0xffffffffu, s[half], off);
      const float nm = fmaxf(m[half], om);
      s[half] = s[half] * expf(m[half] - nm) + os * expf(om - nm);
      m[half] = nm;
      lb[half] += __shfl_xor_sync(0xffffffffu, lb[half], off);
      lt[half] += __shfl_xor_sync(0xffffffffu, lt[half], off);
    }
    const long long r = r0 + warp * 16 + g + 8 * half;
    if (t == 0 && r < n_rows) {
      const float z = m[half] + logf(s[half]);
      lse_out[r] = z;
      lpb[r] = lb[half] - z;
      lpl[r] = (int)(r % U1) == U1 - 1 ? kNegInf : lt[half] - z;
    }
  }
}

}  // namespace

extern "C" {

// enc [B, T, J], dec [B, U1, J], w [V, J]: bf16, contiguous; bias [V] f32;
// tgt [B, U1] int32 (the target of row u, 0 at u = U1 - 1); outputs lp_blank,
// lp_label, lse [B, T, U1] f32; all on card `device`. J: a multiple of 16 up
// to 512 (the shared memory holds 192 rows of J).
int rnnt_joint_lp_bf16(const void* enc, const void* dec, const void* w, const void* bias,
                       const void* tgt, void* lp_blank, void* lp_label, void* lse, int B,
                       int T, int U1, int J, int V, int blank, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  const size_t smem = smem_bytes(J);
  err = cudaFuncSetAttribute(rnnt_joint_lp_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const long long n_rows = (long long)B * T * U1;
  const unsigned grid = (unsigned)((n_rows + ROWS - 1) / ROWS);
  rnnt_joint_lp_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const bf16*>(enc), static_cast<const bf16*>(dec),
      static_cast<const bf16*>(w), static_cast<const float*>(bias),
      static_cast<const int*>(tgt), static_cast<float*>(lp_blank),
      static_cast<float*>(lp_label), static_cast<float*>(lse), B, T, U1, J, V, blank);
  return (int)cudaGetLastError();
}

}  // extern "C"
