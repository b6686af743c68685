// RNNT joint backward: the gradients of the joint's inputs and weights from
// the lattice occupancies, bf16 in, f32 out, sm_90a. The [B, T, U1, V]
// logits and their gradient are never written.
//
// Replaces the TPU kernel espresso_tpu/ops/rnnt_pallas.py::rnnt_joint_bwd
// (Pallas, :211-393). Per lattice row (b, t, u) and vocab column v:
//
//   p     = exp(pre . W[v] + bias[v] - lse)           (pre as in the forward)
//   glog  = -p (ob + ol) + ob [v == blank] + ol [v == tgt[u]]     (f32)
//   g_b[v]  += glog;   glog_c = bf16(glog)
//   g_W[:, v] += pre^T glog_c;   g_pre = glog_c W^T, zeroed where pre <= 0
//   g_enc[b, t] = sum_u g_pre;   g_dec[b, u] = sum_t g_pre
//
// with ob, ol the occupancy-weighted upstream gradients of the blank and
// label moves (rnnt_pallas.py:299-331).
//
// What bounds it on an H100: three products of the forward's size (the
// logits again, g_W and g_pre), 3 x 433.8 GFLOP at the flagship: the
// tensor cores bound it (1.32 ms at 989 TFLOP/s).
//
// Design: two kernels, one per reduction direction, so that neither needs a
// [B, T, U1, V] buffer:
//   * rows: a block owns (b, 16 values of u) and walks the frames 4 at a
//     time (64 lattice rows, 8 warps). Per 64-column V tile it recomputes the
//     logits (each warp 16 rows x 32 columns), forms glog_c into shared
//     memory, and adds glog_c W_tile into g_pre, which stays in registers for
//     the 4 frames (each warp 16 rows x J/2 columns). Then g_pre is masked,
//     summed over u into g_enc (f32 atomics, one per (t, j) per block) and
//     over the frames into a shared g_dec block written once at the end.
//   * columns: a block owns a 64-column V tile and a slice of the lattice
//     rows; it recomputes the logits of its columns only (each lattice row's
//     product with the one W tile kept in shared memory), and adds
//     pre^T glog_c into a J x 64 g_W tile in registers (each warp J/8 rows)
//     and glog into g_b; the slices' partial sums meet in f32 atomics at the
//     end.
// Together they recompute the logits twice: 4 x 433.8 GFLOP of mma.sync
// work against the TPU kernel's 3. Loads are unpipelined 16-byte loads, and
// every block reads W (rows) or the joint hidden (columns) through L2;
// wgmma, TMA pipelining and one fused pass are later work. The f32 atomics
// make g_enc, g_W and g_b sum in an order that changes from run to run.
//
// C entry: rnnt_joint_bwd_bf16(...) returns the CUDA error of the launches;
// it launches on the given stream and does not synchronise. g_enc, g_W and
// g_b must be zero on entry.

#include "rnnt_joint_common.cuh"

namespace {

using namespace rnnt;

constexpr int NWARPS = 8;
constexpr int NTHREADS = NWARPS * 32;
constexpr int UB = 16;           // values of u per row block
constexpr int FRAMES = 4;        // frames per step of the row kernel
constexpr int ROWS = UB * FRAMES;  // lattice rows per step (64)
constexpr int LDG = VT + 8;      // row stride of the glog tile
constexpr int SLICE_BLOCKS = 264;  // ~2 blocks per SM for the column kernel

// glog of the lane's 16 x 32 logits (rows g, g + 8 of the warp's 16; its 4
// column groups of 8), stored bf16 into s_g; returns nothing else. Row info
// in shared memory: lse, ob, ol and the target column.
struct RowInfo {
  float* lse;
  float* ob;
  float* ol;
  int* tgt;
};

__device__ inline void glog_tile(const float (&acc)[4][4], int row_base, int col_base, int v0,
                                 int V, int blank, const float* __restrict__ bias,
                                 const RowInfo& ri, bf16* s_g, float (&colsum)[4][2], int g,
                                 int t) {
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int row = row_base + g + 8 * half;
      const float ob = ri.ob[row], ol = ri.ol[row], lse = ri.lse[row];
      float gl[2];
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int c = col_base + nt * 8 + 2 * t + e, v = v0 + c;
        gl[e] = 0.f;
        if (v < V) {
          const float p = expf(acc[nt][2 * half + e] + bias[v] - lse);
          gl[e] = -p * (ob + ol);
          if (v == blank) gl[e] += ob;
          if (v == ri.tgt[row]) gl[e] += ol;
        }
        colsum[nt][e] += gl[e];
      }
      *reinterpret_cast<uint32_t*>(s_g + row * LDG + col_base + nt * 8 + 2 * t) =
          pack2(__float2bfloat16(gl[0]), __float2bfloat16(gl[1]));
    }
  }
}

// ---------------------------------------------------------------------------
// rows: g_pre -> g_enc, g_dec
// ---------------------------------------------------------------------------

template <int J>
__global__ void __launch_bounds__(NTHREADS, 1)
rnnt_joint_bwd_rows_kernel(const bf16* __restrict__ enc, const bf16* __restrict__ dec,
                           const bf16* __restrict__ w, const float* __restrict__ bias,
                           const int* __restrict__ tgt, const float* __restrict__ lse,
                           const float* __restrict__ ob, const float* __restrict__ ol,
                           float* __restrict__ g_enc, float* __restrict__ g_dec, int T,
                           int U1, int V, int blank) {
  constexpr int JH = J / 2;        // g_pre columns per warp
  constexpr int NJ = JH / 8;       // their n-tiles
  constexpr int LD = J + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_pre = reinterpret_cast<bf16*>(smem_raw);   // [ROWS][LD]
  bf16* s_w = s_pre + ROWS * LD;                       // [VT][LD]
  bf16* s_g = s_w + VT * LD;                           // [ROWS][LDG]
  float* s_gdec = reinterpret_cast<float*>(s_g + ROWS * LDG);  // [UB][J]
  RowInfo ri;
  ri.lse = s_gdec + UB * J;
  ri.ob = ri.lse + ROWS;
  ri.ol = ri.ob + ROWS;
  ri.tgt = reinterpret_cast<int*>(ri.ol + ROWS);

  const int u0 = blockIdx.x * UB, b = blockIdx.y;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int f = warp & 3, hh = warp >> 2;  // the warp's frame and column half
  for (int i = threadIdx.x; i < UB * J; i += NTHREADS) s_gdec[i] = 0.f;

  for (int t0 = 0; t0 < T; t0 += FRAMES) {
    __syncthreads();  // the previous step's readers of s_pre and the row info are done
    auto row_of = [&](int i, int& bb, int& tt, int& u) {
      bb = b;
      tt = t0 + i / UB;
      u = u0 + i % UB;
      return tt < T && u < U1;
    };
    stage_pre(s_pre, enc, dec, ROWS, T, U1, J, row_of);
    for (int i = threadIdx.x; i < ROWS; i += NTHREADS) {
      int bb, tt, u;
      const bool valid = row_of(i, bb, tt, u);
      const size_t cell = ((size_t)b * T + tt) * U1 + u;
      ri.lse[i] = valid ? lse[cell] : 0.f;
      ri.ob[i] = valid ? ob[cell] : 0.f;
      ri.ol[i] = valid ? ol[cell] : 0.f;
      ri.tgt[i] = valid ? tgt[(size_t)b * U1 + u] : -1;
    }
    float gpre[NJ][4];
#pragma unroll
    for (int nt = 0; nt < NJ; ++nt) gpre[nt][0] = gpre[nt][1] = gpre[nt][2] = gpre[nt][3] = 0.f;

    for (int v0 = 0; v0 < V; v0 += VT) {
      __syncthreads();  // s_pre and the row info are staged; the last tile is consumed
      stage_w_tile(s_w, w, v0, V, J);
      __syncthreads();
      {
        float acc[4][4];
        warp_logits<4>(acc, s_pre + f * UB * LD, s_w + hh * 32 * LD, J, g, t);
        float colsum[4][2] = {};
        glog_tile(acc, f * UB, hh * 32, v0, V, blank, bias, ri, s_g, colsum, g, t);
      }
      __syncthreads();
      // g_pre += glog_c [16, 64] . W_tile [64, J/2 of the warp's half]
#pragma unroll
      for (int kk = 0; kk < VT / 16; ++kk) {
        uint32_t a[4];
        load_a(a, s_g + f * UB * LDG + kk * 16, LDG, g, t);
#pragma unroll
        for (int nt = 0; nt < NJ; ++nt) {
          uint32_t b0, b1;
          load_b_rows(b0, b1, s_w + (kk * 16) * LD + hh * JH + nt * 8, LD, g, t);
          mma_bf16(gpre[nt], a, b0, b1);
        }
      }
    }
    // mask by pre > 0; sum over u (the warp's 16 rows) into g_enc, over the
    // frames into s_gdec
    const int tt = t0 + f;
#pragma unroll
    for (int nt = 0; nt < NJ; ++nt) {
      const int j = hh * JH + nt * 8 + 2 * t;
      float col[2] = {0.f, 0.f};
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int rl = g + 8 * half;
        const bf16* pr = s_pre + (f * UB + rl) * LD + j;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float v = __bfloat162float(pr[e]) > 0.f ? gpre[nt][2 * half + e] : 0.f;
          col[e] += v;
          if (v != 0.f) atomicAdd(&s_gdec[rl * J + j + e], v);
        }
      }
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        col[e] += __shfl_xor_sync(0xffffffffu, col[e], 4);
        col[e] += __shfl_xor_sync(0xffffffffu, col[e], 8);
        col[e] += __shfl_xor_sync(0xffffffffu, col[e], 16);
      }
      if (g == 0 && tt < T) {
        float* dst = g_enc + ((size_t)b * T + tt) * J + j;
        atomicAdd(dst, col[0]);
        atomicAdd(dst + 1, col[1]);
      }
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < UB * J; i += NTHREADS) {
    const int u = u0 + i / J;
    if (u < U1) g_dec[((size_t)b * U1 + u) * J + i % J] = s_gdec[i];
  }
}

// ---------------------------------------------------------------------------
// columns: g_W, g_b
// ---------------------------------------------------------------------------

template <int J>
__global__ void __launch_bounds__(NTHREADS, 1)
rnnt_joint_bwd_cols_kernel(const bf16* __restrict__ enc, const bf16* __restrict__ dec,
                           const bf16* __restrict__ w, const float* __restrict__ bias,
                           const int* __restrict__ tgt, const float* __restrict__ lse,
                           const float* __restrict__ ob, const float* __restrict__ ol,
                           float* __restrict__ g_wt, float* __restrict__ g_b, int B, int T,
                           int U1, int V, int blank, long long rows_per_slice) {
  constexpr int LD = J + 8;
  constexpr int JW = J / NWARPS;   // g_W rows per warp
  constexpr int MT = JW / 16;      // their m-tiles
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* s_pre = reinterpret_cast<bf16*>(smem_raw);   // [ROWS][LD]
  bf16* s_w = s_pre + ROWS * LD;                       // [VT][LD]
  bf16* s_g = s_w + VT * LD;                           // [ROWS][LDG]
  float* s_gb = reinterpret_cast<float*>(s_g + ROWS * LDG);  // [VT]
  RowInfo ri;
  ri.lse = s_gb + VT;
  ri.ob = ri.lse + ROWS;
  ri.ol = ri.ob + ROWS;
  ri.tgt = reinterpret_cast<int*>(ri.ol + ROWS);

  const int v0 = blockIdx.x * VT;
  const long long n_rows = (long long)B * T * U1;
  const long long rb = (long long)blockIdx.y * rows_per_slice;
  const long long re = rb + rows_per_slice < n_rows ? rb + rows_per_slice : n_rows;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int rq = warp & 3, hh = warp >> 2;  // logits: rows rq*16, columns hh*32
  stage_w_tile(s_w, w, v0, V, J);
  for (int i = threadIdx.x; i < VT; i += NTHREADS) s_gb[i] = 0.f;

  float gw[MT][VT / 8][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < VT / 8; ++nt) gw[mt][nt][0] = gw[mt][nt][1] = gw[mt][nt][2] = gw[mt][nt][3] = 0.f;

  for (long long r0 = rb; r0 < re; r0 += ROWS) {
    __syncthreads();  // the previous chunk's readers are done
    auto row_of = [&](int i, int& bb, int& tt, int& u) {
      const long long r = r0 + i;
      if (r >= re) return false;
      u = (int)(r % U1);
      const long long bt = r / U1;
      tt = (int)(bt % T);
      bb = (int)(bt / T);
      return true;
    };
    stage_pre(s_pre, enc, dec, ROWS, T, U1, J, row_of);
    for (int i = threadIdx.x; i < ROWS; i += NTHREADS) {
      int bb, tt, u;
      const bool valid = row_of(i, bb, tt, u);
      const long long r = r0 + i;
      ri.lse[i] = valid ? lse[r] : 0.f;
      ri.ob[i] = valid ? ob[r] : 0.f;
      ri.ol[i] = valid ? ol[r] : 0.f;
      ri.tgt[i] = valid ? tgt[(size_t)bb * U1 + u] : -1;
    }
    __syncthreads();
    {
      float acc[4][4];
      warp_logits<4>(acc, s_pre + rq * 16 * LD, s_w + hh * 32 * LD, J, g, t);
      float colsum[4][2] = {};
      glog_tile(acc, rq * 16, hh * 32, v0, V, blank, bias, ri, s_g, colsum, g, t);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float c = colsum[nt][e];
          c += __shfl_xor_sync(0xffffffffu, c, 4);
          c += __shfl_xor_sync(0xffffffffu, c, 8);
          c += __shfl_xor_sync(0xffffffffu, c, 16);
          if (g == 0) atomicAdd(&s_gb[hh * 32 + nt * 8 + 2 * t + e], c);
        }
      }
    }
    __syncthreads();
    // g_W[j, v] += sum_r pre[r, j] glog_c[r, v]: A = pre^T (rows j, k = r)
#pragma unroll
    for (int kk = 0; kk < ROWS / 16; ++kk) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int j0 = warp * JW + mt * 16;
        uint32_t a[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int j = j0 + g + 8 * (r & 1), row = kk * 16 + 2 * t + 8 * (r >> 1);
          a[r] = pack2(s_pre[row * LD + j], s_pre[(row + 1) * LD + j]);
        }
#pragma unroll
        for (int nt = 0; nt < VT / 8; ++nt) {
          uint32_t b0, b1;
          load_b_rows(b0, b1, s_g + (kk * 16) * LDG + nt * 8, LDG, g, t);
          mma_bf16(gw[mt][nt], a, b0, b1);
        }
      }
    }
  }
  __syncthreads();
  // g_wt is the [V, J] layout of g_W
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
#pragma unroll
    for (int nt = 0; nt < VT / 8; ++nt) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int j = warp * JW + mt * 16 + g + 8 * (r >> 1);
        const int v = v0 + nt * 8 + 2 * t + (r & 1);
        if (v < V) atomicAdd(&g_wt[(size_t)v * J + j], gw[mt][nt][r]);
      }
    }
  }
  for (int i = threadIdx.x; i < VT; i += NTHREADS)
    if (v0 + i < V) atomicAdd(&g_b[v0 + i], s_gb[i]);
}

size_t rows_smem_bytes(int J) {
  return sizeof(bf16) * ((size_t)(ROWS + VT) * (J + 8) + ROWS * LDG) +
         sizeof(float) * ((size_t)UB * J + 3 * ROWS) + sizeof(int) * ROWS;
}

size_t cols_smem_bytes(int J) {
  return sizeof(bf16) * ((size_t)(ROWS + VT) * (J + 8) + ROWS * LDG) +
         sizeof(float) * (VT + 3 * ROWS) + sizeof(int) * ROWS;
}

template <int J>
int launch(const bf16* enc, const bf16* dec, const bf16* w, const float* bias, const int* tgt,
           const float* lse, const float* ob, const float* ol, float* g_enc, float* g_dec,
           float* g_wt, float* g_b, int B, int T, int U1, int V, int blank, cudaStream_t s) {
  const size_t smem_r = rows_smem_bytes(J), smem_c = cols_smem_bytes(J);
  cudaError_t err = cudaFuncSetAttribute(rnnt_joint_bwd_rows_kernel<J>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_r);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rnnt_joint_bwd_cols_kernel<J>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem_c);
  if (err != cudaSuccess) return (int)err;
  rnnt_joint_bwd_rows_kernel<J><<<dim3((U1 + UB - 1) / UB, B), NTHREADS, smem_r, s>>>(
      enc, dec, w, bias, tgt, lse, ob, ol, g_enc, g_dec, T, U1, V, blank);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int n_vt = (V + VT - 1) / VT;
  const long long n_rows = (long long)B * T * U1;
  const int slices_wanted = SLICE_BLOCKS / n_vt > 1 ? SLICE_BLOCKS / n_vt : 1;
  long long per = (n_rows + slices_wanted - 1) / slices_wanted;
  per = (per + ROWS - 1) / ROWS * ROWS;
  const int slices = (int)((n_rows + per - 1) / per);
  rnnt_joint_bwd_cols_kernel<J><<<dim3(n_vt, slices), NTHREADS, smem_c, s>>>(
      enc, dec, w, bias, tgt, lse, ob, ol, g_wt, g_b, B, T, U1, V, blank, per);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// enc [B, T, J], dec [B, U1, J], w [V, J]: bf16, contiguous; bias [V] f32;
// tgt [B, U1] int32; lse, ob, ol [B, T, U1] f32; outputs g_enc [B, T, J]
// (zeroed), g_dec [B, U1, J], g_wt [V, J] (zeroed) and g_b [V] (zeroed),
// f32; all on card `device`. J: 128, 256 or 512. Two launches on `stream`.
int rnnt_joint_bwd_bf16(const void* enc, const void* dec, const void* w, const void* bias,
                        const void* tgt, const void* lse, const void* ob, const void* ol,
                        void* g_enc, void* g_dec, void* g_wt, void* g_b, int B, int T, int U1,
                        int J, int V, int blank, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
#define RNNT_BWD_ARGS                                                                    \
  static_cast<const bf16*>(enc), static_cast<const bf16*>(dec),                          \
      static_cast<const bf16*>(w), static_cast<const float*>(bias),                      \
      static_cast<const int*>(tgt), static_cast<const float*>(lse),                      \
      static_cast<const float*>(ob), static_cast<const float*>(ol),                      \
      static_cast<float*>(g_enc), static_cast<float*>(g_dec), static_cast<float*>(g_wt), \
      static_cast<float*>(g_b), B, T, U1, V, blank, (cudaStream_t)stream
  switch (J) {
    case 128: return launch<128>(RNNT_BWD_ARGS);
    case 256: return launch<256>(RNNT_BWD_ARGS);
    case 512: return launch<512>(RNNT_BWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RNNT_BWD_ARGS
}

}  // extern "C"
