// Fused transducer joint + log-softmax + per-row top-n, bf16 products, sm_90a.
//
// Replaces the TPU kernel espresso_tpu/ops/decode_kernels.py::
// fused_joint_topk (Pallas; the AES frame step, three calls per frame). Per
// row r of the BK = B*K hypotheses:
//
//   d      = LN(feat[r] @ W_dec + b_dec) * ln_scale + ln_bias   fp32, eps 1e-6
//   h      = bf16(relu(enc[r] + d))
//   logit  = h @ W_out + b_out                                  fp32 sum
//   lp     = logit - lse(logit)
//   blank  = lp[blank]  (logaddexp with lp[eos] when eos is folded)
//   value  = score[r] + lp[c]   over the columns c != blank (, eos), or with
//            an LM label bias: score[r] + ((lp[c] + bias[r,c]) + factor),
//            factor = lse(masked lp) - lse(masked lp + bias)
//   out    = the n best values of the row, ties to the lower column
//
// as the Pallas kernel computes it (decode_kernels.py:144-217), with the
// cross-row top-k (rows_topk) left to the caller as there.
//
// What bounds it on an H100: at the flagship frame step (BK = 2560, H = J =
// 512, V = 1024) a call does ~4.0 GFLOP (1.3 in d, 2.7 in the logits): ~4 us
// at the bf16 tensor-core peak; it moves ~6.8 MB (enc and feat 5.2 MB, the
// weights 1.5 MB, the outputs 0.3 MB): ~2 us at 3.35 TB/s. So operations
// bound it, barely; with 160 blocks on 132 SMs the real limit is latency.
//
// What the design does about it: the TPU kernel holds a [rows, V] fp32
// tile in VMEM, which fits an H100 block only up to V ~ 3500. Here one block
// owns 16 rows (one m16 tile; 4 warps) and streams V in 64-column tiles:
//   - d: tensor-core products (mma.sync m16n8k16, bf16 in, fp32 sum) into
//     shared memory, then one warp per row takes the LayerNorm in fp32 and
//     writes h as bf16;
//   - logits: each warp takes every fourth 64-column tile of V, and each
//     lane keeps, for its two fragment rows, an online max/sum for lse (and
//     for the masked and biased sums when a label bias is given) and a
//     sorted list of its 16 (or 32) best masked logits. A row constant does
//     not change which columns win, so the lists need no lse. The ragged
//     tail of V is masked;
//   - the end: one thread per row merges the 16 lists of its row and forms
//     each value in the Pallas kernel's order of operations.
// Weights are read through L2 as B fragments straight from device memory
// (W_dec^T [J, H] and W_out^T [V, J], the nn.Linear layout), without
// cp.async/TMA pipelining or wgmma (later work).
//
// C entry: fused_joint_topk_bf16(...) returns the CUDA error of the launch;
// it launches on the given stream and does not synchronise.

#include "bf16_mma.cuh"
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 4;
constexpr int NTHREADS = NWARPS * 32;
constexpr int RB = 16;                // rows per block
constexpr int NC = 64;                // columns per warp tile (8 n-tiles)
constexpr int NLISTS = NWARPS * 4;    // per-row lists: one per (warp, lane t)
constexpr int NSTAT = 6;              // (m, s) for all, masked, biased
constexpr float kEps = 1e-6f;

// online log-sum-exp: (m, s) with sum = s * exp(m)
__device__ inline void stat_add(float& m, float& s, float v) {
  if (v > m) {
    s = s * expf(m - v) + 1.f;
    m = v;
  } else {
    s += expf(v - m);
  }
}

__device__ inline void stat_merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// insert (key, col) into a list sorted by key, descending; an equal key
// stays behind the earlier (lower) columns
template <int N, bool BIAS>
__device__ inline void insert(float (&lk)[N], int (&li)[N], float (&lv)[N], float key,
                              int col, float logit) {
  if (!(key > lk[N - 1])) return;
  lk[N - 1] = key;
  li[N - 1] = col;
  if (BIAS) lv[N - 1] = logit;
#pragma unroll
  for (int i = N - 1; i > 0; --i) {
    if (lk[i] > lk[i - 1]) {
      const float tk = lk[i]; lk[i] = lk[i - 1]; lk[i - 1] = tk;
      const int ti = li[i]; li[i] = li[i - 1]; li[i - 1] = ti;
      if (BIAS) { const float tv = lv[i]; lv[i] = lv[i - 1]; lv[i - 1] = tv; }
    }
  }
}

struct Layout {  // dynamic shared memory, in bytes from the base
  int d, stat, blank, eos, x, h, total;
};

__host__ __device__ inline Layout layout(int H, int J, int nmax, bool bias) {
  Layout L;
  const int dbytes = RB * (J + 4) * 4;
  const int lists = RB * NLISTS * nmax * (bias ? 12 : 8);
  L.d = 0;  // sD, later the per-row lists (sD is dead by then)
  L.stat = dbytes > lists ? dbytes : lists;
  L.blank = L.stat + RB * NLISTS * NSTAT * 4;
  L.eos = L.blank + RB * 4;
  L.x = L.eos + RB * 4;
  L.h = L.x + RB * (H + 8) * 2;
  L.total = L.h + RB * (J + 8) * 2;
  return L;
}

template <int NMAX, bool BIAS>
__global__ void __launch_bounds__(NTHREADS)
fused_joint_topk_kernel(const bf16* __restrict__ enc, const bf16* __restrict__ feat,
                        int feat_ld, const float* __restrict__ scores,
                        const bf16* __restrict__ wdT, const float* __restrict__ b_dec,
                        const float* __restrict__ ln_s, const float* __restrict__ ln_b,
                        const bf16* __restrict__ woT, const float* __restrict__ b_out,
                        const float* __restrict__ bias, float* __restrict__ blank_out,
                        float* __restrict__ vals_out, int* __restrict__ flat_out,
                        float* __restrict__ factor_out, int BK, int H, int J, int V, int K,
                        int n, int blank, int eos) {
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay = layout(H, J, NMAX, BIAS);
  float* sD = reinterpret_cast<float*>(smem + lay.d);
  float* sStat = reinterpret_cast<float*>(smem + lay.stat);
  float* sBlank = reinterpret_cast<float*>(smem + lay.blank);
  float* sEos = reinterpret_cast<float*>(smem + lay.eos);
  bf16* sX = reinterpret_cast<bf16*>(smem + lay.x);
  bf16* sH = reinterpret_cast<bf16*>(smem + lay.h);
  const int LDX = H + 8, LDH = J + 8, LDD = J + 4;

  const int row0 = blockIdx.x * RB;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, t = lane & 3;

  // ---- stage the feature rows (rows past BK are zero)
  for (int i = threadIdx.x; i < RB * (H / 8); i += NTHREADS) {
    const int r = i / (H / 8), c = (i % (H / 8)) * 8;
    uint4 v = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < BK)
      v = *reinterpret_cast<const uint4*>(feat + (size_t)(row0 + r) * feat_ld + c);
    *reinterpret_cast<uint4*>(sX + r * LDX + c) = v;
  }
  __syncthreads();

  // ---- d = feat @ W_dec + b_dec, 64 columns per warp chunk
  for (int c0 = warp * NC; c0 < J; c0 += NWARPS * NC) {
    float acc[NC / 8][4] = {};
    for (int k0 = 0; k0 < H; k0 += 16) {
      uint32_t a[4];
      load_a(a, sX + k0, LDX, g, t);
#pragma unroll
      for (int nt = 0; nt < NC / 8; ++nt) {
        const bf16* wb = wdT + (size_t)(c0 + nt * 8 + g) * H + k0 + 2 * t;
        mma_bf16(acc[nt], a, ld32(wb), ld32(wb + 8));
      }
    }
#pragma unroll
    for (int nt = 0; nt < NC / 8; ++nt) {
#pragma unroll
      for (int half = 0; half < 2; ++half) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + nt * 8 + 2 * t + e;
          sD[(g + 8 * half) * LDD + c] = acc[nt][2 * half + e] + b_dec[c];
        }
      }
    }
  }
  __syncthreads();

  // ---- LayerNorm (fp32, two passes as jnp.mean), h = bf16(relu(enc + d))
  for (int r = warp; r < RB; r += NWARPS) {
    const float* dr = sD + r * LDD;
    float sum = 0.f;
    for (int c = lane; c < J; c += 32) sum += dr[c];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, off);
    const float mu = sum / J;
    float sq = 0.f;
    for (int c = lane; c < J; c += 32) sq += (dr[c] - mu) * (dr[c] - mu);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) sq += __shfl_xor_sync(0xffffffffu, sq, off);
    const float rs = rsqrtf(sq / J + kEps);
    const bool in = row0 + r < BK;
    for (int c = lane; c < J; c += 32) {
      const float dn = (dr[c] - mu) * rs * ln_s[c] + ln_b[c];
      const float e = in ? __bfloat162float(enc[(size_t)(row0 + r) * J + c]) : 0.f;
      sH[r * LDH + c] = __float2bfloat16(fmaxf(e + dn, 0.f));
    }
  }
  __syncthreads();

  // ---- logits over V in 64-column tiles: stats and per-lane top lists
  float st[2][NSTAT];
  float lk[2][NMAX], lv[2][NMAX];
  int li[2][NMAX];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
#pragma unroll
    for (int q = 0; q < NSTAT; q += 2) {
      st[half][q] = -INFINITY;
      st[half][q + 1] = 0.f;
    }
#pragma unroll
    for (int i = 0; i < NMAX; ++i) {
      lk[half][i] = -INFINITY;
      li[half][i] = 0x7fffffff;
      lv[half][i] = 0.f;
    }
  }
  for (int c0 = warp * NC; c0 < V; c0 += NWARPS * NC) {
    float acc[NC / 8][4] = {};
    for (int k0 = 0; k0 < J; k0 += 16) {
      uint32_t a[4];
      load_a(a, sH + k0, LDH, g, t);
#pragma unroll
      for (int nt = 0; nt < NC / 8; ++nt) {
        const int col = c0 + nt * 8 + g;
        uint32_t b0 = 0u, b1 = 0u;
        if (col < V) {
          const bf16* wb = woT + (size_t)col * J + k0 + 2 * t;
          b0 = ld32(wb);
          b1 = ld32(wb + 8);
        }
        mma_bf16(acc[nt], a, b0, b1);
      }
    }
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = g + 8 * half;
      const int grow = row0 + r;
#pragma unroll
      for (int nt = 0; nt < NC / 8; ++nt) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int c = c0 + nt * 8 + 2 * t + e;
          if (c >= V) continue;
          const float v = acc[nt][2 * half + e] + b_out[c];
          stat_add(st[half][0], st[half][1], v);
          if (c == blank) sBlank[r] = v;
          if (c == eos) sEos[r] = v;
          if (c == blank || c == eos) continue;
          float key = v;
          if (BIAS) {
            const float bv = grow < BK ? bias[(size_t)grow * V + c] : 0.f;
            stat_add(st[half][2], st[half][3], v);
            key = v + bv;
            stat_add(st[half][4], st[half][5], key);
          }
          insert<NMAX, BIAS>(lk[half], li[half], lv[half], key, c, v);
        }
      }
    }
  }
  __syncthreads();  // sD is dead: the lists take its space

  float* sK = sD;                                      // [RB][NLISTS][NMAX]
  int* sI = reinterpret_cast<int*>(sK + RB * NLISTS * NMAX);
  float* sV = reinterpret_cast<float*>(sI + RB * NLISTS * NMAX);  // BIAS only
  const int list = warp * 4 + t;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = g + 8 * half;
    const int base = (r * NLISTS + list) * NMAX;
#pragma unroll
    for (int i = 0; i < NMAX; ++i) {
      sK[base + i] = lk[half][i];
      sI[base + i] = li[half][i];
      if (BIAS) sV[base + i] = lv[half][i];
    }
#pragma unroll
    for (int q = 0; q < NSTAT; ++q) sStat[(r * NLISTS + list) * NSTAT + q] = st[half][q];
  }
  __syncthreads();

  // ---- one thread per row: lse, blank log-prob, factor, merged top-n
  const int r = threadIdx.x;
  const int grow = row0 + r;
  if (r >= RB || grow >= BK) return;
  float m[3] = {-INFINITY, -INFINITY, -INFINITY}, s[3] = {0.f, 0.f, 0.f};
  for (int l = 0; l < NLISTS; ++l) {
    const float* p = sStat + (r * NLISTS + l) * NSTAT;
#pragma unroll
    for (int q = 0; q < 3; ++q) stat_merge(m[q], s[q], p[2 * q], p[2 * q + 1]);
  }
  const float lse = m[0] + logf(s[0]);
  float bl = sBlank[r] - lse;
  if (eos >= 0) {
    const float el = sEos[r] - lse;
    bl = fmaxf(bl, el) + log1pf(expf(-fabsf(bl - el)));
  }
  blank_out[grow] = bl;
  float factor = 0.f;
  if (BIAS) {
    const float s1 = (m[1] - lse) + logf(s[1]);
    const float s2 = (m[2] - lse) + logf(s[2]);
    factor = s1 - s2;
    factor_out[grow] = factor;
  }
  const float sc = scores[grow];
  int pos[NLISTS];
#pragma unroll
  for (int l = 0; l < NLISTS; ++l) pos[l] = 0;
  const int rb = r * NLISTS * NMAX;
  for (int i = 0; i < n; ++i) {
    float bk = -INFINITY;
    int bc = 0x7fffffff, bl_ = 0;
    for (int l = 0; l < NLISTS; ++l) {
      if (pos[l] >= NMAX) continue;
      const float k = sK[rb + l * NMAX + pos[l]];
      const int c = sI[rb + l * NMAX + pos[l]];
      if (k > bk || (k == bk && c < bc)) {
        bk = k;
        bc = c;
        bl_ = l;
      }
    }
    float val;
    if (BIAS) {
      const float v = sV[rb + bl_ * NMAX + pos[bl_]];
      val = sc + (((v - lse) + bias[(size_t)grow * V + bc]) + factor);
    } else {
      val = sc + (bk - lse);
    }
    ++pos[bl_];
    vals_out[(size_t)grow * n + i] = val;
    flat_out[(size_t)grow * n + i] = (grow % K) * V + bc;
  }
}

template <int NMAX, bool BIAS>
int launch(const void* enc, const void* feat, int feat_ld, const void* scores,
           const void* wdT, const void* b_dec, const void* ln_s, const void* ln_b,
           const void* woT, const void* b_out, const void* bias, void* blank_out,
           void* vals_out, void* flat_out, void* factor_out, int BK, int H, int J, int V,
           int K, int n, int blank, int eos, cudaStream_t stream) {
  const size_t smem = layout(H, J, NMAX, BIAS).total;
  cudaError_t err = cudaFuncSetAttribute(fused_joint_topk_kernel<NMAX, BIAS>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((BK + RB - 1) / RB);
  fused_joint_topk_kernel<NMAX, BIAS><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(enc), static_cast<const bf16*>(feat), feat_ld,
      static_cast<const float*>(scores), static_cast<const bf16*>(wdT),
      static_cast<const float*>(b_dec), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const bf16*>(woT),
      static_cast<const float*>(b_out), static_cast<const float*>(bias),
      static_cast<float*>(blank_out), static_cast<float*>(vals_out),
      static_cast<int*>(flat_out), static_cast<float*>(factor_out), BK, H, J, V, K, n,
      blank, eos);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// enc [BK, J] bf16 (contiguous); feat: BK rows of H bf16 at row stride
// feat_ld; scores [BK] fp32; wdT = W_dec^T [J, H] and woT = W_out^T [V, J]
// bf16 (contiguous); b_dec, ln_s, ln_b [J] and b_out [V] fp32; bias [BK, V]
// fp32 or null (then factor_out is unused); outputs blank_out [BK],
// vals_out [BK, n] fp32, flat_out [BK, n] int32 (row % K * V + column),
// factor_out [BK] fp32. J % 64 == 0, H % 16 == 0, 1 <= n <= 32; eos < 0
// when no eos column is folded into blank. Launches on `stream` of card
// `device`; returns the CUDA error code (0 on success).
int fused_joint_topk_bf16(const void* enc, const void* feat, int feat_ld,
                          const void* scores, const void* wdT, const void* b_dec,
                          const void* ln_s, const void* ln_b, const void* woT,
                          const void* b_out, const void* bias, void* blank_out,
                          void* vals_out, void* flat_out, void* factor_out, int BK, int H,
                          int J, int V, int K, int n, int blank, int eos, int device,
                          void* stream) {
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' card explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || n > 32 || J % 64 != 0 || H % 16 != 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  if (n <= 16) {
    if (bias)
      return launch<16, true>(enc, feat, feat_ld, scores, wdT, b_dec, ln_s, ln_b, woT, b_out,
                              bias, blank_out, vals_out, flat_out, factor_out, BK, H, J, V,
                              K, n, blank, eos, s);
    return launch<16, false>(enc, feat, feat_ld, scores, wdT, b_dec, ln_s, ln_b, woT, b_out,
                             bias, blank_out, vals_out, flat_out, factor_out, BK, H, J, V, K,
                             n, blank, eos, s);
  }
  if (bias)
    return launch<32, true>(enc, feat, feat_ld, scores, wdT, b_dec, ln_s, ln_b, woT, b_out,
                            bias, blank_out, vals_out, flat_out, factor_out, BK, H, J, V, K,
                            n, blank, eos, s);
  return launch<32, false>(enc, feat, feat_ld, scores, wdT, b_dec, ln_s, ln_b, woT, b_out,
                           bias, blank_out, vals_out, flat_out, factor_out, BK, H, J, V, K,
                           n, blank, eos, s);
}

}  // extern "C"
