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
// bound it, barely; what limits a real kernel is latency: the work is 40
// row tiles of 64 rows. The earlier mma.sync design (160 blocks of 16 rows,
// each reading both weight matrices as 4-byte fragments straight from L2,
// ~240 MB of scattered L2 reads, a thread per row in the final merge) took
// 0.1837 ms on an NVIDIA H100 80GB HBM3 at 700 W; this design takes 0.0779
// ms there (chip_smoke.py, profiler device time).
//
// What the design does about it: a thread-block cluster of C CTAs (C <= 4)
// shares one tile of 64 rows (one wgmma M tile), and each CTA computes a
// 1/C share of the columns, so a cluster reads the weights once:
//   - the feature rows (64 x H) come in by cp.async into shared memory (an
//     activation: no tensor map per call); the weights stream as [64 x 64]
//     tiles brought by TMA (128-byte swizzle, zeros past the vocab's ragged
//     tail) into two rings of 4 stages guarded by mbarriers, one ring and
//     one producer warp per consumer warpgroup, each ring in the order its
//     warpgroup takes the tiles (so the logits' first tiles arrive while the
//     LayerNorm runs, and each warpgroup waits on its slots' phases in turn);
//   - two consumer warpgroups run wgmma m64n64k16 from shared memory: the d
//     columns first (64-column tiles dealt round-robin to the CTAs and, in a
//     CTA, to the warpgroups; d stays in registers), then the LayerNorm's
//     statistics in fp32: each CTA's per-row sum and sum of squares about
//     its own mean, exchanged once through distributed shared memory and
//     combined in rank order, so every CTA gets the same mean and variance;
//     each CTA writes h for its d columns into its shared memory in the
//     swizzled layout and pulls the others' h columns from theirs, so each
//     holds the full h (64 x J) as wgmma's A;
//   - then the logits over V in 64-column tiles (dealt the same way; the two
//     warpgroups alternate, one's epilogue over the other's products): for
//     each of its two accumulator rows a lane folds the tile's 16 values
//     into the lse statistics (and the masked and biased ones with a label
//     bias) with one rescale, sorts the tile's candidates by a bitonic
//     network and merges them into its sorted list of the NMAX best (a
//     bitonic merge; no branches, so no lane waits on another's insertion).
//     A candidate is a 64-bit word: the key's order-preserving bits above
//     the column's complement, so ties go to the lower column. A row
//     constant does not change which columns win, so the lists need no lse;
//   - the end: the lists and the statistics go to shared memory, and a warp
//     per row merges the row's 8 C lists across the cluster (a lane a list,
//     read through distributed shared memory) by n rounds of two warp
//     reductions (redux.sync: the largest key, then the lowest column), two
//     rows at a time, forming each value in the Pallas kernel's order of
//     operations.
// C: the sizes that keep each CTA's d tiles in registers, and among them the
// one with the least waves of co-resident clusters (as
// cudaOccupancyMaxActiveClusters counts them) per CTA share, ties to the
// fewer waves: a CTA holds ~140 KB of shared memory, so one fits an SM, and
// a cluster must fit whole into one of the card's GPCs, which can leave
// fewer clusters co-resident than 132 / C. The clusters synchronise through
// mbarriers armed by remote arrives (release and acquire at cluster scope),
// each used once, so the producer warps never wait on them. The tensor
// maps are encoded once
// per weight set (fused_joint_topk_tmaps) and the shared-memory limit and
// the occupancy counts are asked once per kernel instance, not per call.
//
// What holds it back now: the products are a small part of the time; the
// per-row top-n work (a lane's sorting networks a tile, the final merge's n
// dependent rounds a row) and the cluster's exchanges are most of it, and
// they run on 8 warps an SM.
//
// C entries: fused_joint_topk_tmaps(...) encodes the weights' tensor maps;
// fused_joint_topk_bf16(...) returns the CUDA error of the launch; it
// launches on the given stream and does not synchronise.

#include "hopper_sm90.cuh"
#include <math.h>
#include <stdint.h>

namespace {

constexpr int RT = 64;                  // rows per cluster (one wgmma M tile)
constexpr int NCW = 2;                  // consumer warpgroups
constexpr int NCONS = NCW * 128;        // consumer threads
constexpr int NTHREADS = NCONS + 32 * NCW;  // + a producer warp per consumer warpgroup
constexpr int TN = 64;                  // columns per tile, d and logits
constexpr int STAGES = 4;                // ring stages per consumer warpgroup
constexpr int STAGE_BYTES = TN * 64 * 2;  // [64 x 64] bf16 weight tile
constexpr int BLOCK_BYTES = RT * 128;     // a 64-column block of feat or h rows
constexpr int MAXT = 2;                 // d tiles per consumer warpgroup
constexpr int LISTS = NCW * 4;          // per-row lists per CTA: (warpgroup, lane q)
constexpr int NSTAT = 6;                // (m, s) for all, masked, biased
constexpr int MAXC = 4;                 // cluster size: 8 C lists fill a warp
constexpr float kEps = 1e-6f;
constexpr int kSentinel = 0x7fffffff;

// log-sum-exp statistics: (m, s) with sum = s * exp(m)
// fold a tile's values (where ok) into (m, s): one rescale a tile
__device__ inline void tile_stat(float& m, float& s, const float (&v)[16], const bool (&ok)[16]) {
  float mt = -INFINITY;
#pragma unroll
  for (int x = 0; x < 16; ++x)
    if (ok[x]) mt = fmaxf(mt, v[x]);
  if (mt == -INFINITY) return;
  const float mn = fmaxf(m, mt);
  float add = 0.f;
#pragma unroll
  for (int x = 0; x < 16; ++x)
    if (ok[x]) add += expf(v[x] - mn);
  s = s * expf(m - mn) + add;
  m = mn;
}

__device__ inline void stat_merge(float& m, float& s, float m2, float s2) {
  const float mn = fmaxf(m, m2);
  if (mn == -INFINITY) return;
  s = s * expf(m - mn) + s2 * expf(m2 - mn);
  m = mn;
}

// A candidate is packed into 64 bits so that a larger word is a better
// candidate: the key's order-preserving bits above, the column's complement
// below (an equal key prefers the lower column). 0 is below every real
// candidate and stands for an empty entry.
// a float's bits mapped to an unsigned integer of the same order (-0 as +0)
__device__ inline uint32_t sortable(float f) {
  const uint32_t u = __float_as_uint(f + 0.f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ inline float unsortable(uint32_t u) {
  return __uint_as_float((u & 0x80000000u) ? (u & 0x7fffffffu) : ~u);
}

__device__ inline uint64_t pack(float key, int col) {
  return ((uint64_t)sortable(key) << 32) | (uint32_t)(kSentinel - col);
}

__device__ inline int pack_col(uint64_t p) { return kSentinel - (int)(uint32_t)p; }

// order entries a < b of a list descending (larger word first); the values
// (a label-biased list's logits) follow their words
template <int N, bool VALS>
__device__ inline void exch(uint64_t (&k)[N], float (&v)[N], int a, int b) {
  const bool sw = k[b] > k[a];
  const uint64_t ka = k[a], kb = k[b];
  k[a] = sw ? kb : ka;
  k[b] = sw ? ka : kb;
  if (VALS) {
    const float va = v[a], vb = v[b];
    v[a] = sw ? vb : va;
    v[b] = sw ? va : vb;
  }
}

// sort the first 16 entries descending (bitonic network, no branches)
template <int N, bool VALS>
__device__ inline void sort16(uint64_t (&k)[N], float (&v)[N]) {
#pragma unroll
  for (int size = 2; size <= 16; size <<= 1)
#pragma unroll
    for (int stride = size >> 1; stride > 0; stride >>= 1)
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const int l = i ^ stride;
        if (l > i) {
          if ((i & size) == 0)
            exch<N, VALS>(k, v, i, l);
          else
            exch<N, VALS>(k, v, l, i);
        }
      }
}

// list <- the N best of list and tile, both sorted descending: the
// elementwise max of the list and the reversed tile is bitonic and holds
// them; a bitonic merge sorts it
template <int N, bool VALS>
__device__ inline void merge_top(uint64_t (&lk)[N], float (&lv)[N], const uint64_t (&tk)[N],
                                 const float (&tv)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) {
    const bool take = tk[N - 1 - i] > lk[i];
    lk[i] = take ? tk[N - 1 - i] : lk[i];
    if (VALS) lv[i] = take ? tv[N - 1 - i] : lv[i];
  }
#pragma unroll
  for (int stride = N >> 1; stride > 0; stride >>= 1)
#pragma unroll
    for (int i = 0; i < N; ++i) {
      const int l = i ^ stride;
      if (l > i) exch<N, VALS>(lk, lv, i, l);
    }
}

struct Layout {  // dynamic shared memory, in bytes from the 1024-aligned base
  uint32_t x, ring, lists, stat, part, cta, blank, eos, bar, total;
};

// x: feat, then h, in 64-column swizzled blocks; ring: the weight stages;
// lists alias both once they are dead (every CTA has pulled its h)
__host__ __device__ inline Layout layout(int H, int J, int nmax) {
  Layout l;
  const int kh = (H + 63) / 64, kj = J / 64;
  l.x = 0;
  l.ring = (uint32_t)(kh > kj ? kh : kj) * BLOCK_BYTES;
  const uint32_t front = l.ring + NCW * STAGES * STAGE_BYTES;
  const uint32_t lists = (uint32_t)RT * LISTS * nmax * 8;
  l.lists = 0;
  l.stat = front > lists ? front : lists;
  l.part = l.stat + RT * LISTS * NSTAT * 4;  // [sum, M2][warpgroup][row] partial sums
  l.cta = l.part + 2 * NCW * RT * 4;         // [sum, M2][row]: this CTA's, read by the others
  l.blank = l.cta + 2 * RT * 4;
  l.eos = l.blank + RT * 4;
  l.bar = l.eos + RT * 4;
  l.total = l.bar + (2 * NCW * STAGES + 4) * 8;
  return l;
}

__device__ inline float2 bf2_to_f2(__nv_bfloat162 v) {
  return make_float2(__bfloat162float(v.x), __bfloat162float(v.y));
}

template <int NMAX, bool BIAS>
__global__ void __launch_bounds__(NTHREADS, 1)
fused_joint_topk_kernel(const __grid_constant__ CUtensorMap tm_dec,
                        const __grid_constant__ CUtensorMap tm_out,
                        const bf16* __restrict__ enc, const bf16* __restrict__ feat,
                        int feat_ld, const float* __restrict__ scores,
                        const float* __restrict__ b_dec, const float* __restrict__ ln_s,
                        const float* __restrict__ ln_b, const float* __restrict__ b_out,
                        const float* __restrict__ bias, float* __restrict__ blank_out,
                        float* __restrict__ vals_out, int* __restrict__ flat_out,
                        float* __restrict__ factor_out, int BK, int H, int J, int V, int K,
                        int n, int blank, int eos) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = sm90::smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;  // swizzled tiles need 1024-byte alignment
  uint8_t* smem = smem_raw + (base - raw);
  const Layout lay = layout(H, J, NMAX);
  // ring w feeds consumer warpgroup w alone: each warpgroup waits on its
  // slots' phases in order (a ring shared by warpgroups that take turns
  // would have one wait on a slot two phases ahead, which a parity wait
  // cannot tell from the phase before)
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + lay.bar);  // [NCW][STAGES]
  uint64_t* empty = full + NCW * STAGES;
  // the cluster's exchange points, each used once: the LayerNorm's
  // statistics, h written, lists written; and hb: every CTA has pulled its h
  // columns from this one. (One barrier over several phases would let a CTA
  // that is ahead arrive for the next phase before a slower CTA's arrival
  // for the current one, completing it early.)
  uint64_t* xb = empty + NCW * STAGES;
  uint64_t* hb = xb + 3;

  const int C = (int)sm90::cluster_size(), r = (int)sm90::cluster_rank();
  const int row0 = blockIdx.x / C * RT;
  const int KH = (H + 63) / 64, KJ = J / 64, VT = (V + 63) / 64;
  const int nd = KJ > r ? (KJ - 1 - r) / C + 1 : 0;  // d tiles r, r + C, ...
  const int nv = VT > r ? (VT - 1 - r) / C + 1 : 0;  // logits tiles likewise
  const uint32_t sX = base + lay.x, ring = base + lay.ring;

  if (threadIdx.x == 0) {
    for (int s = 0; s < NCW * STAGES; ++s) {
      sm90::mbar_init(&full[s], 1);   // the producer's expect_tx
      sm90::mbar_init(&empty[s], 1);  // one thread of the consuming warpgroup
    }
    for (int x = 0; x < 4; ++x) sm90::mbar_init(&xb[x], C);
    sm90::fence_barrier_init();
  }
  sm90::cluster_sync();  // every CTA's barriers are ready before any remote arrive

  if (threadIdx.x >= NCONS) {
    // ---- producer warp w fills ring w with the weight tiles of consumer
    // warpgroup w in the order it takes them (the whole warp walks the
    // ring; lane 0 issues)
    const int w = (threadIdx.x - NCONS) / 32;
    const bool leader = threadIdx.x % 32 == 0;
    int it = 0;
    for (int dec = 1; dec >= 0; --dec) {  // d tiles w, w + 2, ..., then logits tiles
      for (int i = w; i < (dec ? nd : nv); i += NCW) {
        const int tile = r + i * C;
        for (int kb = 0; kb < (dec ? KH : KJ); ++kb, ++it) {
          const int slot = w * STAGES + it % STAGES;
          sm90::mbar_wait(&empty[slot], ((it / STAGES) & 1) ^ 1);
          if (leader) {
            sm90::mbar_arrive_expect_tx(&full[slot], STAGE_BYTES);
            sm90::tma_load_2d(ring + slot * STAGE_BYTES, dec ? &tm_dec : &tm_out, &full[slot],
                              kb * 64, tile * TN);
          }
          __syncwarp();
        }
      }
    }
  } else {
    const int cw = threadIdx.x / 128, t = threadIdx.x % 128;
    const int wi = t >> 5, lane = t & 31, g = lane >> 2, q = lane & 3;
    float* part = reinterpret_cast<float*>(smem + lay.part);
    float* cta = reinterpret_cast<float*>(smem + lay.cta);
    float* sBlank = reinterpret_cast<float*>(smem + lay.blank);
    float* sEos = reinterpret_cast<float*>(smem + lay.eos);

    // ---- the feature rows (rows past BK and columns past H are zero)
    for (int i = threadIdx.x; i < RT * KH * 8; i += NCONS) {
      const int row = i / (KH * 8), ch = i % (KH * 8), grow = row0 + row;
      const bool ok = grow < BK && ch * 8 < H;
      sm90::cp_async16(sX + (ch / 8) * BLOCK_BYTES + sm90::swz(row, ch % 8),
                       ok ? feat + (size_t)grow * feat_ld + ch * 8 : feat, ok);
    }
    sm90::cp_async_commit();
    sm90::cp_async_wait<0>();
    sm90::fence_proxy_async();
    sm90::named_sync(1, NCONS);

    // ---- d = feat @ W_dec + b_dec for this CTA's d tiles (local i = cw + 2 s)
    int it = 0;  // this warpgroup's position in its ring
    float dv[MAXT][32];
#pragma unroll
    for (int s = 0; s < MAXT; ++s) {
      const int i = cw + 2 * s;
#pragma unroll
      for (int e = 0; e < 32; ++e) dv[s][e] = 0.f;
      if (i >= nd) continue;
      int prev = -1;
      for (int kb = 0; kb < KH; ++kb, ++it) {
        const int slot = cw * STAGES + it % STAGES;
        sm90::mbar_wait(&full[slot], (it / STAGES) & 1);
        sm90::wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k)
          sm90::wgmma_ss_n64<0, 0>(dv[s], sm90::wgmma_desc(sX + kb * BLOCK_BYTES + 32 * k),
                                   sm90::wgmma_desc(ring + slot * STAGE_BYTES + 32 * k), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // the previous stage's products are done
        if (prev >= 0 && t == 0) sm90::mbar_arrive(&empty[prev]);
        prev = slot;
      }
      sm90::wgmma_wait<0>();
      if (t == 0) sm90::mbar_arrive(&empty[prev]);
      const int c0 = (r + i * C) * TN;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) dv[s][4 * j + e] += b_dec[c0 + 8 * j + 2 * q + (e & 1)];
    }

    // ---- LayerNorm statistics (fp32): each row's sum over this CTA's
    // columns, then its sum of squares about this CTA's mean, exchanged once
    // through the cluster and combined in rank order (Chan et al.), so that
    // every CTA gets the same mean and variance
    float mu[2], rs[2];
    {
      float ps[2] = {0.f, 0.f}, lm[2];
#pragma unroll
      for (int s = 0; s < MAXT; ++s) {
        if (cw + 2 * s >= nd) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) ps[e >> 1] += dv[s][4 * j + e];
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
        ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
        if (q == 0) part[cw * RT + wi * 16 + g + 8 * h] = ps[h];
      }
      sm90::named_sync(1, NCONS);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wi * 16 + g + 8 * h;
        lm[h] = nd > 0 ? (part[row] + part[RT + row]) / (nd * TN) : 0.f;
        ps[h] = 0.f;
      }
#pragma unroll
      for (int s = 0; s < MAXT; ++s) {
        if (cw + 2 * s >= nd) continue;
#pragma unroll
        for (int j = 0; j < 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float dd = dv[s][4 * j + e] - lm[e >> 1];
            ps[e >> 1] += dd * dd;
          }
      }
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 1);
        ps[h] += __shfl_xor_sync(0xffffffffu, ps[h], 2);
        if (q == 0) part[(NCW + cw) * RT + wi * 16 + g + 8 * h] = ps[h];
      }
      sm90::named_sync(1, NCONS);
      if (threadIdx.x < 2 * RT) {
        const int k = threadIdx.x / RT, row = threadIdx.x % RT;
        cta[threadIdx.x] = part[(NCW * k) * RT + row] + part[(NCW * k + 1) * RT + row];
      }
      sm90::fence_cluster();
      sm90::named_sync(1, NCONS);
      if (threadIdx.x == 0)
        for (int c = 0; c < C; ++c) sm90::mbar_arrive_remote(&xb[0], c);
      sm90::mbar_wait_cluster(&xb[0], 0);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wi * 16 + g + 8 * h;
        float sum[MAXC], m2[MAXC], total = 0.f;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          if (c >= C) continue;
          sum[c] = sm90::ld_dsmem_f32(sm90::mapa(sm90::smem_u32(cta + row), c));
          m2[c] = sm90::ld_dsmem_f32(sm90::mapa(sm90::smem_u32(cta + RT + row), c));
          total += sum[c];
        }
        mu[h] = total / J;
        float M2 = 0.f;
#pragma unroll
        for (int c = 0; c < MAXC; ++c) {
          const int cols = KJ > c ? ((KJ - 1 - c) / C + 1) * TN : 0;
          if (c >= C || cols == 0) continue;
          const float dm = sum[c] / cols - mu[h];
          M2 += m2[c] + cols * dm * dm;
        }
        rs[h] = rsqrtf(M2 / J + kEps);
      }
    }

    // ---- h = bf16(relu(enc + d)) for this CTA's d tiles, into x (feat is
    // dead: both warpgroups passed the barriers above after their products)
#pragma unroll
    for (int s = 0; s < MAXT; ++s) {
      const int i = cw + 2 * s;
      if (i >= nd) continue;
      const int td = r + i * C;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wi * 16 + g + 8 * h, grow = row0 + row;
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = td * TN + 8 * j + 2 * q;
          const float2 ev = grow < BK ? bf2_to_f2(*reinterpret_cast<const __nv_bfloat162*>(
                                            enc + (size_t)grow * J + c))
                                      : make_float2(0.f, 0.f);
          const float d0 = (dv[s][4 * j + 2 * h] - mu[h]) * rs[h] * ln_s[c] + ln_b[c];
          const float d1 = (dv[s][4 * j + 2 * h + 1] - mu[h]) * rs[h] * ln_s[c + 1] + ln_b[c + 1];
          *reinterpret_cast<__nv_bfloat162*>(smem + lay.x + td * BLOCK_BYTES +
                                             sm90::swz(row, j) + 4 * q) =
              __halves2bfloat162(__float2bfloat16(fmaxf(ev.x + d0, 0.f)),
                                 __float2bfloat16(fmaxf(ev.y + d1, 0.f)));
        }
      }
    }
    sm90::fence_proxy_async();
    sm90::fence_cluster();
    sm90::named_sync(1, NCONS);
    if (threadIdx.x == 0)
      for (int c = 0; c < C; ++c) sm90::mbar_arrive_remote(&xb[1], c);
    sm90::mbar_wait_cluster(&xb[1], 0);
    // pull the other CTAs' h columns (d tile td lives in CTA td % C), four
    // 16-byte loads in flight per thread
    for (int i0 = threadIdx.x; i0 < KJ * (BLOCK_BYTES / 16); i0 += 4 * NCONS) {
      uint4 v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * NCONS, owner = i / (BLOCK_BYTES / 16) % C;
        if (i < KJ * (BLOCK_BYTES / 16) && owner != r)
          v[u] = sm90::ld_dsmem_v4(sm90::mapa(base + lay.x + i * 16, owner));
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int i = i0 + u * NCONS, owner = i / (BLOCK_BYTES / 16) % C;
        if (i < KJ * (BLOCK_BYTES / 16) && owner != r)
          *reinterpret_cast<uint4*>(smem + lay.x + i * 16) = v[u];
      }
    }
    sm90::fence_proxy_async();
    sm90::named_sync(1, NCONS);
    if (threadIdx.x == 0)
      for (int c = 0; c < C; ++c) sm90::mbar_arrive_remote(hb, c);

    // ---- logits over this CTA's V tiles: stats and per-lane top lists
    float st[2][NSTAT];
    uint64_t lk[2][NMAX];  // per row, this lane's NMAX best candidates, packed
    float lv[2][NMAX];     // and their logits (label bias only)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
#pragma unroll
      for (int k = 0; k < NSTAT; k += 2) {
        st[h][k] = -INFINITY;
        st[h][k + 1] = 0.f;
      }
#pragma unroll
      for (int i = 0; i < NMAX; ++i) {
        lk[h][i] = 0;
        lv[h][i] = 0.f;
      }
    }
    for (int i = cw; i < nv; i += NCW) {
      const int c0 = (r + i * C) * TN;
      float bo[16];  // b_out of this thread's 16 columns, loaded under the products
#pragma unroll
      for (int x = 0; x < 16; ++x) {
        const int c = c0 + 8 * (x >> 1) + 2 * q + (x & 1);
        bo[x] = c < V ? b_out[c] : 0.f;
      }
      float acc[32];
#pragma unroll
      for (int e = 0; e < 32; ++e) acc[e] = 0.f;
      int prev = -1;
      for (int kb = 0; kb < KJ; ++kb, ++it) {
        const int slot = cw * STAGES + it % STAGES;
        sm90::mbar_wait(&full[slot], (it / STAGES) & 1);
        sm90::wgmma_fence();
#pragma unroll
        for (int k = 0; k < 4; ++k)
          sm90::wgmma_ss_n64<0, 0>(acc, sm90::wgmma_desc(sX + kb * BLOCK_BYTES + 32 * k),
                                   sm90::wgmma_desc(ring + slot * STAGE_BYTES + 32 * k), 1);
        sm90::wgmma_commit();
        sm90::wgmma_wait<1>();  // the previous stage's products are done
        if (prev >= 0 && t == 0) sm90::mbar_arrive(&empty[prev]);
        prev = slot;
      }
      sm90::wgmma_wait<0>();
      if (t == 0) sm90::mbar_arrive(&empty[prev]);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = wi * 16 + g + 8 * h, grow = row0 + row;
        float v[16], key[16];
        bool ok[16], cand[16];
#pragma unroll
        for (int x = 0; x < 16; ++x) {
          const int c = c0 + 8 * (x >> 1) + 2 * q + (x & 1);
          ok[x] = c < V;
          cand[x] = ok[x] && c != blank && c != eos;
          v[x] = acc[4 * (x >> 1) + 2 * h + (x & 1)] + bo[x];
          if (ok[x] && c == blank) sBlank[row] = v[x];
          if (ok[x] && c == eos) sEos[row] = v[x];
          key[x] = v[x];
          if (BIAS) key[x] += cand[x] && grow < BK ? bias[(size_t)grow * V + c] : 0.f;
        }
        tile_stat(st[h][0], st[h][1], v, ok);
        if (BIAS) {
          tile_stat(st[h][2], st[h][3], v, cand);
          tile_stat(st[h][4], st[h][5], key, cand);
        }
        // the tile's 16 candidates sorted, then merged into the list
        uint64_t tk[NMAX];
        float tv[NMAX];
#pragma unroll
        for (int x = 0; x < NMAX; ++x) {
          tk[x] = x < 16 && cand[x & 15] ? pack(key[x & 15], c0 + 8 * ((x & 15) >> 1) + 2 * q + (x & 1))
                                         : 0;
          tv[x] = x < 16 ? v[x & 15] : 0.f;
        }
        sort16<NMAX, BIAS>(tk, tv);
        merge_top<NMAX, BIAS>(lk[h], lv[h], tk, tv);
      }
    }

    // ---- lists and statistics into shared memory, over x and the ring:
    // both warpgroups are done with them, and so is every CTA's h pull
    sm90::named_sync(1, NCONS);
    sm90::mbar_wait_cluster(hb, 0);
    float* sStat = reinterpret_cast<float*>(smem + lay.stat);
    const int list = cw * 4 + q;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = wi * 16 + g + 8 * h;
      uint2* dst = reinterpret_cast<uint2*>(smem + lay.lists) + (row * LISTS + list) * NMAX;
#pragma unroll
      for (int p = 0; p < NMAX; ++p)  // (lo, hi) words, or (logit, column) with a label bias
        dst[p] = BIAS ? make_uint2(__float_as_uint(lv[h][p]), (uint32_t)pack_col(lk[h][p]))
                      : make_uint2((uint32_t)lk[h][p], (uint32_t)(lk[h][p] >> 32));
#pragma unroll
      for (int k = 0; k < NSTAT; ++k) sStat[(row * LISTS + list) * NSTAT + k] = st[h][k];
    }
    sm90::fence_cluster();
    sm90::named_sync(1, NCONS);
    if (threadIdx.x == 0)
      for (int c = 0; c < C; ++c) sm90::mbar_arrive_remote(&xb[2], c);
    sm90::mbar_wait_cluster(&xb[2], 0);

    // ---- a warp per row (rows r, r + C, ...), two rows at a time so that
    // their reductions overlap: lane l reads list l % 8 of CTA l / 8; lse,
    // blank log-prob, factor, then n arg-max rounds
    const int warp = threadIdx.x >> 5, from = lane / LISTS, l = lane % LISTS;
    for (int k = warp; r + C * k < RT && row0 + r + C * k < BK; k += 2 * (NCONS / 32)) {
      int row[2], grow[2];
      bool on[2];  // a row of this CTA's share within BK
      uint64_t mk[2][NMAX];
      float mv[2][NMAX], ms[2][NSTAT], sc[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        row[x] = r + C * (k + x * (NCONS / 32));
        grow[x] = row0 + row[x];
        on[x] = row[x] < RT && grow[x] < BK;
        sc[x] = on[x] ? scores[grow[x]] : 0.f;
#pragma unroll
        for (int s = 0; s < NSTAT; ++s) ms[x][s] = s & 1 ? 0.f : -INFINITY;
#pragma unroll
        for (int p = 0; p < NMAX; ++p) {
          mk[x][p] = 0;
          mv[x][p] = 0.f;
        }
      }
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        if (!on[x] || from >= C) continue;
        const uint32_t la = sm90::mapa(
            base + lay.lists + (uint32_t)((row[x] * LISTS + l) * NMAX) * 8, from);
        const uint32_t sa =
            sm90::mapa(base + lay.stat + (uint32_t)((row[x] * LISTS + l) * NSTAT) * 4, from);
        uint4 e[NMAX / 2];  // every load in flight before any is used
#pragma unroll
        for (int p = 0; p < NMAX / 2; ++p) e[p] = sm90::ld_dsmem_v4(la + p * 16);
#pragma unroll
        for (int s = 0; s < NSTAT; ++s) ms[x][s] = sm90::ld_dsmem_f32(sa + 4 * s);
#pragma unroll
        for (int p = 0; p < NMAX; ++p) {
          const uint32_t w0 = p & 1 ? e[p / 2].z : e[p / 2].x;
          const uint32_t w1 = p & 1 ? e[p / 2].w : e[p / 2].y;
          if (BIAS) {
            const int c = (int)w1;
            mv[x][p] = __uint_as_float(w0);
            mk[x][p] = c < V ? pack(mv[x][p] + bias[(size_t)grow[x] * V + c], c) : 0;
          } else {
            mk[x][p] = ((uint64_t)w1 << 32) | w0;
          }
        }
      }
      float lse[2], factor[2];
#pragma unroll
      for (int x = 0; x < 2; ++x) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
#pragma unroll
          for (int s = 0; s < NSTAT; s += 2) {
            const float m2 = __shfl_xor_sync(0xffffffffu, ms[x][s], off);
            const float s2 = __shfl_xor_sync(0xffffffffu, ms[x][s + 1], off);
            stat_merge(ms[x][s], ms[x][s + 1], m2, s2);
          }
        lse[x] = ms[x][0] + logf(ms[x][1]);
        factor[x] = BIAS ? ((ms[x][2] - lse[x]) + logf(ms[x][3])) -
                               ((ms[x][4] - lse[x]) + logf(ms[x][5]))
                         : 0.f;
        if (!on[x]) continue;
        const uint32_t bl_at = base + lay.blank + row[x] * 4, eos_at = base + lay.eos + row[x] * 4;
        float bl = sm90::ld_dsmem_f32(sm90::mapa(bl_at, (blank / TN) % C)) - lse[x];
        if (eos >= 0) {
          const float el = sm90::ld_dsmem_f32(sm90::mapa(eos_at, (eos / TN) % C)) - lse[x];
          bl = fmaxf(bl, el) + log1pf(expf(-fabsf(bl - el)));
        }
        if (lane == 0) {
          blank_out[grow[x]] = bl;
          if (BIAS) factor_out[grow[x]] = factor[x];
        }
      }
      for (int i = 0; i < n; ++i) {
#pragma unroll
        for (int x = 0; x < 2; ++x) {
          // the best head: the largest key, then the lowest column
          const uint32_t hi = (uint32_t)(mk[x][0] >> 32), lo = (uint32_t)mk[x][0];
          const uint32_t best_hi = __reduce_max_sync(0xffffffffu, hi);
          const uint32_t best_lo = __reduce_max_sync(0xffffffffu, hi == best_hi ? lo : 0u);
          const bool win = hi == best_hi && lo == best_lo;
          const int bc = kSentinel - (int)best_lo;
          float val;
          if (BIAS) {
            const unsigned who = __ballot_sync(0xffffffffu, win);
            const float v = __shfl_sync(0xffffffffu, mv[x][0], __ffs(who) - 1);
            val = on[x] ? sc[x] + (((v - lse[x]) + bias[(size_t)grow[x] * V + bc]) + factor[x])
                        : 0.f;
          } else {
            val = sc[x] + (unsortable(best_hi) - lse[x]);
          }
          if (lane == 0 && on[x]) {
            vals_out[(size_t)grow[x] * n + i] = val;
            flat_out[(size_t)grow[x] * n + i] = (grow[x] % K) * V + bc;
          }
          if (win) {
#pragma unroll
            for (int p = 0; p < NMAX - 1; ++p) {
              mk[x][p] = mk[x][p + 1];
              mv[x][p] = mv[x][p + 1];
            }
            mk[x][NMAX - 1] = 0;
          }
        }
      }
    }
  }
  sm90::cluster_sync();  // no CTA leaves while another may still read its shared memory
}


template <int NMAX, bool BIAS>
int launch(const CUtensorMap* maps, const void* enc, const void* feat, int feat_ld,
           const void* scores, const void* b_dec, const void* ln_s, const void* ln_b,
           const void* b_out, const void* bias, void* blank_out, void* vals_out,
           void* flat_out, void* factor_out, int BK, int H, int J, int V, int K, int n,
           int blank, int eos, cudaStream_t stream) {
  auto kernel = fused_joint_topk_kernel<NMAX, BIAS>;
  const int smem = (int)layout(H, J, NMAX).total + 1024;
  static int smem_set = 0;  // raised once per kernel instance, to the largest seen
  if (smem > smem_set) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return (int)err;
    smem_set = smem;
  }
  const int row_tiles = (BK + RT - 1) / RT;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(NTHREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  // the cluster size: each CTA holds at most NCW * MAXT of the J / 64 d
  // tiles; among those sizes, the least time per row tile, i.e. waves of
  // co-resident clusters (as the card can place them) over C, ties to the
  // smaller C (fewer waves). The counts are asked once per size and
  // shared-memory size.
  static int occ_smem[MAXC + 1] = {0}, occ[MAXC + 1] = {0};
  const int need = (J / 64 + NCW * MAXT - 1) / (NCW * MAXT);
  int clusters = 0, best_waves = 0;
  for (int c = need; c <= MAXC; ++c) {
    if (occ_smem[c] != smem) {
      attr[0].val.clusterDim.x = c;
      cfg.gridDim = dim3(row_tiles * c);
      int active = 0;
      if (cudaOccupancyMaxActiveClusters(&active, kernel, &cfg) != cudaSuccess) active = 0;
      occ[c] = active;
      occ_smem[c] = smem;
    }
    if (occ[c] < 1) continue;
    const int waves = (row_tiles + occ[c] - 1) / occ[c];
    // waves / c < best_waves / clusters
    if (clusters == 0 || waves * clusters < best_waves * c) {
      clusters = c;
      best_waves = waves;
    }
  }
  if (clusters == 0) return (int)cudaErrorInvalidConfiguration;
  attr[0].val.clusterDim.x = clusters;
  cfg.gridDim = dim3(row_tiles * clusters);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, kernel, maps[0], maps[1], static_cast<const bf16*>(enc),
      static_cast<const bf16*>(feat), feat_ld, static_cast<const float*>(scores),
      static_cast<const float*>(b_dec), static_cast<const float*>(ln_s),
      static_cast<const float*>(ln_b), static_cast<const float*>(b_out),
      static_cast<const float*>(bias), static_cast<float*>(blank_out),
      static_cast<float*>(vals_out), static_cast<int*>(flat_out),
      static_cast<float*>(factor_out), BK, H, J, V, K, n, blank, eos);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {


// The tensor maps of wdT = W_dec^T [J, H] and woT = W_out^T [V, J] bf16
// (contiguous, 16-byte aligned), read in [64 x 64] boxes (zeros past V);
// writes 2 x 128 bytes to `out`. Returns a CUDA error code (0 on success).
int fused_joint_topk_tmaps(const void* wdT, const void* woT, int H, int J, int V, void* out) {
  const int err = sm90::encode_tmap_bf16(out, wdT, (uint64_t)J, (uint64_t)H, TN);
  if (err != 0) return err;
  return sm90::encode_tmap_bf16(static_cast<uint8_t*>(out) + sizeof(CUtensorMap), woT,
                                (uint64_t)V, (uint64_t)J, TN);
}

// enc [BK, J] bf16 (contiguous); feat: BK rows of H bf16 at row stride
// feat_ld (16-byte aligned rows); scores [BK] fp32; tmaps: the two tensor
// maps of fused_joint_topk_tmaps; b_dec, ln_s, ln_b [J] and b_out [V] fp32;
// bias [BK, V] fp32 or null (then factor_out is unused); outputs blank_out
// [BK], vals_out [BK, n] fp32, flat_out [BK, n] int32 (row % K * V +
// column), factor_out [BK] fp32. J % 64 == 0, J <= 1024, H % 16 == 0, H <=
// 1024, 1 <= n <= 32; eos < 0 when no eos column is folded into blank.
// Launches on `stream` of card `device`; returns the CUDA error code (0 on
// success).
int fused_joint_topk_bf16(const void* enc, const void* feat, int feat_ld,
                          const void* scores, const void* tmaps, const void* b_dec,
                          const void* ln_s, const void* ln_b, const void* b_out,
                          const void* bias, void* blank_out, void* vals_out, void* flat_out,
                          void* factor_out, int BK, int H, int J, int V, int K, int n, int blank,
                          int eos, int device, void* stream) {
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' card explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n < 1 || n > 32 || J % 64 != 0 || J > 1024 || H % 16 != 0 || H > 1024 || BK < 1)
    return (int)cudaErrorInvalidValue;
  CUtensorMap maps[2];
  memcpy(maps, tmaps, sizeof(maps));
  cudaStream_t s = (cudaStream_t)stream;
#define FJT_LAUNCH(NM, BI)                                                                   \
  launch<NM, BI>(maps, enc, feat, feat_ld, scores, b_dec, ln_s, ln_b, b_out, bias, blank_out, \
                 vals_out, flat_out, factor_out, BK, H, J, V, K, n, blank, eos, s)
  if (n <= 16) return bias ? FJT_LAUNCH(16, true) : FJT_LAUNCH(16, false);
  return bias ? FJT_LAUNCH(32, true) : FJT_LAUNCH(32, false);
#undef FJT_LAUNCH
}

}  // extern "C"
