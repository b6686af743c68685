// RNNT joint backward: the gradients of the joint's inputs and weights from
// the lattice occupancies, bf16 in, f32 out, sm_90a. The [B, T, U1, V]
// logits and their gradient are never written.
//
// Replaces the TPU kernel espresso_tpu/ops/rnnt_pallas.py::rnnt_joint_bwd
// (Pallas, :211-393). Per lattice row (b, t, u) and vocab column v:
//
//   pre   = bf16(relu(enc[b, t] + dec[b, u]))          (summed in f32)
//   p     = exp(pre . W[v] + bias[v] - lse)
//   glog  = -p (ob + ol) + ob [v == blank] + ol [v == tgt[u]]     (f32)
//   g_b[v]  += glog;   glog_c = bf16(glog)
//   g_W[:, v] += pre^T glog_c;   g_pre = glog_c W^T, zeroed where pre <= 0
//   g_enc[b, t] = sum_u g_pre;   g_dec[b, u] = sum_t g_pre
//
// with ob, ol the occupancy-weighted upstream gradients of the blank and
// label moves (rnnt_pallas.py:299-331). The sum of two bf16 values rounds
// to bf16 the same whether it is formed in f32 first or by one bf16x2
// operation (an f32 sum of two bf16 values is exact or rounds below the bf16
// half ulp), so the joint hidden is formed by packed fma(enc, 1, dec) with
// relu, two values an instruction.
//
// What bounds it on an H100: three products of the forward's size (the
// logits again, g_W and g_pre), 3 x 433.8 GFLOP at the flagship (B=16,
// T'=256, U1=101, J=512, V=1024): the tensor cores bound it (1.32 ms at 989
// TFLOP/s).
//
// Design: two persistent kernels over the same tiles of 64 lattice rows, one
// utterance x 8 values of u x 8 frames (row r = 8 ul + f), so that a tile's
// joint hidden needs 8 rows of enc and 8 of dec: a thread owns a 16-byte
// column chunk, loads its 8 enc and its dec chunks at once with the tile's
// row data (one round of memory latency a tile) and forms the rows by packed
// bf16x2 fma-relu, into the 128-byte-swizzled layout the wgmma descriptors
// name, in 64-column blocks of J. A block of each kernel runs on every SM
// and takes a contiguous share of the work (tiles ordered utterance, u
// group, frame group: ops/rnnt_kernels.py::joint_bwd_schedule), so the grid
// fills the card whatever the shape. Each block is two consumer warpgroups
// and a producer warpgroup that gives most of its registers to them
// (setmaxnreg); with wgmma, registers are allocated per warpgroup, so a
// lone producer warp would cost as much.
//   * rows (g_pre -> g_enc, g_dec): one producer thread streams the [64 x J]
//     tiles of W (the transposed view of the nn.Linear weight, [V, J], TMA
//     boxes of 64 x 64, rows past V zero) into a ring of stages guarded by
//     mbarriers, V tile by V tile, tile after tile; the consumers form each
//     tile's joint hidden. Per V tile each consumer warpgroup forms the
//     logits of 32 of its columns (wgmma m64n32k16, K = J, A = the joint
//     hidden, B = W K-major), turns them into glog_c in a shared tile
//     (double-buffered), and, once both halves are there, adds glog_c .
//     W_tile into its half of g_pre [64 x J/2] in registers (wgmma
//     m64n(J/2)k16, B = the same W stage read MN-major). At the end of a
//     tile g_pre is masked by pre > 0 and summed: over u into g_enc (the
//     lane's two rows, then the 4 warps through shared memory two at a
//     time, then one f32 atomic per (t, j) and tile), over the frames by a
//     reduce-scatter across the 8 lanes of a frame group into registers
//     that carry the sum over the block's consecutive tiles of one (b, u
//     group) and are added into g_dec once per such run.
//   * cols (g_W, g_b): work units are (V tile, row tile) pairs, V tile
//     slowest, so a block holds one or two V tiles of W (TMA) over its
//     share. The producer warpgroup forms each unit's joint hidden and row
//     data into a ring of stages; the consumers form the logits of the V
//     tile (as above), write glog_c transposed ([64 v][64 rows], K-major)
//     and add glog_c^T . pre into g_W^T [64 v x J/2] in registers (B = the
//     joint hidden read MN-major), with glog summed into g_b in f32; both
//     are added into the outputs by f32 atomics once per V tile and block.
// No epilogue reads or writes wgmma's registers in a divergent branch (it
// selects instead): ptxas would serialise every wgmma of the kernel.
// Together the kernels run four products of the logits' size (the logits
// twice), against the TPU kernel's three; that keeps a [B T U1, V] buffer
// out of memory. g_enc, g_dec, g_W and g_b sum partial sums by f32 atomics,
// in an order that changes from run to run.
//
// What holds it back (chip_kernel_ablation.py, which times the kernels
// with one part left out, on an H100 at the flagship): in the rows kernel,
// each V tile's glog epilogue and barrier stop both warpgroups' products,
// the m64n32 logits read more shared memory than they compute, and each
// tile's reductions and joint hidden form a bubble between its products;
// the columns kernel's products share the SM's instruction slots with the
// producer warpgroup, which forms every joint hidden once per V tile.
//
// C entry: rnnt_joint_bwd_bf16(...) returns the CUDA error of the launches;
// it launches on the given stream and does not synchronise. g_enc, g_dec,
// g_W and g_b must be zero on entry.

#include "hopper_sm90.cuh"
#include <math.h>

namespace {

using namespace sm90;

constexpr int ROWS = 64;             // lattice rows per tile
constexpr int UT = 8, FT = 8;        // values of u and frames per tile: row r = 8 ul + f
constexpr int VT = 64;               // vocab columns per W tile
constexpr int NCONS = 256;           // two consumer warpgroups
constexpr int RING_BYTES = 131072;   // the ring: W tiles (rows) or joint hidden tiles (cols)
constexpr int BOX = ROWS * 128;      // a [64 x 64] bf16 block (8 KB)
constexpr int ROW_INFO = ROWS * 16;  // lse, ob, ol (f32) and the target of each row

__host__ __device__ constexpr int stages(int J) { return RING_BYTES / (ROWS * J * 2); }

// the tiles: utterance b, u group ug (8 values of u), frame group ts (8
// frames); tile i = (b * nu + ug) * nt + ts
struct Tiles {
  int T, U1, nu, nt;
  long long n;
};

__device__ inline void tile_of(const Tiles& tl, long long i, int& b, int& ug, int& ts) {
  ts = (int)(i % tl.nt);
  const long long r = i / tl.nt;
  ug = (int)(r % tl.nu);
  b = (int)(r / tl.nu);
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

// relu(x + y) of two bf16 pairs in one instruction: fma(x, 1, y) rounds the
// exact sum once, as the add does
__device__ inline uint32_t relu_add2(uint32_t x, uint32_t y) {
  const __nv_bfloat162 one = __float2bfloat162_rn(1.f);
  __nv_bfloat162 s = __hfma2_relu(*reinterpret_cast<__nv_bfloat162*>(&x), one,
                                  *reinterpret_cast<__nv_bfloat162*>(&y));
  return *reinterpret_cast<uint32_t*>(&s);
}

// A tile's joint hidden and row data, formed by threads `tid` of NT in two
// steps: load() starts every global load at once (one round of latency a
// tile), store() writes them. A thread owns one 16-byte column chunk of NU
// consecutive values of u: it loads the tile's 8 enc chunks and its NU dec
// chunks of that column (each chunk is read once per tile) and writes 8 rows
// per value of u into `pre` (J / 64 swizzled [64 x 64] blocks; rows past T or
// U1 zero); threads below 64 also carry row tid's lse, ob, ol and target.
template <int J, int NT>
struct TileForm {
  static constexpr int CPR = J / 8;                          // 16-byte chunks a row
  static constexpr int NTU = NT < UT * CPR ? NT : UT * CPR;  // threads that form rows
  static constexpr int NU = UT * CPR / NTU;                  // values of u a thread
  static_assert(UT % NU == 0, "threads per tile");
  uint4 e[FT], d[NU];
  float lse_r, ob_r, ol_r;
  int tgt_r;

  __device__ inline void load(const bf16* __restrict__ enc, const bf16* __restrict__ dec,
                              const int* __restrict__ tgt, const float* __restrict__ lse,
                              const float* __restrict__ ob, const float* __restrict__ ol,
                              const Tiles& tl, int b, int ug, int ts, int tid) {
    const int c = tid % CPR, u0 = (tid / CPR) * NU;
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      const int t = ts * FT + f;
      e[f] = make_uint4(0u, 0u, 0u, 0u);
      if (tid < NTU && t < tl.T)
        e[f] = __ldg(reinterpret_cast<const uint4*>(enc + ((size_t)b * tl.T + t) * J) + c);
    }
#pragma unroll
    for (int x = 0; x < NU; ++x) {
      const int u = ug * UT + u0 + x;
      d[x] = make_uint4(0u, 0u, 0u, 0u);
      if (tid < NTU && u < tl.U1)
        d[x] = __ldg(reinterpret_cast<const uint4*>(dec + ((size_t)b * tl.U1 + u) * J) + c);
    }
    const int t = ts * FT + (tid & 7), u = ug * UT + (tid >> 3);
    const bool ok = tid < ROWS && t < tl.T && u < tl.U1;
    const size_t cell = ((size_t)b * tl.T + t) * tl.U1 + u;
    lse_r = ok ? __ldg(lse + cell) : 0.f;
    ob_r = ok ? __ldg(ob + cell) : 0.f;
    ol_r = ok ? __ldg(ol + cell) : 0.f;
    tgt_r = ok ? __ldg(tgt + (size_t)b * tl.U1 + u) : -1;
  }

  __device__ inline void store(uint8_t* pre, uint8_t* info, const Tiles& tl, int ug, int ts,
                               int tid) const {
    if (tid < ROWS) {
      float* fi = reinterpret_cast<float*>(info);
      fi[tid] = lse_r;
      fi[ROWS + tid] = ob_r;
      fi[2 * ROWS + tid] = ol_r;
      reinterpret_cast<int*>(fi)[3 * ROWS + tid] = tgt_r;
    }
    if (tid >= NTU) return;
    const int c = tid % CPR, u0 = (tid / CPR) * NU;
#pragma unroll
    for (int x = 0; x < NU; ++x) {
      const bool uok = ug * UT + u0 + x < tl.U1;
#pragma unroll
      for (int f = 0; f < FT; ++f) {
        const bool ok = uok && ts * FT + f < tl.T;
        uint4 o = make_uint4(relu_add2(e[f].x, d[x].x), relu_add2(e[f].y, d[x].y),
                             relu_add2(e[f].z, d[x].z), relu_add2(e[f].w, d[x].w));
        if (!ok) o = make_uint4(0u, 0u, 0u, 0u);
        const int r = (u0 + x) * FT + f;
        *reinterpret_cast<uint4*>(pre + (c / 8) * BOX + swz(r, c % 8)) = o;
      }
    }
  }
};

// a row's data in registers: the lane's rows 16 warp + g (h = 0) and + 8 (h = 1)
struct RowRegs {
  float lse[2], ob[2], ol[2];
  int tgt[2];
};

__device__ inline RowRegs row_regs(const uint8_t* info, int warp, int g) {
  const float* fi = reinterpret_cast<const float*>(info);
  RowRegs rr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = 16 * warp + g + 8 * h;
    rr.lse[h] = fi[r];
    rr.ob[h] = fi[ROWS + r];
    rr.ol[h] = fi[2 * ROWS + r];
    rr.tgt[h] = reinterpret_cast<const int*>(fi)[3 * ROWS + r];
  }
  return rr;
}

// the logits of the warpgroup's 32 columns of V tile `vt` (columns v0 = 64 vt
// + 32 w ..): acc = pre . W_tile^T over K = J
template <int J>
__device__ inline void logits32(float (&acc)[16], uint32_t pre, uint32_t wtile, int w) {
#pragma unroll
  for (int kb = 0; kb < J / 64; ++kb)
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_ss_n32<0, 0>(acc, wgmma_desc(pre + kb * BOX + 32 * k),
                         wgmma_desc(wtile + kb * BOX + w * 32 * 128 + 32 * k), kb + k > 0);
}

// glog of a logit in row h of the lane at column v; 0 past V. Branch-free:
// wgmma's registers read in a divergent branch make ptxas serialize them.
__device__ inline float glog_of(float logit, int v, int V, int blank, float bias_v,
                                const RowRegs& rr, int h) {
  const float p = expf(logit + bias_v - rr.lse[h]);
  float gl = -p * (rr.ob[h] + rr.ol[h]);
  gl += v == blank ? rr.ob[h] : 0.f;
  gl += v == rr.tgt[h] ? rr.ol[h] : 0.f;
  return v < V ? gl : 0.f;
}

// g += A . B over one 64-deep K block, N = J / 2, B MN-major
template <int J>
__device__ inline void half_product(float (&d)[J / 4], uint32_t a_kmajor, uint32_t b_mn) {
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint64_t da = wgmma_desc(a_kmajor + 32 * k), db = wgmma_desc_mn(b_mn + 2048 * k, BOX);
    if constexpr (J == 512) wgmma_ss_n256<0, 1>(d, da, db, 1);
    else if constexpr (J == 256) wgmma_ss_n128<0, 1>(d, da, db, 1);
    else wgmma_ss_n64<0, 1>(d, da, db, 1);
  }
}

// one step of a reduce-scatter across lanes `mask` apart: the lanes with the
// mask bit set keep (and sum) the upper N values of v, the others the lower
template <int N, int MASK, int M>
__device__ inline void scatter_step(float (&v)[M], int lane) {
  const bool hi = (lane & MASK) != 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    const float lo_v = v[k], hi_v = v[k + N];
    const float got = __shfl_xor_sync(0xffffffffu, hi ? lo_v : hi_v, MASK);
    v[k] = (hi ? hi_v : lo_v) + got;
  }
}

// reduce-scatter of v[N] across the 8 lanes of a frame group (lane bits 2-4):
// afterwards v[k], k < N / 8, holds the sum over those lanes of element
// (g2 4 + g1 2 + g0) N / 8 + k, with g = (g2 g1 g0) the lane's group index
template <int N>
__device__ inline void reduce_scatter8(float (&v)[N], int lane) {
  scatter_step<N / 2, 16>(v, lane);
  scatter_step<N / 4, 8>(v, lane);
  scatter_step<N / 8, 4>(v, lane);
}

// the bias of the lane's two columns v, v + 1 (0 past V)
__device__ inline float2 bias_pair(const float* __restrict__ bias, int v, int V) {
  return make_float2(v < V ? __ldg(bias + v) : 0.f, v + 1 < V ? __ldg(bias + v + 1) : 0.f);
}

// Every block: two consumer warpgroups (0, 1) and a producer warpgroup (2),
// which gives most of its registers to the consumers.
constexpr int NTHREADS = NCONS + 128;
constexpr int PROD_REGS = 40, CONS_REGS = 232;     // rows: the producer only starts TMA
constexpr int CPROD_REGS = 88, CCONS_REGS = 208;   // cols: the producer forms the joint hidden

template <int J>
struct RowsLayout {
  static constexpr int S = stages(J);
  static constexpr uint32_t pre = 0;                         // J/64 blocks
  static constexpr uint32_t ring = pre + J * 128;            // S x [64 x J]
  static constexpr uint32_t glog = ring + RING_BYTES;        // 2 x [64 x 64]
  static constexpr uint32_t scratch = glog + 2 * BOX;        // 2 x [8 frames][J/2] f32 (g_enc)
  static constexpr uint32_t info = scratch + 2 * FT * (J / 2) * 4;
  static constexpr uint32_t bars = info + ROW_INFO;          // full[S], empty[S]
  static constexpr uint32_t total = bars + 2 * S * 8;
};

// ---------------------------------------------------------------------------
// rows: g_pre -> g_enc, g_dec
// ---------------------------------------------------------------------------

template <int J>
__global__ void __launch_bounds__(NTHREADS, 1)
rnnt_joint_bwd_rows_kernel(const __grid_constant__ CUtensorMap tm_w, const bf16* __restrict__ enc,
                           const bf16* __restrict__ dec, const float* __restrict__ bias,
                           const int* __restrict__ tgt, const float* __restrict__ lse,
                           const float* __restrict__ ob, const float* __restrict__ ol,
                           float* __restrict__ g_enc, float* __restrict__ g_dec, Tiles tl,
                           int V, int blank) {
  using L = RowsLayout<J>;
  constexpr int S = L::S, NV4 = J / 4, NKEEP = NV4 / 8;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + S;
  const int NV = (V + VT - 1) / VT;
  const long long lo = tl.n * blockIdx.x / gridDim.x, hi = tl.n * (blockIdx.x + 1) / gridDim.x;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], 2);  // one arrive per consumer warpgroup
    }
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= NCONS) {
    // ---- producer: the W tiles of every V tile, tile after tile
    setmaxnreg_dec<PROD_REGS>();
    if (threadIdx.x == NCONS) {
      int it = 0;
      for (long long i = lo; i < hi; ++i)
        for (int vt = 0; vt < NV; ++vt, ++it) {
          const int slot = it % S;
          mbar_wait(&empty[slot], ((it / S) & 1) ^ 1);
          mbar_arrive_expect_tx(&full[slot], J * 128);
          for (int kb = 0; kb < J / 64; ++kb)
            tma_load_2d(base + L::ring + slot * (J * 128) + kb * BOX, &tm_w, &full[slot], kb * 64,
                        vt * VT);
        }
    }
  } else {
    setmaxnreg_inc<CONS_REGS>();
    const int tid = threadIdx.x, w = tid / 128, wt = tid % 128;
    const int warp = wt / 32, lane = wt % 32, g = lane / 4, q = lane % 4;
    float* scratch = reinterpret_cast<float*>(smem + L::scratch) + w * FT * (J / 2);
    float gd[NKEEP];
#pragma unroll
    for (int k = 0; k < NKEEP; ++k) gd[k] = 0.f;
    int seg_b = -1, seg_ug = -1, it = 0;
    for (long long i = lo; i <= hi; ++i) {
      int b = -1, ug = -1, ts = 0;
      if (i < hi) tile_of(tl, i, b, ug, ts);
      if ((b != seg_b || ug != seg_ug) && seg_b >= 0) {
        // g_dec[b, u, :] of the run of tiles just ended: the lane's NKEEP
        // sums over the run's frames
        const int gi = lane >> 2;
#pragma unroll
        for (int k = 0; k < NKEEP; ++k) {
          const int idx = gi * NKEEP + k;  // half (J/8 each), then n8 block and element
          const int h = idx / (J / 8), rem = idx % (J / 8);
          const int u = seg_ug * UT + 2 * warp + h;
          const int col = w * (J / 2) + 8 * (rem / 2) + 2 * q + (rem % 2);
          if (u < tl.U1) atomicAdd(g_dec + ((size_t)seg_b * tl.U1 + u) * J + col, gd[k]);
          gd[k] = 0.f;
        }
      }
      if (i == hi) break;
      seg_b = b;
      seg_ug = ug;
      TileForm<J, NCONS> tf;
      tf.load(enc, dec, tgt, lse, ob, ol, tl, b, ug, ts, tid);
      named_sync(1, NCONS);  // both warpgroups are done with the last tile's pre and row data
      tf.store(smem + L::pre, smem + L::info, tl, ug, ts, tid);
      fence_proxy_async();
      named_sync(1, NCONS);
      const RowRegs rr = row_regs(smem + L::info, warp, g);

      float gp[NV4];
#pragma unroll
      for (int k = 0; k < NV4; ++k) gp[k] = 0.f;
      int prev = -1;
      for (int vt = 0; vt < NV; ++vt, ++it) {
        const int slot = it % S;
        const uint32_t wtile = base + L::ring + slot * (J * 128);
        const uint32_t gt = base + L::glog + (vt & 1) * BOX;
        mbar_wait(&full[slot], (it / S) & 1);
        float acc[16];
        wgmma_fence();
        logits32<J>(acc, base + L::pre, wtile, w);
        wgmma_commit();
        float2 bv[4];  // loaded while the products run
#pragma unroll
        for (int j = 0; j < 4; ++j) bv[j] = bias_pair(bias, vt * VT + w * 32 + 8 * j + 2 * q, V);
        wgmma_wait<0>();  // and the last V tile's g_pre product
        if (prev >= 0 && wt == 0) mbar_arrive(&empty[prev]);
        // glog_c into the shared [64 rows][64 v] tile, K-major
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int v = vt * VT + w * 32 + 8 * j + 2 * q;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float g0 = glog_of(acc[4 * j + 2 * h], v, V, blank, bv[j].x, rr, h);
            const float g1 = glog_of(acc[4 * j + 2 * h + 1], v + 1, V, blank, bv[j].y, rr, h);
            *reinterpret_cast<uint32_t*>(smem + (gt - base) + swz(16 * warp + g + 8 * h, w * 4 + j) +
                                         4 * q) = pack_bf16(g0, g1);
          }
        }
        fence_proxy_async();
        named_sync(2, NCONS);  // both halves of glog_c are written
        wgmma_fence();
        half_product<J>(gp, gt, wtile + w * (J / 128) * BOX);
        wgmma_commit();
        prev = slot;
      }
      wgmma_wait<0>();
      if (prev >= 0 && wt == 0) mbar_arrive(&empty[prev]);

      // mask by pre > 0: gp[4 j + 2 h + e] is row 16 warp + g + 8 h (u = 8 ug
      // + 2 warp + h, frame g), column w J/2 + 8 j + 2 q + e
      float vals[NV4];  // [h][j][e]
#pragma unroll
      for (int j = 0; j < J / 16; ++j) {
        const int col = w * (J / 2) + 8 * j + 2 * q;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const uint32_t pp = *reinterpret_cast<const uint32_t*>(
              smem + L::pre + (col / 64) * BOX + swz(16 * warp + g + 8 * h, (col % 64) / 8) +
              2 * (col % 8));
          // a bf16 is > 0 when its sign bit is clear and it is not zero
          const bool p0 = (pp & 0x8000u) == 0 && (pp & 0x7fffu) != 0;
          const bool p1 = (pp & 0x80000000u) == 0 && (pp & 0x7fff0000u) != 0;
          vals[h * (J / 8) + 2 * j] = p0 ? gp[4 * j + 2 * h] : 0.f;
          vals[h * (J / 8) + 2 * j + 1] = p1 ? gp[4 * j + 2 * h + 1] : 0.f;
        }
      }
      // g_enc: the lane's two rows (u), then the 4 warps of the warpgroup in
      // shared memory, two at a time: warps 0 and 1 store into two buffers
      // (its scratch and, now that both warpgroups' products are done, its
      // glog tile), warps 2 and 3 add theirs, and the sums go out by atomics
      float ge[J / 8];
#pragma unroll
      for (int k = 0; k < J / 8; ++k) ge[k] = vals[k] + vals[J / 8 + k];
      // g_dec: the 8 frames of the lane's frame group, kept across the run
      reduce_scatter8<NV4>(vals, lane);
#pragma unroll
      for (int k = 0; k < NKEEP; ++k) gd[k] += vals[k];
      named_sync(1, NCONS);
      float* buf0 = scratch;
      float* buf1 = reinterpret_cast<float*>(smem + L::glog) + w * (BOX / 4);
      float* mine = ((warp & 1) ? buf1 : buf0) + g * (J / 2) + 2 * q;
      if (warp < 2) {
#pragma unroll
        for (int j = 0; j < J / 16; ++j)
          *reinterpret_cast<float2*>(mine + 8 * j) = make_float2(ge[2 * j], ge[2 * j + 1]);
      }
      named_sync(3 + w, 128);
      if (warp >= 2) {
#pragma unroll
        for (int j = 0; j < J / 16; ++j) {
          float2* p = reinterpret_cast<float2*>(mine + 8 * j);
          const float2 o = *p;
          *p = make_float2(o.x + ge[2 * j], o.y + ge[2 * j + 1]);
        }
      }
      named_sync(3 + w, 128);
      for (int x = wt; x < FT * (J / 2); x += 128) {
        const int t = ts * FT + x / (J / 2);
        if (t < tl.T)
          atomicAdd(g_enc + ((size_t)b * tl.T + t) * J + w * (J / 2) + x % (J / 2),
                    buf0[x] + buf1[x]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// cols: g_W, g_b
// ---------------------------------------------------------------------------

template <int J>
struct ColsLayout {
  static constexpr int S = stages(J);
  static constexpr uint32_t w = 0;                            // J/64 blocks of the V tile
  static constexpr uint32_t ring = w + J * 128;               // S x [64 x J] joint hidden
  static constexpr uint32_t glog = ring + RING_BYTES;         // 2 x [64 v][64 rows]
  static constexpr uint32_t info = glog + 2 * BOX;            // S x row data
  static constexpr uint32_t bars = info + S * ROW_INFO;       // full[S], empty[S], wfull, wempty
  static constexpr uint32_t total = bars + (2 * S + 2) * 8;
};

template <int J>
__global__ void __launch_bounds__(NTHREADS, 1)
rnnt_joint_bwd_cols_kernel(const __grid_constant__ CUtensorMap tm_w, const bf16* __restrict__ enc,
                           const bf16* __restrict__ dec, const float* __restrict__ bias,
                           const int* __restrict__ tgt, const float* __restrict__ lse,
                           const float* __restrict__ ob, const float* __restrict__ ol,
                           float* __restrict__ g_wt, float* __restrict__ g_b, Tiles tl, int V,
                           int blank) {
  using L = ColsLayout<J>;
  constexpr int S = L::S, NV4 = J / 4;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::bars);
  uint64_t* empty = full + S;
  uint64_t* wfull = empty + S;
  uint64_t* wempty = wfull + 1;
  const long long units = tl.n * ((V + VT - 1) / VT);
  const long long lo = units * blockIdx.x / gridDim.x, hi = units * (blockIdx.x + 1) / gridDim.x;

  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 128);  // every producer thread
      mbar_init(&empty[s], 2);   // one arrive per consumer warpgroup
    }
    mbar_init(wfull, 1);
    mbar_init(wempty, 2);
    fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= NCONS) {
    // ---- producer: W once per V tile (its thread 0), the joint hidden and
    // row data of every unit
    setmaxnreg_dec<CPROD_REGS>();
    const int ptid = threadIdx.x - NCONS;
    int it = 0, seg = 0;
    for (long long x = lo; x < hi; ++seg) {
      const int vt = (int)(x / tl.n);
      const long long end = (long long)(vt + 1) * tl.n < hi ? (long long)(vt + 1) * tl.n : hi;
      if (ptid == 0) {
        if (seg > 0) mbar_wait(wempty, (seg - 1) & 1);
        mbar_arrive_expect_tx(wfull, J * 128);
        for (int kb = 0; kb < J / 64; ++kb)
          tma_load_2d(base + L::w + kb * BOX, &tm_w, wfull, kb * 64, vt * VT);
      }
      for (; x < end; ++x, ++it) {
        int b, ug, ts;
        tile_of(tl, x % tl.n, b, ug, ts);
        TileForm<J, 128> tf;
        tf.load(enc, dec, tgt, lse, ob, ol, tl, b, ug, ts, ptid);
        const int slot = it % S;
        mbar_wait(&empty[slot], ((it / S) & 1) ^ 1);
        tf.store(smem + L::ring + slot * (J * 128), smem + L::info + slot * ROW_INFO, tl, ug, ts,
                 ptid);
        fence_proxy_async();
        mbar_arrive(&full[slot]);
      }
    }
  } else {
    setmaxnreg_inc<CCONS_REGS>();
    const int tid = threadIdx.x, w = tid / 128, wt = tid % 128;
    const int warp = wt / 32, lane = wt % 32, g = lane / 4, q = lane % 4;
    int it = 0, seg = 0, buf = 0;
    for (long long x = lo; x < hi; ++seg) {
      const int vt = (int)(x / tl.n);
      const long long end = (long long)(vt + 1) * tl.n < hi ? (long long)(vt + 1) * tl.n : hi;
      float gw[NV4];
      float cs[4][2];
      float2 bv[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bias_pair(bias, vt * VT + w * 32 + 8 * j + 2 * q, V);
#pragma unroll
      for (int k = 0; k < NV4; ++k) gw[k] = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) cs[j][0] = cs[j][1] = 0.f;
      mbar_wait(wfull, seg & 1);
      int prev = -1;
      for (; x < end; ++x, ++it) {
        const int slot = it % S;
        const uint32_t pre = base + L::ring + slot * (J * 128);
        const uint32_t gt = base + L::glog + buf * BOX;
        mbar_wait(&full[slot], (it / S) & 1);
        const RowRegs rr = row_regs(smem + L::info + slot * ROW_INFO, warp, g);
        float acc[16];
        wgmma_fence();
        logits32<J>(acc, pre, base + L::w, w);
        wgmma_commit();
        wgmma_wait<0>();  // and the last unit's g_W product
        if (prev >= 0 && wt == 0) mbar_arrive(&empty[prev]);
        // glog_c^T into the shared [64 v][64 rows] tile, K-major
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int v = vt * VT + w * 32 + 8 * j + 2 * q;
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int r = 16 * warp + g + 8 * h;
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const float gl = glog_of(acc[4 * j + 2 * h + e], v + e, V, blank,
                                       e ? bv[j].y : bv[j].x, rr, h);
              cs[j][e] += gl;
              const int vl = w * 32 + 8 * j + 2 * q + e;
              *reinterpret_cast<bf16*>(smem + (gt - base) + swz(vl, r / 8) + 2 * (r % 8)) =
                  __float2bfloat16(gl);
            }
          }
        }
        fence_proxy_async();
        named_sync(2, NCONS);  // both halves of glog_c^T are written
        wgmma_fence();
        half_product<J>(gw, gt, pre + w * (J / 128) * BOX);
        wgmma_commit();
        prev = slot;
        buf ^= 1;
      }
      wgmma_wait<0>();
      if (prev >= 0 && wt == 0) mbar_arrive(&empty[prev]);
      if (wt == 0) mbar_arrive(wempty);
      // g_W^T rows v = 64 vt + 16 warp + g + 8 h, columns w J/2 + 8 j + 2 q + e;
      // rows past V add zeros into row V - 1, so no branch reads gw
#pragma unroll
      for (int j = 0; j < J / 16; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int v = vt * VT + 16 * warp + g + 8 * h;
          const bool ok = v < V;
          atomic_add2(g_wt + (size_t)(ok ? v : V - 1) * J + w * (J / 2) + 8 * j + 2 * q,
                      ok ? gw[4 * j + 2 * h] : 0.f, ok ? gw[4 * j + 2 * h + 1] : 0.f);
        }
      // g_b: the column sums over the 8 lanes of each column group
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float c = cs[j][e];
          c += __shfl_xor_sync(0xffffffffu, c, 4);
          c += __shfl_xor_sync(0xffffffffu, c, 8);
          c += __shfl_xor_sync(0xffffffffu, c, 16);
          const int v = vt * VT + w * 32 + 8 * j + 2 * q + e;
          if (g == 0 && v < V) atomicAdd(g_b + v, c);
        }
    }
  }
}

template <int J>
int launch(const void* tmap_w, const bf16* enc, const bf16* dec, const float* bias,
           const int* tgt, const float* lse, const float* ob, const float* ol, float* g_enc,
           float* g_dec, float* g_wt, float* g_b, Tiles tl, int V, int blank, int grid_rows,
           int grid_cols, cudaStream_t s) {
  CUtensorMap tm;
  memcpy(&tm, tmap_w, sizeof(tm));
  const int smem_r = RowsLayout<J>::total + 1024, smem_c = ColsLayout<J>::total + 1024;
  cudaError_t err = cudaFuncSetAttribute(rnnt_joint_bwd_rows_kernel<J>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem_r);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(rnnt_joint_bwd_cols_kernel<J>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_c);
  if (err != cudaSuccess) return (int)err;
  rnnt_joint_bwd_rows_kernel<J><<<grid_rows, NTHREADS, smem_r, s>>>(
      tm, enc, dec, bias, tgt, lse, ob, ol, g_enc, g_dec, tl, V, blank);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  rnnt_joint_bwd_cols_kernel<J><<<grid_cols, NTHREADS, smem_c, s>>>(
      tm, enc, dec, bias, tgt, lse, ob, ol, g_wt, g_b, tl, V, blank);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The W tensor map: `tmap_spec` = {rank 2, J, V, (unused), J * 2 (row
// stride in bytes), (unused), 64, 64, (unused)}, as
// ops/rnnt_kernels.py::joint_bwd_tmap_spec builds it.
// enc [B, T, J], dec [B, U1, J], w [V, J]: bf16, contiguous; bias [V] f32;
// tgt [B, U1] int32; lse, ob, ol [B, T, U1] f32; outputs g_enc [B, T, J],
// g_dec [B, U1, J], g_wt [V, J] and g_b [V], f32, zeroed; all on card
// `device`. J: 128, 256 or 512. The tiles: nu = ceil(U1 / 8) u groups and
// nt = ceil(T / 8) frame groups per utterance; grid_rows and grid_cols
// blocks (a block per SM, ops/rnnt_kernels.py::joint_bwd_schedule). Two
// launches on `stream`.
int rnnt_joint_bwd_bf16(const void* enc, const void* dec, const void* w, const void* bias,
                        const void* tgt, const void* lse, const void* ob, const void* ol,
                        void* g_enc, void* g_dec, void* g_wt, void* g_b, const long long* tmap_spec,
                        int B, int T, int U1, int J, int V, int blank, int nu, int nt,
                        int grid_rows, int grid_cols, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  alignas(64) unsigned char tmap[128];
  uint64_t dims[3], strides[2];
  uint32_t box[3];
  for (int i = 0; i < 3; ++i) {
    dims[i] = (uint64_t)tmap_spec[1 + i];
    box[i] = (uint32_t)tmap_spec[6 + i];
  }
  for (int i = 0; i < 2; ++i) strides[i] = (uint64_t)tmap_spec[4 + i];
  const int rc = sm90::encode_tmap_bf16_nd(tmap, w, (int)tmap_spec[0], dims, strides, box);
  if (rc != 0) return rc;
  Tiles tl;
  tl.T = T;
  tl.U1 = U1;
  tl.nu = nu;
  tl.nt = nt;
  tl.n = (long long)B * nu * nt;
#define RNNT_BWD_ARGS                                                                       \
  tmap, static_cast<const bf16*>(enc), static_cast<const bf16*>(dec),                       \
      static_cast<const float*>(bias), static_cast<const int*>(tgt),                        \
      static_cast<const float*>(lse), static_cast<const float*>(ob),                        \
      static_cast<const float*>(ol), static_cast<float*>(g_enc), static_cast<float*>(g_dec), \
      static_cast<float*>(g_wt), static_cast<float*>(g_b), tl, V, blank, grid_rows,         \
      grid_cols, (cudaStream_t)stream
  switch (J) {
    case 128: return launch<128>(RNNT_BWD_ARGS);
    case 256: return launch<256>(RNNT_BWD_ARGS);
    case 512: return launch<512>(RNNT_BWD_ARGS);
    default: return (int)cudaErrorInvalidValue;
  }
#undef RNNT_BWD_ARGS
}

}  // extern "C"
