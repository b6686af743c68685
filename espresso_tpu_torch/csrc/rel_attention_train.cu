// Relative-position self-attention for training, bf16 in and out, sm_90a:
// the forward with in-kernel dropout of the softmax weights, and its
// backward.
//
// Replaces the TPU kernels espresso_tpu/ops/attention_kernels.py::
// rel_attention_train (Pallas, `_build_train_kernels` :444-575): the forward
// `fwd_kernel` (:480-498) and the backward `bwd_kernel` (:500-573). Per
// (utterance b, head h), flattened heads [B, T, H*64]:
//
//   s  = bf16(bf16(bf16(ac) + bf16(bd)) * bf16(scale)) + mask   (mask 0 / -1e8)
//   w  = softmax_f32(s);  w_used = w * keep / (1 - rate)        (f32)
//   out = bf16(sum_k bf16(w_used) v)
//   backward: dw = (g v^T) * keep/(1-rate); ds = w (dw - sum(dw w)) * scale;
//   dv = bf16(w_used)^T g; dq_u = bf16(ds) k; dk = bf16(ds)^T q_u;
//   dq_v, dp from the skewed dbd[q, T-1+k-q] = bf16(ds)[q, k]; dp summed over
//   the batch in f32.
//
// The dropout draw is the TPU kernel's counter hash (attention_kernels.py
// :312-362): uint32 wrapping arithmetic, the murmur3 finalizer `imix`, the
// (seed, item, head) triple finalized before the row index enters; a weight
// is kept when the 31-bit draw is below round((1 - rate) (2^31 - 1)). So the
// backward regenerates the forward's mask, and `dropout_keep_mask` replays it.
//
// What bounds them on an H100 at the flagship train shape (B=16, T'=256,
// H=8, d=64): the forward moves ~21.5 MB (q_u, q_v, k, v, out at 4.2 MB,
// p) and does ~3.2 GFLOP, the backward ~39 MB and ~8.6 GFLOP: both below
// the card's bf16 ridge, so memory traffic bounds them (~6.4 and ~11.7 us).
//
// Forward: the inference kernel's block (rel_attention_fwd.cuh, shared with
// rel_attention.cu) with the dropout applied once per element where w is
// formed, as the A fragments of the PV product: w_used = bf16(e * (1/z) *
// keep/(1-rate)), the keep draw imix(row ^ k kKeyMul) of the row's hash
// state (formed once per row) and the key. A block is one warpgroup over 64
// query rows of one (b, h); its thread 0 feeds a two-stage TMA ring of {K,
// 128-row p window} per key tile, then the V tiles three to a stage (the
// tensor maps of the inference kernel: 3-D over [D, T, B], 2-D over
// [D, 2T-1]); ac on wgmma m64n64k16, the bd window on m64n128k16, read
// skewed from shared memory (bd[q, k] = BD[q, k - q + 63]); s by bf16x2
// arithmetic; the whole-row f32 softmax; PV on m64n64k16 with A from
// registers. Sized for the train shape (B=16, T'=256, H=8: 512 blocks of 4
// key tiles): two blocks share an SM (at most 255 registers a thread), so
// the first three key tiles keep their scores and their e in registers
// (FWD_NR = FWD_NE = 3; only the fourth tile's scores pass through shared
// memory, and its exp is formed twice). Keeping the fourth tile's e too
// (FWD_NE = 4) took 255 registers with spills and was 1-3 us slower at the
// train shape, and two tiles' scores (FWD_NR = 2, B1's) no faster
// (chip_kernel_ablation.py; PERF.md). Past T' = 192 the shared memory grows
// by 64 bf16 scores a key (~75 KB a block at T' = 256); the kernel takes
// T' <= 1408 (the wrapper raises above it). What holds it back
// (chip_kernel_ablation.py, H100, the train shape, ~0.031 ms): the softmax's
// exps (~4 us) and the dropout hash (~3.4 us) beside the scores' scalar
// work; the PV products are hidden.
//
// Backward: two kernels on wgmma, each a block of one warpgroup whose
// thread 0 brings every operand tile by TMA (3-D tensor maps over [D, T, B]
// for q_u, q_v, k, v, g, so that a 64-row box of one head never crosses
// into the next utterance and reads zeros past T; a 2-D map over [D, 2T-1]
// for p, zeros outside it: ops/attention_kernels.py::train_bwd_tmap_specs)
// into a ring of two stages guarded by mbarriers, refilling a stage as soon
// as the warpgroup is done with it; two blocks share an SM. No [B, H, T, T]
// matrix is written:
//   1. query pass, a block per 64 queries of (b, h): over the key tiles,
//      the scores (ac = q_u k^T and the relative term from the window
//      BD [64 q][128 j'] = q_v p_win^T, read skewed: bd[q, k] = BD[q,
//      k - q + 63]) and dw = g v^T, from which the row statistics m, 1/l and
//      sum_k dw w go to a [3, B, H, T] f32 buffer (f32, online with one
//      rescale a tile; the sum over the keys the plain version takes, not
//      FlashAttention's rowsum(g o), which differs here because o rounds
//      from bf16 weights); then again over the key tiles: ds (each
//      operation rounded on its own, then to bf16), dq_u += ds k with ds as
//      wgmma's A in registers, and, from ds written skewed into W [64 q]
//      [128 j'] (W[q, k - q + 63] = ds[q, k]), dq_v += W p_win and the dp
//      window += W^T q_v (W read MN-major). Consecutive key tiles' windows
//      overlap by 64 rows, so the upper half is carried into the next
//      tile's lower half and each row of dp gets one paired f32 atomic add a
//      block (dp zeroed by the caller);
//   2. key pass, a block per 64 keys of (b, h), rows = keys: s^T = k q_u^T,
//      dw^T = v g^T, bd^T from X [128 j'][64 q] = p_win q_v^T (bd^T[k, q] =
//      X[k - q + 63, q]), w and ds from the statistics (staged in shared
//      memory per query tile); dv += bf16(w_used)^T g and dk += bf16(ds)^T
//      q_u with A in registers.
// Both passes recompute the scores, ~10 GFLOP a call in all; dp sums over
// (b, query tile) by atomics, in an order that changes from run to run.
// What holds it back: latency, not bandwidth or products; each key tile's
// steps (products, barrier, skewed window, dropout hash and exp of 32
// elements a thread, products) run one after another on 8 warps an SM.
//
// C entries: rel_attention_train_{fwd,bwd}_bf16(...) return the CUDA error
// of the launches; they launch on the given stream and do not synchronise.

#include "rel_attention_fwd.cuh"
#include <math.h>

namespace {

constexpr float kMaskFill = relattn::kMaskFill;

__device__ inline float round_bf16(float x) { return __bfloat162float(__float2bfloat16(x)); }

constexpr uint32_t kGold = 0x9E3779B1u, kHeadMul = 0x27D4EB2Fu, kKeyMul = 0x165667B1u;

__device__ inline uint32_t imix(uint32_t x) {
  x ^= x >> 16;
  x *= 0x85EBCA6Bu;
  x ^= x >> 13;
  x *= 0xC2B2AE35u;
  x ^= x >> 16;
  return x;
}

struct Dropout {
  int on;             // rate > 0
  uint32_t thresh;    // keep when the 31-bit draw is below it
  float inv_keep;     // 1 / (1 - rate)
  // the keep factor of key k in the row whose hash state is `row`
  __device__ inline float factor(uint32_t row, int k) const {
    if (!on) return 1.f;
    return (imix(row ^ ((uint32_t)k * kKeyMul)) >> 1) < thresh ? inv_keep : 0.f;
  }
};

// the row hash states of the lane's rows q0r + g and q0r + g + 8
__device__ inline void row_hashes(uint32_t (&hr)[2], uint32_t seed, int b, int h, int qrow) {
  const uint32_t base = imix(seed + (uint32_t)b * kGold + (uint32_t)h * kHeadMul);
  hr[0] = imix(base + (uint32_t)qrow * kGold);
  hr[1] = imix(base + (uint32_t)(qrow + 8) * kGold);
}

// ---------------------------------------------------------------------------
// forward (wgmma, TMA ring; the block of rel_attention_fwd.cuh)
// ---------------------------------------------------------------------------

constexpr int FWD_NR = 3;  // key tiles whose scores stay in registers
constexpr int FWD_NE = 3;  // key tiles whose e stays in registers once the scores are done

// the forward's weight hook: e * (1/z) of the lane's row qr[hh] and key k
// times the keep factor, Dropout::factor with the dropout on in fewer
// integer operations: imix's first step x ^ (x >> 16) of x = row ^ k kKeyMul
// splits into the row's part, formed once per row, and the key's, which the
// lane's two rows share; and a 31-bit draw below thresh is a 32-bit one
// below 2 thresh
struct KeepHook {
  uint32_t hs[2];    // the lane's rows' hash states h, as h ^ (h >> 16)
  uint32_t thresh2;  // 2 thresh
  float inv_keep;    // 1 / (1 - rate)
  __device__ inline float operator()(float w, int hh, int k) const {
    const uint32_t km = (uint32_t)k * kKeyMul;
    uint32_t x = hs[hh] ^ km ^ (km >> 16);
    x *= 0x85EBCA6Bu;
    x ^= x >> 13;
    x *= 0xC2B2AE35u;
    x ^= x >> 16;
    return w * (x < thresh2 ? inv_keep : 0.f);
  }
};

// kDrop: rate > 0 (else w is used as it is)
template <bool kDrop>
__global__ void __launch_bounds__(relattn::THREADS, 2)
rel_attention_train_fwd_kernel(const __grid_constant__ relattn::Maps maps,
                               const uint8_t* __restrict__ key_valid,
                               const int* __restrict__ seed, bf16* __restrict__ out, int T,
                               int H, float scale_f, Dropout drop) {
  if constexpr (kDrop) {
    const int t = threadIdx.x;
    KeepHook hook;
    uint32_t hr[2];
    row_hashes(hr, (uint32_t)seed[0], blockIdx.z, blockIdx.y,
               blockIdx.x * relattn::TILE + 16 * (t / 32) + (t % 32) / 4);
    for (int hh = 0; hh < 2; ++hh) hook.hs[hh] = hr[hh] ^ (hr[hh] >> 16);
    hook.thresh2 = 2u * drop.thresh;
    hook.inv_keep = drop.inv_keep;
    relattn::attention_block<FWD_NR, FWD_NE>(maps, key_valid, out, T, H, scale_f, hook);
  } else {
    relattn::attention_block<FWD_NR, FWD_NE>(maps, key_valid, out, T, H, scale_f,
                                             relattn::KeepAll{});
  }
}

// ---------------------------------------------------------------------------
// backward (wgmma, TMA rings): the query pass, then the key pass
// ---------------------------------------------------------------------------

namespace bwd {

using namespace sm90;

constexpr int TILE = 64;             // queries or keys per tile; the head width
constexpr int BOX = TILE * 128;      // a [64 x 64] bf16 tile, 128-byte swizzled (8 KB)
constexpr int THREADS = 128;         // one warpgroup; its thread 0 starts the TMA loads
constexpr int S = 2;                 // ring stages
constexpr int WIN_LD = 2 * TILE + 8; // bf16 row stride of the [64 q][128 j'] score window

// per-thread fragment coordinates of an m64nN accumulator
struct Frag {
  int warp, g, q;
};

__device__ inline Frag frag() {
  const int t = threadIdx.x;
  return Frag{t / 32, (t % 32) / 4, t % 4};
}

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  return (uint32_t)__bfloat16_as_ushort(__float2bfloat16(lo)) |
         ((uint32_t)__bfloat16_as_ushort(__float2bfloat16(hi)) << 16);
}

// the bf16 A fragment of k16 step kk from the accumulator c[n8 block][4] of
// the same rows (see wgmma_rs_n64)
__device__ inline void a_frag(uint32_t (&a)[4], const float (&c)[32], int kk) {
  a[0] = pack_bf16(c[8 * kk + 0], c[8 * kk + 1]);
  a[1] = pack_bf16(c[8 * kk + 2], c[8 * kk + 3]);
  a[2] = pack_bf16(c[8 * kk + 4], c[8 * kk + 5]);
  a[3] = pack_bf16(c[8 * kk + 6], c[8 * kk + 7]);
}

__device__ inline void zero(float (&c)[32]) {
#pragma unroll
  for (int i = 0; i < 32; ++i) c[i] = 0.f;
}

// ds = w (dw keep - sum_k dw w) scale, each operation rounded on its own (no
// fused multiply-add), as the plain version rounds it: where w = 1 (one key
// in range), dw keep equals the sum and ds is exactly 0
__device__ inline float ds_of(float w, float dw, float keep, float dsum, float scale) {
  return __fmul_rn(__fmul_rn(w, __fsub_rn(__fmul_rn(dw, keep), dsum)), scale);
}

// s = bf16(bf16(bf16(ac) + bd) * scale), scale rounded to bf16
__device__ inline float score(float ac, float bd, float scale_bf) {
  return round_bf16(round_bf16(round_bf16(ac) + bd) * scale_bf);
}

__device__ inline uint32_t bh_hash(uint32_t seed, int b, int h) {
  return imix(seed + (uint32_t)b * kGold + (uint32_t)h * kHeadMul);
}

// rows r (row-major, 64 wide) of an output, from the accumulator c of the
// lane's rows, stored only where `ok` (no branch reads wgmma's registers)
__device__ inline void store_rows(bf16* out, size_t row_stride, int col0, const float (&c)[32],
                                  const int (&rows)[2], const bool (&ok)[2], int q) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh)
#pragma unroll
    for (int n = 0; n < 8; ++n)
      st_global_if(out + (size_t)rows[hh] * row_stride + col0 + 8 * n + 2 * q,
                   pack_bf16(c[4 * n + 2 * hh], c[4 * n + 2 * hh + 1]), ok[hh]);
}

// dp rows j0 + 16 warp + g + 8 hh of head h += the lane's accumulator rows;
// rows outside [0, 2T-1) add zeros into a row inside, so no branch reads
// wgmma's registers
__device__ inline void add_dp(float* dp, const float (&c)[32], int j0, int T, int D, int h,
                              const int (&qr)[2], int q) {
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int j = j0 + qr[hh];
    const bool ok = j >= 0 && j < 2 * T - 1;
    float* row = dp + (size_t)(ok ? j : 0) * D + h * TILE + 2 * q;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      atomic_add2(row + 8 * n, ok ? c[4 * n + 2 * hh] : 0.f, ok ? c[4 * n + 2 * hh + 1] : 0.f);
  }
}

// the operands of both passes: q+u, q+v, k, v, g as [D, T, B] (box 64 x 64
// x 1: one head, 64 positions, one utterance; zeros past T) and p as
// [D, 2T-1] (box 64 x 64; zeros outside [0, 2T-1))
struct Maps {
  CUtensorMap qu, qv, k, v, g, p;
};

struct Args {
  int T, H;
  float scale_f;
  Dropout drop;
};

// ---------------------------------------------------------------------------
// query pass: a block owns 64 query rows of one (b, h). Pass 1 over the key
// tiles: the softmax statistics m, 1/l and sum_k dw w of each row (online,
// one rescale a tile). Pass 2: ds per key tile, dq_u += ds k (A = ds in
// registers), dq_v += W p_win and dp_win += W^T q_v, where W [64 q][128 j']
// is ds written skewed (W[q, k - q + 63] = ds[q, k]); dp's window is added
// into dp by paired f32 atomics. The statistics go to `stats` for the key
// pass.
// ---------------------------------------------------------------------------

struct QLayout {
  static constexpr uint32_t qu = 0, qv = BOX, g = 2 * BOX;
  static constexpr uint32_t ring = 3 * BOX;          // S x {k, v, p window (2 boxes)}
  static constexpr uint32_t stage = 4 * BOX;
  static constexpr uint32_t win = ring + S * stage;  // bd window, then W (2 boxes)
  static constexpr uint32_t win_bytes = TILE * WIN_LD * 2;
  static constexpr uint32_t bars = win + ((win_bytes + 1023) / 1024) * 1024;
  static constexpr uint32_t total = bars + (1 + S) * 8;
};

__global__ void __launch_bounds__(THREADS, 2)
rel_attention_train_bwd_q_kernel(const __grid_constant__ Maps maps,
                                 const uint8_t* __restrict__ key_valid,
                                 const int* __restrict__ seed, bf16* __restrict__ dqu,
                                 bf16* __restrict__ dqv, float* __restrict__ dp,
                                 float* __restrict__ stats, Args args) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + QLayout::bars);
  uint64_t* full = qbar + 1;
  const int T = args.T, H = args.H, D = H * TILE;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int nk = (T + TILE - 1) / TILE;
  const int t = threadIdx.x;

  // load `it` of the ring: key tile it % nk of pass it / nk (k, v, p window)
  auto refill = [&](int it) {
    if (it >= 2 * nk) return;
    const int slot = it % S, k0 = (it % nk) * TILE;
    const uint32_t st = base + QLayout::ring + slot * QLayout::stage;
    // window row j' <-> relative position T - 1 + k0 - q0 - 63 + j'
    const int j0 = T - 1 + k0 - q0 - (TILE - 1);
    mbar_arrive_expect_tx(&full[slot], 4 * BOX);
    tma_load_3d(st, &maps.k, &full[slot], h * TILE, k0, b);
    tma_load_3d(st + BOX, &maps.v, &full[slot], h * TILE, k0, b);
    tma_load_2d(st + 2 * BOX, &maps.p, &full[slot], h * TILE, j0);
    tma_load_2d(st + 3 * BOX, &maps.p, &full[slot], h * TILE, j0 + TILE);
  };
  if (t == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(qbar, 3 * BOX);
    tma_load_3d(base + QLayout::qu, &maps.qu, qbar, h * TILE, q0, b);
    tma_load_3d(base + QLayout::qv, &maps.qv, qbar, h * TILE, q0, b);
    tma_load_3d(base + QLayout::g, &maps.g, qbar, h * TILE, q0, b);
    for (int it = 0; it < S; ++it) refill(it);
  }
  __syncthreads();

  const Frag f = frag();
  const float scale_bf = round_bf16(args.scale_f);
  uint8_t* win = smem + QLayout::win;
  int qr[2];  // the lane's query rows (block-local)
  uint32_t hr[2];
  const uint32_t hbase = bh_hash((uint32_t)seed[0], b, h);
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    qr[hh] = 16 * f.warp + f.g + 8 * hh;
    hr[hh] = imix(hbase + (uint32_t)(q0 + qr[hh]) * kGold);
  }
  const uint32_t sqv = base + QLayout::qv;
  mbar_wait(qbar, 0);

  // the score tile of the stage's key tile into s[] (rows qr, columns 8 j +
  // 2 q + e), and dw = g v^T into dw[]; the stage is still held
  auto scores = [&](int slot, float (&s)[32], float (&dw)[32]) {
    const uint32_t st = base + QLayout::ring + slot * QLayout::stage;
    {
      float bd[64];
#pragma unroll
      for (int i = 0; i < 64; ++i) bd[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_ss_n128<0, 0>(bd, wgmma_desc(sqv + 32 * k), wgmma_desc(st + 2 * BOX + 32 * k), 1);
      wgmma_commit();
      wgmma_wait<0>();
      named_sync(1, THREADS);  // every warp is done with the last window's readers
#pragma unroll
      for (int j = 0; j < 16; ++j)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh)
          *reinterpret_cast<uint32_t*>(win + 2 * (qr[hh] * WIN_LD + 8 * j + 2 * f.q)) =
              pack_bf16(bd[4 * j + 2 * hh], bd[4 * j + 2 * hh + 1]);
    }
    zero(s);
    zero(dw);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wgmma_ss_n64<0, 0>(s, wgmma_desc(base + QLayout::qu + 32 * k), wgmma_desc(st + 32 * k), 1);
      wgmma_ss_n64<0, 0>(dw, wgmma_desc(base + QLayout::g + 32 * k),
                         wgmma_desc(st + BOX + 32 * k), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    named_sync(1, THREADS);  // the window is written
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1, c = 8 * j + 2 * f.q + (e & 1);
        const float bd = __bfloat162float(
            *reinterpret_cast<const bf16*>(win + 2 * (qr[hh] * WIN_LD + c - qr[hh] + TILE - 1)));
        s[4 * j + e] = score(s[4 * j + e], bd, scale_bf);
      }
  };

  // ---- pass 1: statistics
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f}, ex[2] = {0.f, 0.f};
  int it = 0;
  for (int kt = 0; kt < nk; ++kt, ++it) {
    const int slot = it % S, k0 = kt * TILE;
    mbar_wait(&full[slot], (it / S) & 1);
    float s[32], dw[32];
    scores(slot, s, dw);
    if (t == 0) refill(it + S);  // every product of the stage is done
    float mask[16];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = k0 + 8 * j + 2 * f.q + e;
        mask[2 * j + e] = k < T ? (key_valid[(size_t)b * T + k] ? 0.f : kMaskFill) : -INFINITY;
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mt = -INFINITY;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) mt = fmaxf(mt, s[4 * j + 2 * hh + e] + mask[2 * j + e]);
      // branch-free: a tile with no key in range leaves (m, l, sum) as they are
      const float mn = fmaxf(m[hh], mt);
      const float r0 = expf(m[hh] - mn), r = mn == -INFINITY ? 1.f : r0;
      float lt = 0.f, et = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int k = k0 + 8 * j + 2 * f.q + e;
          const float p0 = expf(s[4 * j + 2 * hh + e] + mask[2 * j + e] - mn);
          const float p = k < T ? p0 : 0.f;
          lt += p;
          et += __fmul_rn(dw[4 * j + 2 * hh + e], args.drop.factor(hr[hh], k)) * p;
        }
      l[hh] = l[hh] * r + lt;
      ex[hh] = ex[hh] * r + et;
      m[hh] = mn;
    }
  }
  float zinv[2], dsum[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[hh], x);
      const float lo = __shfl_xor_sync(0xffffffffu, l[hh], x);
      const float eo = __shfl_xor_sync(0xffffffffu, ex[hh], x);
      const float mn = fmaxf(m[hh], mo);
      const float ra = m[hh] == -INFINITY ? 0.f : expf(m[hh] - mn);
      const float rb = mo == -INFINITY ? 0.f : expf(mo - mn);
      l[hh] = l[hh] * ra + lo * rb;
      ex[hh] = ex[hh] * ra + eo * rb;
      m[hh] = mn;
    }
    zinv[hh] = 1.f / l[hh];
    dsum[hh] = ex[hh] * zinv[hh];
    const int q = q0 + qr[hh];
    if (f.q == 0 && q < T) {
      const size_t o = ((size_t)b * H + h) * T + q;
      const size_t plane = (size_t)gridDim.z * H * T;
      stats[o] = m[hh];
      stats[plane + o] = zinv[hh];
      stats[2 * plane + o] = dsum[hh];
    }
  }

  // ---- pass 2: ds, dq_u, dq_v, dp. The window of key tile kt covers rows
  // j0 .. j0 + 127 of dp, that of kt + 1 rows j0 + 64 ..: the upper half
  // (dpn) is carried into the next tile's lower half (dpc), so that each
  // row of dp gets one atomic add a block
  float oqu[32], oqv[32], dpc[32];
  zero(oqu);
  zero(oqv);
  zero(dpc);
  int j0 = 0;
  for (int kt = 0; kt < nk; ++kt, ++it) {
    const int slot = it % S, k0 = kt * TILE;
    const uint32_t st = base + QLayout::ring + slot * QLayout::stage;
    j0 = T - 1 + k0 - q0 - (TILE - 1);
    mbar_wait(&full[slot], (it / S) & 1);
    float s[32], dw[32];
    scores(slot, s, dw);
    // ds in the accumulator layout (overwrites s), rounded to bf16
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1, k = k0 + 8 * j + 2 * f.q + (e & 1);
        const bool ok = k < T && q0 + qr[hh] < T;
        const float mk = ok && !key_valid[(size_t)b * T + k] ? kMaskFill : 0.f;
        const float w = expf(s[4 * j + e] + mk - m[hh]) * zinv[hh];
        const float ds = ds_of(w, dw[4 * j + e], args.drop.factor(hr[hh], k), dsum[hh], args.scale_f);
        s[4 * j + e] = round_bf16(ok ? ds : 0.f);
      }
    named_sync(1, THREADS);  // every read of the bd window is done
    // W: zero, then ds skewed into it (2 swizzled boxes [64 q][64 j'])
    for (int i = t; i < 2 * BOX / 16; i += THREADS)
      *reinterpret_cast<uint4*>(win + 16 * i) = make_uint4(0u, 0u, 0u, 0u);
    named_sync(1, THREADS);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int hh = e >> 1, jp = 8 * j + 2 * f.q + (e & 1) - qr[hh] + TILE - 1;
        *reinterpret_cast<bf16*>(win + (jp / 64) * BOX + swz(qr[hh], (jp % 64) / 8) +
                                 2 * (jp % 8)) = __float2bfloat16(s[4 * j + e]);
      }
    fence_proxy_async();
    named_sync(1, THREADS);
    uint32_t a[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) a_frag(a[kk], s, kk);
    float dpn[32];
    zero(dpn);
    const uint32_t sw = base + QLayout::win;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_n64<1>(oqu, a[kk], wgmma_desc_mn(st + 2048 * kk, BOX), 1);  // B = k, MN-major
      wgmma_ss_n64<1, 1>(dpc, wgmma_desc_mn(sw + 2048 * kk, BOX),
                         wgmma_desc_mn(sqv + 2048 * kk, BOX), 1);
      wgmma_ss_n64<1, 1>(dpn, wgmma_desc_mn(sw + BOX + 2048 * kk, BOX),
                         wgmma_desc_mn(sqv + 2048 * kk, BOX), 1);
    }
#pragma unroll
    for (int kk = 0; kk < 8; ++kk)
      wgmma_ss_n64<0, 1>(oqv, wgmma_desc(sw + (kk / 4) * BOX + 32 * (kk % 4)),
                         wgmma_desc_mn(st + 2 * BOX + 2048 * kk, BOX), 1);
    wgmma_commit();
    wgmma_wait<0>();
    named_sync(1, THREADS);
    if (t == 0) refill(it + S);
    add_dp(dp, dpc, j0, T, D, h, qr, f.q);
#pragma unroll
    for (int i = 0; i < 32; ++i) dpc[i] = dpn[i];
  }
  add_dp(dp, dpc, j0 + TILE, T, D, h, qr, f.q);
  int rows[2];
  bool ok[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int q = q0 + qr[hh];
    ok[hh] = q < T;
    rows[hh] = b * T + (ok[hh] ? q : 0);
  }
  store_rows(dqu, D, h * TILE, oqu, rows, ok, f.q);
  store_rows(dqv, D, h * TILE, oqv, rows, ok, f.q);
}

// ---------------------------------------------------------------------------
// key pass: a block owns 64 keys of one (b, h) and walks the query tiles,
// in the transposed orientation (rows = keys): s^T = k q_u^T, dw^T = v g^T,
// bd^T from the window X [128 j'][64 q] = p_win q_v^T (bd^T[k, q] =
// X[k - q + 63, q]), w and ds from the query pass's statistics; then
// dv += bf16(w_used)^T g and dk += bf16(ds)^T q_u with A in registers.
// ---------------------------------------------------------------------------

struct KLayout {
  static constexpr uint32_t k = 0, v = BOX;
  static constexpr uint32_t ring = 2 * BOX;  // S x {q_u, q_v, g, p window (2 boxes)}
  static constexpr uint32_t stage = 5 * BOX;
  static constexpr uint32_t stat = ring + S * stage;  // [3][64] f32: the query tile's statistics
  static constexpr uint32_t bars = stat + 3 * TILE * 4;
  static constexpr uint32_t total = bars + (1 + S) * 8;
};

__global__ void __launch_bounds__(THREADS, 2)
rel_attention_train_bwd_k_kernel(const __grid_constant__ Maps maps,
                                 const uint8_t* __restrict__ key_valid,
                                 const int* __restrict__ seed, bf16* __restrict__ dk,
                                 bf16* __restrict__ dv, const float* __restrict__ stats, Args args) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  uint64_t* kbar = reinterpret_cast<uint64_t*>(smem + KLayout::bars);
  uint64_t* full = kbar + 1;
  const int T = args.T, H = args.H, D = H * TILE;
  const int k0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int nq = (T + TILE - 1) / TILE;
  const int t = threadIdx.x;

  // load `it` of the ring: query tile it (q_u, q_v, g, p window)
  auto refill = [&](int it) {
    if (it >= nq) return;
    const int slot = it % S, q0 = it * TILE;
    const uint32_t st = base + KLayout::ring + slot * KLayout::stage;
    const int j0 = T - 1 + k0 - q0 - (TILE - 1);
    mbar_arrive_expect_tx(&full[slot], 5 * BOX);
    tma_load_3d(st, &maps.qu, &full[slot], h * TILE, q0, b);
    tma_load_3d(st + BOX, &maps.qv, &full[slot], h * TILE, q0, b);
    tma_load_3d(st + 2 * BOX, &maps.g, &full[slot], h * TILE, q0, b);
    tma_load_2d(st + 3 * BOX, &maps.p, &full[slot], h * TILE, j0);
    tma_load_2d(st + 4 * BOX, &maps.p, &full[slot], h * TILE, j0 + TILE);
  };
  if (t == 0) {
    mbar_init(kbar, 1);
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(kbar, 2 * BOX);
    tma_load_3d(base + KLayout::k, &maps.k, kbar, h * TILE, k0, b);
    tma_load_3d(base + KLayout::v, &maps.v, kbar, h * TILE, k0, b);
    for (int it = 0; it < S; ++it) refill(it);
  }
  __syncthreads();

  const Frag f = frag();
  const float scale_bf = round_bf16(args.scale_f);
  const size_t plane = (size_t)gridDim.z * H * T, srow = ((size_t)b * H + h) * T;
  const uint32_t hbase = bh_hash((uint32_t)seed[0], b, h);
  int kr[2];
  float mask[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    kr[hh] = 16 * f.warp + f.g + 8 * hh;
    const int k = k0 + kr[hh];
    mask[hh] = k < T ? (key_valid[(size_t)b * T + k] ? 0.f : kMaskFill) : 0.f;
  }
  float odk[32], odv[32];
  zero(odk);
  zero(odv);
  mbar_wait(kbar, 0);
  for (int it = 0; it < nq; ++it) {
    const int slot = it % S, q0 = it * TILE;
    const uint32_t st = base + KLayout::ring + slot * KLayout::stage;
    uint8_t* xwin = smem + (st - base) + 3 * BOX;  // X overwrites the p window
    float* sstat = reinterpret_cast<float*>(smem + KLayout::stat);
    {  // m, 1/l and sum dw w of the query tile, in flight during X's product
      const int q = q0 + (t & 63);
      const bool qok = q < T;
      const float a0 = qok ? stats[srow + q] : 0.f, a1 = qok ? stats[plane + srow + q] : 0.f;
      const float a2 = qok ? stats[2 * plane + srow + q] : 0.f;
      if (t < 64) {
        sstat[t] = a0;
        sstat[TILE + t] = a1;
      } else {
        sstat[2 * TILE + (t & 63)] = a2;
      }
    }
    mbar_wait(&full[slot], (it / S) & 1);
    {
      float x0[32], x1[32];
      zero(x0);
      zero(x1);
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        wgmma_ss_n64<0, 0>(x0, wgmma_desc(st + 3 * BOX + 32 * k), wgmma_desc(st + BOX + 32 * k), 1);
        wgmma_ss_n64<0, 0>(x1, wgmma_desc(st + 4 * BOX + 32 * k), wgmma_desc(st + BOX + 32 * k), 1);
      }
      wgmma_commit();
      wgmma_wait<0>();
      named_sync(1, THREADS);  // the p window is read
      // X[j'][q] (bf16) in the window's place, rows 128 bytes, chunks swizzled
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          *reinterpret_cast<uint32_t*>(xwin + swz(kr[hh], n) + 4 * f.q) =
              pack_bf16(x0[4 * n + 2 * hh], x0[4 * n + 2 * hh + 1]);
          *reinterpret_cast<uint32_t*>(xwin + swz(TILE + kr[hh], n) + 4 * f.q) =
              pack_bf16(x1[4 * n + 2 * hh], x1[4 * n + 2 * hh + 1]);
        }
    }
    float s[32], dw[32];
    zero(s);
    zero(dw);
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      wgmma_ss_n64<0, 0>(s, wgmma_desc(base + KLayout::k + 32 * k), wgmma_desc(st + 32 * k), 1);
      wgmma_ss_n64<0, 0>(dw, wgmma_desc(base + KLayout::v + 32 * k),
                         wgmma_desc(st + 2 * BOX + 32 * k), 1);
    }
    wgmma_commit();
    wgmma_wait<0>();
    named_sync(1, THREADS);  // X is written
    // w_used into s, ds into dw (accumulator layout: rows kr, columns q)
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e2 = 0; e2 < 2; ++e2) {
        const int ql = 8 * n + 2 * f.q + e2, q = q0 + ql;
        const bool qok = q < T;
        const float mq = sstat[ql], zq = sstat[TILE + ql], sq = sstat[2 * TILE + ql];
        const uint32_t hq = imix(hbase + (uint32_t)q * kGold);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const int e = 4 * n + 2 * hh + e2, k = k0 + kr[hh];
          const float bd = __bfloat162float(*reinterpret_cast<const bf16*>(
              xwin + swz(kr[hh] - ql + TILE - 1, ql / 8) + 2 * (ql % 8)));
          const bool ok = qok && k < T;
          const float w = expf(score(s[e], bd, scale_bf) + mask[hh] - mq) * zq;
          const float keep = args.drop.factor(hq, k);
          const float ds = ds_of(w, dw[e], keep, sq, args.scale_f);
          s[e] = ok ? w * keep : 0.f;
          dw[e] = ok ? ds : 0.f;
        }
      }
    uint32_t aw[4][4], ad[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      a_frag(aw[kk], s, kk);
      a_frag(ad[kk], dw, kk);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      wgmma_rs_n64<1>(odv, aw[kk], wgmma_desc_mn(st + 2 * BOX + 2048 * kk, BOX), 1);  // B = g
      wgmma_rs_n64<1>(odk, ad[kk], wgmma_desc_mn(st + 2048 * kk, BOX), 1);            // B = q_u
    }
    wgmma_commit();
    wgmma_wait<0>();
    // the stage (X written by every thread, read by the products) goes back
    // to TMA
    fence_proxy_async();
    named_sync(1, THREADS);
    if (t == 0) refill(it + S);
  }
  int rows[2];
  bool ok[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int k = k0 + kr[hh];
    ok[hh] = k < T;
    rows[hh] = b * T + (ok[hh] ? k : 0);
  }
  store_rows(dk, D, h * TILE, odk, rows, ok, f.q);
  store_rows(dv, D, h * TILE, odv, rows, ok, f.q);
}

}  // namespace bwd

Dropout make_dropout(int use_dropout, uint32_t thresh, float inv_keep) {
  Dropout d;
  d.on = use_dropout;
  d.thresh = thresh;
  d.inv_keep = inv_keep;
  return d;
}

}  // namespace

extern "C" {

// q_u, q_v, k, v, out: [B, T, H*64] bf16, contiguous, 16-byte aligned;
// p: [2T-1, H*64] bf16; key_valid: [B, T] bytes; seed: one int32; all on card
// `device`. The shared memory grows with T past 192 (64 x T bf16 score
// rows): above T = 1408 it exceeds the 227 KB a block may have and the
// launch is refused (the wrapper raises first).
int rel_attention_train_fwd_bf16(const void* q_u, const void* q_v, const void* k,
                                 const void* v, const void* p, const void* key_valid,
                                 const void* seed, void* out, int B, int T, int H,
                                 float scale, int use_dropout, uint32_t thresh,
                                 float inv_keep, int device, void* stream) {
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' card explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  relattn::Maps maps;
  const int rc = relattn::encode_maps(&maps, q_u, q_v, k, v, p, B, T, H);
  if (rc != 0) return rc;
  const auto kernel =
      use_dropout ? rel_attention_train_fwd_kernel<true> : rel_attention_train_fwd_kernel<false>;
  const size_t smem = relattn::smem_bytes<FWD_NR>(T);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + relattn::TILE - 1) / relattn::TILE, H, B);
  kernel<<<grid, relattn::THREADS, smem, (cudaStream_t)stream>>>(
      maps, static_cast<const uint8_t*>(key_valid), static_cast<const int*>(seed),
      static_cast<bf16*>(out), T, H, scale, make_dropout(use_dropout, thresh, inv_keep));
  return (int)cudaGetLastError();
}

// The inputs as above plus g [B, T, H*64] bf16; outputs dq_u, dq_v, dk, dv
// [B, T, H*64] bf16 and dp [2T-1, H*64] f32 (zeroed: the query pass adds
// into it); stats: [3, B, H, T] f32 scratch (m, 1/l, sum dw w of each row).
// tmap_specs: 6 x 9 int64, the tensor maps of q_u, q_v, k, v, g and p as
// ops/attention_kernels.py::train_bwd_tmap_specs builds them ({rank, dims[3]
// innermost first, strides[2] in bytes, box[3]}). Two launches on `stream`,
// in order.
int rel_attention_train_bwd_bf16(const void* q_u, const void* q_v, const void* k,
                                 const void* v, const void* p, const void* key_valid,
                                 const void* seed, const void* g, void* dq_u, void* dq_v,
                                 void* dk, void* dv, void* dp, void* stats,
                                 const long long* tmap_specs, int B, int T, int H, float scale,
                                 int use_dropout, uint32_t thresh, float inv_keep, int device,
                                 void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  cudaStream_t s = (cudaStream_t)stream;
  bwd::Maps maps;
  CUtensorMap* dst[6] = {&maps.qu, &maps.qv, &maps.k, &maps.v, &maps.g, &maps.p};
  const void* src[6] = {q_u, q_v, k, v, g, p};
  for (int i = 0; i < 6; ++i) {
    const long long* sp = tmap_specs + 9 * i;
    uint64_t dims[3], strides[2];
    uint32_t box[3];
    for (int x = 0; x < 3; ++x) {
      dims[x] = (uint64_t)sp[1 + x];
      box[x] = (uint32_t)sp[6 + x];
    }
    for (int x = 0; x < 2; ++x) strides[x] = (uint64_t)sp[4 + x];
    const int rc = sm90::encode_tmap_bf16_nd(dst[i], src[i], (int)sp[0], dims, strides, box);
    if (rc != 0) return rc;
  }
  bwd::Args args;
  args.T = T;
  args.H = H;
  args.scale_f = scale;
  args.drop = make_dropout(use_dropout, thresh, inv_keep);
  const int smem_q = bwd::QLayout::total + 1024, smem_k = bwd::KLayout::total + 1024;
  err = cudaFuncSetAttribute(bwd::rel_attention_train_bwd_q_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_q);
  if (err != cudaSuccess) return (int)err;
  err = cudaFuncSetAttribute(bwd::rel_attention_train_bwd_k_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, smem_k);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + bwd::TILE - 1) / bwd::TILE, H, B);
  bwd::rel_attention_train_bwd_q_kernel<<<grid, bwd::THREADS, smem_q, s>>>(
      maps, static_cast<const uint8_t*>(key_valid), static_cast<const int*>(seed),
      static_cast<bf16*>(dq_u), static_cast<bf16*>(dq_v), static_cast<float*>(dp),
      static_cast<float*>(stats), args);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  bwd::rel_attention_train_bwd_k_kernel<<<grid, bwd::THREADS, smem_k, s>>>(
      maps, static_cast<const uint8_t*>(key_valid), static_cast<const int*>(seed),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv), static_cast<const float*>(stats), args);
  return (int)cudaGetLastError();
}

}  // extern "C"
