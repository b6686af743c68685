// The forward of relative-position self-attention for one block of 64 query
// rows of one (utterance b, head h), bf16 in and out, sm_90a: the body that
// the inference kernel (rel_attention.cu) and the training forward
// (rel_attention_train.cu) share. Per (b, h), with flattened heads
// [B, T, H*64]:
//
//   ac[q,k] = (q+u)[q] . k[k]                    fp32 sum of bf16 products
//   bd[q,k] = (q+v)[q] . p[k - q + T - 1]        the espnet relative shift
//   s       = bf16(bf16(bf16(ac) + bf16(bd)) * bf16(scale))
//   w       = bf16(hook(e * (1/z))), e = exp(s + mask - max), z = sum_k e
//             over the full row, fp32           mask 0 or -1e8 (not -inf)
//   out[q]  = bf16(sum_k w[q,k] v[k])            fp32 sum
//
// The softmax is over the whole row, not online (an online softmax rounds w
// from other partial sums and is another function). The weight hook maps
// e * (1/z) of (row, key) to the weight used: the identity at inference, the
// dropout's keep factor in training, applied once per element where the A
// fragments of the PV product are formed.
//
// A block is one warpgroup. Its thread 0 brings every operand tile by TMA:
// q+u and q+v once, then per key tile K and the 128-row p window into a ring
// of two stages guarded by mbarriers, then the V tiles, three to a stage, so
// that the next tile's loads run under this tile's work and the V tiles
// arrive during the softmax. The maps (encode_maps) are 3-D over [D, T, B]
// for q+u, q+v, k and v, so that a 64-row box of one head never reaches into
// the next utterance and reads zeros past T, and 2-D over [D, 2T-1] for p,
// zeros outside the table. Per key tile:
//   - ac = (q+u) K^T on wgmma m64n64k16, rounded to bf16 pairs, then the
//     window BD = (q+v) p_win^T [64 q][128 j'] on wgmma m64n128k16 (one after
//     the other: at most 64 accumulator registers in flight);
//   - BD is written bf16 over the stage's K and p window, rows 136 wide and
//     not swizzled, so that every skewed read bd[q, k] = BD[q, k - q + 63]
//     is one load at a constant offset from the lane's row; a row of BD is
//     written and read by the one warp that owns that query row;
//   - s by packed bf16x2 arithmetic (an f32 sum or product of two bf16
//     values rounds to bf16 as the bf16x2 instruction does), x = s + mask in
//     f32 (-inf past T) and the row maximum, from registers;
//   - the first NR key tiles keep x in registers; later tiles store s in
//     shared memory (bf16, 64 rows), and tiles NR .. NE - 1 are read back
//     once the scores are done.
// Then e = exp(x - max) once for the first NE key tiles (kept in registers)
// with z, and w = bf16(hook(e * (1/z))) formed directly as the A fragments of
// the PV product (wgmma m64n64k16, A from registers, V read MN-major from the
// ring), a stage's products in one commit group. A tile past NE computes its
// exp twice (for z and for w). e * (1/z) is within an f32 ulp of e / z
// before the bf16 rounding. A warp whose 16 rows all lie past T, and the
// upper 32 keys of a tile when they lie past T, skip their scalar work and
// exps; 16 keys past T skip their PV step. No epilogue reads wgmma's
// registers in a divergent branch (ptxas would serialise every wgmma): the
// output is stored through a predicate.

#pragma once

#include "hopper_sm90.cuh"
#include <math.h>

namespace relattn {

using namespace sm90;

constexpr int TILE = 64;            // query rows a block, keys a tile, the head width
constexpr int BOX = TILE * 128;     // a [64 x 64] bf16 tile, 128-byte swizzled (8 KB)
constexpr int THREADS = 128;        // one warpgroup
constexpr int S = 2;                // ring stages: {K, p window} of a key tile, or VG V tiles
constexpr int VG = 3;               // V tiles a ring stage
constexpr int WLD = 2 * TILE + 8;   // bf16 row stride of the [64 q][128 j'] bd window
constexpr float kMaskFill = -1.0e8f;

__host__ __device__ inline int padded_len(int T) { return (T + TILE - 1) / TILE * TILE; }

// bf16 row stride of the shared score rows of the key tiles past NR (0: none)
template <int NR>
__host__ __device__ inline int tail_ld(int T) {
  const int n = padded_len(T) - NR * TILE;
  return n > 0 ? n + 8 : 0;
}

// the operands: q+u, q+v, k, v as [D, T, B] (box 64 x 64 x 1) and p as
// [D, 2T-1] (box 64 x 64)
struct Maps {
  CUtensorMap qu, qv, k, v, p;
};

struct Layout {
  static constexpr uint32_t qu = 0, qv = BOX;
  static constexpr uint32_t ring = 2 * BOX;       // S x {K or V, p window (2 boxes)}
  static constexpr uint32_t stage = 3 * BOX;
  static constexpr uint32_t bars = ring + S * stage;  // q, full[S]
  static constexpr uint32_t mask = bars + 64;         // [Tp] f32, then the tail scores
};

static_assert(TILE * WLD * 2 <= 3 * BOX, "the bd window fits in a stage");

// the dynamic shared memory of a block at length T (1 KB of alignment slack)
template <int NR>
__host__ inline size_t smem_bytes(int T) {
  return 1024 + Layout::mask + sizeof(float) * padded_len(T) +
         sizeof(bf16) * (size_t)TILE * tail_ld<NR>(T);
}

// the softmax's e of a score x + mask under the row maximum m
__device__ inline float e_of(float x, float m) { return expf(x - m); }

__device__ inline uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// the weight hook of inference: w as it is
struct KeepAll {
  __device__ inline float operator()(float w, int, int) const { return w; }
};

// One block: 64 query rows (blockIdx.x) of head blockIdx.y of utterance
// blockIdx.z. NR: key tiles whose scores stay in registers; NE: key tiles
// whose e stays in registers (NR <= NE). hook(w, hh, k): the weight used for
// e * (1/z) of the lane's row qr[hh] and key k. Every thread of the block
// calls it; the dynamic shared memory holds smem_bytes<NR>(T).
template <int NR, int NE, class Hook>
__device__ __forceinline__ void attention_block(const Maps& maps,
                                                const uint8_t* __restrict__ key_valid,
                                                bf16* __restrict__ out, int T, int H,
                                                float scale_f, const Hook& hook) {
  static_assert(NR <= NE, "the scores of the tiles whose e stays in registers");
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + Layout::bars);
  uint64_t* full = qbar + 1;
  float* mask = reinterpret_cast<float*>(smem + Layout::mask);
  const int Tp = padded_len(T), nk = Tp / TILE, D = H * TILE, LDT = tail_ld<NR>(T);
  bf16* tail = reinterpret_cast<bf16*>(mask + Tp);  // [64][LDT]: s of key tiles NR..
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x;

  // load `it` of the ring: {K, p window} of key tile it, then the V tiles,
  // VG a stage (V tile kt in box kt % VG of load nk + kt / VG)
  const int nit = nk + (nk + VG - 1) / VG;
  auto refill = [&](int it) {
    if (it >= nit) return;
    const int slot = it % S;
    const uint32_t st = base + Layout::ring + slot * Layout::stage;
    if (it < nk) {
      const int k0 = it * TILE;
      // window row j' <-> relative position T - 1 + k0 - q0 - 63 + j'
      const int j0 = T - 1 + k0 - q0 - (TILE - 1);
      mbar_arrive_expect_tx(&full[slot], 3 * BOX);
      tma_load_3d(st, &maps.k, &full[slot], h * TILE, k0, b);
      tma_load_2d(st + BOX, &maps.p, &full[slot], h * TILE, j0);
      tma_load_2d(st + 2 * BOX, &maps.p, &full[slot], h * TILE, j0 + TILE);
    } else {
      const int kt0 = VG * (it - nk), n = nk - kt0 < VG ? nk - kt0 : VG;
      mbar_arrive_expect_tx(&full[slot], n * BOX);
      for (int i = 0; i < n; ++i)
        tma_load_3d(st + i * BOX, &maps.v, &full[slot], h * TILE, (kt0 + i) * TILE, b);
    }
  };
  if (t == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(qbar, 2 * BOX);
    tma_load_3d(base + Layout::qu, &maps.qu, qbar, h * TILE, q0, b);
    tma_load_3d(base + Layout::qv, &maps.qv, qbar, h * TILE, q0, b);
    for (int it = 0; it < S; ++it) refill(it);
  }
  // additive key mask; -inf past T, so that padded keys add nothing
  for (int k = t; k < Tp; k += THREADS)
    mask[k] = k < T ? (key_valid[(size_t)b * T + k] ? 0.f : kMaskFill) : -INFINITY;
  __syncthreads();

  // the lane's accumulator rows qr[hh] = 16 warp + g + 8 hh, columns 8 j + 2 q
  const int warp = t / 32, g = (t % 32) / 4, q = t % 4;
  const int qr[2] = {16 * warp + g, 16 * warp + g + 8};
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale_f);
  float mx[2] = {-INFINITY, -INFINITY};
  mbar_wait(qbar, 0);

  // a warp whose 16 query rows all lie past T skips its scalar work (it
  // still takes part in the products and barriers)
  const bool live = q0 + 16 * warp < T;

  // key tile kt: x[4 j + 2 hh + e] = s + mask of row qr[hh], key 64 kt + 8 j +
  // 2 q + e, and the row maxima; with `to_tail`, s also goes to the shared
  // score rows. The products run one after the other, ac rounded to bf16
  // pairs before bd's starts, so that at most 64 accumulator registers are
  // in flight. The stage of tile kt - 1 goes back to TMA once every warp is
  // past this tile's products.
  auto score_tile = [&](int kt, float (&x)[32], bool to_tail) {
    const int slot = kt % S;
    const uint32_t st = base + Layout::ring + slot * Layout::stage;
    mbar_wait(&full[slot], (kt / S) & 1);
    __nv_bfloat162 acp[16];  // bf16(ac) of rows qr[hh], columns 8 j + 2 q (+1): [2 j + hh]
    {
      float ac[32];
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_ss_n64<0, 0>(ac, wgmma_desc(base + Layout::qu + 32 * k), wgmma_desc(st + 32 * k),
                           k > 0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 16; ++i) acp[i] = __floats2bfloat162_rn(ac[2 * i], ac[2 * i + 1]);
    }
    float bd[64];
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_ss_n128<0, 0>(bd, wgmma_desc(base + Layout::qv + 32 * k),
                          wgmma_desc(st + BOX + 32 * k), k > 0);
    wgmma_commit();
    wgmma_wait<0>();
    named_sync(1, THREADS);  // K and the p window are read; so is tile kt - 1's bd window
    if (t == 0 && kt > 0) refill(kt - 1 + S);
    // BD (bf16, rows WLD apart, not swizzled: every access below is one
    // load or store at a constant offset from the lane's row) over the
    // stage's K and p window: rows qr, columns 8 j + 2 q (+1)
    bf16* win = reinterpret_cast<bf16*>(smem + (st - base));
#pragma unroll
    for (int j = 0; j < 16; ++j)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(win + qr[hh] * WLD + 8 * j + 2 * q) =
            pack_bf16(bd[4 * j + 2 * hh], bd[4 * j + 2 * hh + 1]);
    __syncwarp();  // a row of the window is written and read by one warp
    // the upper 32 keys of a tile that lie past T: x = -inf without the work
    const bool upper = kt * TILE + TILE / 2 < T;
    if (live) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * q;
        if (j >= 4 && !upper) {
#pragma unroll
          for (int e = 0; e < 4; ++e) x[4 * j + e] = -INFINITY;
          continue;
        }
        const float2 mk = *reinterpret_cast<const float2*>(mask + kt * TILE + c);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          // bd[q, k] = BD[q, k - q + 63]
          const bf16* bdr = win + qr[hh] * WLD + c - qr[hh] + TILE - 1;
          __nv_bfloat162 bdp;
          bdp.x = bdr[0];
          bdp.y = bdr[1];
          const __nv_bfloat162 sp = __hmul2(__hadd2(acp[2 * j + hh], bdp), scale2);
          if (to_tail)
            *reinterpret_cast<__nv_bfloat162*>(tail + qr[hh] * LDT + (kt - NR) * TILE + c) = sp;
          const float x0 = __low2float(sp) + mk.x, x1 = __high2float(sp) + mk.y;
          x[4 * j + 2 * hh] = x0;
          x[4 * j + 2 * hh + 1] = x1;
          mx[hh] = fmaxf(mx[hh], fmaxf(x0, x1));
        }
      }
    }
    // the window's generic writes, before TMA overwrites the stage
    fence_proxy_async();
  };

  // ---- scores
  float xr[NE][32];  // x, then e: tiles 0 .. NR - 1 from the scores, NR .. NE - 1 read back
#pragma unroll
  for (int kt = 0; kt < NR; ++kt)
    if (kt < nk) score_tile(kt, xr[kt], false);
  for (int kt = NR; kt < nk; ++kt) {
    float x[32];
    score_tile(kt, x, true);
  }
  named_sync(1, THREADS);  // every warp is done with the last key tile's stage
  if (t == 0) refill(nk - 1 + S);

  // ---- softmax over the full row: max and sum over the 4 lanes of a row.
  // e is formed once and kept in registers for the first NE key tiles
  // (tiles NR .. NE - 1 read back from the shared rows, the lane's own
  // elements); tiles past them form it again for w. A key past T has x =
  // -inf, so e = 0; a warp whose rows all lie past T skips the exps.
  float zinv[2];
  {
    float z[2] = {0.f, 0.f};
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 1));
      mx[hh] = fmaxf(mx[hh], __shfl_xor_sync(0xffffffffu, mx[hh], 2));
    }
#pragma unroll
    for (int kt = NR; kt < NE; ++kt)
      if (kt < nk && live) {
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int c = 8 * j + 2 * q;
          const float2 mk = *reinterpret_cast<const float2*>(mask + kt * TILE + c);
#pragma unroll
          for (int hh = 0; hh < 2; ++hh) {
            const __nv_bfloat162 sp = *reinterpret_cast<const __nv_bfloat162*>(
                tail + qr[hh] * LDT + (kt - NR) * TILE + c);
            xr[kt][4 * j + 2 * hh] = __low2float(sp) + mk.x;
            xr[kt][4 * j + 2 * hh + 1] = __high2float(sp) + mk.y;
          }
        }
      }
    if (live) {
#pragma unroll
      for (int kt = 0; kt < NE; ++kt)
        if (kt < nk) {
          // the upper 32 keys of the tile, when they lie past T, hold e = 0
          const bool upper = kt * TILE + TILE / 2 < T;
#pragma unroll
          for (int i = 0; i < 16; ++i) {
            const int hh = (i >> 1) & 1;
            xr[kt][i] = e_of(xr[kt][i], mx[hh]);
            z[hh] += xr[kt][i];
          }
          if (upper) {
#pragma unroll
            for (int i = 16; i < 32; ++i) {
              const int hh = (i >> 1) & 1;
              xr[kt][i] = e_of(xr[kt][i], mx[hh]);
              z[hh] += xr[kt][i];
            }
          } else {
#pragma unroll
            for (int i = 16; i < 32; ++i) xr[kt][i] = 0.f;
          }
        }
    } else {
#pragma unroll
      for (int kt = 0; kt < NE; ++kt)
#pragma unroll
        for (int i = 0; i < 32; ++i) xr[kt][i] = 0.f;
    }
    for (int kt = NE; kt < nk; ++kt)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int c = 8 * j + 2 * q;
        if (!live || kt * TILE + 8 * j >= T) continue;
        const float2 mk = *reinterpret_cast<const float2*>(mask + kt * TILE + c);
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          const __nv_bfloat162 sp = *reinterpret_cast<const __nv_bfloat162*>(
              tail + qr[hh] * LDT + (kt - NR) * TILE + c);
          z[hh] += e_of(__low2float(sp) + mk.x, mx[hh]) + e_of(__high2float(sp) + mk.y, mx[hh]);
        }
      }
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      z[hh] += __shfl_xor_sync(0xffffffffu, z[hh], 1);
      z[hh] += __shfl_xor_sync(0xffffffffu, z[hh], 2);
      zinv[hh] = 1.f / z[hh];
    }
  }

  // ---- out = w v, w = bf16(hook(e / z)) as wgmma's A fragments (the k16
  // step kk of a tile is its n8 blocks 2 kk and 2 kk + 1: rows g, g + 8 x
  // columns 2 q, 2 q + 1 and 2 q + 8, 2 q + 9). Each ring stage holds VG V
  // tiles: their products go out tile by tile, as each tile's fragments are
  // formed, in one commit group (B = V tile kt [64 keys][64], MN-major; 16
  // keys past T are not run).
  float o[32];
  auto pv_issue = [&](uint32_t vtile, int kt, const uint32_t (&a)[4][4]) {
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (kt * TILE + 16 * kk < T)
        wgmma_rs_n64<1>(o, a[kk], wgmma_desc_mn(vtile + 2048 * kk, BOX), kt > 0 || kk > 0);
  };
  auto pv_done = [&](int it) {
    wgmma_commit();
    wgmma_wait<0>();
    named_sync(1, THREADS);  // every warp's products are done with the stage
    if (t == 0) refill(it + S);
  };
  // the fragments of a tile past NE: e again from the shared scores
  auto tail_frags = [&](uint32_t (&a)[4][4], int kt) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      if (kt * TILE + 16 * kk >= T) continue;  // not run
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int hh = r & 1, c = 16 * kk + 2 * q + 8 * (r >> 1), k = kt * TILE + c;
        const float2 mk = *reinterpret_cast<const float2*>(mask + k);
        const __nv_bfloat162 sp = *reinterpret_cast<const __nv_bfloat162*>(
            tail + qr[hh] * LDT + (kt - NR) * TILE + c);
        a[kk][r] = pack_bf16(hook(e_of(__low2float(sp) + mk.x, mx[hh]) * zinv[hh], hh, k),
                             hook(e_of(__high2float(sp) + mk.y, mx[hh]) * zinv[hh], hh, k + 1));
      }
    }
  };
  // the ring loads whose V tiles include those of the first NE key tiles
  // (e in registers: unrolled, so that every index into xr is a constant)
  constexpr int NSR = (NE + VG - 1) / VG;
#pragma unroll
  for (int si = 0; si < NSR; ++si) {
    const int it = nk + si;
    if (it >= nit) break;
    const int slot = it % S;
    const uint32_t st = base + Layout::ring + slot * Layout::stage;
    mbar_wait(&full[slot], (it / S) & 1);
    uint32_t a[VG][4][4];
#pragma unroll
    for (int i = 0; i < VG; ++i) {
      const int kt = VG * si + i;
      if (kt >= nk) break;
      if (kt < NE) {
        const float(&x)[32] = xr[kt < NE ? kt : 0];
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int e = 8 * kk + 2 * r, hh = r & 1;
            const int k = kt * TILE + 16 * kk + 8 * (r >> 1) + 2 * q;
            a[i][kk][r] = pack_bf16(hook(x[e] * zinv[hh], hh, k),
                                    hook(x[e + 1] * zinv[hh], hh, k + 1));
          }
      } else {
        tail_frags(a[i], kt);
      }
      pv_issue(st + i * BOX, kt, a[i]);
    }
    pv_done(it);
  }
  // later key tiles: e again from the shared scores
  for (int it = nk + NSR; it < nit; ++it) {
    const int slot = it % S;
    const uint32_t st = base + Layout::ring + slot * Layout::stage;
    mbar_wait(&full[slot], (it / S) & 1);
    uint32_t a[VG][4][4];
#pragma unroll
    for (int i = 0; i < VG; ++i) {
      const int kt = VG * (it - nk) + i;
      if (kt >= nk) break;
      tail_frags(a[i], kt);
      pv_issue(st + i * BOX, kt, a[i]);
    }
    pv_done(it);
  }

  // rows past T are not stored (a predicate, not a branch over o)
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qq = q0 + qr[hh];
    const bool ok = qq < T;
    bf16* orow = out + ((size_t)b * T + (ok ? qq : 0)) * D + h * TILE + 2 * q;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      st_global_if(orow + 8 * j, pack_bf16(o[4 * j + 2 * hh], o[4 * j + 2 * hh + 1]), ok);
  }
}

// ---- the long-row mode: no score row in shared memory
//
// Past the lengths whose score rows fit in shared memory (T' > 1344 at NR
// = 2, > 1408 at NR = 3), a block runs two passes over the key tiles and
// keeps only the f32 key mask (4 Tp bytes) in shared memory beside a ring
// of two stages of {K, p window, V}:
//   pass 1: per key tile, the ac and bd products, the skewed read and s as
//     above; each lane folds its x = s + mask into an online (max, sum of
//     exps) per row, one rescale a tile (e = exp(x - m_tile_run)); the four
//     lanes of a row then combine theirs: M = max, Z = sum z exp(m - M);
//   pass 2: per key tile, the products again (the same s), e = exp(x - M),
//     w = bf16(hook(e * (1/Z), row, key)) formed as the PV product's A
//     fragments (the hook where w is formed, as above), and PV with the
//     stage's V tile, one commit group a tile.
// Z sums the same e as the full-row softmax, rescaled once a tile, so it
// lies within a few f32 ulps of it; the score arithmetic, the mask and the
// keep draw are those of attention_block. The scores cost twice their
// products and scalar work: the mode trades time for a length limit set by
// the mask alone.

struct LongLayout {
  static constexpr uint32_t qu = 0, qv = BOX;
  static constexpr uint32_t ring = 2 * BOX;          // S x {K, p window (2 boxes), V}
  static constexpr uint32_t stage = 4 * BOX;
  static constexpr uint32_t bars = ring + S * stage;  // q, full[S]
  static constexpr uint32_t mask = bars + 64;         // [Tp] f32
};

static_assert(TILE * WLD * 2 <= 3 * BOX, "the bd window leaves the stage's V tile alone");

// the dynamic shared memory of a long-row block at length T
__host__ inline size_t long_smem_bytes(int T) {
  return 1024 + LongLayout::mask + sizeof(float) * padded_len(T);
}

// One block of the long-row mode (grid and hook as attention_block); the
// dynamic shared memory holds long_smem_bytes(T).
template <class Hook>
__device__ __forceinline__ void attention_block_long(const Maps& maps,
                                                     const uint8_t* __restrict__ key_valid,
                                                     bf16* __restrict__ out, int T, int H,
                                                     float scale_f, const Hook& hook) {
  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t base = (raw + 1023u) & ~1023u;
  uint8_t* smem = smem_raw + (base - raw);
  uint64_t* qbar = reinterpret_cast<uint64_t*>(smem + LongLayout::bars);
  uint64_t* full = qbar + 1;
  float* mask = reinterpret_cast<float*>(smem + LongLayout::mask);
  const int Tp = padded_len(T), nk = Tp / TILE, D = H * TILE;
  const int q0 = blockIdx.x * TILE, h = blockIdx.y, b = blockIdx.z;
  const int t = threadIdx.x;

  // load `it` of the ring: key tile it % nk's K and p window, and in pass 2
  // (it >= nk) its V tile
  auto stage_of = [&](int it) { return base + LongLayout::ring + (it % S) * LongLayout::stage; };
  auto refill = [&](int it) {
    if (it >= 2 * nk) return;
    const int slot = it % S, kt = it < nk ? it : it - nk;
    const uint32_t st = stage_of(it);
    const int k0 = kt * TILE, j0 = T - 1 + k0 - q0 - (TILE - 1);
    const bool pv = it >= nk;
    mbar_arrive_expect_tx(&full[slot], (pv ? 4 : 3) * BOX);
    tma_load_3d(st, &maps.k, &full[slot], h * TILE, k0, b);
    tma_load_2d(st + BOX, &maps.p, &full[slot], h * TILE, j0);
    tma_load_2d(st + 2 * BOX, &maps.p, &full[slot], h * TILE, j0 + TILE);
    if (pv) tma_load_3d(st + 3 * BOX, &maps.v, &full[slot], h * TILE, k0, b);
  };
  if (t == 0) {
    mbar_init(qbar, 1);
    for (int s = 0; s < S; ++s) mbar_init(&full[s], 1);
    fence_barrier_init();
    mbar_arrive_expect_tx(qbar, 2 * BOX);
    tma_load_3d(base + LongLayout::qu, &maps.qu, qbar, h * TILE, q0, b);
    tma_load_3d(base + LongLayout::qv, &maps.qv, qbar, h * TILE, q0, b);
    for (int it = 0; it < S; ++it) refill(it);
  }
  for (int k = t; k < Tp; k += THREADS)
    mask[k] = k < T ? (key_valid[(size_t)b * T + k] ? 0.f : kMaskFill) : -INFINITY;
  __syncthreads();

  const int warp = t / 32, g = (t % 32) / 4, q = t % 4;
  const int qr[2] = {16 * warp + g, 16 * warp + g + 8};
  const __nv_bfloat162 scale2 = __float2bfloat162_rn(scale_f);
  mbar_wait(qbar, 0);

  // load it's scores: x[4 j + 2 hh + e] = s + mask of row qr[hh], key
  // 64 kt + 8 j + 2 q + e (as attention_block's score_tile); the stage of
  // load it - 1 goes back to TMA once every warp is past these products
  auto score_tile = [&](int it, float (&x)[32]) {
    const int kt = it < nk ? it : it - nk;
    const uint32_t st = stage_of(it);
    mbar_wait(&full[it % S], (it / S) & 1);
    __nv_bfloat162 acp[16];
    {
      float ac[32];
      wgmma_fence();
#pragma unroll
      for (int k = 0; k < 4; ++k)
        wgmma_ss_n64<0, 0>(ac, wgmma_desc(base + LongLayout::qu + 32 * k),
                           wgmma_desc(st + 32 * k), k > 0);
      wgmma_commit();
      wgmma_wait<0>();
#pragma unroll
      for (int i = 0; i < 16; ++i) acp[i] = __floats2bfloat162_rn(ac[2 * i], ac[2 * i + 1]);
    }
    float bd[64];
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k)
      wgmma_ss_n128<0, 0>(bd, wgmma_desc(base + LongLayout::qv + 32 * k),
                          wgmma_desc(st + BOX + 32 * k), k > 0);
    wgmma_commit();
    wgmma_wait<0>();
    named_sync(1, THREADS);  // K and the p window are read; so is load it - 1's stage
    if (t == 0 && it > 0) refill(it - 1 + S);
    bf16* win = reinterpret_cast<bf16*>(smem + (st - base));
#pragma unroll
    for (int jw = 0; jw < 16; ++jw)
#pragma unroll
      for (int hh = 0; hh < 2; ++hh)
        *reinterpret_cast<uint32_t*>(win + qr[hh] * WLD + 8 * jw + 2 * q) =
            pack_bf16(bd[4 * jw + 2 * hh], bd[4 * jw + 2 * hh + 1]);
    __syncwarp();
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = 8 * j + 2 * q;
      const float2 mk = *reinterpret_cast<const float2*>(mask + kt * TILE + c);
#pragma unroll
      for (int hh = 0; hh < 2; ++hh) {
        const bf16* bdr = win + qr[hh] * WLD + c - qr[hh] + TILE - 1;
        __nv_bfloat162 bdp;
        bdp.x = bdr[0];
        bdp.y = bdr[1];
        const __nv_bfloat162 sp = __hmul2(__hadd2(acp[2 * j + hh], bdp), scale2);
        x[4 * j + 2 * hh] = __low2float(sp) + mk.x;
        x[4 * j + 2 * hh + 1] = __high2float(sp) + mk.y;
      }
    }
    fence_proxy_async();  // the window's generic writes, before TMA overwrites the stage
  };

  // ---- pass 1: each lane's online (max, sum of exps) of its rows
  float m[2] = {-INFINITY, -INFINITY}, z[2] = {0.f, 0.f};
  for (int it = 0; it < nk; ++it) {
    float x[32];
    score_tile(it, x);
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      float mt = m[hh];
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (((i >> 1) & 1) == hh) mt = fmaxf(mt, x[i]);
      // no finite score yet: keep z = 0 (exp(-inf - 0) = 0)
      const float ref = mt == -INFINITY ? 0.f : mt;
      float add = 0.f;
#pragma unroll
      for (int i = 0; i < 32; ++i)
        if (((i >> 1) & 1) == hh) add += e_of(x[i], ref);
      z[hh] = z[hh] * e_of(m[hh], ref) + add;
      m[hh] = mt;
    }
  }
  // the row's M and 1/Z over its four lanes
  float zinv[2];
#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    float M = fmaxf(m[hh], __shfl_xor_sync(0xffffffffu, m[hh], 1));
    M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, 2));
    const float ref = M == -INFINITY ? 0.f : M;
    float Z = z[hh] * e_of(m[hh], ref);
    Z += __shfl_xor_sync(0xffffffffu, Z, 1);
    Z += __shfl_xor_sync(0xffffffffu, Z, 2);
    m[hh] = M;
    zinv[hh] = 1.f / Z;
  }

  // ---- pass 2: the scores again, w = bf16(hook(e / Z)) as wgmma's A
  // fragments (k16 step kk: rows g, g + 8 x columns 2 q, 2 q + 1 and 2 q +
  // 8, 2 q + 9), PV with the stage's V tile (MN-major; 16 keys past T are
  // not run)
  float o[32];
  for (int it = nk; it < 2 * nk; ++it) {
    const int kt = it - nk;
    float x[32];
    score_tile(it, x);
    uint32_t af[4][4];
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 8 * kk + 2 * r, hh = r & 1;
        const int k = kt * TILE + 16 * kk + 8 * (r >> 1) + 2 * q;
        af[kk][r] = pack_bf16(hook(e_of(x[e], m[hh]) * zinv[hh], hh, k),
                              hook(e_of(x[e + 1], m[hh]) * zinv[hh], hh, k + 1));
      }
    const uint32_t vtile = stage_of(it) + 3 * BOX;
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      if (kt * TILE + 16 * kk < T)
        wgmma_rs_n64<1>(o, af[kk], wgmma_desc_mn(vtile + 2048 * kk, BOX), kt > 0 || kk > 0);
    wgmma_commit();
    wgmma_wait<0>();
  }

#pragma unroll
  for (int hh = 0; hh < 2; ++hh) {
    const int qq = q0 + qr[hh];
    const bool ok = qq < T;
    bf16* orow = out + ((size_t)b * T + (ok ? qq : 0)) * D + h * TILE + 2 * q;
#pragma unroll
    for (int j = 0; j < 8; ++j)
      st_global_if(orow + 8 * j, pack_bf16(o[4 * j + 2 * hh], o[4 * j + 2 * hh + 1]), ok);
  }
}

// whether a block at length T takes the long-row mode: its score rows
// (smem_bytes<NR>) would not fit the 227 KB a block may have
template <int NR>
__host__ inline bool long_rows(int T) {
  return smem_bytes<NR>(T) > 232448;
}

// the tensor maps of q_u, q_v, k, v ([B, T, H*64] bf16) and p ([2T-1, H*64]
// bf16); 0 on success, else the driver's error
inline int encode_maps(Maps* maps, const void* q_u, const void* q_v, const void* k,
                       const void* v, const void* p, int B, int T, int H) {
  const int D = H * TILE;
  const uint64_t dims[3] = {(uint64_t)D, (uint64_t)T, (uint64_t)B};
  const uint64_t strides[2] = {(uint64_t)D * 2, (uint64_t)T * D * 2};
  const uint32_t box[3] = {64, TILE, 1};
  CUtensorMap* dst[4] = {&maps->qu, &maps->qv, &maps->k, &maps->v};
  const void* src[4] = {q_u, q_v, k, v};
  for (int i = 0; i < 4; ++i) {
    const int rc = encode_tmap_bf16_nd(dst[i], src[i], 3, dims, strides, box);
    if (rc != 0) return rc;
  }
  return encode_tmap_bf16(&maps->p, p, (uint64_t)(2 * T - 1), (uint64_t)D, TILE);
}

}  // namespace relattn
