// The lattice tiles of the RNNT joint kernels (rnnt_joint_lp.cu, the
// forward, and rnnt_joint_bwd.cu, the backward), and the forming of a
// tile's joint hidden.
//
// Rows are (b, t, u) cells of the lattice; the joint hidden of a row is
// pre = bf16(relu(enc_proj[b, t] + dec_proj[b, u])), summed in f32 and
// rounded to bf16 as the TPU kernel rounds it (rnnt_pallas.py:128-133). A
// tile is 64 rows of one utterance: 8 values of u x 8 frames, row r = 8 ul
// + f, so that its joint hidden needs 8 rows of enc and 8 of dec. Tiles are
// ordered utterance, u group, frame group: tile i = (b nu + ug) nt + ts
// (ops/rnnt_kernels.py::joint_bwd_schedule). The sum of two bf16 values
// rounds to bf16 the same whether it is formed in f32 first or by one
// bf16x2 operation (an f32 sum of two bf16 values is exact or rounds below
// the bf16 half ulp), so the joint hidden is formed by packed fma(enc, 1,
// dec) with relu, two values an instruction.

#pragma once

#include "hopper_sm90.cuh"

namespace rnnt {

using namespace sm90;

constexpr int ROWS = 64;         // lattice rows per tile
constexpr int UT = 8, FT = 8;    // values of u and frames per tile: row r = 8 ul + f
constexpr int BOX = ROWS * 128;  // a [64 x 64] bf16 block, 128-byte swizzled (8 KB)

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

// A tile's joint hidden, formed by threads `tid` of NT in two steps: load()
// starts every global load at once (one round of latency a tile), store()
// writes the rows. A thread owns one 16-byte column chunk of NU consecutive
// values of u: it loads the tile's 8 enc chunks and its NU dec chunks of
// that column (each chunk is read once per tile) and writes 8 rows per
// value of u into `pre` (J / 64 swizzled [64 x 64] blocks; rows past T or
// U1, and every row of a tile that is not `live`, zero).
template <int J, int NT>
struct JointHidden {
  static constexpr int CPR = J / 8;                          // 16-byte chunks a row
  static constexpr int NTU = NT < UT * CPR ? NT : UT * CPR;  // threads that form rows
  static constexpr int NU = UT * CPR / NTU;                  // values of u a thread
  static_assert(UT % NU == 0, "threads per tile");
  uint4 e[FT], d[NU];

  __device__ inline void load(const bf16* __restrict__ enc, const bf16* __restrict__ dec,
                              const Tiles& tl, int b, int ug, int ts, int tid, bool live) {
    const int c = tid % CPR, u0 = (tid / CPR) * NU;
#pragma unroll
    for (int f = 0; f < FT; ++f) {
      const int t = ts * FT + f;
      e[f] = make_uint4(0u, 0u, 0u, 0u);
      if (live && tid < NTU && t < tl.T)
        e[f] = __ldg(reinterpret_cast<const uint4*>(enc + ((size_t)b * tl.T + t) * J) + c);
    }
#pragma unroll
    for (int x = 0; x < NU; ++x) {
      const int u = ug * UT + u0 + x;
      d[x] = make_uint4(0u, 0u, 0u, 0u);
      if (live && tid < NTU && u < tl.U1)
        d[x] = __ldg(reinterpret_cast<const uint4*>(dec + ((size_t)b * tl.U1 + u) * J) + c);
    }
  }

  __device__ inline void store(uint8_t* pre, const Tiles& tl, int ug, int ts, int tid) const {
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

}  // namespace rnnt
