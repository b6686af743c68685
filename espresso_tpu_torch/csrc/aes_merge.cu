// One AES blank-merge round, fp32 scores and int32 bookkeeping, sm_90a.
//
// Replaces the TPU kernel espresso_tpu/ops/decode_kernels.py::aes_merge
// (Pallas; three calls per frame). Per utterance, over the pool of 2K
// columns [pool | expansion]:
//
//   merged  = [pool_scores | exp_scores (+ blank_lp)], hash = [pool_hash | exp_hash]
//   eff[c]  = merged[c] > NEG_INF/2 ? hash[c] : -(c + 1)
//   comb[c] = m + log(sum_{eff[c2] == eff[c]} exp(merged[c2] - m)), m their
//             max (NEG_INF when m <= NEG_INF/2), kept at the first column of
//             its hash, NEG_INF elsewhere
//   top-K of comb, ties to the lower column; for each pick: the score, the
//   hash, version (pool_ver or round_j) and slot (pool_slot or the column's
//   own beam), from_pool = (column < K), src_slot = column mod K
//
// exactly the arithmetic of the Pallas kernel (decode_kernels.py:770-830),
// with the sum taken in column order. With blank_lp the expansion half's
// score is exp_scores + blank_lp, one fp32 add rounded as torch rounds it,
// so the fused call is bit for bit the call on the pre-added scores.
//
// What bounds it on an H100: at the flagship (B = 256, K = 10) a call moves
// ~0.13 MB and does ~0.1 MFLOP: under 0.1 us of either. What is left is
// latency: the launch, one round trip to read the inputs and one to write
// the outputs.
//
// What the design does about it: a warp per utterance, two utterances a
// block (128 blocks at B = 256), a lane per column (any K: a lane takes
// columns lane, lane + 32, ...). Every input is read once, all loads issued
// together, into shared memory; after that no global load is waited on.
// The dedup is two column loops per lane over shared memory, one exp a
// column. The top-K is a rank select instead of K serial argmax rounds:
// each column counts the columns before it in the total order (value
// descending, column ascending) and a column of rank r < K writes output
// slot r. Round k of
// the argmax rounds picks the k-th column of that order (a picked column
// drops to 2 NEG_INF, below every comb value, which is NEG_INF or above),
// ties, NEG_INF columns and the dedup's non-first columns included, so the
// outputs are the same. The TPU kernel's one-hot mask-reduce extracts,
// forced by Mosaic's lane layouts, are plain indexed loads here.
//
// C entry: aes_merge_f32(...) returns the CUDA error of the launch; it
// launches on the given stream and does not synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int NWARPS = 2;  // utterances per block
constexpr float kNegInf = -1.0e9f;

__global__ void __launch_bounds__(NWARPS * 32)
aes_merge_kernel(const float* __restrict__ pool_scores, const float* __restrict__ exp_scores,
                 const float* __restrict__ blank_lp, const int* __restrict__ pool_hash,
                 const int* __restrict__ exp_hash, const int* __restrict__ pool_ver,
                 const int* __restrict__ pool_slot, int round_j, int B, int K,
                 float* __restrict__ top, int* __restrict__ ints) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int K2 = 2 * K;
  // per warp, 2K each: merged, comb (the group max, then the combined
  // score), term (f32); eff, hash, version, slot, first (i32)
  float* merged = reinterpret_cast<float*>(smem) + (size_t)warp * 8 * K2;
  float* comb = merged + K2;
  float* term = comb + K2;
  int* eff = reinterpret_cast<int*>(term + K2);
  int* hash = eff + K2;
  int* ver = hash + K2;
  int* slot = ver + K2;
  int* first = slot + K2;
  const int b = blockIdx.x * NWARPS + warp;
  if (b >= B) return;  // whole warps leave together
  const size_t row = (size_t)b * K;
  const float* add = blank_lp != nullptr ? blank_lp : exp_scores;

  // stage: every load of a column issued before any is used
  for (int c = lane; c < K2; c += 32) {
    const bool pool = c < K;
    const int src = pool ? c : c - K;
    const float s = (pool ? pool_scores : exp_scores)[row + src];
    const float a = add[row + src];
    const int h = (pool ? pool_hash : exp_hash)[row + src];
    const int pv = pool_ver[row + src];
    const int ps = pool_slot[row + src];
    const float v = !pool && blank_lp != nullptr ? __fadd_rn(s, a) : s;
    merged[c] = v;
    eff[c] = v > kNegInf / 2 ? h : -(c + 1);
    hash[c] = h;
    ver[c] = pool ? pv : round_j;
    slot[c] = pool ? ps : src;
  }
  __syncwarp();

  // exact duplicate merge: logaddexp over equal hashes, kept at the first.
  // Each column forms its group's max and its own term exp(merged - max)
  // (the group's members agree on the max), then the group's first column
  // sums the terms in column order
  for (int c = lane; c < K2; c += 32) {
    const int e = eff[c];
    float m = kNegInf;
    bool is_first = true;
#pragma unroll 4
    for (int c2 = 0; c2 < K2; ++c2) {
      const int e2 = eff[c2];
      const float v2 = merged[c2];  // loaded whatever e2 is: no load waits on a compare
      if (e2 == e) {
        m = fmaxf(m, v2);
        is_first &= c2 >= c;
      }
    }
    comb[c] = m;
    term[c] = expf(merged[c] - m);
    first[c] = is_first;
  }
  __syncwarp();
  for (int c = lane; c < K2; c += 32) {
    const int e = eff[c];
    float s = 0.f;
    // the same count for every lane; a term of another group adds 0 (s >= 0)
#pragma unroll 4
    for (int c2 = 0; c2 < K2; ++c2) {
      const float t = term[c2];
      s += eff[c2] == e && c2 >= c ? t : 0.f;
    }
    const float m = comb[c];
    comb[c] = first[c] && m > kNegInf / 2 ? m + logf(s) : kNegInf;
  }
  __syncwarp();

  // rank select: slot r of the output takes the column of rank r
  const size_t plane = (size_t)B * K;
  for (int c = lane; c < K2; c += 32) {
    const float w = comb[c];
    int rank = 0;
#pragma unroll 4
    for (int c2 = 0; c2 < K2; ++c2) {
      const float o = comb[c2];
      rank += (o > w) || (o == w && c2 < c);
    }
    if (rank < K) {
      const size_t o = row + rank;
      top[o] = w;
      ints[o] = hash[c];
      ints[plane + o] = ver[c];
      ints[2 * plane + o] = slot[c];
      ints[3 * plane + o] = c < K;
      ints[4 * plane + o] = c < K ? c : c - K;
    }
  }
}

}  // namespace

extern "C" {

// pool_scores, exp_scores, blank_lp (or null) [B, K] f32; pool_hash,
// exp_hash, pool_ver, pool_slot [B, K] int32; top [B, K] f32 and ints
// [5, B, K] int32 (new hash, version, slot, from_pool, src_slot); all
// contiguous. Launches on `stream` of card `device`; returns the CUDA error
// code (0 on success).
int aes_merge_f32(const void* pool_scores, const void* exp_scores, const void* blank_lp,
                  const void* pool_hash, const void* exp_hash, const void* pool_ver,
                  const void* pool_slot, int round_j, int B, int K, void* top, void* ints,
                  int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || K == 0) return 0;
  const size_t smem = (size_t)NWARPS * 2 * K * 8 * 4;
  if (smem > 48 * 1024) {
    err = cudaFuncSetAttribute(aes_merge_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                               (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const dim3 grid((B + NWARPS - 1) / NWARPS);
  aes_merge_kernel<<<grid, NWARPS * 32, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(pool_scores), static_cast<const float*>(exp_scores),
      static_cast<const float*>(blank_lp), static_cast<const int*>(pool_hash),
      static_cast<const int*>(exp_hash), static_cast<const int*>(pool_ver),
      static_cast<const int*>(pool_slot), round_j, B, K, static_cast<float*>(top),
      static_cast<int*>(ints));
  return (int)cudaGetLastError();
}

}  // extern "C"
