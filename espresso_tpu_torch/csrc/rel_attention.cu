// Relative-position self-attention for inference, bf16 in and out, sm_90a.
//
// Replaces the TPU kernel espresso_tpu/ops/attention_kernels.py::
// rel_attention_fused (Pallas; the conformer encoder's attention at decode).
// Per (utterance b, head h), with flattened heads [B, T, H*64]:
//
//   ac[q,k] = (q+u)[q] . k[k]                    fp32 sum of bf16 products
//   bd[q,k] = (q+v)[q] . p[k - q + T - 1]        the espnet relative shift
//   s       = bf16(bf16(bf16(ac) + bf16(bd)) * bf16(scale))
//   w       = bf16(e / z), e = exp(s + mask - max), z = sum_k e over the
//             full row, fp32                     mask 0 or -1e8 (not -inf)
//   out[q]  = bf16(sum_k w[q,k] v[k])            fp32 sum
//
// exactly the arithmetic of the Pallas kernel (attention_kernels.py:140-180):
// the softmax is over the whole row, not online (an online softmax rounds w
// from other partial sums and is another function).
//
// What bounds it on an H100: at the flagship decode shape (B=256, T'=156,
// H=8, d=64) one layer moves about 200 MB of bf16 I/O (q+u, q+v, k, v, out:
// 5 B T D 2 bytes) and does about 19 GFLOP (ac, bd and PV at ~6.4 each):
// ~95 FLOP a byte, below the card's bf16 ridge of ~295, so a kernel that
// keeps the [T, T] scores on chip is bounded by memory traffic (0.061 ms).
// Every score also costs some 20 instructions of scalar work (the bf16
// roundings, the skewed read of bd, the max, one exp), and each key tile
// is a chain of dependent steps, so latency and the SM's issue slots come
// first in practice.
//
// Design (the block body lives in rel_attention_fwd.cuh, shared with the
// training forward, which adds its dropout where w is formed): a block is
// one warpgroup and owns 64 query rows of one (b, h) (grid: query tiles x H
// x B, the query tiles of a head side by side so that its K, V and p rows
// come from L2 after the first); three blocks share an SM (168 registers,
// ~75 KB of shared memory at T' = 156). A two-stage TMA ring brings {K, p
// window} per key tile, then the V tiles three to a stage; ac, the bd window
// and PV run on wgmma; the bd window is read skewed from shared memory; the
// first two key tiles keep their scores in registers and the first three
// their e (NR = 2, NE = 3). Past T' = 1344, where the score rows of the
// later key tiles no longer fit in shared memory, the long-row mode of the
// same block runs instead (two passes over the key tiles: the row's max and
// sum of exps, then the scores again, w and PV; two blocks an SM).
//
// What holds it back (chip_kernel_ablation.py on an H100 at the flagship,
// ~0.18 ms in all): the scores' scalar work (~0.08 ms), the bd window's
// stores and skewed reads, the exp, the bd product and the PV products
// (0.02-0.04 ms each); each key tile's steps run one after another in a
// warpgroup, with two other blocks of the SM to overlap them, and the 168
// registers of three blocks an SM spill ~170 bytes a thread.
//
// C entry: rel_attention_bf16(...) returns the CUDA error of the launch; it
// launches on the given stream and does not synchronise.

#include "rel_attention_fwd.cuh"

namespace {

using namespace relattn;

constexpr int NR = 2;  // key tiles whose scores stay in registers
constexpr int NE = 3;  // key tiles whose e stays in registers once the scores are done

__global__ void __launch_bounds__(THREADS, 3)
rel_attention_kernel(const __grid_constant__ Maps maps, const uint8_t* __restrict__ key_valid,
                     bf16* __restrict__ out, int T, int H, float scale_f) {
  attention_block<NR, NE>(maps, key_valid, out, T, H, scale_f, KeepAll{});
}

// the long-row mode (rel_attention_fwd.cuh) for the lengths whose score rows
// do not fit in shared memory: two blocks an SM
__global__ void __launch_bounds__(THREADS, 2)
rel_attention_long_kernel(const __grid_constant__ Maps maps, const uint8_t* __restrict__ key_valid,
                          bf16* __restrict__ out, int T, int H, float scale_f) {
  attention_block_long(maps, key_valid, out, T, H, scale_f, KeepAll{});
}

}  // namespace

extern "C" {

// q_u, q_v, k, v, out: [B, T, H*64] bf16, contiguous, 16-byte aligned;
// p: [2T-1, H*64] bf16; key_valid: [B, T] bytes (bool); all on card
// `device`. Launches on `stream` (a stream of that card); returns the CUDA
// error code of the first call that failed (0 on success). The shared
// memory grows with T past 64 NR (64 x T bf16 scores); above T = 1344 it
// would exceed the 227 KB a block may have, and the long-row mode runs
// instead (4 T bytes of key mask; the wrapper raises above T = 4096).
int rel_attention_bf16(const void* q_u, const void* q_v, const void* k, const void* v,
                       const void* p, const void* key_valid, void* out, int B, int T, int H,
                       float scale, int device, void* stream) {
  // this library links its own CUDA runtime, whose current device is not
  // PyTorch's: select the tensors' card explicitly
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  Maps maps;
  const int rc = encode_maps(&maps, q_u, q_v, k, v, p, B, T, H);
  if (rc != 0) return rc;
  const bool lr = long_rows<NR>(T);
  const auto kernel = lr ? rel_attention_long_kernel : rel_attention_kernel;
  const size_t smem = lr ? long_smem_bytes(T) : smem_bytes<NR>(T);
  err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + TILE - 1) / TILE, H, B);
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      maps, static_cast<const uint8_t*>(key_valid), static_cast<bf16*>(out), T, H, scale);
  return (int)cudaGetLastError();
}

}  // extern "C"
