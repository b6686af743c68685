// Fused Kaldi log-mel fbank, fp32, sm_90a.
//
// Replaces the TPU kernel espresso_tpu/features/pallas_fbank.py::fbank_pallas
// (Pallas; its production twin there is the XLA composition fbank_fused).
// Per frame t of utterance b (window W = 400 samples, shift 160):
//
//   x      = wave[b, t*shift : t*shift + W] (zero past S)
//   y      = x - mean(x)                          DC removal
//   y[j]  -= 0.97 * y[j-1], y[-1] := y[0]          pre-emphasis
//   y     *= povey window
//   re[k]  = sum_j y[j] cos(2 pi j k / 512), im[k] = -sum_j y[j] sin(...)
//   out[m] = log(max(sum_k (re^2 + im^2)[k] mel[k, m], 1.19e-7))
//
// zero for frames at or past the utterance's length, which is
// min(1 + (n - W) / shift, T) for n >= W samples, else 0.
//
// What bounds the function on an H100: its bytes. An FFT needs ~15 kFLOP
// a frame (a 512-point real FFT, |X|^2, the mel table's 501 non-zeros),
// ~1.9 GFLOP at the serving batch (159,744 frames, ~3/4 of them within
// their utterance's length), 0.028 ms at the 67 TFLOP/s fp32 rate, under
// the 0.046 ms its 154 MB take. This design multiplies the DFT bases
// instead, 2 * 2 * W * 256 fp32 operations a frame, ~410 kFLOP: its own
// floor is ~0.75 ms there, compute-bound. The products stay in fp32 FMA:
// the waveform is int16-scale, the powers reach ~1e14, and the 10-bit
// mantissa of TF32 tensor-core products would lose the spectrum (the
// reason for Precision.HIGHEST in the TPU kernel).
//
// What the design does about it: one block per (utterance, 64 frames). The
// waveform span is staged in shared memory (one padding word every 32, so
// that frame-strided reads hit 32 banks), the frames are DC-removed,
// pre-emphasised and windowed into a transposed [W][64] buffer, and each
// thread keeps a 16-frame x 4-bin register tile of re and im (128
// accumulators): per window sample it reads 4 cos and 4 sin values as two
// 16-byte loads (L1/L2: the 0.8 MB bases do not fit a block's shared
// memory) and 16 frame values as four broadcast 16-byte shared loads, for
// 128 FMAs. Only the W rows of the 512-point DFT that are not zero padding
// are multiplied, and only the 256 bins below Nyquist (the mel banks' Nyquist
// row is zero), and a tile of frames wholly past its utterance's length only
// writes zeros. The mel product runs over each mel bin's non-zero DFT bins
// (a zero term adds exactly 0 to a float sum).
//
// C entry: fbank_f32(...) returns the CUDA error of the launch; it launches
// on the given stream and does not synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int TILE_T = 64;    // frames per block
constexpr int NTHREADS = 256;
constexpr int FR = 16;        // frames per thread: 4 frame groups of 16
constexpr float kEps = 1.1920928955078125e-07f;
constexpr float kPreemph = 0.97f;

// one padding word every 32 samples
__host__ __device__ __forceinline__ int widx(int i) { return i + (i >> 5); }

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

__global__ void __launch_bounds__(NTHREADS, 1)
fbank_kernel(const float* __restrict__ wave, const int* __restrict__ num_samples,
             const float* __restrict__ cos_k, const float* __restrict__ sin_k,
             const float* __restrict__ win, const float* __restrict__ mel_t,
             const int* __restrict__ mel_lo, const int* __restrict__ mel_hi,
             float* __restrict__ out, int* __restrict__ lengths, int S, int T, int W, int shift,
             int NB, int M) {
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y, t0 = blockIdx.x * TILE_T, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int span = (TILE_T - 1) * shift + W;
  float* ws = smem;                                // the waveform span, padded
  float* mean = ws + round4(widx(span - 1) + 1);   // [TILE_T]
  float* fT = mean + TILE_T;                       // [W][TILE_T], then P [TILE_T][NB]

  const int n = num_samples[b];
  const int len = n >= W ? min(1 + (n - W) / shift, T) : 0;
  if (blockIdx.x == 0 && tid == 0) lengths[b] = len;
  if (t0 >= len) {  // the whole tile lies past the length: zeros, no work
    const int rows = min(TILE_T, T - t0);
    float* o = out + ((size_t)b * T + t0) * M;
    for (int i = tid; i < rows * M; i += NTHREADS) o[i] = 0.f;
    return;
  }

  const float* xb = wave + (size_t)b * S;
  const int base = t0 * shift;
  for (int i = tid; i < span; i += NTHREADS) {
    const int g = base + i;
    ws[widx(i)] = g < S ? xb[g] : 0.f;
  }
  __syncthreads();

  for (int t = warp; t < TILE_T; t += NTHREADS / 32) {
    float s = 0.f;
    for (int j = lane; j < W; j += 32) s += ws[widx(t * shift + j)];
#pragma unroll
    for (int o = 16; o; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) mean[t] = s / (float)W;
  }
  __syncthreads();

  // consecutive threads take consecutive frames of one sample j
  for (int idx = tid; idx < W * TILE_T; idx += NTHREADS) {
    const int j = idx / TILE_T, t = idx % TILE_T;
    const float m = mean[t];
    const float x = __fsub_rn(ws[widx(t * shift + j)], m);
    const float xp = __fsub_rn(ws[widx(t * shift + (j > 0 ? j - 1 : 0))], m);
    fT[idx] = __fmul_rn(__fsub_rn(x, __fmul_rn(kPreemph, xp)), win[j]);
  }
  __syncthreads();

  const int tx = tid & 63, ty = tid >> 6;  // bins 4tx..4tx+3, frames FR*ty..
  const bool active = 4 * tx < NB;
  float re[FR][4], im[FR][4];
#pragma unroll
  for (int i = 0; i < FR; ++i)
#pragma unroll
    for (int q = 0; q < 4; ++q) re[i][q] = im[i][q] = 0.f;
  if (active) {
    const float4* cp = reinterpret_cast<const float4*>(cos_k) + tx;
    const float4* sp = reinterpret_cast<const float4*>(sin_k) + tx;
    const int row4 = NB / 4;
#pragma unroll 2
    for (int j = 0; j < W; ++j) {
      const float4 c = __ldg(cp + (size_t)j * row4);
      const float4 s = __ldg(sp + (size_t)j * row4);
      const float4* fr = reinterpret_cast<const float4*>(fT + j * TILE_T + FR * ty);
#pragma unroll
      for (int q = 0; q < FR / 4; ++q) {
        const float4 f = fr[q];
        const float fv[4] = {f.x, f.y, f.z, f.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int i = 4 * q + r;
          re[i][0] = fmaf(fv[r], c.x, re[i][0]);
          re[i][1] = fmaf(fv[r], c.y, re[i][1]);
          re[i][2] = fmaf(fv[r], c.z, re[i][2]);
          re[i][3] = fmaf(fv[r], c.w, re[i][3]);
          im[i][0] = fmaf(fv[r], s.x, im[i][0]);
          im[i][1] = fmaf(fv[r], s.y, im[i][1]);
          im[i][2] = fmaf(fv[r], s.z, im[i][2]);
          im[i][3] = fmaf(fv[r], s.w, im[i][3]);
        }
      }
    }
  }
  __syncthreads();  // every thread is done with fT

  float* P = fT;  // power spectrum [TILE_T][NB]
  if (active) {
#pragma unroll
    for (int i = 0; i < FR; ++i) {
      float4 p;
      p.x = __fadd_rn(__fmul_rn(re[i][0], re[i][0]), __fmul_rn(im[i][0], im[i][0]));
      p.y = __fadd_rn(__fmul_rn(re[i][1], re[i][1]), __fmul_rn(im[i][1], im[i][1]));
      p.z = __fadd_rn(__fmul_rn(re[i][2], re[i][2]), __fmul_rn(im[i][2], im[i][2]));
      p.w = __fadd_rn(__fmul_rn(re[i][3], re[i][3]), __fmul_rn(im[i][3], im[i][3]));
      *reinterpret_cast<float4*>(P + (FR * ty + i) * NB + 4 * tx) = p;
    }
  }
  __syncthreads();

  for (int idx = tid; idx < TILE_T * M; idx += NTHREADS) {
    const int t = idx / M, m = idx % M;
    const int tg = t0 + t;
    if (tg >= T) break;
    const float* p = P + t * NB;
    float acc = 0.f;
    const int hi = mel_hi[m];
    for (int k = mel_lo[m]; k < hi; ++k) acc = fmaf(p[k], mel_t[k * M + m], acc);
    out[((size_t)b * T + tg) * M + m] = tg < len ? logf(fmaxf(acc, kEps)) : 0.f;
  }
}

}  // namespace

extern "C" {

// wave [B, S] f32, num_samples [B] int32, cos_k / sin_k [W, NB] f32 (the
// DFT bases' bins below Nyquist), win [W] f32, mel_t [>= NB, M] f32,
// mel_lo / mel_hi [M] int32 (each mel bin's non-zero DFT bins), out
// [B, T, M] f32, lengths [B] int32; all contiguous. NB is a multiple of 4,
// at most 256. Launches on `stream` of card `device`; returns the CUDA
// error code (0 on success).
int fbank_f32(const void* wave, const void* num_samples, const void* cos_k, const void* sin_k,
              const void* win, const void* mel_t, const void* mel_lo, const void* mel_hi,
              void* out, void* lengths, int B, int S, int T, int W, int shift, int NB, int M,
              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || T == 0) return 0;
  if (NB % 4 != 0 || NB > 4 * 64) return (int)cudaErrorInvalidValue;
  const int span = (TILE_T - 1) * shift + W;
  const int rows = W > NB ? W : NB;
  const size_t smem = ((size_t)round4(widx(span - 1) + 1) + TILE_T + (size_t)rows * TILE_T) * 4;
  err = cudaFuncSetAttribute(fbank_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + TILE_T - 1) / TILE_T, B);
  fbank_kernel<<<grid, NTHREADS, smem, (cudaStream_t)stream>>>(
      static_cast<const float*>(wave), static_cast<const int*>(num_samples),
      static_cast<const float*>(cos_k), static_cast<const float*>(sin_k),
      static_cast<const float*>(win), static_cast<const float*>(mel_t),
      static_cast<const int*>(mel_lo), static_cast<const int*>(mel_hi),
      static_cast<float*>(out), static_cast<int*>(lengths), S, T, W, shift, NB, M);
  return (int)cudaGetLastError();
}

}  // extern "C"
