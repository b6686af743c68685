// Fused Kaldi log-mel fbank, f32 in and out, sm_90a.
//
// Replaces the TPU kernel espresso_tpu/features/pallas_fbank.py::fbank_pallas
// (Pallas; its production twin there is the XLA composition fbank_fused).
// Per frame t of utterance b (window W samples, shift, a 512-point DFT):
//
//   x      = wave[b, t*shift : t*shift + W]
//   y      = x - mean(x)                          DC removal
//   y[j]  -= 0.97 * y[j-1], y[-1] := y[0]          pre-emphasis
//   y     *= povey window, zero-padded to 512
//   X[k]   = sum_j y[j] exp(-2 pi i j k / 512),   k < 256
//   out[m] = log(max(sum_k |X[k]|^2 mel[k, m], 1.19e-7))
//
// zero for frames at or past the utterance's length, which is
// min(1 + (n - W) / shift, T) for n >= W samples, else 0. The Nyquist bin is
// not formed: the mel banks' Nyquist row is zero.
//
// What bounds the function on an H100: its bytes. A real FFT needs ~15
// kFLOP a frame (with |X|^2 and the mel table's non-zeros): ~1.9 GFLOP at
// the serving batch (121,554 valid frames), 0.028 ms at the 67 TFLOP/s f32
// rate, under the 0.046 ms that its 154 MB take. What this kernel pays on
// top is shared-memory traffic (a frame's values cross lanes in two
// transposes and the mel sums, each frame reads its samples, window and
// twiddles) and the f64 work below.
//
// What the design does about it: one block per (utterance, 32 frames),
// eight warps, three blocks an SM (80 registers), a warp per frame. The
// waveform span of the 32 frames (they overlap 2.5x) is copied into shared
// memory once by cp.async, zero past S. Each lane holds 8 of the frame's
// 256 complex points z[n] = y[2n] + i y[2n+1] (n = lane + 32 j), formed in
// registers; the 256-point complex FFT is 8 x 8 x 4: an 8-point DFT over j
// in registers, the twiddles w256^(lane k1) (kept in the lane's registers
// across its frames), a transpose through shared
// memory (rows of 36 points, no bank conflicts), an 8-point DFT over l2
// (l = l1 + 4 l2) and the twiddles w32^(l1 k2a), a second transpose (an XOR
// swizzle, no conflicts), and 4-point DFTs over l1, which leave
// Z[lane + 32 i] on each lane. The real spectrum comes from Z[k] and
// Z[256 - k] (held by lane 32 - lane: four shuffles): E = (Z[k] +
// Z*[256-k]) / 2, O = -i (Z[k] - Z*[256-k]) / 2, X[k] = E + w512^k O and
// |X[256-k]| = |E - w512^k O|.
//
// Precision: the waveform is int16-scale and the powers reach ~1e14, so
// TF32 or bf16 would lose the spectrum. An FFT in f32 throughout keeps the
// loud bins but not the quiet ones: its rounding leaves an error floor that
// is a share of the frame's peak in every bin, and the split pairs bin k
// with bin 256 - k, where pre-emphasis makes the low bins the quietest and
// their mirrors the loudest; mel bins 60-70 dB down then lose about half of
// the 5e-4 log bound (tests/test_torch_kernel_layouts.py models it). So
// stage 1 runs in f32 (f32 twiddles), and stages 2 and 3, the split and
// |X|^2 in f64 (f64 twiddles), then the power is rounded to f32. The
// twiddles are float64 values from the host (fbank_kernels.fft_twiddles),
// kept in shared memory beside the window and the mel banks as a schedule
// (fbank_kernels.mel_schedule); the kernel reads no DFT basis. The mel
// product runs in rounds of 32 mel bins, a lane each, the bins longest
// range first, so that a round's lanes take about as many steps (at M =
// 80: 16, 6 and 2 steps instead of the 4, 10 and 16 of bins in order); the
// frame's M outputs are written together. A tile wholly past its
// utterance's length only writes zeros.
//
// 8 kHz (a 200-sample window, shift 80: a 256-point DFT) runs the same
// kernel: the frame is zero past its window, so the 256-point bins are the
// 512-point even bins (X512[2 k] = X256[k] exactly), and the host's mel
// schedule (fbank_kernels.kernel_mel_banks) reads those. The FFT then does
// twice the work the 256-point transform needs; the precision plan, the
// lanes and the tables' layout are those of 16 kHz. Any window of at most
// 512 samples runs this instance.
//
// Longer windows (22.05 to 192 kHz: 1024, 2048, 4096 and 8192 points) run
// the template's larger instances, NFFT = 512 R for R = 2, 4, 8, 16, NZ = 256 R
// packed points. A first radix-R stage in f32 (decimation in frequency: for
// each q < R, a_q[m] = w_NZ^(m q) sum_r z[m + 256 r] w_R^(r q), m < 256)
// leaves R 256-point transforms, Z[R k + q] = FFT256(a_q)[k]; each runs the
// 8 x 8 x 4 schedule above, all three stages in f64 (f64 twiddles), so that
// only the first stage is f32 at every size. The q are taken in pairs whose
// bins mirror each other ({0, R/2} and {q, R - q}): Z[NZ - (R k + q)] =
// Z[R (255 - k) + R - q] lies on lane 31 - lane of the pair's other
// transform, so the split needs no buffer of Z. Each pair re-forms its
// frame's points (R / 2 times in all). The tables (window, twiddles, mel
// schedule) are read from global memory through the read-only cache; shared
// memory holds the waveform span, and per warp the transposes' buffer (8
// rows of ROW f64 points) and the power spectrum (NZ f32). Tiles of 16
// frames (8 at 4096 points, with 4 warps; 4 at 8192 points, with 2 warps,
// whose power spectrum is 16 KB a warp) keep two blocks an SM up to 192 kHz.
//
// An odd shift (44.1 kHz: 441 samples) puts every other frame's samples off
// 8 bytes: the ODD instances load the sample pairs as two scalars.
//
// C entry: fbank_f32(...) returns the CUDA error of the launch; it launches
// on the given stream and does not synchronise.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

// the 512-point instance (R = 1): eight warps (Geom<1>: 32-frame tiles,
// three blocks an SM)
constexpr int NWARPS = 8;
constexpr int NFFT = 512;       // real points: the window zero-padded
constexpr int NZ = NFFT / 2;    // complex points z[n] = y[2n] + i y[2n+1]
constexpr int ROW = 36;         // first transpose: 8 rows of 32 points, padded
// per warp, one buffer of NZ double2 in turn: the first transpose (8 rows
// of ROW float2), the second (NZ double2), the power spectrum (NZ f32)
constexpr int BUF = NZ;
// the twiddles: w256^(l k1) at [k1][l] (f32, stage 1); w32^(l1 k2a) at
// [k2a][l1], then w512^k for k = 0..128 (f64)
constexpr int NTW1 = 256, TW3 = 32, NTW23 = 161;
// the larger instances' f64 twiddles: w256^(l k1) at 32 k1 + l, w32^(l1
// k2a) from TWL_32 at 4 k2a + l1, w_NFFT^k (k < NZ) from TWL_SPLIT
constexpr int TWL_32 = 256, TWL_SPLIT = 288;

// what each instance takes: frames a tile, warps, blocks an SM
template <int R> struct Geom {
  static constexpr int TILE = R == 1 ? 32 : R == 16 ? 4 : R == 8 ? 8 : 16;
  static constexpr int WARPS = R == 16 ? 2 : R == 8 ? 4 : 8;
  static constexpr int MIN_BLOCKS = R == 1 ? 3 : 2;
  static constexpr int THREADS = WARPS * 32;
};
constexpr float kEps = 1.1920928955078125e-07f;
constexpr float kPreemph = 0.97f;

__host__ __device__ __forceinline__ int round4(int n) { return (n + 3) & ~3; }

__device__ __forceinline__ void cp_async4(float* dst, const float* src, bool valid) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(d), "l"(src),
               "r"(valid ? 4 : 0)
               : "memory");
}

// complex arithmetic on float2 (stage 1) and double2 (the rest)
template <class C>
__device__ __forceinline__ C cx(decltype(C::x) x, decltype(C::x) y) {
  C c;
  c.x = x;
  c.y = y;
  return c;
}
template <class C>
__device__ __forceinline__ C cadd(C a, C b) { return cx<C>(a.x + b.x, a.y + b.y); }
template <class C>
__device__ __forceinline__ C csub(C a, C b) { return cx<C>(a.x - b.x, a.y - b.y); }
__device__ __forceinline__ float fmad(float a, float b, float c) { return fmaf(a, b, c); }
__device__ __forceinline__ double fmad(double a, double b, double c) { return fma(a, b, c); }
template <class C>
__device__ __forceinline__ C cmul(C a, C w) {
  return cx<C>(fmad(a.x, w.x, -a.y * w.y), fmad(a.x, w.y, a.y * w.x));
}
template <class C>
__device__ __forceinline__ C mul_mi(C a) { return cx<C>(a.y, -a.x); }  // * -i

// 4-point DFT, natural order in and out
template <class C>
__device__ __forceinline__ void dft4(C& u0, C& u1, C& u2, C& u3) {
  const C p0 = cadd(u0, u2), p1 = csub(u0, u2);
  const C q0 = cadd(u1, u3), q1 = mul_mi(csub(u1, u3));
  u0 = cadd(p0, q0);
  u2 = csub(p0, q0);
  u1 = cadd(p1, q1);
  u3 = csub(p1, q1);
}

// 8-point DFT, natural order in and out: a radix-2 step (sums and
// differences times w8^j), then 4-point DFTs of each half
template <class C>
__device__ __forceinline__ void dft8(C (&a)[8]) {
  using R = decltype(C::x);
  const R h = static_cast<R>(0.70710678118654752440);
  C s[4], d[4];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    s[j] = cadd(a[j], a[j + 4]);
    d[j] = csub(a[j], a[j + 4]);
  }
  d[1] = cx<C>(h * (d[1].x + d[1].y), h * (d[1].y - d[1].x));
  d[2] = mul_mi(d[2]);
  d[3] = cx<C>(h * (d[3].y - d[3].x), -h * (d[3].x + d[3].y));
  dft4(s[0], s[1], s[2], s[3]);
  dft4(d[0], d[1], d[2], d[3]);
#pragma unroll
  for (int m = 0; m < 4; ++m) {
    a[2 * m] = s[m];
    a[2 * m + 1] = d[m];
  }
}

// second transpose: U(k1, l1, k2a) at 32 k2a + 4 k1 + (l1 ^ (k1 / 2 % 4)),
// so that the writes (fixed k2a) and the reads (fixed l1) each hit 8
// distinct 16-byte slots a quarter-warp
__device__ __forceinline__ int swz(int k1, int l1, int k2a) {
  return 32 * k2a + 4 * k1 + (l1 ^ ((k1 >> 1) & 3));
}

// samples x[i], x[i + 1]: one 8-byte load where the frame starts on an even
// sample (an even shift), two scalar loads otherwise
template <bool ODD>
__device__ __forceinline__ float2 load_pair(const float* p) {
  if constexpr (ODD) return make_float2(p[0], p[1]);
  else return *reinterpret_cast<const float2*>(p);
}

__device__ __forceinline__ double2 ldg2(const double* tw, int i) {
  return __ldg(reinterpret_cast<const double2*>(tw) + i);
}

// the packed point z[n] = y[2n] + i y[2n+1] of the frame at x: DC removal,
// pre-emphasis (y[-1] := y[0]) and the window, rounded as the plain version
// rounds; zero past W
template <bool ODD>
__device__ __forceinline__ float2 packed_point(const float* x, const float* __restrict__ win, int n,
                                              int W, float mean) {
  const int i0 = 2 * n;
  if (i0 >= W) return make_float2(0.f, 0.f);
  const float2 v = load_pair<ODD>(x + i0);
  const float2 w = __ldg(reinterpret_cast<const float2*>(win) + n);
  const float y0 = __fsub_rn(v.x, mean), y1 = __fsub_rn(i0 + 1 < W ? v.y : 0.f, mean);
  const float yp = i0 > 0 ? __fsub_rn(x[i0 - 1], mean) : y0;
  return make_float2(__fmul_rn(__fsub_rn(y0, __fmul_rn(kPreemph, yp)), w.x),
                     __fmul_rn(__fsub_rn(y1, __fmul_rn(kPreemph, y0)), w.y));
}

// the 8 x 8 x 4 schedule of a 256-point transform in f64, u[j] = a[lane +
// 32 j] in; out Z[lane + 32 i] at u[4 (i % 2) + i / 2]. scr: a warp's 8 ROW
// points
__device__ __forceinline__ void fft256_f64(double2 (&u)[8], double2* scr, const double* tw,
                                           int lane) {
  const int k1s = lane >> 2, l1s = lane & 3;
  dft8(u);
#pragma unroll
  for (int k1 = 0; k1 < 8; ++k1)
    scr[k1 * ROW + lane] = k1 == 0 ? u[0] : cmul(u[k1], ldg2(tw, 32 * k1 + lane));
  __syncwarp();
#pragma unroll
  for (int l2 = 0; l2 < 8; ++l2) u[l2] = scr[k1s * ROW + l1s + 4 * l2];
  __syncwarp();
  dft8(u);
#pragma unroll
  for (int k2a = 0; k2a < 8; ++k2a)
    scr[swz(k1s, l1s, k2a)] = k2a == 0 ? u[0] : cmul(u[k2a], ldg2(tw, TWL_32 + 4 * k2a + l1s));
  __syncwarp();
  double2 v[8];
#pragma unroll
  for (int r = 0; r < 2; ++r)
#pragma unroll
    for (int l1 = 0; l1 < 4; ++l1) v[4 * r + l1] = scr[swz(lane & 7, l1, (lane >> 3) + 4 * r)];
  __syncwarp();
#pragma unroll
  for (int r = 0; r < 2; ++r) dft4(v[4 * r], v[4 * r + 1], v[4 * r + 2], v[4 * r + 3]);
#pragma unroll
  for (int j = 0; j < 8; ++j) u[j] = v[j];
}

// |X[k]|^2 and |X[NZ - k]|^2 from Z[k] and Z[NZ - k] (the split), rounded to
// f32
__device__ __forceinline__ void split_pair(float* P, int NZv, int k, double2 za, double2 zb,
                                           double2 w) {
  const double2 e = make_double2(za.x + zb.x, za.y - zb.y);
  const double2 od = make_double2(za.y + zb.y, zb.x - za.x);
  const double2 t2 = cmul(od, w);
  const double2 xp = cadd(e, t2), xm = csub(e, t2);
  P[k] = 0.25f * (float)fma(xp.x, xp.x, xp.y * xp.y);
  if (k != 0) P[NZv - k] = 0.25f * (float)fma(xm.x, xm.x, xm.y * xm.y);
}

// the larger instances' power spectrum of one frame into P [NZ]
template <int R, bool ODD>
__device__ __forceinline__ void power_rn(const float* x, const float* __restrict__ win,
                                         const float* __restrict__ twa, const double* tw,
                                         double2* scr, float* P, int W, float mean, int lane) {
  constexpr int NZR = 256 * R;
  const float2* wa = reinterpret_cast<const float2*>(twa);  // w_NZ^(m q) at 256 q + m
  const float2* wr = wa + 256 * R;                           // w_R^j
  for (int g = 0; g < R / 2; ++g) {
    const int q0 = g, q1 = g == 0 ? R / 2 : R - g;
    // stage 1 (f32): the two transforms' inputs a_q0, a_q1 at m = lane + 32 j
    float2 s0[8], s1[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float2 a0 = make_float2(0.f, 0.f), a1 = a0;
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float2 z = packed_point<ODD>(x, win, lane + 32 * j + 256 * r, W, mean);
        a0 = cadd(a0, cmul(z, __ldg(wr + (r * q0) % R)));
        a1 = cadd(a1, cmul(z, __ldg(wr + (r * q1) % R)));
      }
      s0[j] = cmul(a0, __ldg(wa + 256 * q0 + lane + 32 * j));
      s1[j] = cmul(a1, __ldg(wa + 256 * q1 + lane + 32 * j));
    }
    double2 za[8], zb[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      za[j] = make_double2(s0[j].x, s0[j].y);
      zb[j] = make_double2(s1[j].x, s1[j].y);
    }
    fft256_f64(za, scr, tw, lane);
    fft256_f64(zb, scr, tw, lane);
#define ZA(i) za[4 * ((i) & 1) + ((i) >> 1)]
#define ZB(i) zb[4 * ((i) & 1) + ((i) >> 1)]
    if (g == 0) {
      // q = 0: Z[R k] pairs with Z[R (256 - k)], on lane (32 - lane) % 32
      // (lane 0 holds its own mirrors); Z[NZ / 2] alone, X[NZ / 2] =
      // Z*[NZ / 2]
      const int partner = (32 - lane) & 31;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        double2 zm;
        zm.x = __shfl_sync(0xffffffffu, ZA(7 - i).x, partner);
        zm.y = __shfl_sync(0xffffffffu, ZA(7 - i).y, partner);
        const double2 zo = lane != 0 ? zm : i == 0 ? ZA(0) : ZA((8 - i) & 7);
        const int k = R * (lane + 32 * i);
        split_pair(P, NZR, k, ZA(i), zo, ldg2(tw, TWL_SPLIT + k));
      }
      if (lane == 0) P[NZR / 2] = (float)fma(ZA(4).x, ZA(4).x, ZA(4).y * ZA(4).y);
      // q = R / 2: Z[R k + R/2] pairs with Z[R (255 - k) + R/2], on lane 31
      // - lane
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        double2 zm;
        zm.x = __shfl_sync(0xffffffffu, ZB(7 - i).x, 31 - lane);
        zm.y = __shfl_sync(0xffffffffu, ZB(7 - i).y, 31 - lane);
        const int k = R * (lane + 32 * i) + R / 2;
        split_pair(P, NZR, k, ZB(i), zm, ldg2(tw, TWL_SPLIT + k));
      }
    } else {
      // Z[R k + q0] pairs with Z[R (255 - k) + q1], on lane 31 - lane of
      // the other transform
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        double2 zm;
        zm.x = __shfl_sync(0xffffffffu, ZB(7 - i).x, 31 - lane);
        zm.y = __shfl_sync(0xffffffffu, ZB(7 - i).y, 31 - lane);
        const int k = R * (lane + 32 * i) + q0;
        split_pair(P, NZR, k, ZA(i), zm, ldg2(tw, TWL_SPLIT + k));
      }
    }
#undef ZA
#undef ZB
  }
}

// the larger instances' frames (R > 1): the mean, the power spectrum, the
// mel product with the schedule read from global memory
template <int R, bool ODD>
__device__ __forceinline__ void frames_rn(const float* ws, const float* __restrict__ win,
                                          const float* __restrict__ twa, const double* tw,
                                          const float* __restrict__ mel_w,
                                          const int* __restrict__ mel_meta,
                                          const int* __restrict__ mel_len, float* out, int b,
                                          int t0, int len, int T, int W, int shift, int M,
                                          double2* scr, float* P, int lane, int warp) {
  constexpr int TILE = Geom<R>::TILE, WARPS = Geom<R>::WARPS;
  const int rounds = (M + 31) / 32;
  for (int tt = warp; tt < TILE; tt += WARPS) {
    const int t = t0 + tt;
    if (t >= T) break;
    float* orow = out + ((size_t)b * T + t) * M;
    if (t >= len) {
      for (int m = lane; m < M; m += 32) orow[m] = 0.f;
      continue;
    }
    const float* x = ws + tt * shift;
    float sum = 0.f;
    for (int i = lane; i < W; i += 32) sum += x[i];
#pragma unroll
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / (float)W;
    power_rn<R, ODD>(x, win, twa, tw, scr, P, W, mean, lane);
    __syncwarp();
    const float* wr = mel_w + lane;
    for (int r = 0; r < rounds; ++r) {
      const int L = __ldg(mel_len + r), meta = __ldg(mel_meta + 32 * r + lane);
      const float* pk = P + (meta & 0xffff);
      float acc = 0.f;
#pragma unroll 4
      for (int i = 0; i < L; ++i) acc = fmaf(pk[i], __ldg(wr + 32 * i), acc);
      if (meta >= 0) orow[meta >> 16] = logf(fmaxf(acc, kEps));
      wr += 32 * L;
    }
    __syncwarp();  // the next frame overwrites P
  }
}

template <int R, bool ODD>
__global__ void __launch_bounds__(Geom<R>::THREADS, Geom<R>::MIN_BLOCKS)
fbank_kernel(const float* __restrict__ wave, const int* __restrict__ num_samples,
             const float* __restrict__ win, const float* __restrict__ tw1_g,
             const double* __restrict__ tw23_g,
             const float* __restrict__ mel_w, const int* __restrict__ mel_meta,
             const int* __restrict__ mel_len, float* __restrict__ out, int* __restrict__ lengths,
             int S, int T, int W, int shift, int M, int mel_steps) {
  constexpr int TILE_T = Geom<R>::TILE, NTHREADS = Geom<R>::THREADS, NFFT = 512 * R;
  extern __shared__ __align__(16) float smem[];
  const int b = blockIdx.y, t0 = blockIdx.x * TILE_T, tid = threadIdx.x;
  const int lane = tid & 31, warp = tid >> 5;
  const int span = (TILE_T - 1) * shift + NFFT;  // what the last frame's lanes read
  float* ws = smem;                                    // the waveform span, zero past S
  float* ww = ws + round4(span);                       // the window, zero past W [NFFT]
  double2* tw23 = reinterpret_cast<double2*>(ww + NFFT);        // [NTW23]
  float2* tw1 = reinterpret_cast<float2*>(tw23 + NTW23 + 1);      // [NTW1]
  const int rounds = (M + 31) / 32;
  float* mw = reinterpret_cast<float*>(tw1 + NTW1);      // mel weights [mel_steps][32]
  int* mm = reinterpret_cast<int*>(mw + 32 * mel_steps);   // m << 16 | k0 [rounds][32]
  int* ml = mm + 32 * rounds;                              // steps a round [rounds]
  double2* buf = reinterpret_cast<double2*>(ml + round4(rounds)) + warp * BUF;
  float2* rows = reinterpret_cast<float2*>(buf);
  float* P = reinterpret_cast<float*>(buf);

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
    const bool valid = base + i < S;
    cp_async4(ws + i, valid ? xb + base + i : xb, valid);
  }
  if constexpr (R > 1) {
    // the tables stay in global memory; per warp the transposes' buffer,
    // then the power spectrum
    asm volatile("cp.async.wait_all;" ::: "memory");
    __syncthreads();
    double2* scr = reinterpret_cast<double2*>(smem + round4(span)) + warp * (8 * ROW + 64 * R);
    frames_rn<R, ODD>(ws, win, tw1_g, tw23_g, mel_w, mel_meta, mel_len, out, b, t0, len, T, W,
                      shift, M, scr, reinterpret_cast<float*>(scr + 8 * ROW), lane, warp);
  } else {
  for (int i = tid; i < NFFT; i += NTHREADS) cp_async4(ww + i, win + i, true);
  for (int i = tid; i < 4 * NTW23; i += NTHREADS)
    cp_async4(reinterpret_cast<float*>(tw23) + i, reinterpret_cast<const float*>(tw23_g) + i, true);
  for (int i = tid; i < 2 * NTW1; i += NTHREADS)
    cp_async4(reinterpret_cast<float*>(tw1) + i, tw1_g + i, true);
  for (int i = tid; i < 32 * mel_steps; i += NTHREADS) cp_async4(mw + i, mel_w + i, true);
  for (int i = tid; i < 33 * rounds; i += NTHREADS)  // mel_meta, then mel_len
    cp_async4(reinterpret_cast<float*>(mm) + i,
              reinterpret_cast<const float*>(i < 32 * rounds ? mel_meta + i : mel_len + i - 32 * rounds),
              true);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  const int k1s = lane >> 2, l1s = lane & 3;  // the second stage's (k1, l1)
  float2 tw1r[8];  // this lane's stage-1 twiddles, the same for every frame
#pragma unroll
  for (int k1 = 1; k1 < 8; ++k1) tw1r[k1] = tw1[k1 * 32 + lane];
  for (int tt = warp; tt < TILE_T; tt += NWARPS) {
    const int t = t0 + tt;
    if (t >= T) break;
    float* orow = out + ((size_t)b * T + t) * M;
    if (t >= len) {
      for (int m = lane; m < M; m += 32) orow[m] = 0.f;
      continue;
    }
    const float* x = ws + tt * shift;  // x[2n] is 8-byte aligned for an even shift

    // the frame's samples 2n, 2n+1 for n = lane + 32 j, zero past W; the
    // mean over W
    float2 a[8];
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i0 = 2 * (lane + 32 * j);
      const float2 v = load_pair<ODD>(x + i0);
      a[j] = make_float2(i0 < W ? v.x : 0.f, i0 + 1 < W ? v.y : 0.f);
      sum += a[j].x + a[j].y;
    }
#pragma unroll
    for (int o = 16; o; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
    const float mean = sum / (float)W;

    // DC removal, pre-emphasis (y[-1] := y[0]) and the window, rounded as
    // the plain version rounds; z[n] = y[2n] + i y[2n+1]
    float2 z[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int i0 = 2 * (lane + 32 * j);
      const float2 w = *reinterpret_cast<const float2*>(ww + i0);
      const float y0 = __fsub_rn(a[j].x, mean), y1 = __fsub_rn(a[j].y, mean);
      const float yp = i0 > 0 ? __fsub_rn(x[i0 - 1], mean) : y0;
      z[j] = make_float2(__fmul_rn(__fsub_rn(y0, __fmul_rn(kPreemph, yp)), w.x),
                         __fmul_rn(__fsub_rn(y1, __fmul_rn(kPreemph, y0)), w.y));
    }

    double2 u[8];
    // stage 1 (f32): 8-point DFT over j, twiddles w256^(lane k1); Y(l, k1)
    // to row k1
    dft8(z);
#pragma unroll
    for (int k1 = 0; k1 < 8; ++k1)
      rows[k1 * ROW + lane] = k1 == 0 ? z[0] : cmul(z[k1], tw1r[k1]);
    __syncwarp();
    // stage 2 (f64): lane (k1, l1) takes Y(l1 + 4 l2, k1), an 8-point DFT
    // over l2, twiddles w32^(l1 k2a)
#pragma unroll
    for (int l2 = 0; l2 < 8; ++l2) {
      const float2 y = rows[k1s * ROW + l1s + 4 * l2];
      u[l2] = make_double2(y.x, y.y);
    }
    __syncwarp();
    dft8(u);
#pragma unroll
    for (int k2a = 0; k2a < 8; ++k2a)
      buf[swz(k1s, l1s, k2a)] = k2a == 0 ? u[0] : cmul(u[k2a], tw23[k2a * 4 + l1s]);
    __syncwarp();
    // stage 3: lane takes (k1, k2a) = (lane % 8, lane / 8 + 4 r), r = 0, 1:
    // 4-point DFTs over l1 give Z[k1 + 8 k2a + 64 k2b] = Z[lane + 32 i],
    // i = r + 2 k2b, in u[4 r + k2b]
#pragma unroll
    for (int r = 0; r < 2; ++r)
#pragma unroll
      for (int l1 = 0; l1 < 4; ++l1) u[4 * r + l1] = buf[swz(lane & 7, l1, (lane >> 3) + 4 * r)];
    __syncwarp();
#pragma unroll
    for (int r = 0; r < 2; ++r) dft4(u[4 * r], u[4 * r + 1], u[4 * r + 2], u[4 * r + 3]);

    // the real spectrum from Z[k] and Z[256 - k], k = lane + 32 i (i < 4),
    // as 2E = Z[k] + Z*[256-k], 2O and 2X = 2E + w512^k 2O: |X|^2 = |2X|^2
    // / 4, rounded to f32 (the / 4 is exact); X[128] = Z*[128]. Z[256 - k]
    // = Z[(32 - lane) + 32 (7 - i)] comes from lane 32 - lane by shuffles
    // (lane 0 holds its own mirrors, Z[32 (8 - i)])
#define ZI(i) u[4 * ((i) & 1) + ((i) >> 1)]
    double2 zm[4];
    const int partner = (32 - lane) & 31;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      zm[i].x = __shfl_sync(0xffffffffu, ZI(7 - i).x, partner);
      zm[i].y = __shfl_sync(0xffffffffu, ZI(7 - i).y, partner);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int k = lane + 32 * i;
      const double2 za = ZI(i);
      const double2 zb = lane != 0 ? zm[i] : i == 0 ? ZI(0) : zm[i - 1];
      const double2 e = make_double2(za.x + zb.x, za.y - zb.y);
      const double2 od = make_double2(za.y + zb.y, zb.x - za.x);
      const double2 t2 = cmul(od, tw23[TW3 + k]);
      const double2 xp = cadd(e, t2), xm = csub(e, t2);
      P[k] = 0.25f * (float)fma(xp.x, xp.x, xp.y * xp.y);
      if (k != 0) P[NZ - k] = 0.25f * (float)fma(xm.x, xm.x, xm.y * xm.y);
    }
    if (lane == 0) P[NZ / 2] = (float)fma(ZI(4).x, ZI(4).x, ZI(4).y * ZI(4).y);
#undef ZI
    __syncwarp();

    // the mel product: round r gives each lane a mel bin and L_r steps
    // over the DFT bins from its k0 (zero weights outside the bin's
    // range), then the log
    const float* wr = mw + lane;
    for (int r = 0; r < rounds; ++r) {
      const int L = ml[r], meta = mm[32 * r + lane];
      const float* pk = P + (meta & 0xffff);
      float acc = 0.f;
#pragma unroll 4
      for (int i = 0; i < L; ++i) acc = fmaf(pk[i], wr[32 * i], acc);
      if (meta >= 0) orow[meta >> 16] = logf(fmaxf(acc, kEps));
      wr += 32 * L;
    }
    __syncwarp();  // the next frame's rows overwrite P
  }
  }  // R == 1
}

template <int R, bool ODD>
int launch_fbank(const void* wave, const void* num_samples, const void* win, const void* tw1,
                 const void* tw23, const void* mel_w, const void* mel_meta, const void* mel_len,
                 void* out, void* lengths, int B, int S, int T, int W, int shift, int M,
                 int mel_steps, cudaStream_t stream) {
  constexpr int TILE = Geom<R>::TILE;
  const int span = (TILE - 1) * shift + 512 * R;
  const int rounds = (M + 31) / 32;
  // R = 1: the span, the window, the twiddles, the mel schedule and a
  // buffer a warp; R > 1: the span, then a warp's transposes' buffer (8 ROW
  // f64 points) and power spectrum (256 R f32)
  const size_t smem =
      R == 1 ? ((size_t)round4(span) + NFFT + 4 * (NTW23 + 1) + 2 * NTW1 + 32 * mel_steps +
                32 * rounds + round4(rounds) + (size_t)NWARPS * 4 * BUF) * 4
             : (size_t)round4(span) * 4 + (size_t)Geom<R>::WARPS * (8 * ROW * 16 + 256 * R * 4);
  cudaError_t err = cudaFuncSetAttribute(fbank_kernel<R, ODD>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((T + TILE - 1) / TILE, B);
  fbank_kernel<R, ODD><<<grid, Geom<R>::THREADS, smem, stream>>>(
      static_cast<const float*>(wave), static_cast<const int*>(num_samples),
      static_cast<const float*>(win), static_cast<const float*>(tw1),
      static_cast<const double*>(tw23),
      static_cast<const float*>(mel_w), static_cast<const int*>(mel_meta),
      static_cast<const int*>(mel_len), static_cast<float*>(out), static_cast<int*>(lengths), S,
      T, W, shift, M, mel_steps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// wave [B, S] f32, num_samples [B] int32, win [nfft] f32 (the window, zero
// past W), the twiddles of fbank_kernels.fft_twiddles(nfft) (at 512
// points tw1 [256, 2] f32 and tw23 [161, 2] f64; past it tw1 [257 R, 2] f32
// and tw23 [288 + 256 R, 2] f64); the mel schedule of
// fbank_kernels.mel_schedule: mel_w [mel_steps, 32] f32, mel_meta
// [ceil(M / 32), 32] int32, mel_len [ceil(M / 32)] int32; out [B, T, M]
// f32, lengths [B] int32; all contiguous. nfft is 512, 1024, 2048, 4096 or 8192,
// W at most nfft (and past nfft / 2 above 512), shift at least 1. Launches
// on `stream` of card `device`; returns the CUDA error code (0 on success).
int fbank_f32(const void* wave, const void* num_samples, const void* win, const void* tw1,
              const void* tw23, const void* mel_w, const void* mel_meta, const void* mel_len, void* out,
              void* lengths, int B, int S, int T, int W, int shift, int M, int mel_steps, int nfft,
              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (B == 0 || T == 0) return 0;
  if (W > nfft || W < 1 || shift < 1 || (nfft > NFFT && 2 * W <= nfft))
    return (int)cudaErrorInvalidValue;
  const bool odd = shift % 2 != 0;
  cudaStream_t st = (cudaStream_t)stream;
#define FBANK_LAUNCH(R_)                                                                      \
  return odd ? launch_fbank<R_, true>(wave, num_samples, win, tw1, tw23, mel_w, mel_meta,      \
                                      mel_len, out, lengths, B, S, T, W, shift, M, mel_steps, st) \
             : launch_fbank<R_, false>(wave, num_samples, win, tw1, tw23, mel_w, mel_meta,     \
                                       mel_len, out, lengths, B, S, T, W, shift, M, mel_steps, st)
  switch (nfft) {
    case 512: FBANK_LAUNCH(1);
    case 1024: FBANK_LAUNCH(2);
    case 2048: FBANK_LAUNCH(4);
    case 4096: FBANK_LAUNCH(8);
    case 8192: FBANK_LAUNCH(16);
    default: return (int)cudaErrorInvalidValue;
  }
#undef FBANK_LAUNCH
}

}  // extern "C"
