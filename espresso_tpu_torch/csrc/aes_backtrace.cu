// Reverse walk of the AES merge and expansion backpointers, int32, sm_90a.
//
// Replaces the TPU kernel espresso_tpu/ops/decode_kernels.py::aes_backtrace
// (Pallas; one call per decoded batch). For each (utterance b, final beam
// k), starting from slot = order[b, k] and walking the frames t = T-1..0:
//
//   if frame t is active: follow the merge rounds j = n_exp..0 while the
//     slot came from the pool (fp), to the round where it left an expansion
//     (exit level, exit slot = msrc); then emit the expansion tokens of the
//     rounds r = n_exp..1 at or below the exit level, following esrc
//   toks[t, n_exp - r, b, k] = etok (0 where not emitted), valid likewise
//
// exactly the logic of the Pallas kernel (decode_kernels.py:338-366); an
// index outside [0, K) reads 0, as its select chains do. A slot that stays
// from-pool down to j = 0 keeps its own value and emits nothing; an
// inactive frame passes every slot through and emits nothing.
//
// What bounds it on an H100: at the flagship (T' = 156, B = 256, K = 10,
// n_exp = 2) it reads ~16 MB of backpointers and writes ~6.4 MB: ~7 us at
// 3.35 TB/s; but each beam's walk is a chain of T' dependent steps, and the
// backpointers come in runs of K ints (40 bytes), one per (frame, round,
// utterance).
//
// Design: a frame's step depends only on the slot it is entered with and
// on that frame's own backpointers, so it is tabulated. For every frame and
// every incoming slot s of [0, K], column K standing for every slot outside
// [0, K) (its gathers all read 0), the table holds where the slot goes
// (outside [0, K) -> column K), its exit level and its emitted tokens. A
// block per utterance; past its last active frame nothing is emitted and
// every slot passes through, so those frames are not read, only zeroed in
// the outputs. The frames go in chunks of ~16 KB of backpointers, the last
// chunk first, through a pipeline of three roles, warp-specialised and
// handed over by mbarriers:
//   - two producer warps copy each chunk into a ring of (up to) four
//     staging buffers by cp.async (each input int read once), its
//     completion signalled on the buffer's mbarrier, so that the copies
//     stream while the others work;
//   - worker warps tabulate a chunk (a thread per (frame, slot), its
//     gathers from shared memory, no dependence between frames) into one of
//     two table buffers, free its staging buffer, and write the previous
//     chunk's toks and valid from its tables once it has been walked (a
//     named barrier of the workers keeps a table buffer from being
//     rewritten while some of them still read it);
//   - walker warps (a thread per beam) follow the tables' next-slot entries
//     only, one dependent shared-memory load a frame, and record the entry
//     they hold at every frame.
// The table entries are indexed f (K + 1) + s, and a next-slot entry holds
// the index of its entry in the frame before, so a step of the walk is one
// load and no arithmetic.
//
// What holds it back (chip_kernel_ablation.py on an H100 at the flagship,
// ~0.015 ms in all): the copies of the 40-byte runs, whose issue one
// producer warp cannot keep up (one warp: ~3.7 us more; four: no faster),
// ~1-2 us of them not hidden, and the tabulation (~2 us); the walk and the
// stores are hidden behind them.
//
// C entry: aes_backtrace_i32(...) returns the CUDA error of the launch; it
// launches on the given stream and does not synchronise.

#include "hopper_sm90.cuh"

namespace {

using namespace sm90;

constexpr int kProducerWarps = 2;       // warps that issue the copies
constexpr int kWorkerWarps = 6;         // warps that tabulate and write
constexpr int kMaxWalkerWarps = 16;     // a walker thread takes two beams past 512
constexpr int kChunkBytes = 16 * 1024;  // bytes of backpointers a chunk stages
constexpr int kBufs = 4;                // staging buffers (chunks in flight) at most
constexpr int kSmemLimit = 232448;      // the dynamic shared memory a block may have

__device__ inline void cp_async4(int* dst, const int* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_u32(dst)), "l"(src)
               : "memory");
}

// an arrival on `bar` once every cp.async this thread issued has landed
__device__ inline void cp_async_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];" ::"r"(smem_u32(bar))
               : "memory");
}

__device__ inline void cp_async_wait_all() { asm volatile("cp.async.wait_all;" ::: "memory"); }

__device__ inline int gather_k(const int* tab, int idx, int K) {
  return (unsigned)idx < (unsigned)K ? tab[idx] : 0;
}

// Every item j < n of every frame, spread over nt threads (this one is
// tid): with n at least nt a thread takes the items j = tid, tid + nt, ...
// and all frames; else item tid mod n and every (nt / n)-th frame.
// fn(j, f0, fstep) loops over the frames f0, f0 + fstep, ...
template <class Fn>
__device__ inline void spread(int n, int nt, int tid, Fn fn) {
  if (n >= nt) {
    for (int j = tid; j < n; j += nt) fn(j, 0, 1);
  } else {
    const int groups = nt / n, grp = tid / n;
    if (grp < groups) fn(tid - grp * n, grp, groups);
  }
}

struct Args {
  const int *active, *fp, *msrc, *esrc, *etok, *order;
  int *toks, *valid;
  int T, B, K, n_exp;
  int TC;       // frames a chunk
  int nbuf;     // staging buffers (1 .. kBufs)
  int walkers;  // walker warps
};

// walker warps for K beams
inline int walker_warps(int K) {
  const int w = (K + 31) / 32;
  return w < kMaxWalkerWarps ? w : kMaxWalkerWarps;
}

// the dynamic shared memory in ints: the mbarriers (full[kBufs],
// empty[kBufs], ready[2], walked[2]), the staging ring [nbuf][TC][PF], two
// table buffers [TC][(2 + n_exp) (K + 1)] (next, level, tokens) and two walk
// records [TC][K]
inline size_t smem_ints(int TC, int nbuf, int K, int n_exp) {
  const size_t PF = (size_t)(4 * n_exp + 2) * K + 1, K1 = K + 1;
  return 32 + nbuf * TC * PF + 2 * (size_t)TC * (2 + n_exp) * K1 + 2 * (size_t)TC * K;
}

__global__ void __launch_bounds__(1024) aes_backtrace_kernel(const Args a) {
  extern __shared__ __align__(16) int smem_i[];
  const int K = a.K, n_exp = a.n_exp, R = n_exp + 1, E = n_exp, K1 = K + 1;
  const int B = a.B, T = a.T, TC = a.TC, nbuf = a.nbuf, b = blockIdx.x, tid = threadIdx.x;
  // a staged frame: fp rows j < R, msrc rows, esrc rows, etok rows (K ints
  // each), then active
  const int P = (2 * R + 2 * E) * K, PF = P + 1;
  uint64_t* full = reinterpret_cast<uint64_t*>(smem_i);  // a staging buffer landed
  uint64_t* empty = full + kBufs;                         // a staging buffer tabulated
  uint64_t* ready = empty + kBufs;                        // a table buffer written
  uint64_t* walked = ready + 2;                           // a table buffer walked
  static_assert(2 * kBufs + 4 <= 16, "the barriers fit in 32 ints");
  int* const stage = smem_i + 32;
  int* const tables = stage + nbuf * TC * PF;
  int* const walks = tables + 2 * TC * (2 + n_exp) * K1;
  const int nwalk = 32 * a.walkers, nprod = 32 * kProducerWarps, nwork = 32 * kWorkerWarps;

  // the frames that matter, [0, Tu): past the utterance's last active frame
  // every slot passes through and nothing is emitted
  __shared__ int last_active;
  if (tid == 0) {
    last_active = -1;
    for (int i = 0; i < kBufs; ++i) {
      mbar_init(&full[i], nprod);
      mbar_init(&empty[i], nwork);
    }
    for (int i = 0; i < 2; ++i) {
      mbar_init(&ready[i], nwork);
      mbar_init(&walked[i], nwalk);
    }
    fence_barrier_init();
  }
  __syncthreads();
  {
    int tl = -1;
#pragma unroll 4
    for (int t = tid; t < T; t += blockDim.x) tl = a.active[(size_t)t * B + b] > 0 ? t : tl;
    for (int x = 16; x > 0; x >>= 1) tl = max(tl, __shfl_xor_sync(0xffffffffu, tl, x));
    if (tid % 32 == 0 && tl >= 0) atomicMax(&last_active, tl);
  }
  __syncthreads();
  const int Tu = last_active + 1;
  const int nchunks = (Tu + TC - 1) / TC;
  // chunk c: frames [t0, t0 + nf), the last chunk of the utterance first
  auto frames = [&](int c, int& t0, int& nf) {
    const int tend = Tu - c * TC;
    t0 = tend > TC ? tend - TC : 0;
    nf = tend - t0;
  };
  // chunk c's tables: next [TC][K1], level [TC][K1], tokens [E][TC][K1]
  auto next_of = [&](int c) { return tables + (c & 1) * TC * (2 + n_exp) * K1; };

  if (tid < nwalk) {
    // ---- walkers: beams tid and tid + nwalk, each with its slot (K:
    // outside [0, K)) as it enters the next chunk
    int slot[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = tid + i * nwalk;
      const int o = k < K ? a.order[(size_t)b * K + k] : 0;
      slot[i] = (unsigned)o < (unsigned)K ? o : K;
    }
    for (int c = 0; c < nchunks; ++c) {
      int t0, nf;
      frames(c, t0, nf);
      mbar_wait(&ready[c & 1], (c >> 1) & 1);
      const int* nxt = next_of(c);
      int* at = walks + (c & 1) * TC * K;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int k = tid + i * nwalk;
        if (k >= K) break;
        int e = (nf - 1) * K1 + slot[i];
        for (int f = nf - 1; f >= 0; --f) {
          at[f * K + k] = e;
          e = nxt[e];
        }
        slot[i] = e + K1;  // the entry past frame 0: the slot itself
      }
      mbar_arrive(&walked[c & 1]);
    }
    return;
  }
  if (tid < nwalk + nprod) {
    // ---- producers: chunk c into staging buffer c % nbuf once it is free
    const int pt = tid - nwalk;
    for (int c = 0; c < nchunks; ++c) {
      const int i = c % nbuf;
      if (c >= nbuf) mbar_wait(&empty[i], (c / nbuf - 1) & 1);
      int t0, nf;
      frames(c, t0, nf);
      int* dst = stage + i * TC * PF;
      spread(P, nprod, pt, [&](int j, int f0, int fstep) {
        const int row = j / K, kk = j - row * K;
        const int* src;
        size_t fstride;
        if (row < R) {
          src = a.fp + ((size_t)row * B + b) * K + kk;
          fstride = (size_t)R * B * K;
        } else if (row < 2 * R) {
          src = a.msrc + ((size_t)(row - R) * B + b) * K + kk;
          fstride = (size_t)R * B * K;
        } else if (row < 2 * R + E) {
          src = a.esrc + ((size_t)(row - 2 * R) * B + b) * K + kk;
          fstride = (size_t)E * B * K;
        } else {
          src = a.etok + ((size_t)(row - 2 * R - E) * B + b) * K + kk;
          fstride = (size_t)E * B * K;
        }
        for (int f = f0; f < nf; f += fstep)
          cp_async4(dst + f * PF + j, src + (size_t)(t0 + f) * fstride);
      });
      for (int f = pt; f < nf; f += nprod)
        cp_async4(dst + f * PF + P, a.active + (size_t)(t0 + f) * B + b);
      cp_async_arrive(&full[i]);
    }
    cp_async_wait_all();  // no thread exits with its copies in flight
    return;
  }
  // ---- workers
  const int wt = tid - nwalk - nprod;
  // the frames past Tu emit nothing
  spread(E * K, nwork, wt, [&](int j, int f0, int fstep) {
    const int rr = j / K, k = j - rr * K;
    for (int t = Tu + f0; t < T; t += fstep) {
      const size_t o = (((size_t)t * E + rr) * B + b) * K + k;
      a.toks[o] = 0;
      a.valid[o] = 0;
    }
  });
  for (int c = 0; c <= nchunks; ++c) {
    // every worker is done writing chunk c - 2, whose table buffer chunk c
    // takes
    if (c >= 2) named_sync(1, nwork);
    if (c < nchunks) {
      // the step of frame f for every incoming slot s of [0, K] (s = K: a
      // slot outside [0, K), whose gathers read 0)
      int t0, nf;
      frames(c, t0, nf);
      const int i = c % nbuf;
      mbar_wait(&full[i], (c / nbuf) & 1);
      const int* src = stage + i * TC * PF;
      int* nxt = next_of(c);
      int* lvl = nxt + TC * K1;
      int* tokv = lvl + TC * K1;
      spread(K1, nwork, wt, [&](int s, int f0, int fstep) {
        for (int f = f0; f < nf; f += fstep) {
          const int* fr = src + f * PF;
          bool cont = fr[P] > 0;
          int exit_level = -1, exit_slot = s, cur = s;
          for (int j = n_exp; j >= 0; --j) {
            const bool from_pool = gather_k(fr + j * K, cur, K) > 0;
            const int from = gather_k(fr + (R + j) * K, cur, K);
            if (cont && !from_pool) {
              exit_level = j;
              exit_slot = from;
            }
            if (cont && from_pool) cur = from;
            cont = cont && from_pool;
          }
          int s2 = exit_slot;
          for (int r = n_exp; r >= 1; --r) {
            const bool m = exit_level >= r;
            const int tok = gather_k(fr + (2 * R + E + r - 1) * K, s2, K);
            const int from = gather_k(fr + (2 * R + r - 1) * K, s2, K);
            tokv[((n_exp - r) * TC + f) * K1 + s] = m ? tok : 0;
            if (m) s2 = from;
          }
          nxt[f * K1 + s] = (f - 1) * K1 + ((unsigned)s2 < (unsigned)K ? s2 : K);
          lvl[f * K1 + s] = exit_level;
        }
      });
      mbar_arrive(&empty[i]);
      mbar_arrive(&ready[c & 1]);
    }
    if (c >= 1) {
      // chunk c - 1, walked: toks and valid from its tables
      const int cw = c - 1;
      int t0, nf;
      frames(cw, t0, nf);
      mbar_wait(&walked[cw & 1], (cw >> 1) & 1);
      const int* lvl = next_of(cw) + TC * K1;
      const int* tokv = lvl + TC * K1;
      const int* at = walks + (cw & 1) * TC * K;
      spread(E * K, nwork, wt, [&](int j, int f0, int fstep) {
        const int rr = j / K, k = j - rr * K, r = n_exp - rr;
        for (int f = f0; f < nf; f += fstep) {
          const int e = at[f * K + k];
          const size_t o = (((size_t)(t0 + f) * E + rr) * B + b) * K + k;
          a.toks[o] = tokv[rr * TC * K1 + e];
          a.valid[o] = lvl[e] >= r;
        }
      });
    }
  }
}

// frames a chunk and staging buffers for (T, K, n_exp): chunks of about
// kChunkBytes of backpointers, kBufs of them in flight, fewer where the
// shared memory runs out; the dynamic shared memory; 0 when not even one
// frame fits
size_t plan(int T, int K, int n_exp, int* TC, int* nbuf) {
  const size_t PF = (size_t)(4 * n_exp + 2) * K + 1;
  int tc = (int)(kChunkBytes / (PF * 4));
  if (tc < 1) tc = 1;
  if (tc > T) tc = T > 0 ? T : 1;
  const int nchunks = (T + tc - 1) / tc;
  if (nchunks > 0) tc = (T + nchunks - 1) / nchunks;  // chunks of even length
  for (int nb = kBufs; nb >= 1; --nb) {
    const size_t bytes = smem_ints(tc, nb, K, n_exp) * 4;
    if (bytes <= (size_t)kSmemLimit) {
      *TC = tc;
      *nbuf = nb;
      return bytes;
    }
  }
  return 0;
}

}  // namespace

extern "C" {

// active [T, B]; fp, msrc [T, n_exp+1, B, K]; esrc, etok, toks, valid
// [T, n_exp, B, K]; order [B, K]; all int32 and contiguous, n_exp >= 1,
// K <= 1024. Launches on `stream` of card `device`; returns the CUDA error
// code (0 on success).
int aes_backtrace_i32(const void* active, const void* fp, const void* msrc, const void* esrc,
                      const void* etok, const void* order, void* toks, void* valid, int T,
                      int B, int K, int n_exp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return (int)err;
  if (n_exp < 1 || K < 1 || K > 2 * 32 * kMaxWalkerWarps) return (int)cudaErrorInvalidValue;
  Args a;
  a.active = static_cast<const int*>(active);
  a.fp = static_cast<const int*>(fp);
  a.msrc = static_cast<const int*>(msrc);
  a.esrc = static_cast<const int*>(esrc);
  a.etok = static_cast<const int*>(etok);
  a.order = static_cast<const int*>(order);
  a.toks = static_cast<int*>(toks);
  a.valid = static_cast<int*>(valid);
  a.T = T;
  a.B = B;
  a.K = K;
  a.n_exp = n_exp;
  a.walkers = walker_warps(K);
  const size_t smem = plan(T, K, n_exp, &a.TC, &a.nbuf);
  if (smem == 0) return (int)cudaErrorInvalidValue;
  err = cudaFuncSetAttribute(aes_backtrace_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int threads = 32 * (a.walkers + kProducerWarps + kWorkerWarps);
  aes_backtrace_kernel<<<B, threads, smem, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

}  // extern "C"
