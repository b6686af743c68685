// Hopper (sm_90a) building blocks shared by the redesigned kernels
// (lstm_step_reorder.cu, fused_joint_topk.cu): shared-memory addresses,
// mbarriers (local and across a thread-block cluster), TMA tile loads and
// their tensor maps, cp.async with zero fill, wgmma descriptors for K-major
// tiles in the 128-byte swizzle and the bf16 m64nNk16 products, named
// barriers, and the cluster's distributed shared memory.
//
// Tile layout: every operand tile is K-major, 64 bf16 (128 bytes) of K per
// row, rows 128 bytes apart, the 16-byte chunk c of row r stored at chunk
// c ^ (r % 8), and the tile based on a 1024-byte boundary. That is what a TMA
// load with CU_TENSOR_MAP_SWIZZLE_128B writes (box {64, rows}), what a copy
// or a store to offset swz(row, chunk) writes by hand, and what a wgmma
// descriptor of layout type 1 (128B swizzle) with a stride of 1024 bytes
// between 8-row groups reads. The k16 step inside a 64-wide tile advances
// the descriptor's start address by 32 bytes.

#pragma once

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

typedef __nv_bfloat16 bf16;

namespace sm90 {

__device__ inline uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// byte offset of 16-byte chunk `chunk` of row `row` in a swizzled tile
__host__ __device__ inline uint32_t swz(int row, int chunk) {
  return (uint32_t)row * 128u + ((uint32_t)(chunk ^ (row & 7)) << 4);
}

// ---- mbarriers ------------------------------------------------------------

__device__ inline void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
}

// make the initialised barriers visible to the async proxy and the cluster
__device__ inline void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

__device__ inline void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(smem_u32(bar)) : "memory");
}

__device__ inline void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// a wait that has not completed after ~10 s of SM clocks is a deadlock:
// trap, so that the launch fails instead of hanging the card
__device__ inline void check_stuck(long long t0) {
  if (clock64() - t0 > 20000000000LL) __trap();
}

// wait until the phase of parity `parity` has completed (CTA scope)
__device__ inline void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    check_stuck(t0);
  }
}

// the same with acquire at cluster scope: data that other CTAs of the
// cluster wrote before their release-arrive is visible after it
__device__ inline void mbar_wait_cluster(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  const long long t0 = clock64();
  uint32_t done = 0;
  while (true) {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    check_stuck(t0);
  }
}

// ---- thread-block clusters ------------------------------------------------

__device__ inline uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(r));
  return r;
}

__device__ inline uint32_t cluster_size() {
  uint32_t n;
  asm volatile("mov.u32 %0, %%cluster_nctarank;" : "=r"(n));
  return n;
}

// every thread of every CTA of the cluster (release, then acquire)
__device__ inline void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\nbarrier.cluster.wait;" ::: "memory");
}

__device__ inline void fence_cluster() { asm volatile("fence.acq_rel.cluster;" ::: "memory"); }

// address of the same shared variable in CTA `rank` of the cluster
__device__ inline uint32_t mapa(uint32_t local_addr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(local_addr), "r"(rank));
  return r;
}

// arrive (release, cluster scope) on barrier `bar` of CTA `rank`
__device__ inline void mbar_arrive_remote(uint64_t* bar, uint32_t rank) {
  asm volatile("mbarrier.arrive.release.cluster.shared::cluster.b64 _, [%0];" ::"r"(
                   mapa(smem_u32(bar), rank))
               : "memory");
}

// loads from another CTA's shared memory: volatile, so they stay after the
// barrier waits that order them, but free of a memory clobber, so that
// several can be in flight
__device__ inline float ld_dsmem_f32(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];" : "=f"(v) : "r"(addr));
  return v;
}

__device__ inline uint4 ld_dsmem_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared::cluster.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}

// ---- named barriers -------------------------------------------------------

__device__ inline void named_sync(uint32_t id, uint32_t threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// ---- copies ---------------------------------------------------------------

// generic-proxy writes to shared memory made visible to the async proxy
// (wgmma, TMA) of this CTA; the writer runs it before the barrier that
// hands the data over
__device__ inline void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// 16 bytes global -> shared; zero-filled when !valid (src is then not read)
__device__ inline void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}

__device__ inline void cp_async_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

template <int N>
__device__ inline void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// TMA: the box at (c0 = inner/K element, c1 = row) of a 2-D tensor map into
// shared memory, completing `bytes` on `bar`
__device__ inline void tma_load_2d(uint32_t dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                   int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// ---- wgmma ----------------------------------------------------------------

// descriptor of a K-major, 128B-swizzled tile at shared address `addr`
// (1024-byte aligned base; +32 bytes per k16 step inside the 64-wide tile)
__device__ inline uint64_t wgmma_desc(uint32_t addr) {
  uint64_t d = 0;
  d |= (uint64_t)((addr & 0x3FFFF) >> 4);
  d |= (uint64_t)(1) << 16;          // leading byte offset (unused for this layout)
  d |= (uint64_t)(1024 >> 4) << 32;  // 8-row groups 1024 bytes apart
  d |= (uint64_t)1 << 62;            // 128-byte swizzle
  return d;
}

__device__ inline void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;" ::: "memory"); }

__device__ inline void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

template <int N>
__device__ inline void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(N) : "memory");
}

// d[64 x 64] += A[64 x 16] * B[16 x 64], both K-major in shared memory, fp32
// accumulators: thread (warp w, lane 4g + q) holds rows 16w + g (d[4j],
// d[4j+1]) and 16w + g + 8 (d[4j+2], d[4j+3]) of columns 8j + 2q, 8j + 2q + 1
__device__ inline void wgmma_m64n64k16(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// the same for N = 128 (d[4j..4j+3] for the n8 block j = 0..15)
__device__ inline void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db,
                                        int accumulate) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]),
        "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]),
        "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]),
        "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]),
        "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]), "+f"(d[42]),
        "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]),
        "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// ---- host: tensor maps ----------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, reached through the runtime (no
// link against libcuda)
inline EncodeTiledFn encode_tiled_fn() {
  static EncodeTiledFn fn = nullptr;
  if (!fn) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault,
                                         &q) == cudaSuccess &&
        q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a tensor map of the row-major bf16 matrix [rows, cols] at `ptr` (16-byte
// aligned, cols % 8 == 0) read in boxes of 64 columns x `box_rows` rows with
// the 128-byte swizzle; boxes past the edge read zeros. Writes the 128-byte
// map to `out`; returns a CUDA error code (0 on success).
inline int encode_tmap_bf16(void* out, const void* ptr, uint64_t rows, uint64_t cols,
                            uint32_t box_rows) {
  EncodeTiledFn fn = encode_tiled_fn();
  if (!fn) return (int)cudaErrorNotSupported;
  CUtensorMap map;
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {cols * 2};
  const cuuint32_t box[2] = {64, box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult r = fn(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(ptr), dims,
                        strides, box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  memcpy(out, &map, sizeof(map));
  return 0;
}

inline int sm_count(int device) {
  int n = 0;
  if (cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, device) != cudaSuccess) return 0;
  return n;
}

}  // namespace sm90
