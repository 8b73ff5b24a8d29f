// Hopper's asynchronous primitives (PTX ISA 8.0, sm_90a), shared by the
// warp-specialised kernels: K5's large form (w8a16_gemm.cu), K4's forward
// and backward (train_wgmma_attention.cuh, train_wgmma_attention_bwd.cuh)
// bf16 K1 and K3 (wgmma_attention.cuh), and K2 / K2-int8's decode ring
// (decode_attention.cuh).
//
//   * mbarriers: init, arrive (here or on a cluster peer), expect_tx, wait
//     on a phase's parity; the cluster barrier and rank; named barriers;
//   * 1-D bulk copies that complete on an mbarrier, and the arrival on an
//     mbarrier once a thread's cp.async copies have landed (the decode
//     ring's producer);
//   * TMA: tile loads of 2, 4 and 5 dimensions into shared memory (and one
//     multicast to the blocks of a cluster) that complete on an mbarrier,
//     and the host's tensor maps (cuTensorMapEncodeTiled, reached once
//     through cudaGetDriverEntryPointByVersion, so nothing links libcuda);
//   * the proxy fence that orders a thread's plain shared-memory writes
//     before the wgmma's and TMA's (async proxy) accesses that follow;
//   * wgmma: fence, commit, wait, the shared-memory matrix descriptor, and
//     the m64nNk16 bf16 products at the widths the kernels use, A from
//     registers (RS) or from shared memory (SS), B K-major or transposed.
//
// The accumulator of an m64nNk16 product (N / 2 fp32 a thread) and an A
// operand in registers have mma.sync's m16n8k16 layouts, each warp w of the
// warpgroup owning rows 16 w .. 16 w + 15: d[4 j + 2 h + c] is row gid + 8 h,
// column 8 j + 2 tig + c, and a[2 x + h] holds row gid + 8 h, columns 8 x +
// 2 tig, +1 (lane = 4 gid + tig). So the n8 tiles 2 kk and 2 kk + 1 of an
// accumulator, packed to bf16 pairs, are the k16 step kk of an A operand.

#pragma once

#include <cstdint>

#include <cuda.h>
#include <cudaTypedefs.h>

#include "mma_common.cuh"

namespace livecc {

namespace {

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" :: "r"(smem_addr(bar)), "r"(count));
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" :: "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               :: "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
// an arrival on the barrier at `bar`'s place in the shared memory of the
// cluster's block `rank`
__device__ __forceinline__ void mbar_arrive_at(uint64_t* bar, uint32_t rank) {
  asm volatile("{\n.reg .b32 remote;\nmapa.shared::cluster.u32 remote, %0, %1;\n"
               "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n"
               :: "r"(smem_addr(bar)), "r"(rank) : "memory");
}
// until the phase of parity `parity` has completed (a fresh barrier counts
// the phase before its first as completed: parity 1 passes at once)
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done)
    asm volatile("{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
                 "selp.u32 %0, 1, 0, p;\n}\n"
                 : "=r"(done) : "r"(smem_addr(bar)), "r"(parity) : "memory");
}
// the barriers' initialisation made visible to the async proxy (TMA) and the cluster
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
// the cluster barrier: every thread of the cluster's blocks that has not
// exited arrives; a wait returns once all have
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// a named barrier (ids 1-15; 0 is __syncthreads') of `threads` threads, a
// multiple of 32: sync waits until that many have synced or arrived,
// arrive counts this warp without waiting
__device__ __forceinline__ void named_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
__device__ __forceinline__ void named_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" :: "r"(id), "r"(threads) : "memory");
}
// a warpgroup's registers: lowered to / raised to N a thread (all four warps)
template <int N> __device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" :: "n"(N));
}
template <int N> __device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" :: "n"(N));
}

// `bytes` (a multiple of 16) from global `src` to shared `dst`, both 16-byte
// aligned, as one 1-D bulk copy completing on `bar`
__device__ __forceinline__ void bulk_load(void* dst, const void* src, int bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1], %2, [%3];\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(bar)) : "memory");
}
// an arrival on `bar` once this thread's earlier cp.async copies have
// landed (.noinc: the barrier's initial count includes it)
__device__ __forceinline__ void cp_async_mbar_arrive(uint64_t* bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n"
               :: "r"(smem_addr(bar)) : "memory");
}

// TMA loads of the box at coordinates (c0 innermost, ...) into `dst`,
// completing on `bar`; coordinates past the map's extent read zeros
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, int c0, int c1,
                                         uint64_t* bar) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%2, %3}], [%4];\n"
               :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
                  "r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void tma_load_4d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, uint64_t* bar) {
  asm volatile("cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%2, %3, %4, %5}], [%6];\n"
               :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
                  "r"(c2), "r"(c3), "r"(smem_addr(bar))
               : "memory");
}
__device__ __forceinline__ void tma_load_5d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, int c3, int c4, uint64_t* bar) {
  asm volatile("cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx::bytes "
               "[%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n"
               :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
                  "r"(c2), "r"(c3), "r"(c4), "r"(smem_addr(bar))
               : "memory");
}
// the 2-d load into `dst` of every block of the cluster in `mask`,
// completing on the barrier at `bar`'s place in each
__device__ __forceinline__ void tma_load_multicast(void* dst, const CUtensorMap* map, int c0,
                                                   int c1, uint64_t* bar, uint16_t mask) {
  asm volatile("cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
               ".multicast::cluster [%0], [%1, {%2, %3}], [%4], %5;\n"
               :: "r"(smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
                  "r"(smem_addr(bar)), "h"(mask)
               : "memory");
}

// this thread's plain writes to shared memory, seen by later wgmma / TMA
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
}
// keeps the compiler from moving accumulator accesses across wgmma's
template <int R> __device__ __forceinline__ void fence_acc(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}

// wgmma's shared-memory matrix descriptor of the tile at `tile`: leading and
// stride byte offsets (multiples of 16), layout 1 = 128-byte swizzle. A
// K-major operand in the 128-byte swizzle (rows of 128 bytes, 8-row groups
// 1024 bytes apart, 1024-byte aligned) takes (16, 1024): the leading offset
// is unused; an MN-major one (the transposed B) takes the distance between
// its 64-element blocks along MN as the leading offset and that between its
// 8-row groups along K as the stride.
__device__ __forceinline__ uint64_t wgmma_desc(const void* tile, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}
// the K-major tile with 128-byte rows in the 128-byte swizzle
__device__ __forceinline__ uint64_t sw128_desc(const void* tile) {
  return wgmma_desc(tile, 16, 1024);
}
// the same fields in the 32-byte swizzle (layout 3): rows of 32 bytes, 8-row
// groups 256 bytes apart (256-byte aligned). K-major, a k16 step is the
// whole row: (16, 256); MN-major (16 columns of the transposed B), the
// stride is again the distance between 8-row groups along K
__device__ __forceinline__ uint64_t sw32_desc(const void* tile, uint32_t lbo, uint32_t sbo) {
  return (wgmma_desc(tile, lbo, sbo) & ~(3ull << 62)) | (3ull << 62);
}

#define HOPPER_ACC8(b) "+f"(d[b + 0]), "+f"(d[b + 1]), "+f"(d[b + 2]), "+f"(d[b + 3]), \
                       "+f"(d[b + 4]), "+f"(d[b + 5]), "+f"(d[b + 6]), "+f"(d[b + 7])
#define HOPPER_REGS32 "%0, %1, %2, %3, %4, %5, %6, %7, " \
                      "%8, %9, %10, %11, %12, %13, %14, %15, " \
                      "%16, %17, %18, %19, %20, %21, %22, %23, " \
                      "%24, %25, %26, %27, %28, %29, %30, %31"
#define HOPPER_REGS64 HOPPER_REGS32 ", " \
                      "%32, %33, %34, %35, %36, %37, %38, %39, " \
                      "%40, %41, %42, %43, %44, %45, %46, %47, " \
                      "%48, %49, %50, %51, %52, %53, %54, %55, " \
                      "%56, %57, %58, %59, %60, %61, %62, %63"

// d[40] += A (64 x 16, bf16 fragments a) * B (16 x 80, K-major shared, descriptor b)
__device__ __forceinline__ void wgmma_rs_n80(float (&d)[40], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k16.f32.bf16.bf16 {"
      HOPPER_REGS32 ", "
      "%32, %33, %34, %35, %36, %37, %38, %39"
      "}, {%40, %41, %42, %43}, %44, p, 1, 1, 0;\n}\n"
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24),
        HOPPER_ACC8(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[128] += A (64 x 16, bf16 fragments a) * B (16 x 256, K-major shared, descriptor b)
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128], const uint32_t (&a)[4],
                                              uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      HOPPER_REGS64 ", "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24),
        HOPPER_ACC8(32), HOPPER_ACC8(40), HOPPER_ACC8(48), HOPPER_ACC8(56),
        HOPPER_ACC8(64), HOPPER_ACC8(72), HOPPER_ACC8(80), HOPPER_ACC8(88),
        HOPPER_ACC8(96), HOPPER_ACC8(104), HOPPER_ACC8(112), HOPPER_ACC8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[32] (= / +=, `accumulate`) A (64 x 16, K-major shared, descriptor a)
// * B (16 x 64, K-major shared, descriptor b)
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t a, uint64_t b,
                                             int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HOPPER_REGS32
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24)
      : "l"(a), "l"(b), "r"(accumulate));
}

// d[32] += A (64 x 16, bf16 fragments a) * B (16 x 64, MN-major shared:
// the transposed B, descriptor b)
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HOPPER_REGS32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[64] += A (64 x 16, bf16 fragments a) * B (16 x 128, MN-major shared:
// the transposed B, descriptor b)
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64], const uint32_t (&a)[4],
                                                 uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOPPER_REGS64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC8(0), HOPPER_ACC8(8), HOPPER_ACC8(16), HOPPER_ACC8(24),
        HOPPER_ACC8(32), HOPPER_ACC8(40), HOPPER_ACC8(48), HOPPER_ACC8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// d[8] += A (64 x 16, bf16 fragments a) * B (16 x 16, MN-major shared: the
// transposed B, descriptor b)
__device__ __forceinline__ void wgmma_rs_n16_tb(float (&d)[8], const uint32_t (&a)[4],
                                                uint64_t b) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : HOPPER_ACC8(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

// O += P V at the head dim DP (64 or 128) with V the transposed B
template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&d)[DP / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (DP == 128) wgmma_rs_n128_tb(d, a, b);
  else wgmma_rs_n64_tb(d, a, b);
}

// d = A B^T over the head dim DP for 64 rows of A (at `a`) and 64 rows of B
// (at `b`), both K-major in 64-column chunks of 128-byte rows that lie
// AROWS * 128 and BROWS * 128 bytes apart (the rows of the tiles they are
// part of), issued as DP / 16 k16 steps, each 32 bytes further along the
// rows of a chunk: S = Q K^T in K4's forward (train_wgmma_attention.cuh)
// and in K1 / K3 (wgmma_attention.cuh), S^T = K Q^T, dP^T = V dO^T, S and
// dP in K4's backward (train_wgmma_attention_bwd.cuh)
template <int DP, int AROWS, int BROWS>
__device__ __forceinline__ void ss_scores(float (&d)[32], const unsigned char* a,
                                          const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss_n64(d, sw128_desc(a + (kk / 4) * AROWS * 128 + (kk % 4) * 32),
                 sw128_desc(b + (kk / 4) * BROWS * 128 + (kk % 4) * 32), kk > 0);
}

// cuTensorMapEncodeTiled from the CUDA driver API, looked up once through
// the runtime (null where it has none)
using TensorMapEncode = PFN_cuTensorMapEncodeTiled_v12000;
TensorMapEncode tensor_map_encoder() {
  static const TensorMapEncode fn = []() -> TensorMapEncode {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault,
                                         &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return nullptr;
    return reinterpret_cast<TensorMapEncode>(ptr);
  }();
  return fn;
}

// A tensor map of `rank` dimensions (innermost first: extents `dims`, byte
// strides of dimensions 1.. `strides`) read in boxes of `box`; elements out
// of range read 0. False where the driver refuses it.
bool tensor_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                CUtensorMapSwizzle swizzle) {
  const TensorMapEncode encode = tensor_map_encoder();
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  return encode != nullptr &&
         encode(map, type, rank, const_cast<void*>(base), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace

}  // namespace livecc
