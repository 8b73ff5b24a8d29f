// Fragment and copy primitives of the bf16 tensor-core attention kernels,
// shared by mma_attention.cuh (K1, K3) and train_mma_attention.cuh (K4):
// 16-byte cp.async copies into padded shared rows, ldmatrix, and
// mma.sync.aligned.m16n8k16 with bf16 operands and an fp32 accumulator.
//
// Fragment layout of m16n8k16 (PTX ISA, "Matrix Fragments for mma.m16n8k16"),
// for lane = 4 * gid + tig: the accumulator c[0..1] holds row gid, columns
// 2 tig and 2 tig + 1, c[2..3] row gid + 8; the A fragment a[0] holds row
// gid, columns 2 tig .. +1, a[1] row gid + 8, a[2] and a[3] the same rows at
// columns + 8. So two adjacent n8 accumulator tiles are one k16 A fragment:
// a product's output feeds the next product from registers.

#pragma once

#include <cstdint>

#include "attn_common.cuh"

namespace livecc {

constexpr int kMmaPad = 8;         // bf16 elements of padding per shared row (16 bytes)

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, zero-filled where `valid` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n"); }
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(smem_addr(p)));
}

// c += a (16x16, row) * b (16x8, col); bf16 in, fp32 accumulate
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);   // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Copy `rows` rows of D bf16 (row stride `stride` elements) into a padded
// shared tile, the block's THREADS threads sharing the 16-byte chunks; rows
// at or past `valid` are zero-filled and never read.
template <int D, int THREADS>
__device__ __forceinline__ void cp_tile(__nv_bfloat16* dst, const __nv_bfloat16* src,
                                        long long stride, int rows, int valid) {
  constexpr int kChunks = D / 8;            // 16-byte chunks per row
  constexpr int kLd = D + kMmaPad;
  for (int c = threadIdx.x; c < rows * kChunks; c += THREADS) {
    const int r = c / kChunks, col = (c % kChunks) * 8;
    const bool ok = r < valid;
    cp_async16(dst + r * kLd + col, ok ? src + r * stride + col : src, ok);
  }
}

}  // namespace

}  // namespace livecc
