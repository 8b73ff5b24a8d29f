// Fragment and copy primitives of the mma.sync attention kernel of bf16
// K1-int8 (quant_mma_attention.cuh) and of the W8A16 GEMM w8a16_gemm.cu
// (K5); the wgmma kernels (K4's train_wgmma_attention*.cuh, bf16 K1's and
// K3's wgmma_attention.cuh) take smem_addr, pack_bf16, softmax_max and
// with_head_dim: 16-byte cp.async copies into padded shared rows, ldmatrix,
// mma.sync.aligned.m16n8k16 with bf16 operands and an fp32 accumulator, the
// exact widening of int8 codes to bf16; and the steps of K1-int8's 64-query
// x 64-key online-softmax tile (Q fragments, S = Q K^T, the running max and
// the rescale, the normalising epilogue).
//
// Fragment layout of m16n8k16 (PTX ISA, "Matrix Fragments for mma.m16n8k16"),
// for lane = 4 * gid + tig: the accumulator c[0..1] holds row gid, columns
// 2 tig and 2 tig + 1, c[2..3] row gid + 8; the A fragment a[0] holds row
// gid, columns 2 tig .. +1, a[1] row gid + 8, a[2] and a[3] the same rows at
// columns + 8. So two adjacent n8 accumulator tiles are one k16 A fragment:
// a product's output feeds the next product from registers.

#pragma once

#include <cstdint>
#include <type_traits>

#include "attn_common.cuh"

namespace livecc {

constexpr int kMmaPad = 8;         // bf16 elements of padding per shared row (16 bytes)

namespace {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared, of which the first `bytes` (0-16) are
// copied and the rest zero-filled
__device__ __forceinline__ void cp_async16_n(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(bytes));
}
// 16 bytes from global to shared, zero-filled where `valid` is false
__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool valid) {
  cp_async16_n(dst, src, valid ? 16 : 0);
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

// four int8 codes (K1-int8's K/V tiles, K5's weight tiles) (one word, code 0 in the low byte) -> four bf16, exactly:
// lo holds codes 0 and 1, hi codes 2 and 3 (the lower code in the low half)
__device__ __forceinline__ void int8x4_to_bf16(uint32_t w, uint32_t& lo, uint32_t& hi) {
  const uint32_t u = w ^ 0x80808080u;       // code + 128, unsigned
  float f[4];
#pragma unroll
  for (int i = 0; i < 4; ++i)               // 2^23 + byte i, less 2^23 + 128
    f[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - 8388736.f;
  // the integers are exact in bf16, so bf16 is each float's upper half
  lo = __byte_perm(__float_as_uint(f[0]), __float_as_uint(f[1]), 0x7632);
  hi = __byte_perm(__float_as_uint(f[2]), __float_as_uint(f[3]), 0x7632);
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


// The online-softmax tile of K1-int8: a warp owns 16 query rows
// of a 64-query block, and a thread the two rows gid and gid + 8 of them
// (kAttnNt n8 score tiles over a 64-key tile, D / 8 output tiles).
constexpr int kAttnNt = 8;

// Warp `warp`'s 16 Q rows of the block's padded shared Q tile (rows of D
// bf16) as k16 A-fragments, D / 4 registers a thread.
template <int D>
__device__ __forceinline__ void load_q_fragments(uint32_t (&qf)[D / 16][4],
                                                 const __nv_bfloat16* sQ, int warp, int lane) {
  constexpr int kLd = D + kMmaPad;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    ldmatrix_x4(qf[kk], sQ + (warp * 16 + lane % 16) * kLd + kk * 16 + (lane / 16) * 8);
}

// s = Q K^T over a 64-key tile (a padded shared tile of 64 rows of D bf16):
// [16 rows][64 keys] of this warp in fp32, two n8 key tiles per ldmatrix.x4.
template <int D>
__device__ __forceinline__ void qk_scores(float (&s)[kAttnNt][4], const uint32_t (&qf)[D / 16][4],
                                          const __nv_bfloat16* tK, int lane) {
  constexpr int kLd = D + kMmaPad;
#pragma unroll
  for (int j = 0; j < kAttnNt; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
    for (int j = 0; j < kAttnNt; j += 2) {
      uint32_t b[4];
      ldmatrix_x4(b, tK + (j * 8 + lane % 8 + (lane / 16) * 8) * kLd + kk * 16 +
                         ((lane / 8) % 2) * 8);
      mma_bf16(s[j], qf[kk], b[0], b[1]);
      mma_bf16(s[j + 1], qf[kk], b[2], b[3]);
    }
  }
}

// The tile's row maxima `mx` (log2 units, this thread's share) reduced over
// the quad; the running max m moves to them and l is rescaled by alpha =
// exp2(m_old - m_new), which rescale_acc then applies to the accumulator.
// Both are finite (kNegInf while a row has seen no key), so alpha is 1 until
// a real score arrives.
__device__ __forceinline__ void softmax_max(float (&m)[2], float (&l)[2], float (&mx)[2],
                                            float (&alpha)[2]) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = exp2f(m[r] - m_new);
    m[r] = m_new;
    l[r] *= alpha[r];
  }
}

template <int DT>
__device__ __forceinline__ void rescale_acc(float (&acc)[DT][4], const float (&alpha)[2]) {
#pragma unroll
  for (int j = 0; j < DT; ++j) {
    acc[j][0] *= alpha[0];
    acc[j][1] *= alpha[0];
    acc[j][2] *= alpha[1];
    acc[j][3] *= alpha[1];
  }
}

// Normalise after P V and write this thread's two rows (`row0` and row0 + 8
// of the output, row stride `ss` elements) as bf16, rows at or past `rows`
// skipped; l is summed over the quad first. A row with no valid key (l = 0,
// and then acc = 0) writes exactly 0.
template <int DT>
__device__ __forceinline__ void store_normalised(float (&l)[2], const float (&acc)[DT][4],
                                                 __nv_bfloat16* ob, long long ss, int row0,
                                                 int rows, int tig) {
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = row0 + 8 * r;
    if (row >= rows) continue;
    const float safe = l[r] > 0.f ? l[r] : 1.f;
    __nv_bfloat16* orow = ob + (long long)row * ss + 2 * tig;
#pragma unroll
    for (int j = 0; j < DT; ++j) {
      const __nv_bfloat162 v2 =
          __floats2bfloat162_rn(acc[j][2 * r] / safe, acc[j][2 * r + 1] / safe);
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) = v2;
    }
  }
}

// f(std::integral_constant<int, D>()) for the head dims that have an
// instance, the multiples of 16 up to 128; any other is refused.
template <typename F>
int with_head_dim(int d, F&& f) {
  switch (d) {
    case 16: return f(std::integral_constant<int, 16>());
    case 32: return f(std::integral_constant<int, 32>());
    case 48: return f(std::integral_constant<int, 48>());
    case 64: return f(std::integral_constant<int, 64>());
    case 80: return f(std::integral_constant<int, 80>());
    case 96: return f(std::integral_constant<int, 96>());
    case 112: return f(std::integral_constant<int, 112>());
    case 128: return f(std::integral_constant<int, 128>());
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

}  // namespace livecc
