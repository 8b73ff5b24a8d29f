// K1-int8 for bf16 queries on the tensor cores: chunk queries over an int8
// KV cache with per-key bf16 scales (flash_prefill_int8.cu). fp32 queries
// (the tiny model's dtype) stay on tile_attention.cuh (QUANT); the entry
// point dispatches by the query dtype alone.
//
// Replaces, for bf16 q: the `quantized` branch of
// livecc_tpu/ops/pallas/attention.py:_prefill_kernel (:78-99), which
// flash_prefill (:114) runs when it is given k_scale/v_scale. Its numerics:
// K widened to the query dtype, s = (q.k * d^-0.5) * k_scale[key] in fp32,
// l summing p before the value scale, p * v_scale[key] kept fp32 against V
// widened to fp32, normalisation after p.v, 0 for a row with no valid key.
//
// What bounds it on the H100: compute. At the pool's tick (B = 8, Sq = 256,
// Hq = 28, D = 128, rows 0-8192 keys deep) the products are ~58 GFLOP
// against ~47 MB of int8 K/V, far above the card's ~295 FLOP/byte ridge, so
// they run on the tensor cores. The design, on mma_attention.cuh's tile (64
// queries x 64 keys, 4 warps of 16 query rows, mma.sync.m16n8k16 with bf16
// operands and fp32 accumulators), whose steps it takes from mma_common.cuh
// (Q fragments, S = Q K^T, the online softmax's rescale, the epilogue);
// what is its own:
//
//   * K and V tiles are copied as int8 (64 x D bytes each, half of bf16
//     K1's) with their 64 key and 64 value scales (128 bytes each) through
//     a ring of kQuantStages stages of 16-byte cp.async.cg
//     (commit_group / wait_group): two tiles are in flight while one is
//     used. Rows past kv_limit are zero-filled by a src-size of 0, and so
//     are the scales past it (a partial src-size for the chunk that holds
//     the limit): an uninitialised bf16 scale that is NaN never meets a
//     masked p = 0 in p * v_scale.
//   * Widening: one pass per tile turns the int8 K and V rows into bf16 in
//     shared memory, each thread reading 16 bytes and writing 32 (an int8
//     code in [-127, 127] is an integer bf16 holds exactly; the bytes go
//     into 2^23's mantissa by byte_perm and 2^23 + 128 is subtracted, so no
//     int-to-float conversion runs). The fragment code is then
//     mma_attention.cuh's, unchanged: ldmatrix for K, ldmatrix.trans for V.
//   * Padding: the int8 rows are not padded. A tile is one run of 64 x D
//     bytes and consecutive threads take consecutive 16-byte chunks, so the
//     8 threads of each phase of a 16-byte access (copy, widening read)
//     cover 128 contiguous bytes: all 32 banks once. The widened bf16 rows
//     are padded by 16 bytes (kMmaPad), so one ldmatrix hits 8 distinct
//     bank groups; the widening writes its two 16-byte halves in an order
//     that alternates every 4 threads, which keeps the 8 stores of a phase
//     on 8 distinct bank groups at D = 128 (at most two-way at smaller D).
//   * Scores: S = Q K^T in fp32, then (s * scale) * k_scale[key] in
//     registers, the scale read from the tile's scales in shared memory; the
//     online softmax runs in log2 units with quad shuffles; l sums p before
//     the value scale.
//   * P V: pv = p * v_scale[key] in fp32, split into kQuantPTerms bf16
//     parts, each the rounding of what the earlier ones left (hi = bf16(pv),
//     mid = bf16(pv - hi), lo = bf16(pv - hi - mid)), every part an mma
//     against V into the same fp32 accumulator. V is exact in bf16 and three
//     8-bit parts hold pv's 24 bits, so each product is JAX's fp32 p.v up to
//     the order of the fp32 sums. Two parts (16 bits of pv) were weighed and
//     not taken: tests/test_torch_int8_tiles.py shows them using twice the
//     share of the bf16 limit that three use against JAX.
//   * Grid (64-query tile, q head, batch row). A block stops at
//         kv_end = min(kv_limit[b], Smax, offset[b] + q0 + 64),
//     so the pool's rows walk very different numbers of key tiles (1 to 128
//     at chip_smoke's timed shape). The longest walks launch first: every
//     block ranks the rows by their deepest walk on the device (no host
//     sync), blockIdx.z is a rank, and the query tiles of a row run from the
//     last one down. __launch_bounds__(128, 2) keeps registers at or under
//     255 a thread and the shared memory (100 KB at D = 128) lets two blocks
//     share an SM.
//   * No atomics: two launches give the same bits.
//
// wgmma fed by TMA, with a producer warp and a deeper ring, is later work.

#pragma once

#include <cstdint>

#include "mma_common.cuh"

namespace livecc {

constexpr int kQuantTileQ = 64;      // queries per block (16 per warp)
constexpr int kQuantTileK = 64;      // keys per tile of the ring
constexpr int kQuantThreads = 128;   // 4 warps
constexpr int kQuantStages = 3;      // int8 tiles in the cp.async ring
constexpr int kQuantPTerms = 3;      // bf16 parts of p * v_scale: all 24 bits

struct QuantMmaParams {
  const __nv_bfloat16* q;
  const int8_t* k;
  const int8_t* v;
  const __nv_bfloat16* k_scale;      // [B, Hk, 1, Smax] lane-major, positions unit-stride
  const __nv_bfloat16* v_scale;
  __nv_bfloat16* o;
  const int* offset;                 // [B] on the device
  const int* kv_limit;
  int batch, hq, hk, sq, skv;
  long long q_sb, q_sh, q_ss;        // strides in elements (bytes for the int8 k, v)
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long ks_sb, ks_sh, vs_sb, vs_sh;
  float scale;
};

// Q, widened K and widened V (bf16, padded rows), then the ring's stages:
// int8 K, int8 V, 64 key scales, 64 value scales.
inline size_t quant_stage_bytes(int d) { return (size_t)2 * kQuantTileK * d + 4 * kQuantTileK; }
inline size_t quant_mma_smem_bytes(int d) {
  return sizeof(__nv_bfloat16) * 3 * kQuantTileQ * (size_t)(d + kMmaPad) +
         kQuantStages * quant_stage_bytes(d);
}

namespace {

// Copy one int8 tile of 64 rows of D bytes (row stride `stride` bytes) into
// an unpadded shared tile; rows at or past `valid` are zero-filled.
template <int D>
__device__ __forceinline__ void cp_int8_tile(int8_t* dst, const int8_t* src, long long stride,
                                             int valid) {
  constexpr int kChunks = D / 16;           // 16-byte chunks per row
  for (int c = threadIdx.x; c < kQuantTileK * kChunks; c += kQuantThreads) {
    const int r = c / kChunks, col = (c % kChunks) * 16;
    const bool ok = r < valid;
    cp_async16(dst + c * 16, ok ? src + r * stride + col : src, ok);
  }
}

// Widen an unpadded int8 tile [64][D] into a padded bf16 tile [64][D + kMmaPad].
template <int D>
__device__ __forceinline__ void widen_tile(__nv_bfloat16* dst, const int8_t* src) {
  constexpr int kChunks = D / 16;
  constexpr int kLd = D + kMmaPad;
  const bool swap = (threadIdx.x >> 2) & 1;
  for (int c = threadIdx.x; c < kQuantTileK * kChunks; c += kQuantThreads) {
    const uint4 w = reinterpret_cast<const uint4*>(src)[c];
    uint4 lo, hi;                           // bf16 of bytes 0-7 and 8-15
    int8x4_to_bf16(w.x, lo.x, lo.y);
    int8x4_to_bf16(w.y, lo.z, lo.w);
    int8x4_to_bf16(w.z, hi.x, hi.y);
    int8x4_to_bf16(w.w, hi.z, hi.w);
    uint4* out = reinterpret_cast<uint4*>(dst + (c / kChunks) * kLd + (c % kChunks) * 16);
    if (swap) {
      out[1] = hi;
      out[0] = lo;
    } else {
      out[0] = lo;
      out[1] = hi;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kQuantThreads, 2) quant_mma_attention_kernel(QuantMmaParams p) {
  static_assert(D % 16 == 0 && D <= kMaxHeadDim, "head dim: a multiple of 16 up to 128");
  constexpr int kLd = D + kMmaPad;          // widened shared row, in elements
  constexpr int kNt = kAttnNt;              // n8 score tiles per warp row block
  static_assert(kNt * 8 == kQuantTileK, "mma_common.cuh's tile steps take 64 keys");
  constexpr int kDt = D / 8;                // n8 output tiles
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char quant_smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(quant_smem);   // [64][kLd]
  __nv_bfloat16* sK = sQ + kQuantTileQ * kLd;                         // widened [64][kLd]
  __nv_bfloat16* sV = sK + kQuantTileK * kLd;
  unsigned char* ring = reinterpret_cast<unsigned char*>(sV + kQuantTileK * kLd);
  constexpr int kStage = 2 * kQuantTileK * D + 4 * kQuantTileK;       // quant_stage_bytes
  __shared__ int block_row;

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;  // mma fragment row group, thread in group
  const int q0 = (gridDim.x - 1 - blockIdx.x) * kQuantTileQ;   // a row's last query tile first
  const int h = blockIdx.y;

  // blockIdx.z is a rank: rank 0 is the row with the deepest walk (ties by index)
  for (int i = tid; i < p.batch; i += kQuantThreads) {
    const int walk = min(min(p.kv_limit[i], p.skv), p.offset[i] + p.sq);
    int rank = 0;
    for (int j = 0; j < p.batch; ++j) {
      const int wj = min(min(p.kv_limit[j], p.skv), p.offset[j] + p.sq);
      rank += wj > walk || (wj == walk && j < i);
    }
    if (rank == (int)blockIdx.z) block_row = i;
  }
  __syncthreads();
  const int z = block_row;
  const int limit = min(p.kv_limit[z], p.skv);
  const int offset = p.offset[z];
  const int kv_end = min(limit, offset + q0 + kQuantTileQ);
  const int kvh = h / (p.hq / p.hk);        // GQA: q head h reads KV head h // G
  const __nv_bfloat16* qb = p.q + z * p.q_sb + h * p.q_sh;
  const int8_t* kb = p.k + z * p.k_sb + kvh * p.k_sh;
  const int8_t* vb = p.v + z * p.v_sb + kvh * p.v_sh;
  const __nv_bfloat16* ksb = p.k_scale + z * p.ks_sb + kvh * p.ks_sh;
  const __nv_bfloat16* vsb = p.v_scale + z * p.vs_sb + kvh * p.vs_sh;
  __nv_bfloat16* ob = p.o + z * p.o_sb + h * p.o_sh;

  const int n_tiles = kv_end > 0 ? (kv_end + kQuantTileK - 1) / kQuantTileK : 0;
  // tile t into its stage: int8 K and V rows, then 8 chunks of key scales
  // (threads 0-7) and of value scales (8-15), zero past the limit
  auto load_tile = [&](int t) {
    unsigned char* st = ring + (t % kQuantStages) * kStage;
    const int k0 = t * kQuantTileK, valid = limit - k0;
    cp_int8_tile<D>(reinterpret_cast<int8_t*>(st), kb + k0 * p.k_ss, p.k_ss, valid);
    cp_int8_tile<D>(reinterpret_cast<int8_t*>(st + kQuantTileK * D), vb + k0 * p.v_ss, p.v_ss,
                    valid);
    if (tid < 16) {
      const int c = tid % 8;
      const __nv_bfloat16* src = (tid < 8 ? ksb : vsb) + k0;
      const int bytes = max(0, min(16, 2 * (valid - 8 * c)));
      cp_async16_n(st + 2 * kQuantTileK * D + (tid / 8) * 2 * kQuantTileK + 16 * c,
                   bytes > 0 ? src + 8 * c : src, bytes);
    }
  };
  cp_tile<D, kQuantThreads>(sQ, qb + (long long)q0 * p.q_ss, p.q_ss, kQuantTileQ, p.sq - q0);
#pragma unroll
  for (int t = 0; t < kQuantStages - 1; ++t) {   // group t holds tile t (group 0 also Q)
    if (t < n_tiles) load_tile(t);
    cp_async_commit();
  }

  // online-softmax state of this thread's two rows (gid, gid + 8 of the warp's 16)
  float m[2] = {kNegInf, kNegInf};          // running max of log2(e) * s
  float l[2] = {0.f, 0.f};                  // this thread's share of the running sum
  float acc[kDt][4];
#pragma unroll
  for (int j = 0; j < kDt; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  uint32_t qf[D / 16][4];
  const int row_a = offset + q0 + warp * 16 + gid;     // query positions of the two rows
  const int row_b = row_a + 8;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kQuantTileK;
    cp_async_wait<kQuantStages - 2>();      // tile t has landed
    __syncthreads();                        // ... for every thread; tile t - 1's stage is free
    if (t + kQuantStages - 1 < n_tiles) load_tile(t + kQuantStages - 1);
    cp_async_commit();
    if (t == 0) load_q_fragments<D>(qf, sQ, warp, lane);   // once
    const unsigned char* st = ring + (t % kQuantStages) * kStage;
    widen_tile<D>(sK, reinterpret_cast<const int8_t*>(st));
    widen_tile<D>(sV, reinterpret_cast<const int8_t*>(st + kQuantTileK * D));
    const __nv_bfloat16* sKs = reinterpret_cast<const __nv_bfloat16*>(st + 2 * kQuantTileK * D);
    const __nv_bfloat16* sVs = sKs + kQuantTileK;
    __syncthreads();

    float s[kNt][4];                        // S = Q K^T: [16 rows][64 keys] of this warp
    qk_scores<D>(s, qf, sK, lane);

    // (s * scale) * k_scale, in log2 units, and the masks; a masked score
    // is kNegInf and gives p = 0
    const bool edge = k0 + kQuantTileK > limit || k0 + kQuantTileK - 1 > offset + q0 + warp * 16;
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      const float2 ks = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(sKs + j * 8 + 2 * tig));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * tig + (e & 1);
        const int qpos = e < 2 ? row_a : row_b;
        const bool ok = !edge || (key < limit && key <= qpos);
        s[j][e] = ok ? (s[j][e] * p.scale) * (e & 1 ? ks.y : ks.x) * kLog2e : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
    softmax_max(m, l, mx, alpha);
    // p = exp(s - m), summed into l, then scaled by the key's value scale
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      const float2 vs = __bfloat1622float2(
          *reinterpret_cast<const __nv_bfloat162*>(sVs + j * 8 + 2 * tig));
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = s[j][e] == kNegInf ? 0.f : exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += pe;
        s[j][e] = pe * (e & 1 ? vs.y : vs.x);
      }
    }
    rescale_acc<kDt>(acc, alpha);
    // O += (p * v_scale) V, the fp32 factor as kQuantPTerms bf16 parts
#pragma unroll
    for (int kk = 0; kk < kNt / 2; ++kk) {
      uint32_t pt[kQuantPTerms][4];
#pragma unroll
      for (int u = 0; u < 2; ++u) {         // n8 tiles 2 kk (a0, a1) and 2 kk + 1 (a2, a3)
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          float p0 = s[2 * kk + u][2 * r], p1 = s[2 * kk + u][2 * r + 1];
#pragma unroll
          for (int term = 0; term < kQuantPTerms; ++term) {   // each part rounds what is left
            const __nv_bfloat162 b2 = __floats2bfloat162_rn(p0, p1);
            pt[term][2 * u + r] = *reinterpret_cast<const uint32_t*>(&b2);
            p0 -= __low2float(b2);
            p1 -= __high2float(b2);
          }
        }
      }
#pragma unroll
      for (int j = 0; j < kDt; j += 2) {
        uint32_t bv[4];
        ldmatrix_x4_trans(bv, sV + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kLd + j * 8 +
                                  (lane / 16) * 8);
#pragma unroll
        for (int term = 0; term < kQuantPTerms; ++term) {
          mma_bf16(acc[j], pt[term], bv[0], bv[1]);
          mma_bf16(acc[j + 1], pt[term], bv[2], bv[3]);
        }
      }
    }
    __syncthreads();                        // all warps are done with sK, sV and this stage
  }
  cp_async_wait<0>();                       // the copies of a block with no key tile
  store_normalised<kDt>(l, acc, ob, p.o_ss, q0 + warp * 16 + gid, p.sq, tig);
}

template <int D>
int launch_quant_mma_d(const QuantMmaParams& p, dim3 grid, cudaStream_t stream) {
  const size_t smem = quant_mma_smem_bytes(D);
  auto kernel = quant_mma_attention_kernel<D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kQuantThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Launch over grid (ceil(Sq / 64), Hq, B) on `stream`. Refused (an error,
// nothing launched): a head dim that is not a multiple of 16 up to 128, and
// rows that 16-byte copies cannot take: q, o and the scales need 16-byte
// aligned bases and strides that are multiples of 8 elements, int8 K/V 16-byte
// aligned bases and strides that are multiples of 16 bytes (the stride of a
// dim of one entry is never used and not checked).
inline int launch_quant_mma_attention(const QuantMmaParams& p, int d, cudaStream_t stream) {
  const int b = p.batch, hq = p.hq, hk = p.hk;
  const struct { long long stride; int n, unit; } strides[] = {
      {p.q_sb, b, 8}, {p.q_sh, hq, 8}, {p.q_ss, p.sq, 8},
      {p.o_sb, b, 8}, {p.o_sh, hq, 8}, {p.o_ss, p.sq, 8},
      {p.k_sb, b, 16}, {p.k_sh, hk, 16}, {p.k_ss, p.skv, 16},
      {p.v_sb, b, 16}, {p.v_sh, hk, 16}, {p.v_ss, p.skv, 16},
      {p.ks_sb, b, 8}, {p.ks_sh, hk, 8}, {p.vs_sb, b, 8}, {p.vs_sh, hk, 8}};
  bool ok = b > 0 && p.sq > 0 && hk > 0 && hq % hk == 0;
  for (const auto& s : strides) ok = ok && (s.n <= 1 || s.stride % s.unit == 0);
  const void* bases[] = {p.q, p.k, p.v, p.k_scale, p.v_scale, p.o};
  for (const void* ptr : bases) ok = ok && reinterpret_cast<uintptr_t>(ptr) % 16 == 0;
  if (!ok) return (int)cudaErrorInvalidValue;
  const dim3 grid((p.sq + kQuantTileQ - 1) / kQuantTileQ, p.hq, p.batch);
  return with_head_dim(d, [&](auto dim) { return launch_quant_mma_d<dim()>(p, grid, stream); });
}

}  // namespace

}  // namespace livecc
