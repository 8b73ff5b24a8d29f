// bf16 online-softmax attention on the tensor cores, shared by K1
// (flash_prefill.cu: causal, per-row offset and kv_limit, GQA) and K3
// (vit_attention.cu: bidirectional within segments given by their bounds).
//
// Replaces, for bf16 q/k/v/o: livecc_tpu/ops/pallas/attention.py:flash_prefill
// (_prefill_kernel) and livecc_tpu/ops/pallas/vit_attention.py:
// vit_group_attention (_vit_attn_kernel). fp32 stays on tile_attention.cuh;
// bf16 K1-int8 (the int8 cache) has its own tile, quant_mma_attention.cuh.
//
// What bounds it on the H100: both kernels are compute-bound at the paths'
// shapes (K3 at g = 880, H = 16, D = 80: 11.9 GFLOP against 27 MB; K1 at
// Sq = 1024, kv 690, D = 128: 6.7 GFLOP against 16 MB; both far above the
// card's ~295 FLOP/byte ridge), so the products have to run on the tensor
// cores. This design (FlashAttention-2 style, written by hand):
//
//   * a block is 4 warps over a 64-query tile (kMmaTileQ), each warp owning
//     16 query rows; key tiles are 64 long (kMmaTileK). Both are constants.
//   * Q is copied to shared memory once and held in registers as mma
//     A-fragments (ldmatrix), D / 4 registers a thread.
//   * K and V tiles stream through a double-buffered shared ring with
//     16-byte cp.async.cg (commit_group / wait_group): the next tile's copy
//     is in flight while this tile's products run. Rows past the valid keys
//     (or queries) are zero-filled by a src-size of 0, so an uninitialised
//     cache row never brings NaN into a 0 * v product.
//   * shared rows are padded by 16 bytes: a row of D bf16 is D / 8 + 1
//     16-byte chunks, an odd number for every D that is a multiple of 16,
//     so the 8 row addresses of one ldmatrix hit 8 distinct bank groups.
//   * S = Q K^T and O += P V with mma.sync.aligned.m16n8k16 (bf16 in, fp32
//     accumulate); V is read with ldmatrix.trans.
//   * scale, causal and limit masks and the online softmax run in
//     registers; the row max and sum are reduced across each 4-thread quad
//     with __shfl_xor_sync. Two adjacent n8 score tiles become one k16
//     A-fragment of P, rounded to bf16: this rounding is the TPU kernel's
//     p.astype(v.dtype), so the numerics are those of the plain versions.
//   * O stays in fp32 registers and is normalised after P V; a row that saw
//     no valid key writes exactly 0 (a masked score never becomes p > 0,
//     so the running max stays finite and exp never sees -inf - -inf).
//
// Loop bounds replace the TPU kernels' index-map clamp, as in
// tile_attention.cuh: a causal block stops at
//     kv_end = min(kv_limit[b], Skv, offset[b] + q0 + 64),
// a segment's block at its segment's end.
//
// The fragment and copy primitives and the tile's steps (Q fragments,
// S = Q K^T, the online softmax's rescale, the epilogue) are
// mma_common.cuh's, shared with K1-int8 (quant_mma_attention.cuh).
// mma.sync with cp.async is this version's design; wgmma fed by TMA, with a
// producer warp and a deeper ring, is the later redesign of this header.

#pragma once

#include <cstdint>

#include "mma_common.cuh"

namespace livecc {

constexpr int kMmaTileQ = 64;      // queries per block (16 per warp)
constexpr int kMmaTileK = 64;      // keys per tile of the ring
constexpr int kMmaThreads = 128;   // 4 warps

struct MmaParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  // causal (K1): per-row offset and kv_limit [B] on the device
  const int* offset;
  const int* kv_limit;
  // segments (K3): cu_seqlens [nseg + 1] on the device; blockIdx.z is the
  // segment, whose queries and keys are the rows [cu[z], cu[z + 1])
  const int* cu_seqlens;
  int hq, hk, sq, skv;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  float scale;
};

inline size_t mma_smem_bytes(int d) {
  return sizeof(__nv_bfloat16) * (size_t)(kMmaTileQ + 4 * kMmaTileK) * (d + kMmaPad);
}

namespace {

template <bool CAUSAL, int D>
__global__ void __launch_bounds__(kMmaThreads) mma_attention_kernel(MmaParams p) {
  static_assert(D % 16 == 0 && D <= kMaxHeadDim, "head dim: a multiple of 16 up to 128");
  constexpr int kLd = D + kMmaPad;          // shared row, in elements
  constexpr int kNt = kAttnNt;              // n8 score tiles per warp row block
  static_assert(kNt * 8 == kMmaTileK, "mma_common.cuh's tile steps take 64 keys");
  constexpr int kDt = D / 8;                // n8 output tiles
  constexpr float kLog2e = 1.4426950408889634f;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(mma_smem);   // [64][kLd]
  __nv_bfloat16* sK = sQ + kMmaTileQ * kLd;            // [2][64][kLd]
  __nv_bfloat16* sV = sK + 2 * kMmaTileK * kLd;        // [2][64][kLd]

  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;            // mma fragment row group, thread in group
  const int q0 = blockIdx.x * kMmaTileQ;
  const int h = blockIdx.y;
  const int z = blockIdx.z;

  // this block's queries [q0, sq) and keys [0, limit), bases at row 0
  int sq, limit, offset = 0;
  long long qrow0 = 0, krow0 = 0;
  if (p.cu_seqlens) {
    const int start = p.cu_seqlens[z];
    sq = p.cu_seqlens[z + 1] - start;
    limit = sq;
    qrow0 = krow0 = start;
  } else {
    sq = p.sq;
    limit = min(p.kv_limit ? p.kv_limit[z] : p.skv, p.skv);
    if (CAUSAL) offset = p.offset[z];
  }
  if (q0 >= sq) return;
  const int kv_end = CAUSAL ? min(limit, offset + q0 + kMmaTileQ) : limit;
  const int kvh = h / (p.hq / p.hk);                   // GQA: q head h reads KV head h // G
  const bool seg = p.cu_seqlens != nullptr;
  const __nv_bfloat16* qb = p.q + (seg ? 0 : z * p.q_sb) + h * p.q_sh + qrow0 * p.q_ss;
  const __nv_bfloat16* kb = p.k + (seg ? 0 : z * p.k_sb) + kvh * p.k_sh + krow0 * p.k_ss;
  const __nv_bfloat16* vb = p.v + (seg ? 0 : z * p.v_sb) + kvh * p.v_sh + krow0 * p.v_ss;
  __nv_bfloat16* ob = p.o + (seg ? 0 : z * p.o_sb) + h * p.o_sh + qrow0 * p.o_ss;

  const int n_tiles = kv_end > 0 ? (kv_end + kMmaTileK - 1) / kMmaTileK : 0;
  cp_tile<D, kMmaThreads>(sQ, qb + (long long)q0 * p.q_ss, p.q_ss, kMmaTileQ, sq - q0);
  if (n_tiles > 0) {
    cp_tile<D, kMmaThreads>(sK, kb, p.k_ss, kMmaTileK, limit);
    cp_tile<D, kMmaThreads>(sV, vb, p.v_ss, kMmaTileK, limit);
  }
  cp_async_commit();

  // online-softmax state of this thread's two rows (gid, gid + 8 of the warp's 16)
  float m[2] = {kNegInf, kNegInf};          // running max of scale * log2(e) * s
  float l[2] = {0.f, 0.f};                  // this thread's share of the running sum
  float acc[kDt][4];
#pragma unroll
  for (int j = 0; j < kDt; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
  uint32_t qf[D / 16][4];
  const float sl2 = p.scale * kLog2e;
  const int row_a = offset + q0 + warp * 16 + gid;     // query positions of the two rows
  const int row_b = row_a + 8;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kMmaTileK;
    const int buf = t & 1;
    if (t + 1 < n_tiles) {                  // the next tile's copy overlaps this tile's work
      const int nb = buf ^ 1;
      cp_tile<D, kMmaThreads>(sK + nb * kMmaTileK * kLd,
                              kb + (long long)(k0 + kMmaTileK) * p.k_ss, p.k_ss, kMmaTileK,
                              limit - k0 - kMmaTileK);
      cp_tile<D, kMmaThreads>(sV + nb * kMmaTileK * kLd,
                              vb + (long long)(k0 + kMmaTileK) * p.v_ss, p.v_ss, kMmaTileK,
                              limit - k0 - kMmaTileK);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (t == 0) load_q_fragments<D>(qf, sQ, warp, lane);   // once
    const __nv_bfloat16* tK = sK + buf * kMmaTileK * kLd;
    const __nv_bfloat16* tV = sV + buf * kMmaTileK * kLd;

    float s[kNt][4];                        // S = Q K^T: [16 rows][64 keys] of this warp
    qk_scores<D>(s, qf, tK, lane);

    // scale (in log2 units) and mask; a masked score is kNegInf and gives p = 0
    const bool edge = k0 + kMmaTileK > limit ||
                      (CAUSAL && k0 + kMmaTileK - 1 > offset + q0 + warp * 16);
    float mx[2] = {kNegInf, kNegInf};
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + j * 8 + 2 * tig + (e & 1);
        const int qpos = e < 2 ? row_a : row_b;
        const bool ok = !edge || (key < limit && (!CAUSAL || key <= qpos));
        s[j][e] = ok ? s[j][e] * sl2 : kNegInf;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      }
    }
    float alpha[2];
    softmax_max(m, l, mx, alpha);
    // p = exp(s - m), summed in fp32 before it is rounded to bf16 for P V
    uint32_t pf[kNt / 2][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
      float pv[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        pv[e] = s[j][e] == kNegInf ? 0.f : exp2f(s[j][e] - m[e >> 1]);
        l[e >> 1] += pv[e];
      }
      // n8 tiles 2i and 2i + 1 are the k16 A-fragment i: a0/a1 from 2i, a2/a3 from 2i + 1
      pf[j / 2][(j % 2) * 2 + 0] = pack_bf16(pv[0], pv[1]);
      pf[j / 2][(j % 2) * 2 + 1] = pack_bf16(pv[2], pv[3]);
    }
    rescale_acc<kDt>(acc, alpha);
    // O += P V: k16 steps over the 64 keys, two n8 output tiles per ldmatrix.x4.trans
#pragma unroll
    for (int kk = 0; kk < kNt / 2; ++kk) {
#pragma unroll
      for (int j = 0; j < kDt; j += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, tV + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kLd + j * 8 +
                                 (lane / 16) * 8);
        mma_bf16(acc[j], pf[kk], b[0], b[1]);
        mma_bf16(acc[j + 1], pf[kk], b[2], b[3]);
      }
    }
    __syncthreads();                        // all warps are done with this buffer
  }
  cp_async_wait<0>();                       // the Q copy of a block with no key tile
  store_normalised<kDt>(l, acc, ob, p.o_ss, q0 + warp * 16 + gid, sq, tig);
}

template <bool CAUSAL, int D>
int launch_mma_d(const MmaParams& p, dim3 grid, cudaStream_t stream) {
  const size_t smem = mma_smem_bytes(D);
  auto kernel = mma_attention_kernel<CAUSAL, D>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kMmaThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Launch over grid (ceil(rows / 64), Hq, n) on `stream`: n batch rows (K1)
// or segments (K3, with `rows` the longest segment). Every head dim that is
// a multiple of 16 up to 128 has an instance; any other is refused.
template <bool CAUSAL>
int launch_mma_attention(const MmaParams& p, int d, int rows, int n, cudaStream_t stream) {
  const dim3 grid((rows + kMmaTileQ - 1) / kMmaTileQ, p.hq, n);
  if (rows <= 0 || n <= 0 || p.hk <= 0 || p.hq % p.hk) return (int)cudaErrorInvalidValue;
  return with_head_dim(d, [&](auto dim) { return launch_mma_d<CAUSAL, dim()>(p, grid, stream); });
}

}  // namespace

}  // namespace livecc
