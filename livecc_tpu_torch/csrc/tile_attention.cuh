// One online-softmax attention kernel over 64-query tiles on the fp32 FMA
// pipes: the fp32 instances of K1 (flash_prefill.cu), K3
// (vit_attention.cu) and K1-int8 (flash_prefill_int8.cu: QUANT, int8 K/V
// with per-key bf16 scales). bf16 K1 and K3 run on the tensor cores instead
// (mma_attention.cuh), and so does bf16 K1-int8 (quant_mma_attention.cuh).
//
// Block = (64-query tile, q head, batch row or segment); 128 threads.
// The block walks key tiles of 64 in order: this loop takes the place of the
// TPU kernels' sequential kv grid axis, and its bound
//     kv_end = min(kv_limit[b], Skv, offset[b] + q0 + 64)   (causal)
//     kv_end = the segment's length                        (bidirectional)
// replaces their index-map clamp: tiles past the causal or valid frontier are
// never read. Each thread owns a 4x8 tile of the [64, 64] score block and a
// 4 x (D/8) tile of the [64, D] fp32 accumulator; Q, K and V tiles sit in
// shared memory as fp32 with an odd row stride (D + 1) so the column walks of
// the two products hit distinct banks.
//
// Strides are in elements and the head dim must be unit-stride, so q in
// [B, S, H, D] memory is read through its [B, H, S, D] view without a copy.
// With cu_seqlens (K3), blockIdx.z is a segment whose queries and keys are
// the rows [cu[z], cu[z + 1]), the batch strides unused.
//
// QUANT (the TPU kernel's `quantized` branch, attention.py:78-99): K/V tiles
// are read from device memory as int8 (half the bytes of bf16) and widened
// exactly to fp32 in shared memory; each key tile's lane-major scales
// (positions unit-stride) sit beside it. Scores are (q.k * scale) * k_scale,
// the running sum l takes p before the value scale, and p * v_scale stays
// fp32 for the p.v product (V is fp32 in that branch, so p is not rounded).

#pragma once

#include "attn_common.cuh"

namespace livecc {

struct TileParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* offset;     // [B] device int32, or nullptr (bidirectional)
  const int* kv_limit;   // [B] device int32, or nullptr (= Skv)
  const __nv_bfloat16* k_scale;   // QUANT: [B, Hk, 1, Skv] lane-major scales
  const __nv_bfloat16* v_scale;
  const int* cu_seqlens;          // [nseg + 1] device int32 segment bounds, or nullptr
  int hq, hk, sq, skv, d;
  long long q_sb, q_sh, q_ss;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh, o_ss;
  long long ks_sb, ks_sh, vs_sb, vs_sh;
  float scale;
};

constexpr int kTileQ = 64;
constexpr int kTileK = 64;
constexpr int kTileThreads = 128;

inline size_t tile_smem_bytes(int d) {
  const int ld = d + 1;
  return sizeof(float) *
         (size_t)((kTileQ + 2 * kTileK) * ld + kTileQ * (kTileK + 1) + 3 * kTileQ + 2 * kTileK);
}

namespace {

template <typename T, bool CAUSAL, bool QUANT>
__global__ void __launch_bounds__(kTileThreads) tile_attention_kernel(TileParams p) {
  using KV = typename std::conditional<QUANT, int8_t, T>::type;
  extern __shared__ float smem[];
  const int d = p.d;
  const int ld = d + 1;
  float* sQ = smem;                         // [64][ld]
  float* sK = sQ + kTileQ * ld;             // [64][ld]
  float* sV = sK + kTileK * ld;             // [64][ld]
  float* sS = sV + kTileK * ld;             // [64][65] scores, then probabilities
  float* sM = sS + kTileQ * (kTileK + 1);   // [64] running max
  float* sL = sM + kTileQ;                  // [64] running sum
  float* sAlpha = sL + kTileQ;              // [64] rescale of this step
  float* sKs = sAlpha + kTileQ;             // [64] QUANT: this tile's key scales
  float* sVs = sKs + kTileK;                // [64] QUANT: this tile's value scales

  const int tid = threadIdx.x;
  const int tx = tid % 8;                   // column group: cols/dims tx + 8j
  const int ty = tid / 8;                   // row group: rows 4ty .. 4ty+3
  const int q0 = blockIdx.x * kTileQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.hq / p.hk);        // GQA: q head h reads KV head h // G
  const int nd = d / 8;

  const int offset = CAUSAL ? p.offset[b] : 0;
  int sq = p.sq, limit = p.kv_limit ? p.kv_limit[b] : p.skv;
  limit = min(limit, p.skv);
  long long bq = b * p.q_sb, bk = b * p.k_sb, bv = b * p.v_sb, bo = b * p.o_sb;
  if (p.cu_seqlens) {                       // segment b: rows [start, start + sq)
    const long long start = p.cu_seqlens[b];
    sq = limit = p.cu_seqlens[b + 1] - (int)start;
    bq = start * p.q_ss;
    bk = start * p.k_ss;
    bv = start * p.v_ss;
    bo = start * p.o_ss;
    if (q0 >= sq) return;
  }
  int kv_end = limit;
  if (CAUSAL) kv_end = min(kv_end, offset + q0 + kTileQ);

  const T* qb = static_cast<const T*>(p.q) + bq + h * p.q_sh;
  const KV* kb = static_cast<const KV*>(p.k) + bk + kvh * p.k_sh;
  const KV* vb = static_cast<const KV*>(p.v) + bv + kvh * p.v_sh;
  const __nv_bfloat16* ksb = QUANT ? p.k_scale + b * p.ks_sb + kvh * p.ks_sh : nullptr;
  const __nv_bfloat16* vsb = QUANT ? p.v_scale + b * p.vs_sb + kvh * p.vs_sh : nullptr;
  T* ob = static_cast<T*>(p.o) + bo + h * p.o_sh;

  load_tile(sQ, ld, qb + (long long)q0 * p.q_ss, p.q_ss, 0, kTileQ, sq - q0, d);
  if (tid < kTileQ) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  float acc[4][kMaxHeadDim / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxHeadDim / 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < kv_end; k0 += kTileK) {
    __syncthreads();   // the previous step is done with sK, sV, sS
    load_tile(sK, ld, kb + (long long)k0 * p.k_ss, p.k_ss, 0, kTileK, limit - k0, d);
    load_tile(sV, ld, vb + (long long)k0 * p.v_ss, p.v_ss, 0, kTileK, limit - k0, d);
    if (QUANT) {
      load_scales(sKs, ksb + k0, kTileK, limit - k0);
      load_scales(sVs, vsb + k0, kTileK, limit - k0);
    }
    __syncthreads();

    // S = scale * Q K^T on this thread's 4x8 tile, masked
    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qa[4], ka[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(ty * 4 + i) * ld + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) ka[j] = sK[(tx + 8 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qa[i], ka[j], s[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
      const int qpos = offset + q0 + r;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx + 8 * j;
        const int kpos = k0 + col;
        const bool ok = kpos < limit && (!CAUSAL || kpos <= qpos);
        const float sc = QUANT ? (s[i][j] * p.scale) * sKs[col] : s[i][j] * p.scale;
        sS[r * (kTileK + 1) + col] = ok ? sc : kNegInf;
      }
    }
    __syncthreads();

    // online softmax: two neighbouring threads per row, 32 columns each
    {
      const int r = tid / 2;
      const int half = tid % 2;
      float* row = sS + r * (kTileK + 1) + half * (kTileK / 2);
      float mx = kNegInf;
      for (int c = 0; c < kTileK / 2; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = 0; c < kTileK / 2; ++c) {
        const float sv = row[c];
        const float pv = sv == kNegInf ? 0.f : expf(sv - m_new);
        sum += pv;
        row[c] = QUANT ? pv * sVs[half * (kTileK / 2) + c] : round_to<T>(pv);
      }
      sum += __shfl_xor_sync(0xffffffffu, sum, 1);
      __syncwarp();
      if (half == 0) {
        const float alpha = expf(m_prev - m_new);
        sL[r] = sL[r] * alpha + sum;
        sM[r] = m_new;
        sAlpha[r] = alpha;
      }
    }
    __syncthreads();

    // O = alpha * O + P V on this thread's 4 x (D/8) tile
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sAlpha[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < kMaxHeadDim / 8; ++j) acc[i][j] *= a;
    }
    for (int c = 0; c < kTileK; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = sS[(ty * 4 + i) * (kTileK + 1) + c];
#pragma unroll
      for (int j = 0; j < kMaxHeadDim / 8; ++j) {
        if (j < nd) {
          const float vv = sV[c * ld + tx + 8 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pr[i], vv, acc[i][j]);
        }
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= sq) continue;
    const float l = sL[r];
    const float safe = l > 0.f ? l : 1.f;
    T* orow = ob + (long long)(q0 + r) * p.o_ss;
#pragma unroll
    for (int j = 0; j < kMaxHeadDim / 8; ++j)
      if (j < nd) orow[tx + 8 * j] = from_f<T>(acc[i][j] / safe);
  }
}

// Launch over grid (ceil(Sq / 64), Hq, n_batch) on `stream` (with
// cu_seqlens: Sq the longest segment, n_batch the segments); returns
// cudaGetLastError() so a refused launch is reported, not lost.
template <typename T, bool CAUSAL, bool QUANT = false>
int launch_tile_attention(const TileParams& p, int n_batch, cudaStream_t stream) {
  const size_t smem = tile_smem_bytes(p.d);
  auto kernel = tile_attention_kernel<T, CAUSAL, QUANT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p.sq + kTileQ - 1) / kTileQ, p.hq, n_batch);
  kernel<<<grid, kTileThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Fill TileParams for the prefill entry points (K1 and K1-int8); `strides`
// holds q, k, v, o as (b, h, s) and, for QUANT, the scales' (b, h) of k then
// v. Returns false for shapes the kernel does not take.
inline bool prefill_params(TileParams& p, const void* q, const void* k, const void* v,
                           const void* k_scale, const void* v_scale, void* o,
                           const int* offset, const int* kv_limit, int hq, int hk, int sq,
                           int skv, int d, const long long* strides, float scale, bool quant) {
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.offset = offset;
  p.kv_limit = kv_limit;
  p.k_scale = static_cast<const __nv_bfloat16*>(k_scale);
  p.v_scale = static_cast<const __nv_bfloat16*>(v_scale);
  p.cu_seqlens = nullptr;
  p.hq = hq;
  p.hk = hk;
  p.sq = sq;
  p.skv = skv;
  p.d = d;
  p.q_sb = strides[0];  p.q_sh = strides[1];  p.q_ss = strides[2];
  p.k_sb = strides[3];  p.k_sh = strides[4];  p.k_ss = strides[5];
  p.v_sb = strides[6];  p.v_sh = strides[7];  p.v_ss = strides[8];
  p.o_sb = strides[9];  p.o_sh = strides[10]; p.o_ss = strides[11];
  p.ks_sb = quant ? strides[12] : 0;  p.ks_sh = quant ? strides[13] : 0;
  p.vs_sb = quant ? strides[14] : 0;  p.vs_sh = quant ? strides[15] : 0;
  p.scale = scale;
  return d > 0 && d <= kMaxHeadDim && d % 8 == 0 && hk > 0 && hq % hk == 0 && sq > 0;
}

}  // namespace

}  // namespace livecc
