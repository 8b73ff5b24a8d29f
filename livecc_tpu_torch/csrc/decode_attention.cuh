// One-token GQA decode attention over the KV cache, shared by K2
// (flash_decode.cu) and its int8 variant (flash_decode_int8.cu: QUANT).
//
// Block = (KV head, batch row); 128 threads. The G = Hq / Hk query heads of
// one KV head are grouped in one block, as the TPU kernel grouped them into
// a [G, D] x [bk, D] product, so each K/V row is read once for all G heads.
// G need not be a power of two (7 for the 7B). The block walks key tiles of
// 64 up to kv_limit[b] (read on the device, no host sync). A row with no
// valid key outputs 0.
//
// QUANT (the TPU kernel's `quantized` branch, attention.py:220-238): K/V
// tiles are read as int8 and widened exactly to fp32 in shared memory, the
// tile's lane-major bf16 scales beside them; scores are (q.k * scale) *
// k_scale, l sums p before the value scale, and p * v_scale stays fp32 for
// the p.v product.

#pragma once

#include "attn_common.cuh"

namespace livecc {
namespace {

constexpr int kDecTileK = 64;
constexpr int kDecThreads = 128;
constexpr int kDecMaxOut = 2048;   // G * D per block: G <= 16 at D = 128
constexpr int kDecPerThread = kDecMaxOut / kDecThreads;

struct DecodeParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* kv_limit;
  const __nv_bfloat16* k_scale;   // QUANT: [B, Hk, 1, Skv] lane-major scales
  const __nv_bfloat16* v_scale;
  int hq, hk, skv, d;
  long long q_sb, q_sh;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh;
  long long ks_sb, ks_sh, vs_sb, vs_sh;
  float scale;
};

inline size_t decode_smem_bytes(int groups, int d) {
  const int ld = d + 1;
  return sizeof(float) * (size_t)(groups * ld + 2 * kDecTileK * ld + groups * (kDecTileK + 1) +
                                  3 * groups + 2 * kDecTileK);
}

template <typename T, bool QUANT>
__global__ void __launch_bounds__(kDecThreads) decode_kernel(DecodeParams p) {
  using KV = typename std::conditional<QUANT, int8_t, T>::type;
  extern __shared__ float smem[];
  const int d = p.d;
  const int ld = d + 1;
  const int G = p.hq / p.hk;
  float* sQ = smem;                          // [G][ld]
  float* sK = sQ + G * ld;                   // [64][ld]
  float* sV = sK + kDecTileK * ld;           // [64][ld]
  float* sS = sV + kDecTileK * ld;           // [G][65]
  float* sM = sS + G * (kDecTileK + 1);      // [G]
  float* sL = sM + G;                        // [G]
  float* sAlpha = sL + G;                    // [G]
  float* sKs = sAlpha + G;                   // [64] QUANT: this tile's key scales
  float* sVs = sKs + kDecTileK;              // [64] QUANT: this tile's value scales

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int limit = min(p.kv_limit[b], p.skv);

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + (long long)kvh * G * p.q_sh;
  const KV* kb = static_cast<const KV*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const KV* vb = static_cast<const KV*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const __nv_bfloat16* ksb = QUANT ? p.k_scale + b * p.ks_sb + kvh * p.ks_sh : nullptr;
  const __nv_bfloat16* vsb = QUANT ? p.v_scale + b * p.vs_sb + kvh * p.vs_sh : nullptr;
  T* ob = static_cast<T*>(p.o) + b * p.o_sb + (long long)kvh * G * p.o_sh;

  load_tile(sQ, ld, qb, p.q_sh, 0, G, G, d);
  if (tid < G) {
    sM[tid] = kNegInf;
    sL[tid] = 0.f;
  }
  float acc[kDecPerThread];
#pragma unroll
  for (int j = 0; j < kDecPerThread; ++j) acc[j] = 0.f;

  for (int k0 = 0; k0 < limit; k0 += kDecTileK) {
    __syncthreads();
    load_tile(sK, ld, kb + (long long)k0 * p.k_ss, p.k_ss, 0, kDecTileK, limit - k0, d);
    load_tile(sV, ld, vb + (long long)k0 * p.v_ss, p.v_ss, 0, kDecTileK, limit - k0, d);
    if (QUANT) {
      load_scales(sKs, ksb + k0, kDecTileK, limit - k0);
      load_scales(sVs, vsb + k0, kDecTileK, limit - k0);
    }
    __syncthreads();

    // scores [G, 64]: consecutive threads take consecutive keys of one head
    for (int pair = tid; pair < G * kDecTileK; pair += kDecThreads) {
      const int g = pair / kDecTileK;
      const int c = pair - g * kDecTileK;
      const float* qr = sQ + g * ld;
      const float* kr = sK + c * ld;
      float s = 0.f;
      for (int x = 0; x < d; ++x) s = fmaf(qr[x], kr[x], s);
      const float sc = QUANT ? (s * p.scale) * sKs[c] : s * p.scale;
      sS[g * (kDecTileK + 1) + c] = k0 + c < limit ? sc : kNegInf;
    }
    __syncthreads();

    // online softmax: one warp per head row, two columns per lane
    for (int g = warp; g < G; g += kDecThreads / 32) {
      float* row = sS + g * (kDecTileK + 1);
      const float s0 = row[lane], s1 = row[lane + 32];
      float mx = fmaxf(s0, s1);
#pragma unroll
      for (int w = 16; w > 0; w /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
      const float m_prev = sM[g];
      const float m_new = fmaxf(m_prev, mx);
      const float p0 = s0 == kNegInf ? 0.f : expf(s0 - m_new);
      const float p1 = s1 == kNegInf ? 0.f : expf(s1 - m_new);
      float sum = p0 + p1;
#pragma unroll
      for (int w = 16; w > 0; w /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, w);
      row[lane] = QUANT ? p0 * sVs[lane] : round_to<T>(p0);
      row[lane + 32] = QUANT ? p1 * sVs[lane + 32] : round_to<T>(p1);
      if (lane == 0) {
        const float alpha = expf(m_prev - m_new);
        sL[g] = sL[g] * alpha + sum;
        sM[g] = m_new;
        sAlpha[g] = alpha;
      }
    }
    __syncthreads();

    // acc = alpha * acc + P V; thread owns outputs idx = tid + 128 j of [G, D]
#pragma unroll
    for (int j = 0; j < kDecPerThread; ++j) {
      const int idx = tid + kDecThreads * j;
      if (idx < G * d) {
        const int g = idx / d;
        const int x = idx - g * d;
        const float* pr = sS + g * (kDecTileK + 1);
        float a = acc[j] * sAlpha[g];
        for (int c = 0; c < kDecTileK; ++c) a = fmaf(pr[c], sV[c * ld + x], a);
        acc[j] = a;
      }
    }
  }
  __syncthreads();

#pragma unroll
  for (int j = 0; j < kDecPerThread; ++j) {
    const int idx = tid + kDecThreads * j;
    if (idx < G * d) {
      const int g = idx / d;
      const int x = idx - g * d;
      const float l = sL[g];
      ob[g * p.o_sh + x] = from_f<T>(acc[j] / (l > 0.f ? l : 1.f));
    }
  }
}

template <typename T, bool QUANT>
int launch_decode(const DecodeParams& p, int batch, cudaStream_t stream) {
  const size_t smem = decode_smem_bytes(p.hq / p.hk, p.d);
  auto kernel = decode_kernel<T, QUANT>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(p.hk, batch), kDecThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Fill DecodeParams from the C entry points' arguments; `strides` holds
// q (b, h), k (b, h, s), v (b, h, s), o (b, h) and, for QUANT, the scales'
// (b, h) of k then v. Returns false for shapes the kernel does not take.
inline bool decode_params(DecodeParams& p, const void* q, const void* k, const void* v,
                          const void* k_scale, const void* v_scale, void* o,
                          const int* kv_limit, int hq, int hk, int skv, int d,
                          const long long* strides, float scale, bool quant) {
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.kv_limit = kv_limit;
  p.k_scale = static_cast<const __nv_bfloat16*>(k_scale);
  p.v_scale = static_cast<const __nv_bfloat16*>(v_scale);
  p.hq = hq;
  p.hk = hk;
  p.skv = skv;
  p.d = d;
  p.q_sb = strides[0];  p.q_sh = strides[1];
  p.k_sb = strides[2];  p.k_sh = strides[3];  p.k_ss = strides[4];
  p.v_sb = strides[5];  p.v_sh = strides[6];  p.v_ss = strides[7];
  p.o_sb = strides[8];  p.o_sh = strides[9];
  p.ks_sb = quant ? strides[10] : 0;  p.ks_sh = quant ? strides[11] : 0;
  p.vs_sb = quant ? strides[12] : 0;  p.vs_sh = quant ? strides[13] : 0;
  p.scale = scale;
  return d > 0 && d <= kMaxHeadDim && d % 8 == 0 && hk > 0 && hq % hk == 0 &&
         (hq / hk) * d <= kDecMaxOut;
}

}  // namespace
}  // namespace livecc
