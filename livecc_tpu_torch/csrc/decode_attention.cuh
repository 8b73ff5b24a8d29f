// One-token GQA decode attention over the KV cache, shared by K2
// (flash_decode.cu) and its int8 variant (flash_decode_int8.cu: QUANT).
//
// Split-KV (flash-decoding): one C entry point launches two kernels back to
// back on the caller's stream.
//
//   decode_split_kernel, grid (Hk, B, nsplit = ceil(Smax / kDecSplit)), 128
//   threads: block (KV head, row, split) takes the keys [split * kDecSplit,
//   +kDecSplit) below kv_limit[b]
//   (read on the device: no host sync, and the grid depends on Smax and B
//   alone) for the G = Hq / Hk query heads of its KV head, so each K/V row
//   is read once for all G heads. It writes each head's partial softmax
//   state, fp32: m (the split's max score), l (sum of p) and acc (p.v). A
//   split that starts at or past the row's limit writes m = -inf, l = 0 and
//   exits (its acc is never read).
//   decode_merge_kernel, grid (Hq, B): o = sum_i e^{m_i - M} acc_i /
//   sum_i e^{m_i - M} l_i over the row's non-empty splits in split order,
//   M = max m_i. No atomics anywhere, so two launches are bit-equal. A row
//   with no valid key outputs exactly 0.
//
// Inside a split block: the split's K and V rows are copied to shared
// memory with 16-byte vector loads, kDecBatch of them in flight per thread
// before any is stored (a decode reads each byte once, so nothing else hides
// the memory latency), and q [G, D] is widened to fp32 there once. Scores:
// LPK lanes per key (a power of two covering the row's vector chunks), 32 /
// LPK keys per warp step; each lane reads its chunk of the K row with one
// shared vector load and accumulates G fp32 dot products, reduced over the
// LPK lanes by shuffles. p.v: each thread owns a column (and, for D < 128, a
// subset of the keys) and accumulates G fp32 sums. Row widths or strides
// that a 16-byte load does not fit take 8-byte loads (VB), e.g. an int8 row
// of D = 8. The merge loads the row's m and l into shared memory in parallel
// and then sums the acc rows with independent loads.
//
// Numerics, as the TPU kernel (attention.py:198-249): s = q.k * d^-0.5 in
// fp32 (QUANT: (q.k * d^-0.5) * k_scale[key]); within a split p = exp(s -
// m_split); l sums p before any rounding or value scale; p is rounded to T
// for p.v (QUANT: p * v_scale[key] stays fp32 against V widened exactly);
// normalisation after the merge.

#pragma once

#include <initializer_list>
#include <math_constants.h>

#include "attn_common.cuh"

namespace livecc {
namespace {

constexpr int kDecSplit = 64;      // keys per split block (ops/flash_attention.py:DECODE_SPLIT)
constexpr int kDecThreads = 128;
constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecMaxOut = 2048;   // G * D per block: G <= 16 at D = 128
constexpr int kDecGr = 8;          // query heads per register pass (G = 7 in one)
constexpr int kDecBatch = 16;      // vector loads in flight per thread while staging
constexpr int kMergeGroups = 4;    // merge threads per output column
constexpr int kDecMaxSplits = 3072;   // Smax <= 3072 * kDecSplit: the merge keeps 3 floats per split in smem
constexpr size_t kMaxSmem = 232448;

struct DecodeParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* kv_limit;
  const __nv_bfloat16* k_scale;   // QUANT: [B, Hk, 1, Skv] lane-major scales
  const __nv_bfloat16* v_scale;
  float* ws;                      // m [B, Hq, nsplit], l [B, Hq, nsplit], acc [B, Hq, nsplit, D]
  int batch, hq, hk, skv, d, nsplit;
  long long q_sb, q_sh;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh;
  long long ks_sb, ks_sh, vs_sb, vs_sh;
  float scale;
};

__host__ __device__ inline size_t align16(size_t n) { return (n + 15) / 16 * 16; }

// sK, sV [kDecSplit][d] (KV), then fp32 sQ [G][d], sS [G][kDecSplit], sRed
// [kDecThreads][kDecGr], sKs, sVs [kDecSplit]
inline size_t decode_smem_bytes(int groups, int d, size_t kv_bytes) {
  return align16(2 * (size_t)kDecSplit * d * kv_bytes) +
         sizeof(float) * ((size_t)groups * d + (size_t)groups * kDecSplit +
                          (size_t)kDecThreads * kDecGr + 2 * (size_t)kDecSplit);
}

template <int VB> struct VecOf;
template <> struct VecOf<16> { using type = uint4; };
template <> struct VecOf<8> { using type = uint2; };

// The elements packed in one 32-bit word, widened exactly to fp32.
__device__ __forceinline__ void widen_word(uint32_t w, float* out, float) {
  out[0] = __uint_as_float(w);
}
__device__ __forceinline__ void widen_word(uint32_t w, float* out, __nv_bfloat16) {
  out[0] = __uint_as_float(w << 16);
  out[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ void widen_word(uint32_t w, float* out, int8_t) {
#pragma unroll
  for (int i = 0; i < 4; ++i) out[i] = (float)((int)(w << (24 - 8 * i)) >> 24);
}

// VB bytes of a K/V row (VB = 16 or 8) into fp32 registers.
template <typename KV, int VB>
__device__ __forceinline__ void load_vec(float* out, const KV* src) {
  constexpr int kPerWord = 4 / (int)sizeof(KV);
  uint32_t w[VB / 4];
  if constexpr (VB == 16) {
    const uint4 r = *reinterpret_cast<const uint4*>(src);
    w[0] = r.x; w[1] = r.y; w[2] = r.z; w[3] = r.w;
  } else {
    const uint2 r = *reinterpret_cast<const uint2*>(src);
    w[0] = r.x; w[1] = r.y;
  }
#pragma unroll
  for (int i = 0; i < VB / 4; ++i) widen_word(w[i], out + i * kPerWord, KV());
}

template <typename T, bool QUANT, int VB>
__global__ void __launch_bounds__(kDecThreads) decode_split_kernel(DecodeParams p) {
  using KV = typename std::conditional<QUANT, int8_t, T>::type;
  using Vec = typename VecOf<VB>::type;
  constexpr int VE = VB / (int)sizeof(KV);     // elements per vector load
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int d = p.d;
  const int G = p.hq / p.hk;
  const int Gp = (G + kDecGr - 1) / kDecGr * kDecGr;   // heads padded to whole register passes
  constexpr int split = kDecSplit;
  KV* sK = reinterpret_cast<KV*>(smem_raw);                           // [split][d]
  KV* sV = sK + (size_t)split * d;                                    // [split][d]
  float* sQ = reinterpret_cast<float*>(smem_raw + align16(2 * (size_t)split * d * sizeof(KV)));
  float* sS = sQ + Gp * d;                     // [Gp][split]: scores, then p
  float* sRed = sS + Gp * split;               // [128 / d][kDecGr][d]
  float* sKs = sRed + kDecThreads * kDecGr;    // QUANT: the split's key scales
  float* sVs = sKs + split;                    // QUANT: the split's value scales

  const int tid = threadIdx.x;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int sp = blockIdx.z;
  const int k0 = sp * split;
  // q [G, d] into registers first: its loads overlap the read of kv_limit
  // and, below, those of the K/V rows
  constexpr int kPer = kDecMaxOut / kDecThreads;
  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + (long long)kvh * G * p.q_sh;
  float qv[kPer];
#pragma unroll
  for (int j = 0; j < kPer; ++j) {
    const int i = tid + j * kDecThreads;
    if (i < G * d) qv[j] = to_f(qb[(i / d) * p.q_sh + i % d]);
  }
  const int limit = min(p.kv_limit[b], p.skv);
  const int n = min(split, limit - k0);        // this split's valid keys

  const long long stat = (long long)p.batch * p.hq * p.nsplit;
  float* ws_m = p.ws;
  float* ws_l = p.ws + stat;
  float* ws_acc = p.ws + 2 * stat;
  const long long part0 = ((long long)b * p.hq + (long long)kvh * G) * p.nsplit + sp;
  if (n <= 0) {
    for (int g = tid; g < G; g += kDecThreads) {
      ws_m[part0 + (long long)g * p.nsplit] = -CUDART_INF_F;
      ws_l[part0 + (long long)g * p.nsplit] = 0.f;
    }
    return;
  }

  const KV* kb = static_cast<const KV*>(p.k) + b * p.k_sb + kvh * p.k_sh + (long long)k0 * p.k_ss;
  const KV* vb = static_cast<const KV*>(p.v) + b * p.v_sb + kvh * p.v_sh + (long long)k0 * p.v_ss;
  const int C = d / VE;                        // vector chunks per row
  if (QUANT) {
    const __nv_bfloat16* ksb = p.k_scale + b * p.ks_sb + kvh * p.ks_sh + k0;
    const __nv_bfloat16* vsb = p.v_scale + b * p.vs_sb + kvh * p.vs_sh + k0;
    for (int c = tid; c < n; c += kDecThreads) {
      sKs[c] = __bfloat162float(ksb[c]);
      sVs[c] = __bfloat162float(vsb[c]);
    }
  }
  // the split's K then V rows into shared memory, kDecBatch loads in flight
  // per thread; q is stored (widened) once the first batch is in flight,
  // element x = ch * VE + e at e * C + ch, so the lanes of one key
  // (consecutive ch) read consecutive banks
  auto store_q = [&]() {
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int i = tid + j * kDecThreads;
      if (i < G * d) {
        const int g = i / d, x = i % d;
        sQ[g * d + (x % VE) * C + x / VE] = qv[j];
      }
    }
  };
  for (int i = G * d + tid; i < Gp * d; i += kDecThreads) sQ[i] = 0.f;   // padded heads
  const int rows_chunks = n * C;
  if (tid >= 2 * rows_chunks) store_q();       // a thread with no K/V chunk to copy
  for (int i0 = tid; i0 < 2 * rows_chunks; i0 += kDecThreads * kDecBatch) {
    Vec buf[kDecBatch];
#pragma unroll
    for (int j = 0; j < kDecBatch; ++j) {
      const int i = i0 + j * kDecThreads;
      if (i < 2 * rows_chunks) {
        const bool is_v = i >= rows_chunks;
        const int ii = is_v ? i - rows_chunks : i;
        const int r = ii / C, ch = ii - (ii / C) * C;
        const KV* src = (is_v ? vb + (long long)r * p.v_ss : kb + (long long)r * p.k_ss) + ch * VE;
        buf[j] = *reinterpret_cast<const Vec*>(src);
      }
    }
    if (i0 == tid) store_q();
#pragma unroll
    for (int j = 0; j < kDecBatch; ++j) {
      const int i = i0 + j * kDecThreads;
      if (i < 2 * rows_chunks) {
        const bool is_v = i >= rows_chunks;
        const int ii = is_v ? i - rows_chunks : i;
        *reinterpret_cast<Vec*>((is_v ? sV : sK) + ii * VE) = buf[j];
      }
    }
  }
  __syncthreads();

  // scores [Gp, n]: LPK lanes per key, KPW keys per warp step. The padded
  // heads (q = 0) run along, so no head loop below branches.
  int lpk = 1;
  while (lpk < C && lpk < 32) lpk *= 2;
  const int kpw = 32 / lpk;
  const int sub = lane / lpk, part = lane - (lane / lpk) * lpk;
  for (int g0 = 0; g0 < Gp; g0 += kDecGr) {
    for (int cb = warp * kpw; cb < n; cb += kDecWarps * kpw) {
      const int c = cb + sub;
      float dot[kDecGr];
#pragma unroll
      for (int gg = 0; gg < kDecGr; ++gg) dot[gg] = 0.f;
      if (c < n) {
        for (int ch = part; ch < C; ch += lpk) {
          float kv[VE];
          load_vec<KV, VB>(kv, sK + c * d + ch * VE);
#pragma unroll
          for (int gg = 0; gg < kDecGr; ++gg) {
            const float* qr = sQ + (g0 + gg) * d + ch;
#pragma unroll
            for (int e = 0; e < VE; ++e) dot[gg] = fmaf(qr[e * C], kv[e], dot[gg]);
          }
        }
      }
      // reduce over the key's LPK lanes, the G heads' shuffles interleaved
#pragma unroll
      for (int w = 16; w > 0; w /= 2) {
        if (w < lpk) {
#pragma unroll
          for (int gg = 0; gg < kDecGr; ++gg) dot[gg] += __shfl_xor_sync(0xffffffffu, dot[gg], w);
        }
      }
      if (part == 0 && c < n) {
#pragma unroll
        for (int gg = 0; gg < kDecGr; ++gg)
          sS[(g0 + gg) * split + c] = QUANT ? (dot[gg] * p.scale) * sKs[c] : dot[gg] * p.scale;
      }
    }
  }
  __syncthreads();

  // softmax within the split: one warp per head row
  for (int g = warp; g < G; g += kDecWarps) {
    float* row = sS + g * split;
    float mx = kNegInf;
    for (int c = lane; c < n; c += 32) mx = fmaxf(mx, row[c]);
#pragma unroll
    for (int w = 16; w > 0; w /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
    float sum = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float pc = expf(row[c] - mx);
      sum += pc;
      row[c] = QUANT ? pc * sVs[c] : round_to<T>(pc);
    }
#pragma unroll
    for (int w = 16; w > 0; w /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, w);
    if (lane == 0) {
      ws_m[part0 + (long long)g * p.nsplit] = mx;
      ws_l[part0 + (long long)g * p.nsplit] = sum;
    }
  }
  __syncthreads();

  // acc [G, d] = P V: thread (ks, x) takes column x over keys ks, ks + KS, ...
  const int KS = d >= kDecThreads ? 1 : kDecThreads / d;
  const int ks = tid / d, x = tid - (tid / d) * d;
  for (int g0 = 0; g0 < Gp; g0 += kDecGr) {
    float acc[kDecGr];
#pragma unroll
    for (int gg = 0; gg < kDecGr; ++gg) acc[gg] = 0.f;
    if (ks < KS) {
#pragma unroll 4
      for (int c = ks; c < n; c += KS) {
        const float vx = to_f(sV[c * d + x]);
#pragma unroll
        for (int gg = 0; gg < kDecGr; ++gg) acc[gg] = fmaf(sS[(g0 + gg) * split + c], vx, acc[gg]);
      }
    }
    if (KS > 1) {
      __syncthreads();                         // the previous pass has read sRed
      if (ks < KS) {
#pragma unroll
        for (int gg = 0; gg < kDecGr; ++gg) sRed[(ks * kDecGr + gg) * d + x] = acc[gg];
      }
      __syncthreads();
      if (ks == 0) {
#pragma unroll
        for (int gg = 0; gg < kDecGr; ++gg) {
          float a = 0.f;
          for (int j = 0; j < KS; ++j) a += sRed[(j * kDecGr + gg) * d + x];
          acc[gg] = a;
        }
      }
    }
    if (ks == 0) {
#pragma unroll
      for (int gg = 0; gg < kDecGr; ++gg) {
        if (g0 + gg < G) ws_acc[(part0 + (long long)(g0 + gg) * p.nsplit) * d + x] = acc[gg];
      }
    }
  }
}

template <typename T, bool QUANT>
__global__ void __launch_bounds__(kDecThreads * kMergeGroups) decode_merge_kernel(DecodeParams p) {
  extern __shared__ float sMerge[];            // m, l, weight of each split
  __shared__ float sPart[kMergeGroups][kDecThreads];
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int limit = min(p.kv_limit[b], p.skv);
  const int nv = limit > 0 ? (limit + kDecSplit - 1) / kDecSplit : 0;   // splits with a valid key
  const long long stat = (long long)p.batch * p.hq * p.nsplit;
  const long long row = ((long long)b * p.hq + h) * p.nsplit;
  const float* acc = p.ws + 2 * stat + row * p.d;
  float* sM = sMerge;
  float* sL = sM + p.nsplit;
  float* sW = sL + p.nsplit;
  for (int i = threadIdx.x; i < nv; i += blockDim.x) {
    sM[i] = p.ws[row + i];
    sL[i] = p.ws[stat + row + i];
  }
  __syncthreads();
  float M = kNegInf;
  for (int i = 0; i < nv; ++i)
    if (sL[i] > 0.f) M = fmaxf(M, sM[i]);
  for (int i = threadIdx.x; i < nv; i += blockDim.x)
    sW[i] = sL[i] > 0.f ? expf(sM[i] - M) : 0.f;     // an empty split weighs 0
  __syncthreads();
  // thread (group, x): column x over the splits group, group + kMergeGroups, ...
  const int grp = threadIdx.x / kDecThreads, x = threadIdx.x % kDecThreads;
  float a = 0.f;
  if (x < p.d) {
#pragma unroll 8
    for (int i = grp; i < nv; i += kMergeGroups) a += sW[i] * acc[(long long)i * p.d + x];
  }
  sPart[grp][x] = a;
  __syncthreads();
  if (grp == 0 && x < p.d) {
    float L = 0.f;
    for (int i = 0; i < nv; ++i) L += sW[i] * sL[i];
    float o = sPart[0][x];
#pragma unroll
    for (int j = 1; j < kMergeGroups; ++j) o += sPart[j][x];
    T* ob = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;
    ob[x] = from_f<T>(L > 0.f ? o / L : 0.f);
  }
}

// The widest vector load (16 or 8 bytes) that every K/V row start fits; 0
// if none does.
inline int decode_vec_bytes(const DecodeParams& p, size_t kv_bytes) {
  for (int vb : {16, 8}) {
    bool ok = (p.d * kv_bytes) % vb == 0 && reinterpret_cast<uintptr_t>(p.k) % vb == 0 &&
              reinterpret_cast<uintptr_t>(p.v) % vb == 0;
    for (long long s : {p.k_sb, p.k_sh, p.k_ss, p.v_sb, p.v_sh, p.v_ss})
      ok = ok && (s * (long long)kv_bytes) % vb == 0;
    if (ok) return vb;
  }
  return 0;
}

template <typename T, bool QUANT, int VB>
int launch_split_merge(const DecodeParams& p, size_t smem, cudaStream_t stream) {
  auto split_kernel = decode_split_kernel<T, QUANT, VB>;
  cudaError_t err =
      cudaFuncSetAttribute(split_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  split_kernel<<<dim3(p.hk, p.batch, p.nsplit), kDecThreads, smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const size_t merge_smem = 3 * sizeof(float) * p.nsplit;
  decode_merge_kernel<T, QUANT><<<dim3(p.hq, p.batch), kDecThreads * kMergeGroups, merge_smem,
                                  stream>>>(p);
  return (int)cudaGetLastError();
}

template <typename T, bool QUANT>
int launch_decode(const DecodeParams& p, cudaStream_t stream) {
  using KV = typename std::conditional<QUANT, int8_t, T>::type;
  const int padded = (p.hq / p.hk + kDecGr - 1) / kDecGr * kDecGr;
  const size_t smem = decode_smem_bytes(padded, p.d, sizeof(KV));
  if (smem > kMaxSmem) return (int)cudaErrorInvalidValue;
  switch (decode_vec_bytes(p, sizeof(KV))) {
    case 16: return launch_split_merge<T, QUANT, 16>(p, smem, stream);
    case 8: return launch_split_merge<T, QUANT, 8>(p, smem, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// Fill DecodeParams from the C entry points' arguments; `strides` holds
// q (b, h), k (b, h, s), v (b, h, s), o (b, h) and, for QUANT, the scales'
// (b, h) of k then v. `workspace` holds (2 + d) * batch * hq * nsplit fp32;
// the caller sized it for nsplit = ceil(skv / kDecSplit), and any other
// nsplit is refused. Returns false for shapes the kernels do not take.
inline bool decode_params(DecodeParams& p, const void* q, const void* k, const void* v,
                          const void* k_scale, const void* v_scale, void* o,
                          const int* kv_limit, int batch, int hq, int hk, int skv, int d,
                          const long long* strides, float scale, void* workspace, int nsplit,
                          bool quant) {
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.kv_limit = kv_limit;
  p.k_scale = static_cast<const __nv_bfloat16*>(k_scale);
  p.v_scale = static_cast<const __nv_bfloat16*>(v_scale);
  p.ws = static_cast<float*>(workspace);
  p.batch = batch;
  p.hq = hq;
  p.hk = hk;
  p.skv = skv;
  p.d = d;
  p.nsplit = nsplit;
  p.q_sb = strides[0];  p.q_sh = strides[1];
  p.k_sb = strides[2];  p.k_sh = strides[3];  p.k_ss = strides[4];
  p.v_sb = strides[5];  p.v_sh = strides[6];  p.v_ss = strides[7];
  p.o_sb = strides[8];  p.o_sh = strides[9];
  p.ks_sb = quant ? strides[10] : 0;  p.ks_sh = quant ? strides[11] : 0;
  p.vs_sb = quant ? strides[12] : 0;  p.vs_sh = quant ? strides[13] : 0;
  p.scale = scale;
  return d > 0 && d <= kMaxHeadDim && d % 8 == 0 && hk > 0 && hq % hk == 0 &&
         (hq / hk) * d <= kDecMaxOut && batch > 0 && skv > 0 &&
         nsplit == (skv + kDecSplit - 1) / kDecSplit && nsplit <= kDecMaxSplits &&
         workspace != nullptr;
}

}  // namespace
}  // namespace livecc
