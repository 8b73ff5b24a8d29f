// K4 training attention (splash semantics): forward with log-sum-exp, and
// the backward's dK/dV and dQ kernels. Shared by train_attention_fwd.cu and
// train_attention_bwd.cu.
//
// Contract (the wrapper ops/train_attention.py checks it): q pre-scaled by
// d**-0.5 and rounded to its dtype ("qs"), q [B, S, Hq, D], k/v [B, S, Hk, D],
// all read through (batch, seq, head) strides with a unit-stride head dim;
// seg int32 [B, S] contiguous segment ids (a bool validity mask arrives as
// 0/1). Query i attends key j iff seg[i] == seg[j] and, in the causal form
// (every training caller's), j <= i: splash's CausalMask. The non-causal
// form (the kCausal template flag false, the entry points' causal = 0) is
// splash's FullMask: the segments alone. So pad tokens (id 0) attend among
// themselves, as splash does. Outputs are contiguous:
// o, dq [B, S, Hq, D], dk, dv [B, S, Hk, D] in the operands'
// dtype, lse fp32 [B, Hq, S]; di = rowsum(o * do) fp32 [B, Hq, S] is an input
// of the backward (splash computes it outside its kernels too).
//
// Numerics are splash's (jax/experimental/pallas/ops/tpu/splash_attention/
// splash_attention_kernel.py): fp32 scores, masked scores take
// DEFAULT_MASK_VALUE = -0.7 * FLT_MAX, p stays fp32 against V widened to fp32
// (no rounding of p, unlike K1), normalisation at the end, lse = m + log l.
// Backward: p = exp(s - lse), dv += p.to(do)^T do, ds = p * (dp - di),
// dk += ds.to(do)^T q, dq += ds.to(k) k; every product accumulates in fp32.
// A masked score contributes exactly 0 (every row holds its own diagonal
// key, in either form, so the running max is real before any row is
// normalised).
//
// Tiles are 64 queries x 64 keys held in shared memory as fp32 with an odd
// row stride (D + 1), as in tile_attention.cuh. Work that the data makes
// zero is skipped: a causal block never walks past its causal frontier, and a tile
// pair whose segment ids cannot meet (no key id inside the query tile's id
// range, or the reverse) is skipped on a __syncthreads_or vote. Skipping a
// tile changes no bit of the result (its p would be 0 everywhere).
//
// These kernels serve fp32 operands (the tiny test model, and the CPU-vs-GPU
// loss check), on the fp32 FMA pipes; they are instantiated for float only.
// bf16 operands, the model's, run on the tensor cores in
// train_wgmma_attention.cuh (the forward) and train_wgmma_attention_bwd.cuh
// (the backward), which keep this contract.

#pragma once

#include <climits>

#include "attn_common.cuh"

namespace livecc {

constexpr float kSplashMask = -0.7f * FLT_MAX;   // splash DEFAULT_MASK_VALUE
constexpr int kTrainTile = 64;
constexpr int kFwdThreads = 128;
constexpr int kBwdThreads = 256;

struct TrainAttnParams {
  const void* q;        // qs [B, S, Hq, D] (strided)
  const void* k;        // [B, S, Hk, D] (strided)
  const void* v;
  const void* dout;     // bwd: do [B, S, Hq, D] (strided)
  const int* seg;       // [B, S]
  void* o;              // fwd: [B, S, Hq, D] contiguous
  float* lse;           // fwd out / bwd in: [B, Hq, S]
  const float* di;      // bwd: [B, Hq, S]
  void* dq;             // bwd: [B, S, Hq, D] contiguous
  void* dk;             // bwd: [B, S, Hk, D] contiguous
  void* dv;
  int hq, hk, s, d;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long do_sb, do_ss, do_sh;
};

inline size_t train_fwd_smem_bytes(int d) {
  const int ld = d + 1;
  return sizeof(float) * (size_t)(3 * kTrainTile * ld + kTrainTile * (kTrainTile + 1) +
                                  3 * kTrainTile + 2 * kTrainTile);
}

inline size_t train_bwd_smem_bytes(int d) {
  const int ld = d + 1;
  return sizeof(float) * (size_t)(4 * kTrainTile * ld + 2 * kTrainTile * (kTrainTile + 1) +
                                  4 * kTrainTile);
}

namespace {

// Threads < 64 load the 64 segment ids of rows [r0, r0 + 64) (`pad` past S)
// into `dst`; returns, for this thread, whether its id lies in [lo, hi].
__device__ __forceinline__ bool load_segments(int* dst, const int* segb, int r0, int s, int pad,
                                              int lo, int hi) {
  bool hit = false;
  if (threadIdx.x < kTrainTile) {
    const int r = r0 + threadIdx.x;
    const int id = r < s ? segb[r] : pad;
    dst[threadIdx.x] = id;
    hit = r < s && id >= lo && id <= hi;
  }
  return hit;
}

// Min and max segment id of rows [r0, min(r0 + 64, S)) into *lo, *hi.
__device__ __forceinline__ void segment_range(int* lo, int* hi, const int* segb, int r0, int s) {
  if (threadIdx.x == 0) {
    *lo = INT_MAX;
    *hi = INT_MIN;
  }
  __syncthreads();
  if (threadIdx.x < kTrainTile && r0 + (int)threadIdx.x < s) {
    const int id = segb[r0 + threadIdx.x];
    atomicMin(lo, id);
    atomicMax(hi, id);
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// Forward: block = (64-query tile, q head, row), 128 threads; each thread
// owns a 4x8 tile of the [64, 64] scores and a 4 x (D/8) tile of the fp32
// output accumulator.
// ---------------------------------------------------------------------------
template <typename T, bool kCausal>
__global__ void __launch_bounds__(kFwdThreads) train_fwd_kernel(TrainAttnParams p) {
  extern __shared__ float smem[];
  __shared__ int q_lo, q_hi;
  const int d = p.d;
  const int ld = d + 1;
  float* sQ = smem;                                  // [64][ld]
  float* sK = sQ + kTrainTile * ld;                  // [64][ld]
  float* sV = sK + kTrainTile * ld;                  // [64][ld]
  float* sS = sV + kTrainTile * ld;                  // [64][65] scores, then p
  float* sM = sS + kTrainTile * (kTrainTile + 1);    // [64] running max
  float* sL = sM + kTrainTile;                       // [64] running sum
  float* sAlpha = sL + kTrainTile;                   // [64] rescale of this step
  int* sSegQ = reinterpret_cast<int*>(sAlpha + kTrainTile);   // [64]
  int* sSegK = sSegQ + kTrainTile;                             // [64]

  const int tid = threadIdx.x;
  const int tx = tid % 8;
  const int ty = tid / 8;
  const int q0 = blockIdx.x * kTrainTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.hq / p.hk);
  const int nd = d / 8;
  const int s_len = p.s;
  const int* segb = p.seg + (long long)b * s_len;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  load_tile(sQ, ld, qb + (long long)q0 * p.q_ss, p.q_ss, 0, kTrainTile, s_len - q0, d);
  segment_range(&q_lo, &q_hi, segb, q0, s_len);
  if (tid < kTrainTile) {
    sSegQ[tid] = q0 + tid < s_len ? segb[q0 + tid] : INT_MIN;
    sM[tid] = kSplashMask;
    sL[tid] = 0.f;
  }
  float acc[4][kMaxHeadDim / 8];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxHeadDim / 8; ++j) acc[i][j] = 0.f;

  const int kv_end = kCausal ? min(s_len, q0 + kTrainTile) : s_len;
  for (int k0 = 0; k0 < kv_end; k0 += kTrainTile) {
    __syncthreads();   // the previous step is done with sK, sV, sS, sSegK
    const bool hit = load_segments(sSegK, segb, k0, s_len, INT_MAX, q_lo, q_hi);
    if (!__syncthreads_or(hit)) continue;   // no key of this tile meets a query
    load_tile(sK, ld, kb + (long long)k0 * p.k_ss, p.k_ss, 0, kTrainTile, s_len - k0, d);
    load_tile(sV, ld, vb + (long long)k0 * p.v_ss, p.v_ss, 0, kTrainTile, s_len - k0, d);
    __syncthreads();

    float sc[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) sc[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qa[4], ka[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(ty * 4 + i) * ld + c];
#pragma unroll
      for (int j = 0; j < 8; ++j) ka[j] = sK[(tx + 8 * j) * ld + c];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) sc[i][j] = fmaf(qa[i], ka[j], sc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx + 8 * j;
        const int kpos = k0 + col;
        const bool ok = kpos < s_len && (!kCausal || kpos <= q0 + r) && sSegK[col] == sSegQ[r];
        sS[r * (kTrainTile + 1) + col] = ok ? sc[i][j] : kSplashMask;
      }
    }
    __syncthreads();

    // online softmax, p kept fp32: two neighbouring threads per row
    {
      const int r = tid / 2;
      const int half = tid % 2;
      float* row = sS + r * (kTrainTile + 1) + half * (kTrainTile / 2);
      float mx = kSplashMask;
      for (int c = 0; c < kTrainTile / 2; ++c) mx = fmaxf(mx, row[c]);
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      const float m_prev = sM[r];
      const float m_new = fmaxf(m_prev, mx);
      float sum = 0.f;
      for (int c = 0; c < kTrainTile / 2; ++c) {
        const float sv = row[c];
        const float pv = sv == kSplashMask ? 0.f : expf(sv - m_new);
        sum += pv;
        row[c] = pv;
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

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a = sAlpha[ty * 4 + i];
#pragma unroll
      for (int j = 0; j < kMaxHeadDim / 8; ++j) acc[i][j] *= a;
    }
    for (int c = 0; c < kTrainTile; ++c) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = sS[(ty * 4 + i) * (kTrainTile + 1) + c];
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

  T* ob = static_cast<T*>(p.o) + ((long long)b * s_len * p.hq + h) * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    if (q0 + r >= s_len) continue;
    const float l = sL[r];
    const float safe = l > 0.f ? l : 1.f;
    T* orow = ob + (long long)(q0 + r) * p.hq * d;
#pragma unroll
    for (int j = 0; j < kMaxHeadDim / 8; ++j)
      if (j < nd) orow[tx + 8 * j] = from_f<T>(acc[i][j] / safe);
  }
  if (tid < kTrainTile && q0 + tid < s_len)
    p.lse[((long long)b * p.hq + h) * s_len + q0 + tid] = sM[tid] + logf(sL[tid]);
}

// ---------------------------------------------------------------------------
// Backward dK/dV: block = (64-key tile, KV head, row), 256 threads. It walks
// the G q heads of its group and the query tiles from its diagonal on (all
// of them in the non-causal form), so each dK/dV row is summed by one block
// (no atomics). Each thread owns a 4x4
// tile of the [64 keys, 64 queries] scores and 4 x (D/16) of both fp32
// accumulators.
// ---------------------------------------------------------------------------
template <typename T, bool kCausal>
__global__ void __launch_bounds__(kBwdThreads) train_dkv_kernel(TrainAttnParams p) {
  extern __shared__ float smem[];
  __shared__ int k_lo, k_hi;
  const int d = p.d;
  const int ld = d + 1;
  constexpr int lds = kTrainTile + 1;
  float* sK = smem;                       // [64][ld]
  float* sV = sK + kTrainTile * ld;       // [64][ld]
  float* sQ = sV + kTrainTile * ld;       // [64][ld]
  float* sDO = sQ + kTrainTile * ld;      // [64][ld]
  float* sP = sDO + kTrainTile * ld;      // [64 keys][65] p rounded to do's dtype
  float* sDS = sP + kTrainTile * lds;     // [64 keys][65] ds rounded to do's dtype
  float* sLse = sDS + kTrainTile * lds;   // [64]
  float* sDi = sLse + kTrainTile;         // [64]
  int* sSegK = reinterpret_cast<int*>(sDi + kTrainTile);   // [64]
  int* sSegQ = sSegK + kTrainTile;                          // [64]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int k0 = blockIdx.x * kTrainTile;
  const int kvh = blockIdx.y;
  const int b = blockIdx.z;
  const int groups = p.hq / p.hk;
  const int nd = d / 16 + (d % 16 ? 1 : 0);
  const int s_len = p.s;
  const int* segb = p.seg + (long long)b * s_len;

  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  load_tile(sK, ld, kb + (long long)k0 * p.k_ss, p.k_ss, 0, kTrainTile, s_len - k0, d);
  load_tile(sV, ld, vb + (long long)k0 * p.v_ss, p.v_ss, 0, kTrainTile, s_len - k0, d);
  segment_range(&k_lo, &k_hi, segb, k0, s_len);
  if (tid < kTrainTile) sSegK[tid] = k0 + tid < s_len ? segb[k0 + tid] : INT_MAX;

  float dk[4][kMaxHeadDim / 16], dv[4][kMaxHeadDim / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxHeadDim / 16; ++j) dk[i][j] = dv[i][j] = 0.f;

  for (int g = 0; g < groups; ++g) {
    const int h = kvh * groups + g;
    const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
    const T* dob = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
    const float* lseb = p.lse + ((long long)b * p.hq + h) * s_len;
    const float* dib = p.di + ((long long)b * p.hq + h) * s_len;
    for (int q0 = kCausal ? k0 : 0; q0 < s_len; q0 += kTrainTile) {
      __syncthreads();   // the previous step is done with sQ, sDO, sP, sDS, sSegQ
      const bool hit = load_segments(sSegQ, segb, q0, s_len, INT_MIN, k_lo, k_hi);
      if (!__syncthreads_or(hit)) continue;   // no query of this tile meets a key
      load_tile(sQ, ld, qb + (long long)q0 * p.q_ss, p.q_ss, 0, kTrainTile, s_len - q0, d);
      load_tile(sDO, ld, dob + (long long)q0 * p.do_ss, p.do_ss, 0, kTrainTile, s_len - q0, d);
      if (tid < kTrainTile) {
        const bool in = q0 + tid < s_len;
        sLse[tid] = in ? lseb[q0 + tid] : 0.f;
        sDi[tid] = in ? dib[q0 + tid] : 0.f;
      }
      __syncthreads();

      // s = K Q^T and dp = V dO^T on this thread's 4 keys x 4 queries
      float sc[4][4], dp[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
      for (int c = 0; c < d; ++c) {
        float ka[4], va[4], qa[4], da[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          ka[i] = sK[(ty * 4 + i) * ld + c];
          va[i] = sV[(ty * 4 + i) * ld + c];
        }
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          qa[j] = sQ[(tx + 16 * j) * ld + c];
          da[j] = sDO[(tx + 16 * j) * ld + c];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            sc[i][j] = fmaf(ka[i], qa[j], sc[i][j]);
            dp[i][j] = fmaf(va[i], da[j], dp[i][j]);
          }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int kr = ty * 4 + i;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int qc = tx + 16 * j;
          const int qpos = q0 + qc;
          const bool ok = k0 + kr < s_len && qpos < s_len &&
                          (!kCausal || k0 + kr <= qpos) && sSegK[kr] == sSegQ[qc];
          const float pv = ok ? expf(sc[i][j] - sLse[qc]) : 0.f;
          const float ds = pv * (dp[i][j] - sDi[qc]);
          sP[kr * lds + qc] = round_to<T>(pv);
          sDS[kr * lds + qc] = round_to<T>(ds);
        }
      }
      __syncthreads();

      // dV += P dO, dK += dS Q on this thread's 4 keys x (D/16) dims
      for (int qq = 0; qq < kTrainTile; ++qq) {
        float pr[4], dr[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pr[i] = sP[(ty * 4 + i) * lds + qq];
          dr[i] = sDS[(ty * 4 + i) * lds + qq];
        }
#pragma unroll
        for (int j = 0; j < kMaxHeadDim / 16; ++j) {
          const int dd = tx + 16 * j;
          if (j < nd && dd < d) {
            const float dov = sDO[qq * ld + dd];
            const float qv = sQ[qq * ld + dd];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              dv[i][j] = fmaf(pr[i], dov, dv[i][j]);
              dk[i][j] = fmaf(dr[i], qv, dk[i][j]);
            }
          }
        }
      }
    }
  }

  T* dkb = static_cast<T*>(p.dk) + ((long long)b * s_len * p.hk + kvh) * d;
  T* dvb = static_cast<T*>(p.dv) + ((long long)b * s_len * p.hk + kvh) * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kpos = k0 + ty * 4 + i;
    if (kpos >= s_len) continue;
    const long long row = (long long)kpos * p.hk * d;
#pragma unroll
    for (int j = 0; j < kMaxHeadDim / 16; ++j) {
      const int dd = tx + 16 * j;
      if (j < nd && dd < d) {
        dkb[row + dd] = from_f<T>(dk[i][j]);
        dvb[row + dd] = from_f<T>(dv[i][j]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward dQ: block = (64-query tile, q head, row), 256 threads; walks the
// key tiles up to its causal frontier (all of them in the non-causal
// form). Each thread owns a 4x4 tile of the
// [64 queries, 64 keys] scores and 4 x (D/16) of the fp32 dq accumulator.
// ---------------------------------------------------------------------------
template <typename T, bool kCausal>
__global__ void __launch_bounds__(kBwdThreads) train_dq_kernel(TrainAttnParams p) {
  extern __shared__ float smem[];
  __shared__ int q_lo, q_hi;
  const int d = p.d;
  const int ld = d + 1;
  constexpr int lds = kTrainTile + 1;
  float* sQ = smem;                       // [64][ld]
  float* sDO = sQ + kTrainTile * ld;      // [64][ld]
  float* sK = sDO + kTrainTile * ld;      // [64][ld]
  float* sV = sK + kTrainTile * ld;       // [64][ld]
  float* sDS = sV + kTrainTile * ld;      // [64 queries][65] ds rounded to k's dtype
  float* sLse = sDS + kTrainTile * lds;   // [64]
  float* sDi = sLse + kTrainTile;         // [64]
  int* sSegQ = reinterpret_cast<int*>(sDi + kTrainTile);   // [64]
  int* sSegK = sSegQ + kTrainTile;                          // [64]

  const int tid = threadIdx.x;
  const int tx = tid % 16;
  const int ty = tid / 16;
  const int q0 = blockIdx.x * kTrainTile;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.hq / p.hk);
  const int nd = d / 16 + (d % 16 ? 1 : 0);
  const int s_len = p.s;
  const int* segb = p.seg + (long long)b * s_len;

  const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* dob = static_cast<const T*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const T* kb = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* vb = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  const float* lseb = p.lse + ((long long)b * p.hq + h) * s_len;
  const float* dib = p.di + ((long long)b * p.hq + h) * s_len;

  load_tile(sQ, ld, qb + (long long)q0 * p.q_ss, p.q_ss, 0, kTrainTile, s_len - q0, d);
  load_tile(sDO, ld, dob + (long long)q0 * p.do_ss, p.do_ss, 0, kTrainTile, s_len - q0, d);
  segment_range(&q_lo, &q_hi, segb, q0, s_len);
  if (tid < kTrainTile) {
    const bool in = q0 + tid < s_len;
    sSegQ[tid] = in ? segb[q0 + tid] : INT_MIN;
    sLse[tid] = in ? lseb[q0 + tid] : 0.f;
    sDi[tid] = in ? dib[q0 + tid] : 0.f;
  }

  float dq[4][kMaxHeadDim / 16];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kMaxHeadDim / 16; ++j) dq[i][j] = 0.f;

  const int kv_end = kCausal ? min(s_len, q0 + kTrainTile) : s_len;
  for (int k0 = 0; k0 < kv_end; k0 += kTrainTile) {
    __syncthreads();   // the previous step is done with sK, sV, sDS, sSegK
    const bool hit = load_segments(sSegK, segb, k0, s_len, INT_MAX, q_lo, q_hi);
    if (!__syncthreads_or(hit)) continue;
    load_tile(sK, ld, kb + (long long)k0 * p.k_ss, p.k_ss, 0, kTrainTile, s_len - k0, d);
    load_tile(sV, ld, vb + (long long)k0 * p.v_ss, p.v_ss, 0, kTrainTile, s_len - k0, d);
    __syncthreads();

    // s = Q K^T and dp = dO V^T on this thread's 4 queries x 4 keys
    float sc[4][4], dp[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sc[i][j] = dp[i][j] = 0.f;
    for (int c = 0; c < d; ++c) {
      float qa[4], da[4], ka[4], va[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        qa[i] = sQ[(ty * 4 + i) * ld + c];
        da[i] = sDO[(ty * 4 + i) * ld + c];
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ka[j] = sK[(tx + 16 * j) * ld + c];
        va[j] = sV[(tx + 16 * j) * ld + c];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          sc[i][j] = fmaf(qa[i], ka[j], sc[i][j]);
          dp[i][j] = fmaf(da[i], va[j], dp[i][j]);
        }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qr = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kc = tx + 16 * j;
        const int kpos = k0 + kc;
        const bool ok = kpos < s_len && q0 + qr < s_len && (!kCausal || kpos <= q0 + qr) &&
                        sSegK[kc] == sSegQ[qr];
        const float pv = ok ? expf(sc[i][j] - sLse[qr]) : 0.f;
        sDS[qr * lds + kc] = round_to<T>(pv * (dp[i][j] - sDi[qr]));
      }
    }
    __syncthreads();

    // dQ += dS K on this thread's 4 queries x (D/16) dims
    for (int kk = 0; kk < kTrainTile; ++kk) {
      float dr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) dr[i] = sDS[(ty * 4 + i) * lds + kk];
#pragma unroll
      for (int j = 0; j < kMaxHeadDim / 16; ++j) {
        const int dd = tx + 16 * j;
        if (j < nd && dd < d) {
          const float kv = sK[kk * ld + dd];
#pragma unroll
          for (int i = 0; i < 4; ++i) dq[i][j] = fmaf(dr[i], kv, dq[i][j]);
        }
      }
    }
  }

  T* dqb = static_cast<T*>(p.dq) + ((long long)b * s_len * p.hq + h) * d;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qpos = q0 + ty * 4 + i;
    if (qpos >= s_len) continue;
    const long long row = (long long)qpos * p.hq * d;
#pragma unroll
    for (int j = 0; j < kMaxHeadDim / 16; ++j) {
      const int dd = tx + 16 * j;
      if (j < nd && dd < d) dqb[row + dd] = from_f<T>(dq[i][j]);
    }
  }
}

template <typename Kernel>
int launch_train_kernel(Kernel kernel, dim3 grid, int threads, size_t smem, const TrainAttnParams& p,
                        cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// Fill the shapes and the (batch, seq, head) strides of q, k, v and, for the
// backward, do. Returns false for shapes the kernels do not take.
inline bool train_params(TrainAttnParams& p, int hq, int hk, int s, int d,
                         const long long* strides, bool backward) {
  p.hq = hq;
  p.hk = hk;
  p.s = s;
  p.d = d;
  p.q_sb = strides[0];  p.q_ss = strides[1];  p.q_sh = strides[2];
  p.k_sb = strides[3];  p.k_ss = strides[4];  p.k_sh = strides[5];
  p.v_sb = strides[6];  p.v_ss = strides[7];  p.v_sh = strides[8];
  p.do_sb = backward ? strides[9] : 0;
  p.do_ss = backward ? strides[10] : 0;
  p.do_sh = backward ? strides[11] : 0;
  return d > 0 && d <= kMaxHeadDim && d % 8 == 0 && hk > 0 && hq % hk == 0 && s > 0;
}

}  // namespace

}  // namespace livecc
