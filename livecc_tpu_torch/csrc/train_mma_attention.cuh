// K4 training attention (splash semantics) for bf16 operands on the tensor
// cores: the backward's dK/dV and dQ kernels, and the live-tile walk that
// they and the forward (train_wgmma_attention.cuh) share. fp32 operands
// stay on the FMA kernels of train_attention.cuh, whose contract and
// numerics these kernels keep (see there): query i attends key j iff
// seg[i] == seg[j] and, in the causal form, j <= i (the kCausal template
// flag; without it, splash's FullMask), q pre-scaled and rounded, masked
// scores at kSplashMask with p = 0, lse = m + log l in fp32 (the forward's),
// and di = rowsum(o * do) computed outside the kernels.
//
// Replaces, for bf16: the backward of livecc_tpu/ops/attention.py:
// _train_splash (JAX's Pallas splash MQA kernels' fused backward; :126) and
// of _train_flash_stock (:65), which share the contract of
// train_flash_attention (:39).
//
// What bounds it on the H100: compute. At the timed training shape (S =
// 8192 packed [2900, 2700, 2300] + 292 pad, Hq = 28, Hk = 4, D = 128) the
// backward needs 378 GFLOP against 219 MB, far above the card's ~295
// FLOP/byte ridge: the products have to run on the tensor cores. The
// design (FlashAttention-2 style, written by hand on mma_common.cuh's
// primitives):
//
//   * Tiles of 64 queries x 64 keys (kTrainMmaTileQ, kTrainMmaTileK); a
//     block is 4 warps, each owning 16 rows of its tile; every product is
//     mma.sync.m16n8k16 with bf16 operands and an fp32 accumulator.
//   * The streamed tiles go through a double-buffered shared ring of
//     16-byte cp.async copies (rows padded by 16 bytes, so an ldmatrix hits
//     8 distinct bank groups), with their segment ids, lse and di beside
//     them in 4-byte copies: the next tile's copy is in flight while this
//     tile's products run. Rows past S are zero-filled (src-size 0) and
//     masked.
//   * Work the data makes zero is never copied or computed. Each block first
//     reads the segment ids of its own tile and of the tiles it could walk,
//     on the device, and compacts the live ones into a list in shared memory
//     (live_tiles): a tile is live if it holds an id of the block's tile
//     (exact when the block's tile holds at most two ids, else any id in
//     their range). The ring then walks the list, so it never waits on, or
//     computes over, a skipped tile; a skipped tile's p would be 0
//     everywhere, so skipping changes no bit. At the timed shape about two
//     thirds of the causal tile pairs are skipped.
//   * dK/dV in transposed form: one block per (64-key tile, KV head, row)
//     walks the G q heads of its group and the live query tiles from its
//     diagonal on, so each dK/dV row is summed in one block (no atomics, no
//     K/V repeat). S^T = K Q^T and dP^T = V dO^T; P^T = exp(S^T - lse) is
//     the bf16 A fragment of dV += P^T dO (splash's p.astype(do.dtype)) and
//     dS^T = P^T (dP^T - di) that of dK += dS^T Q (ds.astype(do.dtype)):
//     the accumulator of one product is the A fragment of the next, so P
//     and dS never leave registers. Registers are the limit at D = 128: dK
//     and dV alone take 128 fp32 registers a thread, so K and V are re-read
//     from shared memory at each use, and a query tile is taken in two
//     passes of 32 queries, S^T and dP^T 16 registers each (with 64 at
//     once, ptxas spilled).
//   * dQ: one block per (64-query tile, q head, row): S = Q K^T, dP = dO
//     V^T, dS = P (dP - di) as the bf16 A fragment of dQ += dS K
//     (ds.astype(k.dtype)). It stays its own launch: a fused dQ would need
//     fp32 atomics across key-tile blocks (launches would differ in their
//     bits) or a second pass.
//   * Launch order: dQ's query tiles are launched from the last one down,
//     dK/dV's key tiles from the first up, so the blocks with the longest
//     causal walks start first.
//   * The non-causal form (kCausal = false): dQ's walks cover every live
//     key tile instead of stopping at the diagonal, dK/dV's every live
//     query tile instead of starting at it, and the masks test the segments
//     alone. The launch order stays; it means nothing there: a block's walk
//     is as long as the tiles its ids cover, wherever it sits.
//
// wgmma fed by TMA, as the forward has it, is later work here: dK / dV
// need P^T and dS^T as operands, which would go through shared memory.

#pragma once

#include <climits>

#include "mma_common.cuh"
#include "train_attention.cuh"

namespace livecc {

constexpr int kTrainMmaTileQ = 64;     // queries per tile (16 per warp in dQ)
constexpr int kTrainMmaTileK = 64;     // keys per tile (16 per warp in dK/dV)
constexpr int kTrainMmaThreads = 128;  // 4 warps

inline int train_mma_tiles(int s) { return (s + kTrainMmaTileQ - 1) / kTrainMmaTileQ; }

// Dynamic shared memory of each kernel at head dim d for sequence length s:
// bf16 tiles of 64 padded rows, then fp32 (lse, di) and int (ids, list).
inline size_t train_mma_dkv_smem(int d, int s) {     // K, V, 2 Q, 2 dO | 2 lse, 2 di | ids
  return sizeof(__nv_bfloat16) * 6 * 64 * (size_t)(d + kMmaPad) + sizeof(float) * 4 * 64 +
         sizeof(int) * (3 * 64 + (size_t)train_mma_tiles(s));
}
inline size_t train_mma_dq_smem(int d, int s) {      // Q, dO, 2 K, 2 V | ids
  return sizeof(__nv_bfloat16) * 6 * 64 * (size_t)(d + kMmaPad) +
         sizeof(int) * (3 * 64 + (size_t)train_mma_tiles(s));
}

namespace {

// 4 bytes from global to shared, zero-filled where `valid` is false
__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(valid ? 4 : 0));
}

// Which tiles a block walks: its own ROWS rows' segment ids (rows [r0, r0 +
// ROWS) below s) into ids[ROWS] (`pad` past s), then the KT-row tiles t in
// [t0, t1) that hold one of those ids, compacted in order into list[] (t1 -
// t0 ints), by the block's THREADS threads; scratch holds ROWS / 32 + 1
// ints. Exact when the block's rows hold at most two ids; otherwise a tile
// is kept when it holds any id in their range (a superset: the masks
// decide). With `uni` (t1 - t0 ints), each listed tile's one id where all
// its KT rows lie below s and hold that id, else INT_MIN, beside it.
// Returns the number of live tiles, the same in every thread.
template <int ROWS, int KT, int THREADS>
__device__ int live_tiles(int* ids, int* list, int* scratch, const int* segb, int s, int r0,
                          int pad, int t0, int t1, int* uni = nullptr) {
  constexpr int kWarps = ROWS / 32;         // warps w < kWarps hold rows 32 w .. 32 w + 31
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const bool in = tid < ROWS && r0 + tid < s;
  const int id = in ? segb[r0 + tid] : 0;
  if (tid < ROWS) ids[tid] = in ? id : pad;
  int lo = in ? id : INT_MAX, hi = in ? id : INT_MIN;
#pragma unroll
  for (int o = 16; o > 0; o /= 2) {
    lo = min(lo, __shfl_xor_sync(0xffffffffu, lo, o));
    hi = max(hi, __shfl_xor_sync(0xffffffffu, hi, o));
  }
  if (warp < kWarps && lane == 0) scratch[warp] = lo;
  __syncthreads();
  lo = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) lo = min(lo, scratch[w]);
  __syncthreads();
  if (warp < kWarps && lane == 0) scratch[warp] = hi;
  __syncthreads();
  hi = scratch[0];
#pragma unroll
  for (int w = 1; w < kWarps; ++w) hi = max(hi, scratch[w]);
  const bool three = __syncthreads_or(in && id != lo && id != hi);   // 3+ distinct ids

  const int n = t1 - t0;
  for (int i = tid; i < n; i += THREADS) {
    const int a = (t0 + i) * KT, e = min(a + KT, s);
    const int first = segb[a];
    bool hit = false, same = e - a == KT;
#pragma unroll 16
    for (int r = a; r < e; ++r) {
      const int x = segb[r];
      hit |= three ? (x >= lo && x <= hi) : (x == lo || x == hi);
      same &= x == first;
    }
    list[i] = hit;
    if (uni) uni[i] = same ? first : INT_MIN;
  }
  __syncthreads();
  if (warp == 0) {
    int count = 0;
    for (int base = 0; base < n; base += 32) {
      const bool f = base + lane < n && list[base + lane];
      const int u = f && uni ? uni[base + lane] : 0;
      const unsigned m = __ballot_sync(0xffffffffu, f);
      const int at = count + __popc(m & ((1u << lane) - 1u));
      if (f) list[at] = t0 + base + lane;
      if (f && uni) uni[at] = u;
      count += __popc(m);
      __syncwarp();
    }
    if (lane == 0) scratch[kWarps] = count;
  }
  __syncthreads();
  return scratch[kWarps];
}

// ---------------------------------------------------------------------------
// Backward dK/dV: block = (KV head, row, 64-key tile from the first up); the
// ring walks (q head g of the group, live query tile) pairs.
// ---------------------------------------------------------------------------
template <int D, bool kCausal>
__global__ void __launch_bounds__(kTrainMmaThreads, 1) train_dkv_mma_kernel(TrainAttnParams p) {
  static_assert(D % 16 == 0 && D <= kMaxHeadDim, "head dim: a multiple of 16 up to 128");
  constexpr int kLd = D + kMmaPad;
  constexpr int kT = kTrainMmaTileQ;        // queries per streamed tile
  constexpr int kQh = 32;                   // queries per pass over the tile
  constexpr int kKSteps = D / 16;
  constexpr int kNh = kQh / 8;              // n8 tiles of a warp's 16 keys x 32 queries
  constexpr int kDt = D / 8;
  extern __shared__ __align__(16) unsigned char train_smem[];
  __shared__ int shared3[3];
  __nv_bfloat16* sK = reinterpret_cast<__nv_bfloat16*>(train_smem);   // [64][kLd]
  __nv_bfloat16* sV = sK + kTrainMmaTileK * kLd;                       // [64][kLd]
  __nv_bfloat16* sQ = sV + kTrainMmaTileK * kLd;                       // [2][64][kLd]
  __nv_bfloat16* sDO = sQ + 2 * kT * kLd;                              // [2][64][kLd]
  float* sLse = reinterpret_cast<float*>(sDO + 2 * kT * kLd);          // [2][64]
  float* sDi = sLse + 2 * kT;                                          // [2][64]
  int* sSegK = reinterpret_cast<int*>(sDi + 2 * kT);                   // [64]
  int* sSegQ = sSegK + kTrainMmaTileK;                                 // [2][64]
  int* sList = sSegQ + 2 * kT;                                         // [tiles]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const int kt = blockIdx.z;                // heaviest first: the longest walk is tile 0's
  const int k0 = kt * kTrainMmaTileK;
  const int s = p.s;
  const int groups = p.hq / p.hk;
  const int* segb = p.seg + (long long)b * s;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  cp_tile<D, kTrainMmaThreads>(sK, kb + (long long)k0 * p.k_ss, p.k_ss, kTrainMmaTileK, s - k0);
  cp_tile<D, kTrainMmaThreads>(sV, vb + (long long)k0 * p.v_ss, p.v_ss, kTrainMmaTileK, s - k0);
  const int n_live = live_tiles<kTrainMmaTileK, kTrainMmaTileQ, kTrainMmaThreads>(
      sSegK, sList, shared3, segb, s, k0, INT_MAX, kCausal ? kt : 0, (int)gridDim.z);
  const int total = groups * n_live;

  auto fetch = [&](int i, int buf) {        // (q head i / n_live, query tile list[i % n_live])
    const int h = kvh * groups + i / n_live;
    const int q0 = sList[i % n_live] * kT;
    const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
    const __nv_bfloat16* dob =
        static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh;
    cp_tile<D, kTrainMmaThreads>(sQ + buf * kT * kLd, qb + (long long)q0 * p.q_ss, p.q_ss, kT,
                                 s - q0);
    cp_tile<D, kTrainMmaThreads>(sDO + buf * kT * kLd, dob + (long long)q0 * p.do_ss, p.do_ss, kT,
                                 s - q0);
    const int r = min(q0 + tid % kT, s - 1);
    const bool ok = q0 + tid % kT < s;
    const long long row = ((long long)b * p.hq + h) * s + r;
    if (tid < kT) {
      cp_async4(sLse + buf * kT + tid, p.lse + row, ok);
      cp_async4(sSegQ + buf * kT + tid, segb + r, ok);
    } else {
      cp_async4(sDi + buf * kT + tid - kT, p.di + row, ok);
    }
  };
  fetch(0, 0);                              // n_live >= 1: the diagonal tile
  cp_async_commit();

  float dk[kDt][4], dv[kDt][4];
#pragma unroll
  for (int j = 0; j < kDt; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[j][e] = dv[j][e] = 0.f;
  const int kl_a = warp * 16 + gid;         // the thread's two key rows in the tile
  const int key_a = k0 + kl_a, key_b = key_a + 8;
  const int seg_a = sSegK[kl_a], seg_b = sSegK[kl_a + 8];

  for (int i = 0; i < total; ++i) {
    const int buf = i & 1;
    if (i + 1 < total) {
      fetch(i + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int q0 = sList[i % n_live] * kT;
    const __nv_bfloat16* tQ = sQ + buf * kT * kLd;
    const __nv_bfloat16* tDO = sDO + buf * kT * kLd;
    const float* tLse = sLse + buf * kT;
    const float* tDi = sDi + buf * kT;
    const int* tSeg = sSegQ + buf * kT;

#pragma unroll 1
    for (int qh = 0; qh < kT; qh += kQh) {  // 32 queries at a time (registers)
      // S^T = K Q^T: this warp's 16 keys x 32 queries
      float st[kNh][4];
#pragma unroll
      for (int j = 0; j < kNh; ++j) st[j][0] = st[j][1] = st[j][2] = st[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, sK + (warp * 16 + lane % 16) * kLd + kk * 16 + (lane / 16) * 8);
#pragma unroll
        for (int j = 0; j < kNh; j += 2) {
          uint32_t bq[4];
          ldmatrix_x4(bq, tQ + (qh + j * 8 + lane % 8 + (lane / 16) * 8) * kLd + kk * 16 +
                              ((lane / 8) % 2) * 8);
          mma_bf16(st[j], a, bq[0], bq[1]);
          mma_bf16(st[j + 1], a, bq[2], bq[3]);
        }
      }
      // P^T = exp(S^T - lse) where allowed, else 0
#pragma unroll
      for (int j = 0; j < kNh; ++j) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int ql = qh + j * 8 + 2 * tig + (e & 1);
          const int query = q0 + ql;
          const int key = e < 2 ? key_a : key_b;
          const bool ok = query < s && key < s && (!kCausal || key <= query) &&
                          tSeg[ql] == (e < 2 ? seg_a : seg_b);
          st[j][e] = ok ? __expf(st[j][e] - tLse[ql]) : 0.f;
        }
      }
      // dV += P^T dO (P^T rounded to bf16)
#pragma unroll
      for (int kk = 0; kk < kNh / 2; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(st[2 * kk][0], st[2 * kk][1]);
        a[1] = pack_bf16(st[2 * kk][2], st[2 * kk][3]);
        a[2] = pack_bf16(st[2 * kk + 1][0], st[2 * kk + 1][1]);
        a[3] = pack_bf16(st[2 * kk + 1][2], st[2 * kk + 1][3]);
#pragma unroll
        for (int j = 0; j < kDt; j += 2) {
          uint32_t bo[4];
          ldmatrix_x4_trans(bo, tDO + (qh + kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kLd +
                                    j * 8 + (lane / 16) * 8);
          mma_bf16(dv[j], a, bo[0], bo[1]);
          mma_bf16(dv[j + 1], a, bo[2], bo[3]);
        }
      }
      // dP^T = V dO^T, then dS^T = P^T (dP^T - di) in place
      float dpt[kNh][4];
#pragma unroll
      for (int j = 0; j < kNh; ++j) dpt[j][0] = dpt[j][1] = dpt[j][2] = dpt[j][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < kKSteps; ++kk) {
        uint32_t a[4];
        ldmatrix_x4(a, sV + (warp * 16 + lane % 16) * kLd + kk * 16 + (lane / 16) * 8);
#pragma unroll
        for (int j = 0; j < kNh; j += 2) {
          uint32_t bo[4];
          ldmatrix_x4(bo, tDO + (qh + j * 8 + lane % 8 + (lane / 16) * 8) * kLd + kk * 16 +
                              ((lane / 8) % 2) * 8);
          mma_bf16(dpt[j], a, bo[0], bo[1]);
          mma_bf16(dpt[j + 1], a, bo[2], bo[3]);
        }
      }
#pragma unroll
      for (int j = 0; j < kNh; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dpt[j][e] = st[j][e] * (dpt[j][e] - tDi[qh + j * 8 + 2 * tig + (e & 1)]);
      // dK += dS^T Q (dS^T rounded to bf16)
#pragma unroll
      for (int kk = 0; kk < kNh / 2; ++kk) {
        uint32_t a[4];
        a[0] = pack_bf16(dpt[2 * kk][0], dpt[2 * kk][1]);
        a[1] = pack_bf16(dpt[2 * kk][2], dpt[2 * kk][3]);
        a[2] = pack_bf16(dpt[2 * kk + 1][0], dpt[2 * kk + 1][1]);
        a[3] = pack_bf16(dpt[2 * kk + 1][2], dpt[2 * kk + 1][3]);
#pragma unroll
        for (int j = 0; j < kDt; j += 2) {
          uint32_t bq[4];
          ldmatrix_x4_trans(bq, tQ + (qh + kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kLd +
                                    j * 8 + (lane / 16) * 8);
          mma_bf16(dk[j], a, bq[0], bq[1]);
          mma_bf16(dk[j + 1], a, bq[2], bq[3]);
        }
      }
    }
    __syncthreads();                        // all warps are done with this slot
  }

  __nv_bfloat16* dkb = static_cast<__nv_bfloat16*>(p.dk) + ((long long)b * s * p.hk + kvh) * D;
  __nv_bfloat16* dvb = static_cast<__nv_bfloat16*>(p.dv) + ((long long)b * s * p.hk + kvh) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int key = r ? key_b : key_a;
    if (key >= s) continue;
    const long long off = (long long)key * p.hk * D + 2 * tig;
#pragma unroll
    for (int j = 0; j < kDt; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + off + j * 8) =
          __floats2bfloat162_rn(dk[j][2 * r], dk[j][2 * r + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + off + j * 8) =
          __floats2bfloat162_rn(dv[j][2 * r], dv[j][2 * r + 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// Backward dQ: block = (q head, row, 64-query tile from the last down).
// ---------------------------------------------------------------------------
template <int D, bool kCausal>
__global__ void __launch_bounds__(kTrainMmaThreads, 1) train_dq_mma_kernel(TrainAttnParams p) {
  static_assert(D % 16 == 0 && D <= kMaxHeadDim, "head dim: a multiple of 16 up to 128");
  constexpr int kLd = D + kMmaPad;
  constexpr int kT = kTrainMmaTileK;
  constexpr int kKSteps = D / 16;
  constexpr int kNt = kT / 8;
  constexpr int kDt = D / 8;
  extern __shared__ __align__(16) unsigned char train_smem[];
  __shared__ int shared3[3];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(train_smem);   // [64][kLd]
  __nv_bfloat16* sDO = sQ + kTrainMmaTileQ * kLd;                      // [64][kLd]
  __nv_bfloat16* sK = sDO + kTrainMmaTileQ * kLd;                      // [2][64][kLd]
  __nv_bfloat16* sV = sK + 2 * kT * kLd;                               // [2][64][kLd]
  int* sSegQ = reinterpret_cast<int*>(sV + 2 * kT * kLd);              // [64]
  int* sSegK = sSegQ + kTrainMmaTileQ;                                 // [2][64]
  int* sList = sSegK + 2 * kT;                                         // [tiles]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int h = blockIdx.x, b = blockIdx.y;
  const int qt = gridDim.z - 1 - blockIdx.z;
  const int q0 = qt * kTrainMmaTileQ;
  const int s = p.s;
  const int kvh = h / (p.hq / p.hk);
  const int* segb = p.seg + (long long)b * s;
  const __nv_bfloat16* qb = static_cast<const __nv_bfloat16*>(p.q) + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* dob = static_cast<const __nv_bfloat16*>(p.dout) + b * p.do_sb + h * p.do_sh;
  const __nv_bfloat16* kb = static_cast<const __nv_bfloat16*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const __nv_bfloat16* vb = static_cast<const __nv_bfloat16*>(p.v) + b * p.v_sb + kvh * p.v_sh;

  cp_tile<D, kTrainMmaThreads>(sQ, qb + (long long)q0 * p.q_ss, p.q_ss, kTrainMmaTileQ, s - q0);
  cp_tile<D, kTrainMmaThreads>(sDO, dob + (long long)q0 * p.do_ss, p.do_ss, kTrainMmaTileQ,
                               s - q0);
  const int n_live = live_tiles<kTrainMmaTileQ, kTrainMmaTileK, kTrainMmaThreads>(
      sSegQ, sList, shared3, segb, s, q0, INT_MIN, 0, kCausal ? qt + 1 : (int)gridDim.z);

  auto fetch = [&](int i, int buf) {
    const int k0 = sList[i] * kT;
    cp_tile<D, kTrainMmaThreads>(sK + buf * kT * kLd, kb + (long long)k0 * p.k_ss, p.k_ss, kT,
                                 s - k0);
    cp_tile<D, kTrainMmaThreads>(sV + buf * kT * kLd, vb + (long long)k0 * p.v_ss, p.v_ss, kT,
                                 s - k0);
    if (tid < kT) cp_async4(sSegK + buf * kT + tid, segb + min(k0 + tid, s - 1), k0 + tid < s);
  };
  fetch(0, 0);
  cp_async_commit();

  const int rl_a = warp * 16 + gid;
  const int row_a = q0 + rl_a, row_b = row_a + 8;
  const int seg_a = sSegQ[rl_a], seg_b = sSegQ[rl_a + 8];
  const float* lseb = p.lse + ((long long)b * p.hq + h) * s;
  const float* dib = p.di + ((long long)b * p.hq + h) * s;
  const float lse_a = row_a < s ? lseb[row_a] : 0.f, lse_b = row_b < s ? lseb[row_b] : 0.f;
  const float di_a = row_a < s ? dib[row_a] : 0.f, di_b = row_b < s ? dib[row_b] : 0.f;
  float dq[kDt][4];
#pragma unroll
  for (int j = 0; j < kDt; ++j) dq[j][0] = dq[j][1] = dq[j][2] = dq[j][3] = 0.f;

  for (int i = 0; i < n_live; ++i) {
    const int buf = i & 1;
    if (i + 1 < n_live) {
      fetch(i + 1, buf ^ 1);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int k0 = sList[i] * kT;
    const __nv_bfloat16* tK = sK + buf * kT * kLd;
    const __nv_bfloat16* tV = sV + buf * kT * kLd;
    const int* tSeg = sSegK + buf * kT;

    // S = Q K^T and dP = dO V^T: this warp's 16 queries x 64 keys
    float sc[kNt][4], dp[kNt][4];
#pragma unroll
    for (int j = 0; j < kNt; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) sc[j][e] = dp[j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < kKSteps; ++kk) {
      uint32_t aq[4], ad[4];
      ldmatrix_x4(aq, sQ + (warp * 16 + lane % 16) * kLd + kk * 16 + (lane / 16) * 8);
      ldmatrix_x4(ad, sDO + (warp * 16 + lane % 16) * kLd + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < kNt; j += 2) {
        uint32_t bk[4], bv[4];
        const int at = (j * 8 + lane % 8 + (lane / 16) * 8) * kLd + kk * 16 + ((lane / 8) % 2) * 8;
        ldmatrix_x4(bk, tK + at);
        ldmatrix_x4(bv, tV + at);
        mma_bf16(sc[j], aq, bk[0], bk[1]);
        mma_bf16(sc[j + 1], aq, bk[2], bk[3]);
        mma_bf16(dp[j], ad, bv[0], bv[1]);
        mma_bf16(dp[j + 1], ad, bv[2], bv[3]);
      }
    }
    // dS = P (dP - di), P = exp(S - lse) where allowed, else 0
#pragma unroll
    for (int j = 0; j < kNt; ++j) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int kl = j * 8 + 2 * tig + (e & 1);
        const int key = k0 + kl;
        const int r = e >> 1;
        const bool ok = key < s && (!kCausal || key <= (r ? row_b : row_a)) &&
                        tSeg[kl] == (r ? seg_b : seg_a);
        const float pv = ok ? __expf(sc[j][e] - (r ? lse_b : lse_a)) : 0.f;
        dp[j][e] = pv * (dp[j][e] - (r ? di_b : di_a));
      }
    }
    // dQ += dS K (dS rounded to bf16); K read transposed
#pragma unroll
    for (int kk = 0; kk < kNt / 2; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(dp[2 * kk][0], dp[2 * kk][1]);
      a[1] = pack_bf16(dp[2 * kk][2], dp[2 * kk][3]);
      a[2] = pack_bf16(dp[2 * kk + 1][0], dp[2 * kk + 1][1]);
      a[3] = pack_bf16(dp[2 * kk + 1][2], dp[2 * kk + 1][3]);
#pragma unroll
      for (int j = 0; j < kDt; j += 2) {
        uint32_t bk[4];
        ldmatrix_x4_trans(bk, tK + (kk * 16 + lane % 8 + ((lane / 8) % 2) * 8) * kLd + j * 8 +
                                  (lane / 16) * 8);
        mma_bf16(dq[j], a, bk[0], bk[1]);
        mma_bf16(dq[j + 1], a, bk[2], bk[3]);
      }
    }
    __syncthreads();
  }

  __nv_bfloat16* dqb = static_cast<__nv_bfloat16*>(p.dq) + ((long long)b * s * p.hq + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = r ? row_b : row_a;
    if (row >= s) continue;
    __nv_bfloat16* drow = dqb + (long long)row * p.hq * D + 2 * tig;
#pragma unroll
    for (int j = 0; j < kDt; ++j)
      *reinterpret_cast<__nv_bfloat162*>(drow + j * 8) =
          __floats2bfloat162_rn(dq[j][2 * r], dq[j][2 * r + 1]);
  }
}

template <typename Kernel>
int launch_train_mma(Kernel kernel, dim3 grid, size_t smem, const TrainAttnParams& p,
                     cudaStream_t stream) {
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kTrainMmaThreads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The backward of bf16 operands: dK/dV over (Hk, B, key tiles), then dQ over
// (Hq, B, query tiles), on one stream.
template <int D, bool kCausal>
int launch_train_bwd_mma(const TrainAttnParams& p, int batch, cudaStream_t stream) {
  const int tiles = train_mma_tiles(p.s);
  const int err = launch_train_mma(train_dkv_mma_kernel<D, kCausal>, dim3(p.hk, batch, tiles),
                                   train_mma_dkv_smem(D, p.s), p, stream);
  if (err) return err;
  return launch_train_mma(train_dq_mma_kernel<D, kCausal>, dim3(p.hq, batch, tiles),
                          train_mma_dq_smem(D, p.s), p, stream);
}

}  // namespace

}  // namespace livecc
