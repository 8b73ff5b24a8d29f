// One-token GQA decode attention over the KV cache, shared by K2
// (flash_decode.cu: fp32 and bf16) and its int8 variant
// (flash_decode_int8.cu: QUANT), as one kernel launch on the caller's stream.
//
// Replaces livecc_tpu/ops/pallas/attention.py:253 flash_decode
// (_decode_kernel, :198; its int8 branch :220-238). The TPU kernel walks a
// row's keys in blocks of bk = 512 along a sequential grid dimension and
// keeps an online softmax in VMEM scratch. On Hopper that dimension becomes
// splits across blocks, merged at the end.
//
// What bounds it on the H100: bytes. A call reads each valid K / V row once
// for the G = Hq / Hk query heads of its KV head, ~4 G FLOP a byte (28 at
// the 7B's G = 7), against the card's ~295 FLOP/byte ridge: the pool's
// B = 8 step reads 50 MB of bf16 cache, 15 us at 3.35 TB/s. At B = 1 (1.6 MB)
// it is a matter of latency. The design:
//
//   1. Grid (Hk, B, ceil(Smax / kDecSplit)): block (KV head, row, split)
//      owns the keys [split * kDecSplit, +kDecSplit) below kv_limit[b],
//      read on the device (no host sync; the grid depends on Smax and B
//      alone). The span is one constant for every shape, so a row's partials
//      and bits depend only on its own keys; 256 keys ran every timed case
//      faster than the two-launch kernel it replaced, 512 and 1024 did not
//      (tools/decode_span_sweep.py, PERF.md). A block past the row's live
//      splits returns at once.
//   2. One producer warp streams the split's K tiles, then its V tiles (64
//      keys each, with the tile's bf16 k / v scales for QUANT) into a ring of
//      at least three stages (64 KB), handed over by full and empty
//      mbarriers (hopper_common.cuh); four consumer warps compute on the
//      tiles that have arrived while the next ones land, so a split's V
//      tiles load while its softmax runs. Two routes, chosen at launch:
//        * TMA (bf16 q, rows of 128 or 256 bytes: bf16 D = 64 / 128, int8
//          D = 128; the paths' shapes): the producer's first lane loads a
//          tile as one or two 128-byte-swizzled boxes of 64 rows from K's /
//          V's tensor map over the stacked cache (the wrapper encodes them
//          once per cache, ops/flash_attention.py:_decode_maps), and the
//          scales as one 1-D bulk copy. Rows past Smax read as zeros.
//        * cp.async (every other shape): the producer's lanes copy the
//          valid rows as 16- or 8-byte pieces into rows padded by 16 bytes
//          (so ldmatrix reads 8 rows at one column without a bank
//          conflict), each lane's cp.async.mbarrier.arrive completing the
//          stage once its pieces land.
//      A warp's cp.async pieces, or one small TMA copy a row, kept only
//      ~8 KB a block in flight (a tile every ~2000 cycles; PERF.md);
//      a box is 8 KB in one request.
//   3. Numerics, as the TPU kernel's and as flash_decode_split_plain /
//      flash_decode_merge_plain mirror them: s = q.k * d^-0.5 in fp32
//      (QUANT: (q.k * d^-0.5) * k_scale[key]); the split's scores [G, span]
//      stay in shared memory in fp32; one m_split a split and p = exp(s -
//      m_split); l sums p before any rounding or value scale; p is rounded to
//      T for P.V (QUANT: p * v_scale[key] stays fp32 against V widened
//      exactly); normalisation after the merge.
//   4. bf16 q: Q.K^T on the tensor cores, mma.sync m16n8k16 with the KV
//      head's G query heads as the A rows (padded to 16; up to 16 heads a
//      pass, more in passes over the same keys), each consumer warp 16 keys
//      of a tile. An int8 K row widens to bf16 exactly; each lane reads 4
//      codes of one row in one word, so the k slots of a lane hold 4
//      consecutive columns (q's fragments follow the same order). bf16 P.V
//      is mma.sync too: P (fp32 already rounded to bf16) from shared memory
//      as the A fragments, V by ldmatrix.trans, each warp a quarter of the
//      n8 column tiles. wgmma is not used: its 64-row tile would waste at
//      least 48 of 64 rows at G = 7, and the tensor work (~2 FLOP a byte of
//      cache a head) is far below what either instruction leaves idle.
//      QUANT P.V (D a multiple of 16) is mma.sync too, p * v_scale (fp32)
//      as three bf16 parts, each the rounding of what the earlier ones left,
//      against V widened exactly: on the FMA pipes K2-int8 at B = 8 took
//      0.078 ms, on mma.sync 0.065 (PERF.md). Other head dims and fp32 q
//      (the tiny model's CPU = GPU parity path) run on the FMA pipes over
//      the same ring.
//   5. One launch: each live split block writes its partials (m, l, acc
//      [G, D]) to the workspace, then __threadfence() and one ticket from a
//      per-(row, KV head) int32 arrival counter. The block that takes the
//      ticket of the row's last live split (counted from kv_limit) merges
//      that row's splits in split order (o = sum_s e^{m_s - M} acc_s / sum_s
//      e^{m_s - M} l_s), writes o for its G heads and sets the counter back
//      to 0, so every launch leaves the counters zero. The order of the
//      merge does not depend on which block finishes last, so two launches
//      (and a graph replay) give the same bits. A row with no valid key
//      writes exactly 0 (block 0 of the row, no ticket).
//
// The counters live in one buffer per device made zeroed by the wrapper
// (ops/flash_attention.py:_arrival_counters): two decode launches that run
// at once on one device (two streams) would share them (ROADMAP hazards).

#pragma once

#include <cstring>
#include <initializer_list>
#include <math_constants.h>

#include "hopper_common.cuh"

namespace livecc {
namespace {

constexpr int kDecSplit = 256;       // keys per split block (ops/flash_attention.py:DECODE_SPLIT)
constexpr int kDecTile = 64;         // keys per ring stage
constexpr int kDecWarps = 4;         // consumer warps
constexpr int kDecConsumers = 32 * kDecWarps;
constexpr int kDecThreads = kDecConsumers + 32;   // and the producer warp
constexpr int kDecHeads = 16;        // query heads a pass: the products' m16 rows
constexpr int kDecMaxOut = 2048;     // G * D per launch: G <= 16 at D = 128
constexpr int kDecMaxKeys = 196608;  // the largest Smax taken
constexpr int kDecScoreLd = kDecSplit + 8;   // fp32 score row stride: P fragments without conflicts
constexpr int kDecRowPad = 16;       // bytes after each K / V row in the ring
constexpr int kDecMinStages = 3;
constexpr int kDecMaxStages = 8;
constexpr int kDecRingBytes = 64 * 1024;   // stages: as many as fit, within the bounds above
constexpr int kDecTma = 0;           // route: TMA boxes (else cp.async pieces of 16 or 8 bytes)

// K's and V's tensor maps over the stacked cache [L, B, Hk, Smax, D]
// (livecc_decode_kv_map): 128-byte-swizzled boxes of 64 rows x 128 bytes
struct DecodeMaps {
  CUtensorMap k, v;
};

struct DecodeParams {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* kv_limit;
  const __nv_bfloat16* k_scale;   // QUANT: [B, Hk, 1, Skv] lane-major scales
  const __nv_bfloat16* v_scale;
  float* ws;                      // m [B, Hq, nsplit], l [B, Hq, nsplit], acc [B, Hq, nsplit, D]
  int* counters;                  // [B * Hk] arrival counters, zero between launches
  int batch, hq, hk, skv, d, nsplit, layer;
  int row_ld, stage_bytes, stages;   // the ring: row stride (bytes), bytes a stage, stages
  int scale_off;                  // QUANT: where a stage's scales start (bytes)
  int scales_async;               // QUANT: the scale rows take 16-byte cp.async pieces
  long long q_sb, q_sh;
  long long k_sb, k_sh, k_ss;
  long long v_sb, v_sh, v_ss;
  long long o_sb, o_sh;
  long long ks_sb, ks_sh, vs_sb, vs_sh;
  float scale;
};

__host__ __device__ inline int align_up(int n, int a) { return (n + a - 1) / a * a; }

// Dynamic shared memory: the ring (1024-byte aligned, as the swizzle
// wants), then fp32 scores [kDecHeads][kDecScoreLd], q [kDecHeads][d]
// (fp32, or bf16 rows of d + 8), the merge's sums [kDecHeads].
inline size_t decode_smem_bytes(const DecodeParams& p) {
  return 1024 + (size_t)p.stages * p.stage_bytes +
         sizeof(float) * ((size_t)kDecHeads * kDecScoreLd + (size_t)kDecHeads * p.d + kDecHeads);
}

// The byte `x` of row `r` of a ring stage: TMA's 128-byte swizzle over boxes
// of 64 rows x 128 bytes (a row's 16-byte piece c sits at c ^ (r % 8)), or
// rows `row_ld` bytes apart, padded against bank conflicts.
template <int ROUTE>
__device__ __forceinline__ const unsigned char* kv_at(const unsigned char* stage, int row_ld, int r,
                                                      int x) {
  if constexpr (ROUTE == kDecTma)
    return stage + (x >> 7) * (kDecTile * 128) + r * 128 + ((((x >> 4) & 7) ^ (r & 7)) << 4) +
           (x & 15);
  else
    return stage + r * row_ld + x;
}

// Four elements of a K / V row in shared memory, widened exactly to fp32.
__device__ __forceinline__ void widen4(float (&out)[4], const float* src) {
  const float4 r = *reinterpret_cast<const float4*>(src);
  out[0] = r.x; out[1] = r.y; out[2] = r.z; out[3] = r.w;
}
// four int8 codes, exactly: 2^23 + (code + 128) by a byte permute, less
// 2^23 + 128, on the full-rate pipes (a conversion runs at a quarter rate)
__device__ __forceinline__ void widen4(float (&out)[4], const int8_t* src) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(src) ^ 0x80808080u;
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[i] = __uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 + i)) - 8388736.f;
}

__device__ __forceinline__ uint32_t bf16_bits(const __nv_bfloat16* p) {
  return *reinterpret_cast<const unsigned short*>(p);
}

// BYTES (8 or 16) from global to shared by cp.async
template <int BYTES>
__device__ __forceinline__ void cp_async_piece(void* dst, const void* src) {
  if constexpr (BYTES == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" :: "r"(smem_addr(dst)), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" :: "r"(smem_addr(dst)), "l"(src));
}

// The producer warp: for each pass of query heads, the split's K tiles then
// its V tiles into the ring, stage by stage as the consumers free them.
template <typename KV, bool QUANT, int ROUTE>
__device__ __forceinline__ void decode_produce(const DecodeParams& p, const DecodeMaps& maps,
                                               unsigned char* ring, uint64_t* full,
                                               uint64_t* empty, int b, int kvh, int k0, int n,
                                               int passes, int lane) {
  constexpr int kPiece = ROUTE == kDecTma ? 16 : ROUTE;
  const int row_bytes = p.d * (int)sizeof(KV);
  const int pieces = row_bytes / kPiece;              // a row's pieces, at most 32 (cp.async)
  const int r0 = lane / pieces, c0 = lane % pieces, rstep = 32 / pieces, cstep = 32 % pieces;
  const int ntiles = (n + kDecTile - 1) / kDecTile;
  int st = 0;
  uint32_t phase = 0;
  for (int pass = 0; pass < passes; ++pass) {
    for (int kv = 0; kv < 2; ++kv) {
      const KV* src = static_cast<const KV*>(kv ? p.v : p.k) + b * (kv ? p.v_sb : p.k_sb) +
                      kvh * (kv ? p.v_sh : p.k_sh);
      const long long ss = kv ? p.v_ss : p.k_ss;
      const long long row_gap = ss * (long long)sizeof(KV);    // bytes between rows
      const long long from_step = rstep * row_gap + cstep * kPiece;
      const int to_step = rstep * p.row_ld + cstep * kPiece;
      const __nv_bfloat16* scale = nullptr;
      if (QUANT) scale = kv ? p.v_scale + b * p.vs_sb + kvh * p.vs_sh
                            : p.k_scale + b * p.ks_sb + kvh * p.ks_sh;
      for (int t = 0; t < ntiles; ++t) {
        const int key0 = k0 + t * kDecTile;
        const int rows = min(kDecTile, n - t * kDecTile);
        mbar_wait(&empty[st], phase ^ 1);
        unsigned char* stage = ring + (size_t)st * p.stage_bytes;
        unsigned char* sScale = stage + p.scale_off;
        const KV* tile = src + (long long)key0 * ss;
        if constexpr (ROUTE == kDecTma) {
          // the tile's 64 rows as boxes of 128 bytes (rows past Smax read 0),
          // its valid keys' scales as one bulk copy
          if (lane == 0) {
            const int scale_bytes = QUANT ? align_up(rows * 2, 16) : 0;
            mbar_expect_tx(&full[st], kDecTile * row_bytes + scale_bytes);
            const CUtensorMap* map = kv ? &maps.v : &maps.k;
            for (int c = 0; c < row_bytes / 128; ++c)
              tma_load_5d(stage + c * kDecTile * 128, map, c * 128 / (int)sizeof(KV), key0, kvh, b,
                          p.layer, &full[st]);
            if (QUANT) bulk_load(sScale, scale + key0, scale_bytes, &full[st]);
          }
        } else {
          // lane l copies pieces l, l + 32, ... of the valid rows: (row r,
          // piece c), both addresses stepped by additions
          const unsigned char* from = reinterpret_cast<const unsigned char*>(tile) +
                                      r0 * row_gap + c0 * kPiece;
          unsigned char* to = stage + r0 * p.row_ld + c0 * kPiece;
          for (int r = r0, c = c0; r < rows;) {
            cp_async_piece<kPiece>(to, from);
            r += rstep;
            c += cstep;
            from += from_step;
            to += to_step;
            if (c >= pieces) {
              c -= pieces;
              ++r;
              from += row_gap - pieces * kPiece;
              to += p.row_ld - pieces * kPiece;
            }
          }
          if (QUANT && p.scales_async) {   // the tile's scales: 16-byte pieces, below Smax
            if (lane < (rows + 7) / 8)
              cp_async_piece<16>(sScale + 16 * lane, scale + key0 + 8 * lane);
          }
          cp_async_mbar_arrive(&full[st]);       // once this lane's pieces have landed
          if (QUANT && !p.scales_async) {
            for (int r = lane; r < rows; r += 32)
              reinterpret_cast<__nv_bfloat16*>(sScale)[r] = scale[key0 + r];
          }
          mbar_arrive(&full[st]);                // and its plain stores are done
        }
        if (++st == p.stages) { st = 0; phase ^= 1; }
      }
    }
  }
}

// Merge the row's nv live splits for the G heads of KV head kvh, in split
// order, and write o (all kDecThreads threads).
template <typename T>
__device__ __forceinline__ void decode_merge(const DecodeParams& p, float* sW, float* sL, int b,
                                             int kvh, int G, int nv) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  constexpr int kWarpsAll = kDecThreads / 32;
  const long long stat = (long long)p.batch * p.hq * p.nsplit;
  const float* ws_m = p.ws;
  const float* ws_l = p.ws + stat;
  const float* ws_acc = p.ws + 2 * stat;
  const int hc = max(1, min(kDecHeads, kDecHeads * kDecScoreLd / (2 * nv)));   // heads a round
  float* sLs = sW + hc * nv;                    // the splits' l, beside their m, then weights
  for (int g0 = 0; g0 < G; g0 += hc) {
    const int gc = min(hc, G - g0);
    for (int g = warp; g < gc; g += kWarpsAll) {
      const long long row = ((long long)b * p.hq + (long long)kvh * G + g0 + g) * p.nsplit;
      float* w_g = sW + g * nv;
      float* l_g = sLs + g * nv;
      float M = kNegInf;
      for (int s = lane; s < nv; s += 32) {    // m and l of a split in flight together
        const float m = __ldcg(ws_m + row + s);
        l_g[s] = __ldcg(ws_l + row + s);
        w_g[s] = m;
        M = fmaxf(M, m);
      }
#pragma unroll
      for (int w = 16; w > 0; w /= 2) M = fmaxf(M, __shfl_xor_sync(0xffffffffu, M, w));
      float L = 0.f;
      for (int s = lane; s < nv; s += 32) {    // this lane's own entries
        const float w = expf(w_g[s] - M);
        w_g[s] = w;
        L += w * l_g[s];
      }
#pragma unroll
      for (int w = 16; w > 0; w /= 2) L += __shfl_xor_sync(0xffffffffu, L, w);
      if (lane == 0) sL[g] = L;
    }
    __syncthreads();
    for (int i = tid; i < gc * p.d; i += kDecThreads) {
      const int g = i / p.d, x = i - g * p.d;
      const long long row = ((long long)b * p.hq + (long long)kvh * G + g0 + g) * p.nsplit;
      const float* acc = ws_acc + row * p.d + x;
      float o = 0.f;
#pragma unroll 8
      for (int s = 0; s < nv; ++s) o = fmaf(sW[g * nv + s], __ldcg(acc + (long long)s * p.d), o);
      const float L = sL[g];
      T* ob = static_cast<T*>(p.o) + b * p.o_sb + ((long long)kvh * G + g0 + g) * p.o_sh;
      ob[x] = from_f<T>(L > 0.f ? o / L : 0.f);
    }
    __syncthreads();
  }
}

template <typename T, bool QUANT, int ROUTE>
__global__ void __launch_bounds__(kDecThreads, 1)
    decode_ring_kernel(const __grid_constant__ DecodeMaps maps, const DecodeParams p) {
  using KV = typename std::conditional<QUANT, int8_t, T>::type;
  constexpr bool kMmaQK = std::is_same<T, __nv_bfloat16>::value;   // bf16 q: Q.K^T on mma.sync
  constexpr bool kMmaPV = kMmaQK && !QUANT;                         // bf16 V: P.V on mma.sync
  extern __shared__ __align__(128) unsigned char smem_raw[];
  static_assert(ROUTE != kDecTma || kMmaQK, "the TMA route serves bf16 q");
  __shared__ __align__(8) uint64_t full[kDecMaxStages], empty[kDecMaxStages];
  __shared__ int s_last;

  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int kvh = blockIdx.x, b = blockIdx.y, sp = blockIdx.z;
  const int d = p.d;
  const int G = p.hq / p.hk;
  const int limit = min(p.kv_limit[b], p.skv);
  const int nv = limit > 0 ? (limit + kDecSplit - 1) / kDecSplit : 0;   // live splits
  if (nv == 0) {                     // no valid key: block 0 of the row writes zeros
    if (sp == 0) {
      for (int i = tid; i < G * d; i += kDecThreads) {
        T* ob = static_cast<T*>(p.o) + b * p.o_sb + ((long long)kvh * G + i / d) * p.o_sh;
        ob[i % d] = from_f<T>(0.f);
      }
    }
    return;
  }
  if (sp >= nv) return;
  const int k0 = sp * kDecSplit;
  const int n = min(kDecSplit, limit - k0);        // this split's valid keys
  const int ntiles = (n + kDecTile - 1) / kDecTile;
  const int passes = (G + kDecHeads - 1) / kDecHeads;

  unsigned char* ring = reinterpret_cast<unsigned char*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) / 1024 * 1024);
  float* sS = reinterpret_cast<float*>(ring + (size_t)p.stages * p.stage_bytes);
  float* sQ = sS + kDecHeads * kDecScoreLd;        // fp32 q, or bf16 rows of d + 8
  float* sL = sQ + kDecHeads * d;
  if (tid == 0) {
    for (int i = 0; i < p.stages; ++i) {
      mbar_init(&full[i], ROUTE == kDecTma ? 1 : 64);   // expect_tx, or each lane's two arrivals
      mbar_init(&empty[i], kDecWarps);                    // one arrival a consumer warp
    }
    mbar_init_fence();
  }
  // the k16 steps of the products read the rows' padding where D % 16 = 8:
  // it stays zero (no copy writes it; the TMA route takes D = 64 and 128)
  if (kMmaQK && d % 16 != 0) {
    const int pad0 = d * (int)sizeof(KV);            // 8-byte aligned (an int8 row of 24 bytes)
    for (int i = tid; i < p.stages * kDecTile * 2; i += kDecThreads)
      *reinterpret_cast<uint2*>(ring + (size_t)(i / (2 * kDecTile)) * p.stage_bytes +
                                (i / 2 % kDecTile) * p.row_ld + pad0 + 8 * (i % 2)) = make_uint2(0, 0);
  }
  __syncthreads();

  const long long stat = (long long)p.batch * p.hq * p.nsplit;
  const long long part0 = ((long long)b * p.hq + (long long)kvh * G) * p.nsplit + sp;

  if (warp == kDecWarps) {
    decode_produce<KV, QUANT, ROUTE>(p, maps, ring, full, empty, b, kvh, k0, n, passes, lane);
  } else {
    const int gid = lane / 4, tig = lane % 4;
    int st = 0;
    uint32_t phase = 0;
    auto stage_at = [&]() { return ring + (size_t)st * p.stage_bytes; };
    auto release = [&]() {           // this warp is done with the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[st]);
      if (++st == p.stages) { st = 0; phase ^= 1; }
    };
    const int ksteps = (d + 15) / 16;
    for (int pass = 0; pass < passes; ++pass) {
      const int g0 = pass * kDecHeads;
      const int gc = min(kDecHeads, G - g0);       // heads of this pass
      const T* qb = static_cast<const T*>(p.q) + b * p.q_sb + ((long long)kvh * G + g0) * p.q_sh;

      // ---- scores [gc, n] of the split's K tiles into sS ----
      uint32_t qf[kMaxHeadDim / 16][4];
      if constexpr (kMmaQK) {
        // q [16][d] bf16 into shared rows of d + 8 (zero past gc heads and
        // past d), then its A fragments: rows gid, gid + 8; k slots (2 tig,
        // +1) and (2 tig + 8, +9) hold columns 16 kk + 2 tig (+8), or for an
        // int8 K 16 kk + 4 tig (+2)
        __nv_bfloat16* sQb = reinterpret_cast<__nv_bfloat16*>(sQ);
        const int ld = d + 8, chunks = ld / 8;
        const bool vec = reinterpret_cast<uintptr_t>(qb) % 16 == 0 && (p.q_sh * 2) % 16 == 0;
        for (int i = tid; i < kDecHeads * chunks; i += kDecConsumers) {
          const int g = i / chunks, x = (i - g * chunks) * 8;
          uint4 w = make_uint4(0, 0, 0, 0);
          if (g < gc && x < d) {
            const __nv_bfloat16* src = reinterpret_cast<const __nv_bfloat16*>(qb) + g * p.q_sh + x;
            if (vec) {
              w = *reinterpret_cast<const uint4*>(src);
            } else {
              uint32_t h[8];
#pragma unroll
              for (int e = 0; e < 8; ++e) h[e] = bf16_bits(src + e);
              w = make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16, h[4] | h[5] << 16,
                             h[6] | h[7] << 16);
            }
          }
          *reinterpret_cast<uint4*>(sQb + g * ld + x) = w;
        }
        named_sync(1, kDecConsumers);
#pragma unroll
        for (int kk = 0; kk < kMaxHeadDim / 16; ++kk) {
          if (kk < ksteps) {
            if (QUANT) {
#pragma unroll
              for (int r = 0; r < 4; ++r)
                qf[kk][r] = *reinterpret_cast<const uint32_t*>(
                    sQb + (gid + 8 * (r & 1)) * ld + 16 * kk + 4 * tig + 2 * (r >> 1));
            } else {
              ldmatrix_x4(qf[kk], sQb + (lane % 16) * ld + 16 * kk + (lane / 16) * 8);
            }
          }
        }
      } else {
        for (int i = tid; i < kDecHeads * d; i += kDecConsumers) {
          const int g = i / d;
          sQ[i] = g < gc ? to_f(qb[g * p.q_sh + i % d]) : 0.f;
        }
        named_sync(1, kDecConsumers);
      }
      for (int t = 0; t < ntiles; ++t) {
        mbar_wait(&full[st], phase);
        const unsigned char* stage = stage_at();
        const __nv_bfloat16* ks = reinterpret_cast<const __nv_bfloat16*>(stage + p.scale_off);
        float* srow = sS + t * kDecTile;
        if constexpr (kMmaQK) {
          // two accumulators a key tile (even and odd k16 steps), so the
          // products form two dependent chains, not one
          float s[2][4] = {}, s_odd[2][4] = {};
          const int key_w = 16 * warp;             // this warp's 16 keys of the tile
#pragma unroll
          for (int kk = 0; kk < kMaxHeadDim / 16; ++kk) {
            if (kk < ksteps) {
              float (&acc)[2][4] = kk % 2 ? s_odd : s;
              if constexpr (QUANT) {
#pragma unroll
                for (int nt = 0; nt < 2; ++nt) {
                  const uint32_t w = *reinterpret_cast<const uint32_t*>(
                      kv_at<ROUTE>(stage, p.row_ld, key_w + 8 * nt + gid, 16 * kk + 4 * tig));
                  uint32_t b0, b1;
                  int8x4_to_bf16(w, b0, b1);
                  mma_bf16(acc[nt], qf[kk], b0, b1);
                }
              } else {
                uint32_t bk[4];
                ldmatrix_x4(bk, kv_at<ROUTE>(stage, p.row_ld, key_w + lane % 8 + (lane / 16) * 8,
                                             32 * kk + ((lane / 8) % 2) * 16));
                mma_bf16(acc[0], qf[kk], bk[0], bk[1]);
                mma_bf16(acc[1], qf[kk], bk[2], bk[3]);
              }
            }
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int e = 0; e < 4; ++e) s[nt][e] += s_odd[nt][e];
          }
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = gid + 8 * r;
              if (row < gc) {
                const int key = key_w + 8 * nt + 2 * tig;
                float2 v = make_float2(s[nt][2 * r] * p.scale, s[nt][2 * r + 1] * p.scale);
                if (QUANT) {
                  v.x *= __bfloat162float(ks[key]);
                  v.y *= __bfloat162float(ks[key + 1]);
                }
                *reinterpret_cast<float2*>(srow + row * kDecScoreLd + key) = v;
              }
            }
          }
        } else {
          // thread (key c, half h): the dot products of heads 8 h .. 8 h + 7
          const int rows = min(kDecTile, n - t * kDecTile);
          const int c = tid % kDecTile, h = tid / kDecTile;
          if (c < rows && 8 * h < gc) {
            float dot[8] = {};
            for (int x = 0; x < d; x += 4) {
              float kv[4];
              widen4(kv, reinterpret_cast<const KV*>(
                             kv_at<ROUTE>(stage, p.row_ld, c, x * (int)sizeof(KV))));
#pragma unroll
              for (int j = 0; j < 8; ++j) {
                const float4 q4 = *reinterpret_cast<const float4*>(sQ + (8 * h + j) * d + x);
                dot[j] = fmaf(q4.x, kv[0], dot[j]);
                dot[j] = fmaf(q4.y, kv[1], dot[j]);
                dot[j] = fmaf(q4.z, kv[2], dot[j]);
                dot[j] = fmaf(q4.w, kv[3], dot[j]);
              }
            }
#pragma unroll
            for (int j = 0; j < 8; ++j) {
              if (8 * h + j < gc) {
                float v = dot[j] * p.scale;
                if (QUANT) v *= __bfloat162float(ks[c]);
                srow[(8 * h + j) * kDecScoreLd + c] = v;
              }
            }
          }
        }
        release();
      }
      named_sync(1, kDecConsumers);

      // ---- the split's softmax: one warp a head row ----
      for (int g = warp; g < gc; g += kDecWarps) {
        float* row = sS + g * kDecScoreLd;
        float mx = kNegInf;
        for (int c = lane; c < n; c += 32) mx = fmaxf(mx, row[c]);
#pragma unroll
        for (int w = 16; w > 0; w /= 2) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, w));
        float sum = 0.f;
        for (int c = lane; c < n; c += 32) {
          const float pc = expf(row[c] - mx);
          sum += pc;
          row[c] = QUANT ? pc : round_to<T>(pc);   // QUANT: times v_scale in P.V
        }
        for (int c = n + lane; c < ntiles * kDecTile; c += 32) row[c] = 0.f;
#pragma unroll
        for (int w = 16; w > 0; w /= 2) sum += __shfl_xor_sync(0xffffffffu, sum, w);
        if (lane == 0) {
          p.ws[part0 + (long long)(g0 + g) * p.nsplit] = mx;
          p.ws[stat + part0 + (long long)(g0 + g) * p.nsplit] = sum;
        }
      }
      named_sync(1, kDecConsumers);

      // ---- acc [gc, D] = P V over the split's V tiles ----
      float* ws_acc = p.ws + 2 * stat;
      if constexpr (kMmaPV) {
        // warp w: the n8 column tiles w, w + 4, ... of D / 8
        float o[kMaxHeadDim / 32][4] = {};
        const int ntd = d / 8;
        for (int t = 0; t < ntiles; ++t) {
          mbar_wait(&full[st], phase);
          const unsigned char* stage = stage_at();
          const int rows = min(kDecTile, n - t * kDecTile);
#pragma unroll
          for (int kp = 0; kp < 2; ++kp) {         // 32 keys: two k16 steps
            if (32 * kp < rows) {
              uint32_t a[2][4];
#pragma unroll
              for (int sub = 0; sub < 2; ++sub) {
                const int kb = t * kDecTile + 32 * kp + 16 * sub + 2 * tig;
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                  const int row = gid + 8 * (r & 1);
                  const float2 pv = row < gc
                      ? *reinterpret_cast<const float2*>(sS + row * kDecScoreLd + kb + 8 * (r >> 1))
                      : make_float2(0.f, 0.f);
                  a[sub][r] = pack_bf16(pv.x, pv.y);    // exact: p was rounded to bf16
                }
              }
#pragma unroll
              for (int i = 0; i < kMaxHeadDim / 32; ++i) {
                const int j = warp + kDecWarps * i;
                if (j < ntd) {
                  uint32_t vf[4];
                  ldmatrix_x4_trans(vf, kv_at<ROUTE>(stage, p.row_ld, 32 * kp + lane, 16 * j));
                  if (32 * kp + 32 > rows) {       // V rows past kv_limit were not copied
#pragma unroll
                    for (int m = 0; m < 4; ++m) {
                      const int key = 32 * kp + 8 * m + 2 * tig;
                      const uint32_t keep = (key < rows ? 0x0000ffffu : 0u) |
                                            (key + 1 < rows ? 0xffff0000u : 0u);
                      vf[m] &= keep;
                    }
                  }
                  mma_bf16(o[i], a[0], vf[0], vf[1]);
                  mma_bf16(o[i], a[1], vf[2], vf[3]);
                }
              }
            }
          }
          release();
        }
#pragma unroll
        for (int i = 0; i < kMaxHeadDim / 32; ++i) {
          const int j = warp + kDecWarps * i;
          if (j < ntd) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = gid + 8 * r;
              if (row < gc) {
                float* dst = ws_acc + (part0 + (long long)(g0 + row) * p.nsplit) * d + 8 * j + 2 * tig;
                *reinterpret_cast<float2*>(dst) = make_float2(o[i][2 * r], o[i][2 * r + 1]);
              }
            }
          }
        }
      } else if (QUANT && kMmaQK && d % 16 == 0) {
        // QUANT P.V on the tensor cores: p * v_scale (fp32) as three bf16
        // parts, each the rounding of what the earlier ones left, against V
        // widened exactly. ldmatrix.trans reads V's int8 rows as 16-bit
        // pairs: a lane gets keys (2 tig, +1) at columns (2 gid, +1) of a
        // 16-column chunk, the B fragments of an even-column and an
        // odd-column n8 tile. Warp w takes the chunks w, w + 4.
        float oe[kMaxHeadDim / 64][4] = {}, oo[kMaxHeadDim / 64][4] = {};
        const int chunks = d / 16;
        for (int t = 0; t < ntiles; ++t) {
          mbar_wait(&full[st], phase);
          const unsigned char* stage = stage_at();
          const __nv_bfloat16* vs = reinterpret_cast<const __nv_bfloat16*>(stage + p.scale_off);
          const int rows = min(kDecTile, n - t * kDecTile);
#pragma unroll
          for (int kp = 0; kp < 2; ++kp) {         // 32 keys: two k16 steps
            if (32 * kp < rows) {
              uint32_t a[3][2][4];
#pragma unroll
              for (int sub = 0; sub < 2; ++sub) {
#pragma unroll
                for (int r = 0; r < 4; ++r) {
                  const int row = gid + 8 * (r & 1);
                  const int key = 32 * kp + 16 * sub + 2 * tig + 8 * (r >> 1);   // in the tile
                  float p0 = 0.f, p1 = 0.f;             // keys past kv_limit: 0, whatever the scale
                  if (row < gc) {
                    const float2 pv =
                        *reinterpret_cast<const float2*>(sS + row * kDecScoreLd + t * kDecTile + key);
                    if (key < rows) p0 = pv.x * __bfloat162float(vs[key]);
                    if (key + 1 < rows) p1 = pv.y * __bfloat162float(vs[key + 1]);
                  }
#pragma unroll
                  for (int part = 0; part < 3; ++part) {
                    const __nv_bfloat162 b2 = __floats2bfloat162_rn(p0, p1);
                    a[part][sub][r] = *reinterpret_cast<const uint32_t*>(&b2);
                    p0 -= __low2float(b2);
                    p1 -= __high2float(b2);
                  }
                }
              }
#pragma unroll
              for (int i = 0; i < kMaxHeadDim / 64; ++i) {
                const int m = warp + kDecWarps * i;
                if (m < chunks) {
                  uint32_t vr[4];
                  ldmatrix_x4_trans(vr, kv_at<ROUTE>(stage, p.row_ld, 32 * kp + lane, 16 * m));
#pragma unroll
                  for (int sub = 0; sub < 2; ++sub) {
                    uint32_t e0, e1, o0, o1;
                    int8x4_to_bf16(__byte_perm(vr[2 * sub], vr[2 * sub + 1], 0x6420), e0, e1);
                    int8x4_to_bf16(__byte_perm(vr[2 * sub], vr[2 * sub + 1], 0x7531), o0, o1);
#pragma unroll
                    for (int part = 0; part < 3; ++part) {
                      mma_bf16(oe[i], a[part][sub], e0, e1);
                      mma_bf16(oo[i], a[part][sub], o0, o1);
                    }
                  }
                }
              }
            }
          }
          release();
        }
#pragma unroll
        for (int i = 0; i < kMaxHeadDim / 64; ++i) {
          const int m = warp + kDecWarps * i;
          if (m < chunks) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
              const int row = gid + 8 * r;
              if (row < gc) {
                float* dst = ws_acc + (part0 + (long long)(g0 + row) * p.nsplit) * d + 16 * m + 4 * tig;
                *reinterpret_cast<float4*>(dst) = make_float4(oe[i][2 * r], oo[i][2 * r],
                                                              oe[i][2 * r + 1], oo[i][2 * r + 1]);
              }
            }
          }
        }
      } else {
        // thread (slot, cw): columns 4 cw .. 4 cw + 3 of heads slot, slot + slots, ...
        const int nc = d / 4, slots = kDecConsumers / nc;
        const int cw = tid % nc, slot = tid / nc;
        float acc[4][4] = {};
        for (int t = 0; t < ntiles; ++t) {
          mbar_wait(&full[st], phase);
          const unsigned char* stage = stage_at();
          const __nv_bfloat16* vs = reinterpret_cast<const __nv_bfloat16*>(stage + p.scale_off);
          const int rows = min(kDecTile, n - t * kDecTile);
          const float* prow = sS + t * kDecTile;
          if (slot < slots && slot < gc) {
#pragma unroll 4
            for (int c = 0; c < rows; ++c) {
              float v[4];
              widen4(v, reinterpret_cast<const KV*>(
                            kv_at<ROUTE>(stage, p.row_ld, c, 4 * cw * (int)sizeof(KV))));
              const float vsc = QUANT ? __bfloat162float(vs[c]) : 1.f;
#pragma unroll
              for (int i = 0; i < 4; ++i) {
                const int h = slot + slots * i;
                if (h < gc) {
                  float pv = prow[h * kDecScoreLd + c];
                  if (QUANT) pv *= vsc;
#pragma unroll
                  for (int e = 0; e < 4; ++e) acc[i][e] = fmaf(pv, v[e], acc[i][e]);
                }
              }
            }
          }
          release();
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int h = slot + slots * i;
          if (slot < slots && h < gc) {
            float* dst = ws_acc + (part0 + (long long)(g0 + h) * p.nsplit) * d + 4 * cw;
#pragma unroll
            for (int e = 0; e < 4; ++e) dst[e] = acc[i][e];
          }
        }
      }
      named_sync(1, kDecConsumers);      // sS and sQ are free for the next pass
    }
  }

  // ---- the ticket; the row's last live split merges ----
  __threadfence();
  __syncthreads();
  if (tid == 0) s_last = atomicAdd(&p.counters[b * p.hk + kvh], 1) == nv - 1;
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  decode_merge<T>(p, sS, sL, b, kvh, G, nv);
  if (tid == 0) p.counters[b * p.hk + kvh] = 0;
}

// The widest piece (16 or 8 bytes) that every K/V row start and length fits;
// 0 if none does.
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

// QUANT: whether each tile's scales are 16-byte aligned pieces that stay
// below Smax (else the producer's lanes load and store them one by one)
inline bool decode_scales_async(const DecodeParams& p) {
  bool ok = p.skv % 8 == 0 && reinterpret_cast<uintptr_t>(p.k_scale) % 16 == 0 &&
            reinterpret_cast<uintptr_t>(p.v_scale) % 16 == 0;
  for (long long s : {p.ks_sb, p.ks_sh, p.vs_sb, p.vs_sh}) ok = ok && (s * 2) % 16 == 0;
  return ok;
}

template <typename T, bool QUANT, int ROUTE>
int launch_ring(const DecodeMaps& maps, const DecodeParams& p, cudaStream_t stream) {
  auto kernel = decode_ring_kernel<T, QUANT, ROUTE>;
  const size_t smem = decode_smem_bytes(p);
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<dim3(p.hk, p.batch, p.nsplit), kDecThreads, smem, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

// Whether the TMA route takes rows of `row_bytes`: one or two 128-byte
// boxes a row (bf16 D = 64 or 128, int8 D = 128)
inline bool decode_tma_rows(int row_bytes) { return row_bytes == 128 || row_bytes == 256; }

// K / V's tensor map over the stacked cache [layers, batch, hk, smax, d] of
// `elem_bytes` (2: bf16, 1: int8) elements, element strides (layer, batch,
// head, row): 128-byte-swizzled boxes of 128 bytes x 64 rows
inline bool decode_kv_map(CUtensorMap* map, const void* base, int layers, int batch, int hk,
                          int smax, int d, const long long* strides, int elem_bytes) {
  const cuuint64_t dims[5] = {(cuuint64_t)d, (cuuint64_t)smax, (cuuint64_t)hk,
                              (cuuint64_t)batch, (cuuint64_t)layers};
  cuuint64_t gs[4];
  for (int i = 0; i < 4; ++i)      // row, head, batch, layer; a dim of one takes any stride
    gs[i] = strides[3 - i] ? (cuuint64_t)strides[3 - i] * elem_bytes : 16;
  const cuuint32_t box[5] = {(cuuint32_t)(128 / elem_bytes), (cuuint32_t)kDecTile, 1, 1, 1};
  return decode_tma_rows(d * elem_bytes) &&
         tensor_map(map, elem_bytes == 1 ? CU_TENSOR_MAP_DATA_TYPE_UINT8
                                         : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                    5, base, dims, gs, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// The route: TMA where the wrapper passed the cache's maps (bf16 q, rows of
// 128 or 256 bytes, 16-byte aligned scale rows), else cp.async pieces of
// the widest size every row fits.
template <typename T, bool QUANT>
int launch_decode(DecodeParams p, const void* kv_maps, cudaStream_t stream) {
  using KV = typename std::conditional<QUANT, int8_t, T>::type;
  const int row_bytes = p.d * (int)sizeof(KV);
  p.scales_async = QUANT && decode_scales_async(p);
  DecodeMaps maps;
  const bool tma = kv_maps != nullptr;
  if (tma) {
    if (!std::is_same<T, __nv_bfloat16>::value || !decode_tma_rows(row_bytes) ||
        (QUANT && !p.scales_async))
      return (int)cudaErrorInvalidValue;
    std::memcpy(&maps, kv_maps, sizeof maps);
    p.row_ld = 128;
    p.scale_off = kDecTile * row_bytes;
    p.stage_bytes = align_up(p.scale_off + (QUANT ? 2 * kDecTile : 0), 1024);
  } else {
    std::memset(&maps, 0, sizeof maps);
    p.row_ld = row_bytes + kDecRowPad;
    p.scale_off = kDecTile * p.row_ld;
    p.stage_bytes = align_up(p.scale_off + (QUANT ? 2 * kDecTile : 0), 128);
  }
  p.stages = max(kDecMinStages, min(kDecMaxStages, kDecRingBytes / p.stage_bytes));
  if (decode_smem_bytes(p) > 232448) return (int)cudaErrorInvalidValue;
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    if (tma) return launch_ring<T, QUANT, kDecTma>(maps, p, stream);
  }
  const int vb = decode_vec_bytes(p, sizeof(KV));
  if (vb == 16) return launch_ring<T, QUANT, 16>(maps, p, stream);
  if (vb == 8) return launch_ring<T, QUANT, 8>(maps, p, stream);
  return (int)cudaErrorInvalidValue;
}

// Fill DecodeParams from the C entry points' arguments; `strides` holds
// q (b, h), k (b, h, s), v (b, h, s), o (b, h) and, for QUANT, the scales'
// (b, h) of k then v. `workspace` holds (2 + d) * batch * hq * nsplit fp32;
// the caller sized it for nsplit = ceil(skv / kDecSplit), and any other
// nsplit is refused. `counters` holds batch * hk int32, zero; `layer` is the
// layer's index into the stacked cache of the TMA route's maps. Returns
// false for shapes the kernel does not take.
inline bool decode_params(DecodeParams& p, const void* q, const void* k, const void* v,
                          const void* k_scale, const void* v_scale, void* o,
                          const int* kv_limit, int batch, int hq, int hk, int skv, int d,
                          const long long* strides, float scale, void* workspace, int* counters,
                          int nsplit, int layer, bool quant) {
  p.q = q;
  p.k = k;
  p.v = v;
  p.o = o;
  p.kv_limit = kv_limit;
  p.k_scale = static_cast<const __nv_bfloat16*>(k_scale);
  p.v_scale = static_cast<const __nv_bfloat16*>(v_scale);
  p.ws = static_cast<float*>(workspace);
  p.counters = counters;
  p.batch = batch;
  p.hq = hq;
  p.hk = hk;
  p.skv = skv;
  p.d = d;
  p.nsplit = nsplit;
  p.layer = layer;
  p.q_sb = strides[0];  p.q_sh = strides[1];
  p.k_sb = strides[2];  p.k_sh = strides[3];  p.k_ss = strides[4];
  p.v_sb = strides[5];  p.v_sh = strides[6];  p.v_ss = strides[7];
  p.o_sb = strides[8];  p.o_sh = strides[9];
  p.ks_sb = quant ? strides[10] : 0;  p.ks_sh = quant ? strides[11] : 0;
  p.vs_sb = quant ? strides[12] : 0;  p.vs_sh = quant ? strides[13] : 0;
  p.scale = scale;
  return d > 0 && d <= kMaxHeadDim && d % 8 == 0 && hk > 0 && hq % hk == 0 &&
         (hq / hk) * d <= kDecMaxOut && batch > 0 && skv > 0 && skv <= kDecMaxKeys &&
         nsplit == (skv + kDecSplit - 1) / kDecSplit && workspace != nullptr &&
         counters != nullptr;
}

}  // namespace
}  // namespace livecc
