// K4's forward for bf16 operands on Hopper: warpgroup products (wgmma) fed
// by TMA from a producer warp, keeping splash's fp32 p. The contract and
// numerics are train_attention.cuh's (see there), which the backward
// kernels of train_wgmma_attention_bwd.cuh keep too and which read this
// kernel's o and lse: query i attends key j iff seg[i] == seg[j] and, in
// the causal form (kCausal), j <= i; masked scores at kSplashMask with p =
// 0; o = (sum p v) / l in bf16, lse = m + log l in fp32.
//
// Replaces, for bf16: the forward of livecc_tpu/ops/attention.py:
// _train_splash (JAX's Pallas splash MQA kernel, built at :99; :126) and of
// _train_flash_stock (:65), which share the contract of train_flash_attention
// (:39).
//
// What bounds it on the H100: compute. A causal segment of S = 8192 at
// Hq = 28, D = 128 is 0.481 TFLOP of splash's products against ~80 MB of
// q, k, v and o; one of 32,768 (the training CLI's and the MCQ item's rows)
// 7.7 TFLOP against 0.3 GB: ~6000 operations a byte, twenty times the
// card's ~295 ridge. Keeping p in fp32 (below) doubles the tensor work, so
// the floor is 2 x 0.481 TFLOP in 0.97 ms at S = 8192 at the 989 TFLOP/s peak
// (NVIDIA H100 80GB HBM3, 700 W).
//
// The design, against what held the earlier mma.sync forward back:
//
//   1. Every product is a wgmma of the block's two consumer warpgroups, each
//      owning 64 of the block's kTrainFwdRows = 128 query rows: S = Q K^T
//      as m64nNk16 with both operands read from shared memory (N =
//      kTrainFwdKeys = 64 keys), O += P V with P from registers and V the
//      transposed (MN-major) B operand in shared memory (N = the head dim).
//      A warpgroup issues tile i's S beside tile i - 1's P V, so its
//      softmax of tile i runs while the tensor cores work through P V (the
//      two groups complete in order: S first). The mma.sync forward ran
//      per-warp products fed by ldmatrix, one after the other.
//   2. Loads leave the compute warps: the block's first thread issues the
//      TMA copy of its Q tile at the start, beside the live-tile walk's
//      reads, and the producer warpgroup's first warp those of each K / V
//      tile (lane 0) with its segment ids (all lanes) into a ring of
//      kStages stages (as many as 227 KB hold: 5 of 32 KB at D = 128),
//      handed over by full and empty mbarriers. The producer runs at 40 registers and the consumers at
//      232 (setmaxnreg): O (64 fp32 a thread), p's parts (48) in flight
//      beside the next tile's S (32) and the softmax fit with no spill.
//      128-key tiles did not: with S at 64 registers and the parts at 96,
//      ptxas spilled and serialized the wgmma's. Tiles land 128-byte
//      swizzled, as wgmma reads them; rows past S are zero-filled by TMA,
//      and so are the columns past D of a head dim that is not a multiple
//      of 64 (the products run at D rounded up to 64 or 128, the extra
//      columns adding exact zeros; only D columns are stored). q, k and v
//      are read through their (batch, seq, head) strides in 4-d tensor
//      maps, so a strided q costs nothing.
//   3. P V keeps splash's fp32 p (splash_attention_kernel.py: dot(s_curr,
//      v.astype(float32))): p is split into kPTerms = 3 bf16 parts, each the
//      rounding of what the earlier ones left, which hold its 24 bits
//      exactly. The S accumulator packed into bf16 pairs is the A operand's
//      register layout (hopper_common.cuh), so each part goes to the tensor
//      cores from registers and P never touches shared memory. That is
//      2x the tensor work of a bf16 p, as before; two parts flip the
//      rounding of many bf16 outputs and carry the backward's dq past its
//      check.
//   4. The G q heads of a KV group still stream the same K / V tiles, from
//      L2: blocks are launched with the heads fastest, so a group's G blocks
//      of one query tile run at once.
//
// As before, work the data makes zero is never loaded or computed: each
// block first reads the segment ids of its 128 rows and compacts the key
// tiles that hold one of them (live_tiles, which the backward shares) up to
// its causal frontier (all of them in the non-causal form) into a list in
// shared memory, which the producer walks; a skipped tile's p would be 0
// everywhere, so skipping changes no bit. The masks (past S, the diagonal,
// the segments) and the online softmax run in registers on the
// accumulator's layout, a row's max and sum reduced across its quad; a
// tile below a thread's diagonal whose keys all hold that thread's rows'
// id (the walk records each listed tile's one id) skips the masks, which
// could change nothing there. The query tiles are launched from the last
// one down, so the blocks with the longest walks start first.

#pragma once

#include <climits>

#include "hopper_common.cuh"
#include "train_attention.cuh"

namespace livecc {

constexpr int kTrainFwdRows = 128;     // queries per block: 64 per consumer warpgroup
constexpr int kTrainFwdKeys = 64;      // keys per ring stage
constexpr int kTrainFwdThreads = 384;  // two consumer warpgroups, then the producer's
constexpr int kPTerms = 3;             // bf16 parts of the forward's fp32 p: all 24 bits
constexpr int kTrainFwdMaxStages = 6;
constexpr int kTrainFwdSmemLimit = 232448;   // 227 KB a block

// The shared memory of head dim D: kResident tiles of the block's rows (the
// forward's Q; the backward's dQ kernel keeps Q and dO), then kStages
// stages of a K tile and a V tile, each in 64-column chunks of 128-byte
// rows (1024-byte aligned, 128-byte swizzled); then ints: the stages' key
// segment ids, the block's row ids, live_tiles' scratch, the list of live
// key tiles and their one ids.
template <int D, int kResident = 1>
struct TrainFwdTile {
  static constexpr int kDp = D <= 64 ? 64 : 128;   // the products' head dim
  static constexpr int kChunks = kDp / 64;
  static constexpr int kQBytes = kChunks * kTrainFwdRows * 128;
  static constexpr int kRingAt = kResident * kQBytes;
  static constexpr int kKVBytes = kChunks * kTrainFwdKeys * 128;
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kFree = kTrainFwdSmemLimit - 1024 - kRingAt - 8192;   // 8 KB for the ints
  static constexpr int kStages = kFree / (kStageBytes + 4 * kTrainFwdKeys) < kTrainFwdMaxStages
                                     ? kFree / (kStageBytes + 4 * kTrainFwdKeys)
                                     : kTrainFwdMaxStages;
  static constexpr int kIntsAt = kRingAt + kStages * kStageBytes;
  static constexpr int kScratch = 8;
  static_assert(kStages >= 2, "a ring of two stages at least");
  // bytes of dynamic shared memory for `key_tiles` key tiles (the list and
  // each listed tile's one id)
  static size_t smem(int key_tiles) {
    return 1024 + kIntsAt + sizeof(int) * ((size_t)kStages * kTrainFwdKeys + kTrainFwdRows +
                                           kScratch + 2 * (size_t)key_tiles);
  }
};

namespace {

// Which tiles a block walks: its own ROWS rows' segment ids (rows [r0, r0 +
// ROWS) below s) into ids[ROWS] (`pad` past s), then the KT-row tiles t in
// [t0, t1) that hold one of those ids, compacted in order into list[] (t1 -
// t0 ints), by the block's THREADS threads; scratch holds ROWS / 32 + 1
// ints. Exact when the block's rows hold at most two ids; otherwise a tile
// is kept when it holds any id in their range (a superset: the masks
// decide). Beside it, uni[] (t1 - t0 ints): each listed tile's one id
// where all its KT rows lie below s and hold that id, else INT_MIN.
// Returns the number of live tiles, the same in every thread.
template <int ROWS, int KT, int THREADS>
__device__ int live_tiles(int* ids, int* list, int* scratch, const int* segb, int s, int r0,
                          int pad, int t0, int t1, int* uni) {
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
    uni[i] = same ? first : INT_MIN;
  }
  __syncthreads();
  if (warp == 0) {
    int count = 0;
    for (int base = 0; base < n; base += 32) {
      const bool f = base + lane < n && list[base + lane];
      const int u = f ? uni[base + lane] : 0;
      const unsigned m = __ballot_sync(0xffffffffu, f);
      const int at = count + __popc(m & ((1u << lane) - 1u));
      if (f) list[at] = t0 + base + lane;
      if (f) uni[at] = u;
      count += __popc(m);
      __syncwarp();
    }
    if (lane == 0) scratch[kWarps] = count;
  }
  __syncthreads();
  return scratch[kWarps];
}

// O += P V over a stage's KT keys: V's k16 step kk is 16 rows (2048 bytes)
// further, its 64-column chunks KT * 128 bytes apart, its 8-row groups 1024;
// each step takes p's kPTerms parts
template <int KT, int DP>
__device__ __forceinline__ void pv(float (&acc)[DP / 2], const uint32_t (&pa)[kPTerms][KT / 16][4],
                                   const unsigned char* stage) {
  const unsigned char* const sV = stage + (DP / 64) * KT * 128;
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
    const uint64_t vd = wgmma_desc(sV + kk * 16 * 128, KT * 128, 1024);
#pragma unroll
    for (int t = 0; t < kPTerms; ++t) wgmma_pv<DP>(acc, pa[t][kk], vd);
  }
}

// The masks (past S, causal, segments: a masked score is kSplashMask), the
// new running max of the two rows and its rescale alpha, and p = exp(s - m)
// (0 where masked) in place, summed into l. sc[4 j + 2 r + c] is row r,
// key k0 + 8 j + 2 tig + c; tSeg holds the tile's key ids. A `clean` tile
// has no masked score and skips the masks; the rest is one code for both.
template <int KT, bool kCausal>
__device__ __forceinline__ void softmax_tile(float (&sc)[KT / 2], const int* tSeg, int k0, int s,
                                             const int (&rows)[2], const int (&segs)[2], int tig,
                                             bool clean, float (&m)[2], float (&l)[2],
                                             float (&alpha)[2]) {
  if (!clean) {
#pragma unroll
    for (int j = 0; j < KT / 8; ++j) {
      const int kl = 8 * j + 2 * tig;
      const int2 ids = *reinterpret_cast<const int2*>(tSeg + kl);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + kl + (e & 1), r = e >> 1;
        const bool ok = key < s && (!kCausal || key <= rows[r]) &&
                        ((e & 1) ? ids.y : ids.x) == segs[r];
        sc[4 * j + e] = ok ? sc[4 * j + e] : kSplashMask;
      }
    }
  }
  float mx[2] = {kSplashMask, kSplashMask};
#pragma unroll
  for (int e = 0; e < KT / 2; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
    const float m_new = fmaxf(m[r], mx[r]);
    alpha[r] = __expf(m[r] - m_new);        // 0 once a real score replaces the mask value
    m[r] = m_new;
    l[r] *= alpha[r];
  }
#pragma unroll
  for (int e = 0; e < KT / 2; ++e) {
    const int r = (e >> 1) & 1;
    sc[e] = sc[e] == kSplashMask ? 0.f : __expf(sc[e] - m[r]);
    l[r] += sc[e];
  }
}

// p as kPTerms bf16 parts, each the rounding of what the earlier ones left:
// part t of key step kk is the A fragment pa[t][kk] (the accumulator's n8
// tiles 2 kk and 2 kk + 1, rows a and b)
template <int KT>
__device__ __forceinline__ void split_p(const float (&sc)[KT / 2],
                                        uint32_t (&pa)[kPTerms][KT / 16][4]) {
#pragma unroll
  for (int kk = 0; kk < KT / 16; ++kk) {
#pragma unroll
    for (int x = 0; x < 4; ++x) {
      float p0 = sc[8 * kk + 2 * x], p1 = sc[8 * kk + 2 * x + 1];
#pragma unroll
      for (int t = 0; t < kPTerms; ++t) {
        const __nv_bfloat162 b2 = __floats2bfloat162_rn(p0, p1);
        pa[t][kk][x] = *reinterpret_cast<const uint32_t*>(&b2);
        p0 -= __low2float(b2);
        p1 -= __high2float(b2);
      }
    }
  }
}

// The producer warp's walk over the n_live listed key tiles (list[i] x KT
// keys): lane 0 copies each tile's K and V rows by TMA into the next stage
// of the ring at `ring` (STAGES stages of a K tile and a V tile, CHUNKS
// 64-column chunks each), all 32 lanes its key ids into seg_k[stage][KT]
// with 4-byte loads (a row's ids need not start 16-byte aligned, as a TMA
// copy's would; 0 past s). full[stage] takes the lanes' arrivals, lane 0's
// expect_tx and the copies' bytes; empty[stage] the consumers' release.
template <int KT, int STAGES, int CHUNKS>
__device__ __forceinline__ void produce_kv_tiles(unsigned char* ring, int* seg_k, uint64_t* full,
                                                 uint64_t* empty, const int* list, int n_live,
                                                 const CUtensorMap* kmap, const CUtensorMap* vmap,
                                                 int kvh, int b, const int* segb, int s) {
  constexpr int kKVBytes = CHUNKS * KT * 128;
  const int lane = threadIdx.x % 32;
  for (int i = 0; i < n_live; ++i) {
    const int st = i % STAGES;
    unsigned char* const stage = ring + st * 2 * kKVBytes;
    const int k0 = list[i] * KT;
    mbar_wait(&empty[st], ((i / STAGES) & 1) ^ 1);
    if (lane == 0) {
      mbar_expect_tx(&full[st], 2 * kKVBytes);
      for (int c = 0; c < CHUNKS; ++c) {
        tma_load_4d(stage + c * KT * 128, kmap, 64 * c, k0, kvh, b, &full[st]);
        tma_load_4d(stage + kKVBytes + c * KT * 128, vmap, 64 * c, k0, kvh, b, &full[st]);
      }
    }
    for (int j = lane; j < KT; j += 32) seg_k[st * KT + j] = k0 + j < s ? segb[k0 + j] : 0;
    mbar_arrive(&full[st]);
  }
}

// Block (q head, row, 128-query tile from the last down). Threads 0-255:
// the consumer warpgroups (rows 0-63, 64-127 of the tile); 256-383: the
// producer, whose first warp fills the ring.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kTrainFwdThreads, 1)
    train_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap, TrainAttnParams p) {
  static_assert(D % 16 == 0 && D <= kMaxHeadDim, "head dim: a multiple of 16 up to 128");
  using Tile = TrainFwdTile<D>;
  constexpr int R = kTrainFwdRows, KT = kTrainFwdKeys, S = Tile::kStages, DP = Tile::kDp;
  __shared__ __align__(8) uint64_t q_full, full[S], empty[S];
  extern __shared__ unsigned char fwd_dyn[];
  unsigned char* const tiles = fwd_dyn + ((1024 - (smem_addr(fwd_dyn) & 1023)) & 1023);
  int* const sSegK = reinterpret_cast<int*>(tiles + Tile::kIntsAt);   // [S][KT]
  int* const sSegQ = sSegK + S * KT;                                   // [R]
  int* const scratch = sSegQ + R;                                      // [kScratch]
  int* const sList = scratch + Tile::kScratch;                         // [key tiles]
  int* const sUni = sList + (p.s + KT - 1) / KT;                       // [key tiles]

  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * R;
  const int s = p.s;
  const int kvh = h / (p.hq / p.hk);
  const int key_tiles = (s + KT - 1) / KT;
  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 33);              // the producer warp's lanes, lane 0's expect_tx,
                                            // then TMA's bytes
      mbar_init(&empty[i], 8);              // one arrival per consumer warp
    }
    mbar_init_fence();
    mbar_expect_tx(&q_full, Tile::kQBytes);   // Q's copy runs beside the walk's reads
    for (int c = 0; c < Tile::kChunks; ++c)
      tma_load_4d(tiles + c * R * 128, &qmap, 64 * c, q0, h, b, &q_full);
  }
  // (live_tiles' barriers order the initialisation before any use)
  const int n_live = live_tiles<R, KT, kTrainFwdThreads>(
      sSegQ, sList, scratch, p.seg + (long long)b * s, s, q0, INT_MIN, 0,
      kCausal ? min(key_tiles, (q0 + R - 1) / KT + 1) : key_tiles, sUni);

  if (threadIdx.x >= 256) {                 // the producer
    regs_dec<40>();
    if (threadIdx.x < 288)                  // its first warp
      produce_kv_tiles<KT, S, Tile::kChunks>(tiles + Tile::kRingAt, sSegK, full, empty, sList,
                                             n_live, &kmap, &vmap, kvh, b,
                                             p.seg + (long long)b * s, s);
    return;
  }

  regs_inc<232>();
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int rl_a = wg * 64 + warp * 16 + gid;   // the thread's two rows in the tile
  const int rows[2] = {q0 + rl_a, q0 + rl_a + 8};
  const int segs[2] = {sSegQ[rl_a], sSegQ[rl_a + 8]};
  const unsigned char* const sQ = tiles + wg * 64 * 128;   // this warpgroup's 64 rows
  float m[2] = {kSplashMask, kSplashMask};  // running max of the two rows
  float l[2] = {0.f, 0.f};                  // this thread's share of the running sums
  float acc[DP / 2], sc[KT / 2];
  uint32_t pa[kPTerms][KT / 16][4];
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) acc[i] = 0.f;
  float alpha[2];                           // the latest tile's rescale of O
  auto stage_at = [&](int i) { return tiles + Tile::kRingAt + (i % S) * Tile::kStageBytes; };
  auto tile_p = [&](int i) {                // tile i's scores into p, in sc
    const int k0 = sList[i] * KT, one = sUni[i];
    // no mask can apply: the tile lies below both rows' diagonal and holds their id alone
    const bool clean = one != INT_MIN && one == segs[0] && one == segs[1] &&
                       (!kCausal || k0 + KT - 1 <= rows[0]);
    softmax_tile<KT, kCausal>(sc, sSegK + (i % S) * KT, k0, s, rows, segs, tig, clean, m, l,
                              alpha);
  };
  mbar_wait(&q_full, 0);

  // Tile i's S = Q K^T runs on the tensor cores beside tile i - 1's O += P V:
  // its softmax waits for S alone, the rescale of O and the next parts of p
  // for both (wgmma groups complete in order).
  mbar_wait(&full[0], 0);
  fence_acc(sc);
  wgmma_fence();
  ss_scores<DP, R, KT>(sc, sQ, stage_at(0));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(sc);
  tile_p(0);
  split_p<KT>(sc, pa);
  for (int i = 1; i < n_live; ++i) {
    mbar_wait(&full[i % S], (i / S) & 1);
    fence_acc(sc);
    fence_acc(acc);
    wgmma_fence();
    ss_scores<DP, R, KT>(sc, sQ, stage_at(i));
    wgmma_commit();
    pv<KT, DP>(acc, pa, stage_at(i - 1));
    wgmma_commit();
    wgmma_wait<1>();                        // S of tile i
    fence_acc(sc);
    tile_p(i);
    wgmma_wait<0>();                        // O += P V of tile i - 1
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[(i - 1) % S]);   // this warp is done with its stage
#pragma unroll
    for (int e = 0; e < DP / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];
    split_p<KT>(sc, pa);
  }
  fence_acc(acc);
  wgmma_fence();
  pv<KT, DP>(acc, pa, stage_at(n_live - 1));
  wgmma_commit();
  wgmma_wait<0>();
  fence_acc(acc);
  if (lane == 0) mbar_arrive(&empty[(n_live - 1) % S]);

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  __nv_bfloat16* ob = static_cast<__nv_bfloat16*>(p.o) + ((long long)b * s * p.hq + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= s) continue;
    const float safe = l[r] > 0.f ? l[r] : 1.f;
    __nv_bfloat16* orow = ob + (long long)rows[r] * p.hq * D + 2 * tig;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(acc[4 * j + 2 * r] / safe, acc[4 * j + 2 * r + 1] / safe);
    if (tig == 0) p.lse[((long long)b * p.hq + h) * s + rows[r]] = m[r] + logf(l[r]);
  }
}

// A 4-d map over x [B, S, H, D] (element strides sb, ss, sh) read in boxes
// of `rows` rows of 64 columns, 128-byte swizzled
bool train_fwd_map(CUtensorMap* map, const void* x, int d, int s, int heads, int batch,
                   long long sb, long long ss, long long sh, int rows) {
  const cuuint64_t dims[4] = {(cuuint64_t)d, (cuuint64_t)s, (cuuint64_t)heads,
                              (cuuint64_t)batch};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, x, dims, strides, box,
                    CU_TENSOR_MAP_SWIZZLE_128B);
}

// The forward of bf16 operands: grid (Hq, B, 128-query tiles). The tensor
// maps are encoded at each call and passed by value (__grid_constant__),
// so a captured graph holds them beside the addresses it was captured with.
template <int D, bool kCausal>
int launch_train_fwd_wgmma(const TrainAttnParams& p, int batch, cudaStream_t stream) {
  using Tile = TrainFwdTile<D>;
  CUtensorMap qmap, kmap, vmap;
  if (!train_fwd_map(&qmap, p.q, D, p.s, p.hq, batch, p.q_sb, p.q_ss, p.q_sh, kTrainFwdRows) ||
      !train_fwd_map(&kmap, p.k, D, p.s, p.hk, batch, p.k_sb, p.k_ss, p.k_sh, kTrainFwdKeys) ||
      !train_fwd_map(&vmap, p.v, D, p.s, p.hk, batch, p.v_sb, p.v_ss, p.v_sh, kTrainFwdKeys))
    return (int)cudaErrorInvalidValue;
  const size_t smem = Tile::smem((p.s + kTrainFwdKeys - 1) / kTrainFwdKeys);
  const auto kernel = train_fwd_wgmma_kernel<D, kCausal>;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid(p.hq, batch, (p.s + kTrainFwdRows - 1) / kTrainFwdRows);
  kernel<<<grid, kTrainFwdThreads, smem, stream>>>(qmap, kmap, vmap, p);
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace livecc
