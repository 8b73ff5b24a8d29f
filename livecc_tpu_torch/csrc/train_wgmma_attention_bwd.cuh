// K4's backward for bf16 operands on Hopper: dK/dV and dQ as warpgroup
// products (wgmma) fed by TMA from a producer warp, keeping splash's bf16
// P^T and dS^T. The contract and numerics are train_attention.cuh's (see
// there), and the forward (train_wgmma_attention.cuh) gives the o and lse
// it reads: query i attends key j iff seg[i] == seg[j] and, in the causal
// form (kCausal), j <= i; p = exp(s - lse) from the forward's fp32 lse, 0
// where masked; di = rowsum(o * do), computed by the wrapper; dv +=
// p.astype(bf16)^T do, ds = p (dp - di), dk += ds.astype(bf16)^T q, dq +=
// ds.astype(bf16) k; every product accumulates in fp32.
//
// Replaces, for bf16: the backward of livecc_tpu/ops/attention.py:
// _train_splash (JAX's Pallas splash MQA kernels' fused backward; :126) and
// of _train_flash_stock (:65), which share the contract of
// train_flash_attention (:39).
//
// What bounds it on the H100: compute. The fused backward is 5 products of
// the forward's size (2.5x its work): at the training CLI's row (S =
// 32,768, 29,422 real tokens, Hq = 28, D = 128) 15.71 TFLOP, 15.9 ms at the
// 989 TFLOP/s peak, against ~0.5 GB of operands. Two launches take 7
// products (dQ computes S and dP again), so this split's own floor is 7/5
// of that bound: 22.2 ms there, 0.535 ms at the packed 8192-token row
// (NVIDIA H100 80GB HBM3, 700 W).
//
// The design:
//
//   1. dK/dV, in the transposed form. A block owns kTrainBwdKeys = 128 keys
//      of one KV head and batch row, 64 for each of its two consumer
//      warpgroups; the block's first thread loads their K and V rows once
//      by TMA. The producer warp walks the (q head of the group, live
//      64-query tile) pairs and brings each pair's Q and dO tiles into a
//      ring of stages by TMA, with the tile's lse, di and query ids beside
//      them in 4-byte loads (a TMA box must start 16-byte aligned, and a
//      row of [B, Hq, S] lse does not where S % 4 != 0). Per pair a
//      warpgroup computes S^T = K Q^T and dP^T = V dO^T (both operands in
//      shared memory), P^T = exp(S^T - lse) and dS^T = P^T (dP^T - di) on
//      the accumulators' layout, then dV += P^T dO and dK += dS^T Q, P^T
//      and dS^T packed to bf16 as A operands from registers and dO, Q read
//      as the transposed B. The accumulator of an m64n64 product packed
//      into bf16 pairs is the register layout of an A operand
//      (hopper_common.cuh), so P^T and dS^T never touch shared memory.
//      Each dK / dV row is summed in one block over the group's q heads:
//      no atomics, no K / V repeat.
//   2. dQ, the forward's shape with one more product and no online
//      softmax. A block of kTrainBwdRows = 128 queries of one q head (64 a
//      consumer warpgroup) loads Q and dO once by TMA; the producer brings
//      the live K / V tiles and their key ids as the forward's does; per
//      tile S = Q K^T and dP = dO V^T, then dS = P (dP - di) packed to bf16
//      into dQ += dS K (K the transposed B), issued beside the next tile's
//      S and dP.
//   3. In both kernels the two consumer warpgroups take turns at the tensor
//      cores (FlashAttention-3's ping-pong, on two named barriers): each
//      issues its next batch of products once the other has issued its
//      own, so one warpgroup's masks, exps and packing run while the
//      other's products do (both read the same stage, and without turns
//      they would reach their arithmetic together). Every wgmma is issued
//      unconditionally and waited for before other instructions touch its
//      accumulators: ptxas serializes every wgmma of a kernel that does
//      otherwise (its "Potential Performance Loss" lines).
//   4. Two launches and no atomics, so two runs give the same bits. A dQ
//      fused into the dK/dV kernel (FlashAttention-3's) sums across
//      blocks with fp32 atomics. dQ's query tiles launch from the last one
//      down, dK/dV's key tiles from the first up: the longest causal walks
//      start first.
//
// 128 keys a block rather than 64 with the two warpgroups splitting the
// pairs: both warpgroups read each pair's Q and dO from one stage, so a
// block brings 32 KB from L2 for 8.4 MFLOP at D = 128, as the forward does;
// 64 keys a block would double that traffic, ~4.6 TB/s from L2 at 60% of
// the tensor peak at S = 32,768. The price is Hk x S / 128 blocks: 64 for
// 132 SMs at a tensor-parallel rank's Hk = 1 and S = 8192.
//
// Registers: at D = 128, dK and dV take 128 fp32 registers a consumer
// thread and S^T and dP^T 32 each; P^T and dS^T are packed as S^T and dP^T
// die, which fits the consumers' kTrainBwdRegs (setmaxnreg; the producer
// runs at kTrainBwdLoadRegs) with no spill. As in the
// forward, work the data makes zero is never loaded or computed (live_tiles:
// the tiles that share an id with the block's rows, from / up to the
// diagonal in the causal form), a tile that lies wholly on the allowed
// side of a thread's diagonal and holds its rows' one id skips the masks
// (one exp for both paths, so the bits agree), and head dims below 128 run
// at 64 / 128 with TMA's zero fill, only D columns stored.

#pragma once

#include <climits>

#include "hopper_common.cuh"
#include "train_attention.cuh"
#include "train_wgmma_attention.cuh"

namespace livecc {

constexpr int kTrainBwdKeys = 128;      // dK/dV: keys per block, 64 per consumer warpgroup
constexpr int kTrainBwdRows = 128;      // dQ: queries per block, 64 per consumer warpgroup
constexpr int kTrainBwdTile = 64;       // the ring's tiles: 64 queries (dK/dV), 64 keys (dQ)
constexpr int kTrainBwdThreads = 384;   // two consumer warpgroups, then the producer's
constexpr int kTrainBwdRegs = 240;      // a consumer thread's registers (setmaxnreg)
constexpr int kTrainBwdLoadRegs = 24;   // a producer thread's
constexpr int kTrainBwdTurn = 1;        // named barriers 1, 2: the consumer warpgroups' turns

// The shared memory of the dK/dV kernel at head dim D: K and V of the
// block's keys, then kStages stages of a Q tile and a dO tile (64-column
// chunks of 128-byte rows, 1024-byte aligned, 128-byte swizzled); then the
// stages' lse, di and query ids, the block's key ids, live_tiles' scratch,
// the list of live query tiles and their one ids.
template <int D>
struct TrainDkvTile {
  static constexpr int kDp = D <= 64 ? 64 : 128;   // the products' head dim
  static constexpr int kChunks = kDp / 64;
  static constexpr int kKBytes = kChunks * kTrainBwdKeys * 128;      // K, then V
  static constexpr int kTileBytes = kChunks * kTrainBwdTile * 128;   // Q, then dO
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kRowInts = 3 * kTrainBwdTile;                 // lse, di, ids
  static constexpr int kFree = kTrainFwdSmemLimit - 1024 - 2 * kKBytes - 8192;
  static constexpr int kStages = kFree / (kStageBytes + 4 * kRowInts) < kTrainFwdMaxStages
                                     ? kFree / (kStageBytes + 4 * kRowInts)
                                     : kTrainFwdMaxStages;
  static constexpr int kIntsAt = 2 * kKBytes + kStages * kStageBytes;
  static constexpr int kScratch = 8;
  static_assert(kStages >= 2, "a ring of two stages at least");
  static size_t smem(int query_tiles) {
    return 1024 + kIntsAt + sizeof(int) * ((size_t)kStages * kRowInts + kTrainBwdKeys +
                                           kScratch + 2 * (size_t)query_tiles);
  }
};

// The dQ kernel keeps the forward's tiles, with Q and dO resident.
static_assert(kTrainBwdRows == kTrainFwdRows && kTrainBwdTile == kTrainFwdKeys,
              "dQ runs on the forward's tiles");
template <int D>
using TrainDqTile = TrainFwdTile<D, 2>;

namespace {

// d += A B over ROWS rows of B: A the bf16 fragments a[ROWS / 16] (one a
// k16 step), B the ROWS-row tile at `b` read transposed (MN-major: its
// 64-column chunks ROWS * 128 bytes apart, its 8-row groups 1024): dV +=
// P^T dO, dK += dS^T Q, dQ += dS K
template <int DP, int ROWS>
__device__ __forceinline__ void rs_product(float (&d)[DP / 2], const uint32_t (&a)[ROWS / 16][4],
                                           const unsigned char* b) {
#pragma unroll
  for (int kk = 0; kk < ROWS / 16; ++kk)
    wgmma_pv<DP>(d, a[kk], wgmma_desc(b + kk * 16 * 128, ROWS * 128, 1024));
}

// x (an m64n64 accumulator) as bf16 A fragments: its n8 tiles 2 kk and
// 2 kk + 1 are k16 step kk
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int j = 0; j < 4; ++j) a[kk][j] = pack_bf16(x[8 * kk + 2 * j], x[8 * kk + 2 * j + 1]);
}

// The consumer warpgroups' turns at the tensor cores (named barriers
// kTrainBwdTurn + wg): a warpgroup issues its next products once the other
// has issued its own (take_turn), then hands the turn over (pass_turn).
__device__ __forceinline__ void take_turn(int wg) { named_sync(kTrainBwdTurn + wg, 256); }
__device__ __forceinline__ void pass_turn(int wg) { named_arrive(kTrainBwdTurn + 1 - wg, 256); }

// P^T = exp(S^T - lse) where allowed, else 0, in place in sc, and dS^T =
// P^T (dP^T - di) in place in dp, on the accumulators' layout: sc[4 j + 2 h
// + c] is key keys[h], query q0 + 8 j + 2 tig + c. `rows` holds the query
// tile's lse, di and ids (kTrainBwdTile each). A tile with no masked pair
// (kClean) skips the masks; the rest is one code for both.
template <bool kCausal, bool kClean>
__device__ __forceinline__ void dkv_scores(float (&sc)[32], float (&dp)[32], const float* rows,
                                           int q0, int s, const int (&keys)[2],
                                           const int (&segk)[2], int tig) {
  const int* const ids = reinterpret_cast<const int*>(rows) + 2 * kTrainBwdTile;
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int ql = 8 * j + 2 * tig;
    const float2 lse = *reinterpret_cast<const float2*>(rows + ql);
    const float2 di = *reinterpret_cast<const float2*>(rows + kTrainBwdTile + ql);
    const int2 id = *reinterpret_cast<const int2*>(ids + ql);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int h = e >> 1, c = e & 1, q = q0 + ql + c;
      const bool ok = kClean || (q < s && keys[h] < s && (!kCausal || keys[h] <= q) &&
                                 (c ? id.y : id.x) == segk[h]);
      const float pt = ok ? __expf(sc[4 * j + e] - (c ? lse.y : lse.x)) : 0.f;
      sc[4 * j + e] = pt;
      dp[4 * j + e] = pt * (dp[4 * j + e] - (c ? di.y : di.x));
    }
  }
}

// dS = P (dP - di), P = exp(S - lse) where allowed, else 0, in place in dp
// on the accumulators' layout: sc[4 j + 2 r + c] is row rows[r], key k0 + 8
// j + 2 tig + c; tSeg holds the tile's key ids. A tile with no masked pair
// (kClean) skips the masks, with the same exp.
template <bool kCausal, bool kClean>
__device__ __forceinline__ void dq_scores(const float (&sc)[32], float (&dp)[32], const int* tSeg,
                                          int k0, int s, const int (&rows)[2],
                                          const int (&segs)[2], const float (&lse)[2],
                                          const float (&di)[2], int tig) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int kl = 8 * j + 2 * tig;
    const int2 ids = *reinterpret_cast<const int2*>(tSeg + kl);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + kl + (e & 1), r = e >> 1;
      const bool ok = kClean || (key < s && (!kCausal || key <= rows[r]) &&
                                 ((e & 1) ? ids.y : ids.x) == segs[r]);
      const float pv = ok ? __expf(sc[4 * j + e] - lse[r]) : 0.f;
      dp[4 * j + e] = pv * (dp[4 * j + e] - di[r]);
    }
  }
}

// Block (KV head, row, 128-key tile from the first up). Threads 0-255: the
// consumer warpgroups (keys 0-63, 64-127 of the block); 256-383: the
// producer, whose first warp fills the ring with the (q head, live query
// tile) pairs.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kTrainBwdThreads, 1)
    train_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                           const __grid_constant__ CUtensorMap kmap,
                           const __grid_constant__ CUtensorMap vmap,
                           const __grid_constant__ CUtensorMap domap, TrainAttnParams p) {
  static_assert(D % 16 == 0 && D <= kMaxHeadDim, "head dim: a multiple of 16 up to 128");
  using Tile = TrainDkvTile<D>;
  constexpr int KB = kTrainBwdKeys, QT = kTrainBwdTile, S = Tile::kStages, DP = Tile::kDp;
  __shared__ __align__(8) uint64_t kv_full, full[S], empty[S];
  extern __shared__ unsigned char dkv_dyn[];
  unsigned char* const tiles = dkv_dyn + ((1024 - (smem_addr(dkv_dyn) & 1023)) & 1023);
  unsigned char* const ring = tiles + 2 * Tile::kKBytes;
  float* const sRows = reinterpret_cast<float*>(tiles + Tile::kIntsAt);   // [S][lse, di, ids]
  int* const sSegK = reinterpret_cast<int*>(sRows + S * Tile::kRowInts);  // [KB]
  int* const scratch = sSegK + KB;                                        // [kScratch]
  int* const sList = scratch + Tile::kScratch;                            // [query tiles]
  const int s = p.s, q_tiles = (s + QT - 1) / QT;
  int* const sUni = sList + q_tiles;                                      // [query tiles]

  const int kvh = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * KB;
  const int groups = p.hq / p.hk;
  if (threadIdx.x == 0) {
    mbar_init(&kv_full, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 33);              // the producer warp's lanes, lane 0's expect_tx,
                                            // then TMA's bytes
      mbar_init(&empty[i], 8);              // one arrival per consumer warp
    }
    mbar_init_fence();
    mbar_expect_tx(&kv_full, 2 * Tile::kKBytes);   // K and V run beside the walk's reads
    for (int c = 0; c < Tile::kChunks; ++c) {
      tma_load_4d(tiles + c * KB * 128, &kmap, 64 * c, k0, kvh, b, &kv_full);
      tma_load_4d(tiles + Tile::kKBytes + c * KB * 128, &vmap, 64 * c, k0, kvh, b, &kv_full);
    }
  }
  // (live_tiles' barriers order the initialisation before any use)
  const int n_live = live_tiles<KB, QT, kTrainBwdThreads>(
      sSegK, sList, scratch, p.seg + (long long)b * s, s, k0, INT_MAX, kCausal ? k0 / QT : 0,
      q_tiles, sUni);
  const int pairs = groups * n_live;        // pair i: q head i / n_live, tile sList[i % n_live]

  if (threadIdx.x >= 256) {                 // the producer
    regs_dec<kTrainBwdLoadRegs>();
    if (threadIdx.x < 288) {                // its first warp: lane 0 the copies, all the rows
      const int lane = threadIdx.x % 32;
      const int* segb = p.seg + (long long)b * s;
      for (int i = 0; i < pairs; ++i) {
        const int st = i % S, h = kvh * groups + i / n_live, q0 = sList[i % n_live] * QT;
        unsigned char* const stage = ring + st * Tile::kStageBytes;
        mbar_wait(&empty[st], ((i / S) & 1) ^ 1);
        if (lane == 0) {
          mbar_expect_tx(&full[st], Tile::kStageBytes);
          for (int c = 0; c < Tile::kChunks; ++c) {
            tma_load_4d(stage + c * QT * 128, &qmap, 64 * c, q0, h, b, &full[st]);
            tma_load_4d(stage + Tile::kTileBytes + c * QT * 128, &domap, 64 * c, q0, h, b,
                        &full[st]);
          }
        }
        float* const rows = sRows + st * Tile::kRowInts;
        const long long at = ((long long)b * p.hq + h) * s + q0;
        for (int j = lane; j < QT; j += 32) {
          const bool in = q0 + j < s;
          rows[j] = in ? p.lse[at + j] : 0.f;
          rows[QT + j] = in ? p.di[at + j] : 0.f;
          reinterpret_cast<int*>(rows)[2 * QT + j] = in ? segb[q0 + j] : INT_MIN;
        }
        mbar_arrive(&full[st]);
      }
    }
    return;
  }

  regs_inc<kTrainBwdRegs>();
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int kl = wg * 64 + warp * 16 + gid;       // the thread's two keys in the block
  const int keys[2] = {k0 + kl, k0 + kl + 8};
  const int segk[2] = {sSegK[kl], sSegK[kl + 8]};
  const unsigned char* const sK = tiles + wg * 64 * 128;   // this warpgroup's 64 keys
  const unsigned char* const sV = tiles + Tile::kKBytes + wg * 64 * 128;
  float dk[DP / 2], dv[DP / 2], sc[32], dp[32];
  uint32_t pa[4][4], da[4][4];              // P^T, dS^T as A fragments over the tile's queries
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dk[i] = dv[i] = 0.f;
  mbar_wait(&kv_full, 0);

  // The warpgroups take turns at the tensor cores, warpgroup 0 first: one's
  // masks and exps run beside the other's products. Every wgmma is issued
  // unconditionally and waited for before its accumulators are touched:
  // ptxas serializes wgmma's issued on a branch, or whose accumulators other
  // instructions write while a group is in flight. A pair whose queries all
  // precede the warpgroup's keys (the diagonal tile of the second one) is
  // computed all the same: every p is masked to 0 and adds exact zeros.
  if (wg == 1) pass_turn(wg);
  for (int i = 0; i < pairs; ++i) {
    const int st = i % S, t = i % n_live, q0 = sList[t] * QT;
    const unsigned char* const stage = ring + st * Tile::kStageBytes;
    mbar_wait(&full[st], (i / S) & 1);
    take_turn(wg);
    fence_acc(sc);
    fence_acc(dp);
    wgmma_fence();
    ss_scores<DP, KB, QT>(sc, sK, stage);                      // S^T = K Q^T
    ss_scores<DP, KB, QT>(dp, sV, stage + Tile::kTileBytes);   // dP^T = V dO^T
    wgmma_commit();
    pass_turn(wg);
    wgmma_wait<0>();
    fence_acc(sc);
    fence_acc(dp);
    // no mask can apply: the tile lies after both keys and holds their id alone
    const int one = sUni[t];
    const float* const rows = sRows + st * Tile::kRowInts;
    if (one != INT_MIN && one == segk[0] && one == segk[1] && keys[1] < s &&
        (!kCausal || keys[1] <= q0))
      dkv_scores<kCausal, true>(sc, dp, rows, q0, s, keys, segk, tig);
    else
      dkv_scores<kCausal, false>(sc, dp, rows, q0, s, keys, segk, tig);
    pack_a(pa, sc);
    pack_a(da, dp);
    take_turn(wg);
    fence_acc(dk);
    fence_acc(dv);
    wgmma_fence();
    rs_product<DP, QT>(dv, pa, stage + Tile::kTileBytes);      // dV += P^T dO
    rs_product<DP, QT>(dk, da, stage);                         // dK += dS^T Q
    wgmma_commit();
    pass_turn(wg);
    wgmma_wait<0>();
    fence_acc(dk);
    fence_acc(dv);
    if (lane == 0) mbar_arrive(&empty[st]);   // this warp is done with its stage
  }
  if (wg == 0) take_turn(wg);               // warpgroup 1's last pass

  __nv_bfloat16* const dkb =
      static_cast<__nv_bfloat16*>(p.dk) + ((long long)b * s * p.hk + kvh) * D;
  __nv_bfloat16* const dvb =
      static_cast<__nv_bfloat16*>(p.dv) + ((long long)b * s * p.hk + kvh) * D;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (keys[h] >= s) continue;
    const long long off = (long long)keys[h] * p.hk * D + 2 * tig;
#pragma unroll
    for (int j = 0; j < D / 8; ++j) {
      *reinterpret_cast<__nv_bfloat162*>(dkb + off + j * 8) =
          __floats2bfloat162_rn(dk[4 * j + 2 * h], dk[4 * j + 2 * h + 1]);
      *reinterpret_cast<__nv_bfloat162*>(dvb + off + j * 8) =
          __floats2bfloat162_rn(dv[4 * j + 2 * h], dv[4 * j + 2 * h + 1]);
    }
  }
}

// Block (q head, row, 128-query tile from the last down). Threads 0-255:
// the consumer warpgroups (rows 0-63, 64-127 of the tile); 256-383: the
// producer, whose first warp fills the ring with the live key tiles.
template <int D, bool kCausal>
__global__ void __launch_bounds__(kTrainBwdThreads, 1)
    train_dq_wgmma_kernel(const __grid_constant__ CUtensorMap qmap,
                          const __grid_constant__ CUtensorMap kmap,
                          const __grid_constant__ CUtensorMap vmap,
                          const __grid_constant__ CUtensorMap domap, TrainAttnParams p) {
  static_assert(D % 16 == 0 && D <= kMaxHeadDim, "head dim: a multiple of 16 up to 128");
  using Tile = TrainDqTile<D>;
  constexpr int R = kTrainBwdRows, KT = kTrainBwdTile, S = Tile::kStages, DP = Tile::kDp;
  __shared__ __align__(8) uint64_t q_full, full[S], empty[S];
  extern __shared__ unsigned char dq_dyn[];
  unsigned char* const tiles = dq_dyn + ((1024 - (smem_addr(dq_dyn) & 1023)) & 1023);
  unsigned char* const ring = tiles + Tile::kRingAt;
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
  const int* segb = p.seg + (long long)b * s;
  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 33);
      mbar_init(&empty[i], 8);
    }
    mbar_init_fence();
    mbar_expect_tx(&q_full, 2 * Tile::kQBytes);   // Q and dO run beside the walk's reads
    for (int c = 0; c < Tile::kChunks; ++c) {
      tma_load_4d(tiles + c * R * 128, &qmap, 64 * c, q0, h, b, &q_full);
      tma_load_4d(tiles + Tile::kQBytes + c * R * 128, &domap, 64 * c, q0, h, b, &q_full);
    }
  }
  const int n_live = live_tiles<R, KT, kTrainBwdThreads>(
      sSegQ, sList, scratch, segb, s, q0, INT_MIN, 0,
      kCausal ? min(key_tiles, (q0 + R - 1) / KT + 1) : key_tiles, sUni);

  if (threadIdx.x >= 256) {                 // the producer: the forward's walk
    regs_dec<kTrainBwdLoadRegs>();
    if (threadIdx.x < 288)
      produce_kv_tiles<KT, S, Tile::kChunks>(ring, sSegK, full, empty, sList, n_live, &kmap,
                                             &vmap, kvh, b, segb, s);
    return;
  }

  regs_inc<kTrainBwdRegs>();
  const int wg = threadIdx.x / 128, warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int rl = wg * 64 + warp * 16 + gid;     // the thread's two rows in the tile
  const int rows[2] = {q0 + rl, q0 + rl + 8};
  const int segs[2] = {sSegQ[rl], sSegQ[rl + 8]};
  float lse[2], di[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const long long at = ((long long)b * p.hq + h) * s + rows[r];
    lse[r] = rows[r] < s ? p.lse[at] : 0.f;
    di[r] = rows[r] < s ? p.di[at] : 0.f;
  }
  const unsigned char* const sQ = tiles + wg * 64 * 128;   // this warpgroup's 64 rows
  const unsigned char* const sDO = tiles + Tile::kQBytes + wg * 64 * 128;
  float dq[DP / 2], sc[32], dp[32];
  uint32_t pa[4][4];                        // dS as A fragments over a tile's keys
#pragma unroll
  for (int i = 0; i < DP / 2; ++i) dq[i] = 0.f;
  auto stage_at = [&](int i) { return ring + (i % S) * Tile::kStageBytes; };
  mbar_wait(&q_full, 0);

  // A turn issues tile i's S and dP beside tile i - 1's dQ += dS K, the
  // warpgroups taking turns as in the dK/dV kernel; each turn's products
  // are waited for before dS is formed in their accumulators (see there).
  auto tile_ds = [&](int i) {               // tile i's dS, in dp, packed into pa
    const int k0 = sList[i] * KT, one = sUni[i];
    const int* const tSeg = sSegK + (i % S) * KT;
    // no mask can apply: the tile lies below both rows' diagonal and holds their id alone
    if (one != INT_MIN && one == segs[0] && one == segs[1] &&
        (!kCausal || k0 + KT - 1 <= rows[0]))
      dq_scores<kCausal, true>(sc, dp, tSeg, k0, s, rows, segs, lse, di, tig);
    else
      dq_scores<kCausal, false>(sc, dp, tSeg, k0, s, rows, segs, lse, di, tig);
    pack_a(pa, dp);
  };
  if (wg == 1) pass_turn(wg);
  mbar_wait(&full[0], 0);
  take_turn(wg);
  fence_acc(sc);
  fence_acc(dp);
  wgmma_fence();
  ss_scores<DP, R, KT>(sc, sQ, stage_at(0));                         // S = Q K^T
  ss_scores<DP, R, KT>(dp, sDO, stage_at(0) + Tile::kKVBytes);       // dP = dO V^T
  wgmma_commit();
  pass_turn(wg);
  wgmma_wait<0>();
  fence_acc(sc);
  fence_acc(dp);
  tile_ds(0);
  for (int i = 1; i < n_live; ++i) {
    mbar_wait(&full[i % S], (i / S) & 1);
    take_turn(wg);
    fence_acc(sc);
    fence_acc(dp);
    fence_acc(dq);
    wgmma_fence();
    ss_scores<DP, R, KT>(sc, sQ, stage_at(i));
    ss_scores<DP, R, KT>(dp, sDO, stage_at(i) + Tile::kKVBytes);
    rs_product<DP, KT>(dq, pa, stage_at(i - 1));                     // dQ += dS K
    wgmma_commit();
    pass_turn(wg);
    wgmma_wait<0>();
    fence_acc(sc);
    fence_acc(dp);
    fence_acc(dq);
    if (lane == 0) mbar_arrive(&empty[(i - 1) % S]);   // this warp is done with tile i - 1
    tile_ds(i);
  }
  take_turn(wg);
  fence_acc(dq);
  wgmma_fence();
  rs_product<DP, KT>(dq, pa, stage_at(n_live - 1));
  wgmma_commit();
  pass_turn(wg);
  wgmma_wait<0>();
  fence_acc(dq);
  if (lane == 0) mbar_arrive(&empty[(n_live - 1) % S]);
  if (wg == 0) take_turn(wg);               // warpgroup 1's last pass

  __nv_bfloat16* const dqb =
      static_cast<__nv_bfloat16*>(p.dq) + ((long long)b * s * p.hq + h) * D;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (rows[r] >= s) continue;
    __nv_bfloat16* const drow = dqb + (long long)rows[r] * p.hq * D + 2 * tig;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(drow + j * 8) =
          __floats2bfloat162_rn(dq[4 * j + 2 * r], dq[4 * j + 2 * r + 1]);
  }
}

// The backward of bf16 operands: dK/dV over (Hk, B, 128-key tiles), then dQ
// over (Hq, B, 128-query tiles), on one stream. dK/dV streams 64-row Q and
// dO tiles beside its 128 K / V rows, dQ 64-row K and V tiles beside its
// 128 Q / dO rows; the tensor maps are encoded at each call and passed by
// value (__grid_constant__), so a captured graph holds them beside the
// addresses it was captured with.
template <int D, bool kCausal>
int launch_train_bwd_wgmma(const TrainAttnParams& p, int batch, cudaStream_t stream) {
  constexpr int T = kTrainBwdTile;
  CUtensorMap q_t, do_t, k_b, v_b, q_b, do_b, k_t, v_t;
  if (!train_fwd_map(&q_t, p.q, D, p.s, p.hq, batch, p.q_sb, p.q_ss, p.q_sh, T) ||
      !train_fwd_map(&do_t, p.dout, D, p.s, p.hq, batch, p.do_sb, p.do_ss, p.do_sh, T) ||
      !train_fwd_map(&k_b, p.k, D, p.s, p.hk, batch, p.k_sb, p.k_ss, p.k_sh, kTrainBwdKeys) ||
      !train_fwd_map(&v_b, p.v, D, p.s, p.hk, batch, p.v_sb, p.v_ss, p.v_sh, kTrainBwdKeys) ||
      !train_fwd_map(&q_b, p.q, D, p.s, p.hq, batch, p.q_sb, p.q_ss, p.q_sh, kTrainBwdRows) ||
      !train_fwd_map(&do_b, p.dout, D, p.s, p.hq, batch, p.do_sb, p.do_ss, p.do_sh,
                     kTrainBwdRows) ||
      !train_fwd_map(&k_t, p.k, D, p.s, p.hk, batch, p.k_sb, p.k_ss, p.k_sh, T) ||
      !train_fwd_map(&v_t, p.v, D, p.s, p.hk, batch, p.v_sb, p.v_ss, p.v_sh, T))
    return (int)cudaErrorInvalidValue;
  const int tiles = (p.s + T - 1) / T;
  const size_t dkv_smem = TrainDkvTile<D>::smem(tiles), dq_smem = TrainDqTile<D>::smem(tiles);
  const auto dkv = train_dkv_wgmma_kernel<D, kCausal>;
  const auto dq = train_dq_wgmma_kernel<D, kCausal>;
  cudaError_t err =
      cudaFuncSetAttribute(dkv, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dkv_smem);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(dq, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)dq_smem);
  if (err != cudaSuccess) return (int)err;
  dkv<<<dim3(p.hk, batch, (p.s + kTrainBwdKeys - 1) / kTrainBwdKeys), kTrainBwdThreads, dkv_smem,
        stream>>>(q_t, k_b, v_b, do_t, p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq<<<dim3(p.hq, batch, (p.s + kTrainBwdRows - 1) / kTrainBwdRows), kTrainBwdThreads, dq_smem,
       stream>>>(q_b, k_t, v_t, do_b, p);
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace livecc
