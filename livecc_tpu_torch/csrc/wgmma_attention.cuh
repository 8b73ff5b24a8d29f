// bf16 online-softmax attention on Hopper's warpgroup products, shared by K1
// (flash_prefill.cu: causal, per-row offset and kv_limit, GQA) and K3
// (vit_attention.cu: bidirectional within segments given by their bounds):
// a tile of kWgRows = 128 query rows against the keys in tiles of
// kWgKeys = 64, wgmma fed by TMA from a producer warp.
//
// Replaces, for bf16 q/k/v/o: livecc_tpu/ops/pallas/attention.py:flash_prefill
// (_prefill_kernel) and livecc_tpu/ops/pallas/vit_attention.py:
// vit_group_attention (_vit_attn_kernel). fp32 stays on tile_attention.cuh;
// bf16 K1-int8 (the int8 cache) has its own tile, quant_mma_attention.cuh.
//
// What bounds it on the H100: the products, at the paths' long shapes (K3
// at g = 880, H = 16, D = 80: 11.9 GFLOP against 27 MB; K1 at Sq = 1024,
// kv 690, D = 128: 6.7 GFLOP against 16 MB; both far above the card's ~295
// FLOP/byte ridge); launch and fill at the short ones (K1's verify window,
// Sq = 9). The design is K4's forward core (train_wgmma_attention.cuh):
//
//   1. A block is two consumer warpgroups, each owning 64 of the tile's 128
//      rows, and a producer warpgroup. S = Q K^T is m64n64k16 with both
//      operands in shared memory; O += P V takes P from registers (the S
//      accumulator packed to bf16 pairs is the A operand's layout,
//      hopper_common.cuh) and V as the transposed B. Tile i's S is issued
//      beside tile i - 1's P V, so the softmax of tile i runs while the
//      tensor cores work through P V (the two groups complete in order).
//      The warpgroups take turns at issuing their products (named barriers
//      1 and 2), so one's products run while the other computes its
//      softmax: both would otherwise reach the softmax together, for they
//      wait on the same stages, and leave the tensor cores idle.
//   2. One thread copies the Q tile by TMA at the start; the producer warp's
//      first lane copies each K / V tile into a ring of kStages stages (as
//      many as 227 KB hold, at most kWgMaxStages), handed over by full and
//      empty mbarriers. setmaxnreg gives the producer 40 registers and the
//      consumers 232. Tiles land 128-byte swizzled, as wgmma reads them.
//      A softmax step is one tile of 64 keys. Two tiles a step (one max and
//      one rescale for 128 keys, six stages) ran the long walks 5-8% faster
//      but moved the reduced MCQ item's letter logits past chip_smoke's bf16
//      limit from the plain path (PERF.md).
//   3. One bf16 P term: p is rounded to v's dtype for P V, the TPU kernels'
//      p.astype(v.dtype), so P V is one product, half of K4's three-part
//      tensor work per score. With so little tensor work per score the
//      softmax sets the pace, so it is lean: scores, masks, the running max
//      and sum stay fp32 in registers in log2 units, p = 2^(s * scale *
//      log2 e - m) is one FMA and the SFU's ex2.approx.ftz, and a tile
//      below both of a thread's row limits skips the masks and their test.
//      l is summed before p is rounded, the output is normalised after P V,
//      and a row that saw no valid key writes 0 (a masked score never
//      becomes p > 0, so the running max stays finite). A second
//      warpgroup with no row of the tile returns at once and the ring
//      waits for four warps, not eight.
//
// K1 (kCausal):
//   * The G = Hq / Hk query heads of a KV head are packed into the rows: a
//     block serves one KV head, its row r is query r / G, head r % G of that
//     group, so each K / V tile is read once per group, not G times. A tile
//     holds qt = 128 / G whole queries (18 at the 7B's G = 7: 126 rows; a
//     verify window's 9 queries are 63 rows, one warpgroup). q arrives
//     [B, Sq, Hq, D] (the text tower's layout, seen transposed), so a
//     token's G heads are adjacent and one TMA box of (64 columns, G heads,
//     qt queries) reads a tile's rows in order. A row's causal frontier is
//     offset[b] + its query.
//   * The keys of a tile are split across nsplit blocks (grid z = B x
//     nsplit), nsplit chosen by the wrapper from the grid's shape alone to
//     fill the card's 132 SMs (ops/flash_attention.py:prefill_plan). Each
//     block reads offset / kv_limit itself (no host sync), takes its tile's
//     n key tiles up to the frontier (prefill_span) and walks its share of
//     per = ceil(n / nsplit); a block past the live splits exits. A tile
//     with one live split writes its output; with more, each block writes
//     its rows' unnormalised O, max and sum to the wrapper's workspace, and
//     prefill_merge_kernel combines them (sum e^(m_s - M) acc_s / sum
//     e^(m_s - M) l_s, as K2's merge does). So a row's bits depend on the
//     call's shape (B, Hk, Sq), not only on its own keys (ROADMAP hazards).
//   * K and V are each one 5-d map over the stacked cache [L, B, Hk, Smax,
//     D], the layer a coordinate, encoded once per cache by the wrapper
//     (livecc_prefill_kv_map); q's map is encoded at each call. Both reach
//     the kernel by value (__grid_constant__), so a CUDA graph captured
//     around K1 (the lookahead steps, engine/graphs.py) keeps them as they
//     were at capture. That is valid only because the cache and the graph's
//     q buffer stay where they were for the graph's life (graph_key changes
//     when the cache grows).
//   * TMA reads a tile's 64 keys whole, so the tile that crosses kv_limit
//     brings cache rows past it that nothing need have written. Their
//     scores are masked; their V rows are set to 0 in shared memory before
//     P V reads them (wg_clear_v), so a NaN or Inf stored there never meets
//     p = 0 and the output is as if those rows held zeros (the plain
//     version reads them as zeros too).
// K3:
//   * A block is one 128-row tile of one segment and head: the tile starts
//     at the segment's first row (TMA's row coordinate); keys past the
//     segment's end (the next segment's rows, or TMA's zeros past N) are
//     masked, and query rows past it are never stored, for the next
//     segment's output lies there.
//   * D = 80 (kTail): 64 columns in the 128-byte swizzle and a 16-column
//     tail in the 32-byte swizzle, S in 4 + 1 k-steps and P V at N = 64 + 16.
//     Without kTail a head dim is rounded up to 64 or 128 by TMA's zero fill
//     (the extra columns add exact zeros; only D columns are stored), which
//     at D = 80 runs both products 1.6x wider.
//
// As in the earlier mma.sync version, masks run only on a tile that crosses
// a row's limit, and nothing is atomic: two launches give the same bits.

#pragma once

#include "hopper_common.cuh"

namespace livecc {

constexpr int kWgRows = 128;       // query rows a block: 64 a consumer warpgroup
constexpr int kWgKeys = 64;        // keys a ring stage (tools/kernel_check.py TILE)
constexpr int kWgThreads = 384;    // two consumer warpgroups, then the producer's
constexpr int kWgMaxStages = 4;
constexpr int kWgSmemLimit = 232448;   // 227 KB a block
constexpr float kLog2e = 1.4426950408889634f;

// The shared memory of head dim D: the Q tile, then kStages stages of a K
// tile and a V tile. A tile of R rows holds kFull 64-column chunks of R
// 128-byte rows (128-byte swizzled), chunk c at c * R * 128, then with kTail
// the 16-column tail, R rows of 32 bytes (32-byte swizzled).
template <int D, bool kTail>
struct WgTile {
  static_assert(D % 16 == 0 && D <= kMaxHeadDim, "head dim: a multiple of 16 up to 128");
  static_assert(!kTail || D % 64 == 16, "a tail of 16 columns");
  static constexpr int kFull = kTail ? D / 64 : (D + 63) / 64;
  static constexpr int kDp = 64 * kFull + (kTail ? 16 : 0);   // the products' head dim
  static constexpr int kRowBytes = 128 * kFull + (kTail ? 32 : 0);
  static constexpr int kQBytes = kWgRows * kRowBytes;
  static constexpr int kKVBytes = kWgKeys * kRowBytes;
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kFit = (kWgSmemLimit - 1024 - kQBytes) / kStageBytes;
  static constexpr int kStages = kFit < kWgMaxStages ? kFit : kWgMaxStages;
  static constexpr size_t kSmem = 1024 + kQBytes + (size_t)kStages * kStageBytes;
  static_assert(kStages >= 2, "a ring of two stages at least");
};

// q's map (4-d: columns, heads, rows, batch) and K's and V's (5-d: columns,
// rows, heads, batch, layer), each with its tail's maps where kTail
struct WgMaps {
  CUtensorMap q, k, v, q_tail, k_tail, v_tail;
};

struct WgAttnParams {
  __nv_bfloat16* o;
  long long o_sb, o_sh, o_ss;   // the output's (batch, head, row) strides, elements
  const int* offset;            // K1: [B] on the device
  const int* kv_limit;          // K1: [B] on the device
  const int* cu_seqlens;        // K3: [nseg + 1] on the device
  float* ws;                    // K1 with nsplit > 1: [B, Hk, tiles, nsplit, 128, D] partial O
  float* ws_ml;                 // and [B, Hk, tiles, nsplit, 128, 2] (max, sum)
  int hk, g;                    // KV heads; query heads a KV head (K3: 1)
  int qt, tiles, nsplit;        // queries a tile (K3: 128), query tiles, key splits a tile
  int sq, skv, layer;
  float scale;
};

// K1's key tiles of query tile t of batch row b: n up to the tile's causal
// frontier (0 where no key is valid), per = ceil(n / nsplit) a split, and
// the live splits ceil(n / per). ops/flash_attention.py:prefill_span is
// the same rule.
struct WgSpan {
  int n, per, live;
};

namespace {

__device__ __forceinline__ WgSpan prefill_span(const WgAttnParams& p, int b, int t) {
  const int last = min(p.sq, (t + 1) * p.qt);                 // the tile's queries end here
  const int lim = min(p.kv_limit ? p.kv_limit[b] : p.skv, p.skv);
  const int kv_end = min(lim, p.offset[b] + last);
  const int n = kv_end > 0 ? (kv_end + kWgKeys - 1) / kWgKeys : 0;
  const int per = max(1, (n + p.nsplit - 1) / p.nsplit);
  return {n, per, (n + per - 1) / per};
}

// S = Q K^T of warpgroup wg's 64 rows against a stage's 64 keys: 4 k-steps a
// 128-byte chunk, then the tail's one
template <int D, bool kTail>
__device__ __forceinline__ void wg_scores(float (&sc)[32], const unsigned char* sQ,
                                          const unsigned char* stage, int wg) {
  using Tile = WgTile<D, kTail>;
  if constexpr (Tile::kFull > 0)
    ss_scores<64 * Tile::kFull, kWgRows, kWgKeys>(sc, sQ + wg * 64 * 128, stage);
  if constexpr (kTail)
    wgmma_ss_n64(sc, sw32_desc(sQ + Tile::kFull * kWgRows * 128 + wg * 64 * 32, 16, 256),
                 sw32_desc(stage + Tile::kFull * kWgKeys * 128, 16, 256), Tile::kFull > 0);
}

// O += P V over a stage's 64 keys: V's k16 step kk is 16 rows further, its
// 64-column chunks 64 x 128 bytes apart, its 8-row groups 1024 bytes (the
// tail's 256)
template <int D, bool kTail>
__device__ __forceinline__ void wg_pv(float (&acc)[WgTile<D, kTail>::kDp / 2],
                                      const uint32_t (&pa)[kWgKeys / 16][4],
                                      const unsigned char* stage) {
  using Tile = WgTile<D, kTail>;
  constexpr int F = Tile::kFull;
  const unsigned char* const sV = stage + Tile::kKVBytes;
#pragma unroll
  for (int kk = 0; kk < kWgKeys / 16; ++kk) {
    if constexpr (F > 0)
      wgmma_pv<64 * F>(*reinterpret_cast<float(*)[32 * F]>(acc), pa[kk],
                       wgmma_desc(sV + kk * 16 * 128, kWgKeys * 128, 1024));
    if constexpr (kTail)
      wgmma_rs_n16_tb(*reinterpret_cast<float(*)[8]>(acc + 32 * F), pa[kk],
                      sw32_desc(sV + F * kWgKeys * 128 + kk * 16 * 32, kWgKeys * 32, 256));
  }
}

// K1: V's rows `from`..63 of a stage set to 0 (each 64-column chunk's rows
// are 128 bytes, whose swizzle stays within the row). Each consumer
// warpgroup clears them all, the other writing the same zeros, and orders
// its writes before its own P V by the proxy fence and a barrier of its 128
// threads (ids 3 and 4; 1 and 2 are the turns).
template <int F>
__device__ __forceinline__ void wg_clear_v(unsigned char* sV, int from, int wg) {
  const int chunks = (kWgKeys - from) * 8;      // 16-byte chunks of a 64-column chunk
  for (int c = 0; c < F; ++c)
    for (int i = threadIdx.x % 128; i < chunks; i += 128)
      *reinterpret_cast<uint4*>(sV + c * kWgKeys * 128 + from * 128 + i * 16) =
          make_uint4(0u, 0u, 0u, 0u);
  fence_proxy_async();
  named_sync(3 + wg, 128);
}

// 2^x by the SFU alone (ex2.approx.ftz: subnormal results flush to 0)
__device__ __forceinline__ float wg_ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// The masks (a key at or past a row's limit klim scores kNegInf), the new
// running max of the thread's two rows (log2 units) and its rescale alpha,
// and p = 2^(s * scale * log2(e) - m) (0 where masked) in place, summed
// into l; sc[4 j + 2 h + c] is row h, key k0 + 8 j + 2 tig + c. A tile below
// both limits takes neither the masks nor their test.
__device__ __forceinline__ void wg_softmax(float (&sc)[32], int k0, const int (&klim)[2],
                                           int tig, float sl2, float (&m)[2], float (&l)[2],
                                           float (&alpha)[2]) {
  const bool clean = k0 + kWgKeys <= min(klim[0], klim[1]);
  float mx[2] = {kNegInf, kNegInf};
  if (!clean) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int h = (e >> 1) & 1, key = k0 + 8 * (e >> 2) + 2 * tig + (e & 1);
      sc[e] = key < klim[h] ? sc[e] : kNegInf;
    }
  }
#pragma unroll
  for (int e = 0; e < 32; ++e) mx[(e >> 1) & 1] = fmaxf(mx[(e >> 1) & 1], sc[e]);
#pragma unroll
  for (int h = 0; h < 2; ++h) mx[h] = mx[h] == kNegInf ? kNegInf : mx[h] * sl2;
  softmax_max(m, l, mx, alpha);
  if (clean) {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int h = (e >> 1) & 1;
      sc[e] = wg_ex2(fmaf(sc[e], sl2, -m[h]));
      l[h] += sc[e];
    }
  } else {
#pragma unroll
    for (int e = 0; e < 32; ++e) {
      const int h = (e >> 1) & 1;
      sc[e] = sc[e] == kNegInf ? 0.f : wg_ex2(fmaf(sc[e], sl2, -m[h]));
      l[h] += sc[e];
    }
  }
}

// p rounded to bf16 as the A operand: key step kk is the accumulator's n8
// tiles 2 kk and 2 kk + 1
__device__ __forceinline__ void wg_pack_p(const float (&sc)[32], uint32_t (&pa)[4][4]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int x = 0; x < 4; ++x) pa[kk][x] = pack_bf16(sc[8 * kk + 2 * x], sc[8 * kk + 2 * x + 1]);
}

// Grid: K1 (query tiles from the last down, Hk, B x nsplit); K3 (128-row
// tiles of the longest segment, H, segments). Threads 0-255: the consumer
// warpgroups (rows 0-63, 64-127 of the tile); 256-383: the producer, whose
// first thread fills the ring.
template <int D, bool kTail, bool kCausal>
__global__ void __launch_bounds__(kWgThreads, 1)
    wgmma_attention_kernel(const __grid_constant__ WgMaps maps, const WgAttnParams p) {
  using Tile = WgTile<D, kTail>;
  constexpr int R = kWgRows, KT = kWgKeys, S = Tile::kStages, F = Tile::kFull;
  __shared__ __align__(8) uint64_t q_full, full[S], empty[S];
  extern __shared__ unsigned char wg_dyn[];
  unsigned char* const tiles = wg_dyn + ((1024 - (smem_addr(wg_dyn) & 1023)) & 1023);

  // The block's work, the same in every thread: `rows` query rows (row r is
  // query r / g, head r % g) whose Q box sits at (head0, qrow0, qb); the key
  // tiles [t0, t0 + n) at (krow0 + key, kvh, kb, layer); row r's keys below
  // min(lim, qpos0 + r / g + 1) (K3: below lim); the output rows from `ob`,
  // or K1's partials at `part`.
  int rows, t0, n, head0, qrow0, qb, krow0, kvh, kb, layer, lim, qpos0;
  __nv_bfloat16* ob;
  float* part = nullptr;
  float* part_ml = nullptr;
  if constexpr (kCausal) {
    const int t = p.tiles - 1 - blockIdx.x;                    // the longest walks first
    const int b = blockIdx.z / p.nsplit, s = blockIdx.z % p.nsplit;
    const WgSpan sp = prefill_span(p, b, t);
    if (s >= max(sp.live, 1)) return;                          // past the live splits
    kvh = blockIdx.y;
    rows = min(p.qt, p.sq - t * p.qt) * p.g;
    t0 = s * sp.per;
    n = max(min(sp.n - t0, sp.per), 1);     // a tile with no valid key walks one, all masked
    head0 = kvh * p.g;
    qrow0 = t * p.qt;
    qb = kb = b;
    krow0 = 0;
    layer = p.layer;
    lim = min(p.kv_limit ? p.kv_limit[b] : p.skv, p.skv);
    qpos0 = p.offset[b] + qrow0;
    ob = p.o + b * p.o_sb + (long long)qrow0 * p.o_ss + (long long)head0 * p.o_sh;
    if (sp.live > 1) {
      const long long at = ((((long long)b * p.hk + kvh) * p.tiles + t) * p.nsplit + s) * R;
      part = p.ws + at * D;
      part_ml = p.ws_ml + at * 2;
    }
  } else {
    const int start = p.cu_seqlens[blockIdx.z];
    const int len = p.cu_seqlens[blockIdx.z + 1] - start, q0 = blockIdx.x * R;
    if (q0 >= len) return;
    rows = min(R, len - q0);
    t0 = 0;
    n = (len + KT - 1) / KT;
    head0 = kvh = blockIdx.y;
    qrow0 = start + q0;
    qb = kb = layer = 0;
    krow0 = start;
    lim = len;
    qpos0 = 0;
    ob = p.o + (long long)qrow0 * p.o_ss + (long long)head0 * p.o_sh;
  }
  const bool two = rows > 64;               // the second warpgroup has rows

  if (threadIdx.x == 0) {
    mbar_init(&q_full, 1);
    for (int i = 0; i < S; ++i) {
      mbar_init(&full[i], 1);               // the producer's expect_tx, then TMA's bytes
      mbar_init(&empty[i], two ? 8 : 4);    // one arrival per consumer warp
    }
    mbar_init_fence();
    mbar_expect_tx(&q_full, p.g * p.qt * Tile::kRowBytes);   // the Q box: g x qt rows
#pragma unroll
    for (int c = 0; c < F; ++c)
      tma_load_4d(tiles + c * R * 128, &maps.q, 64 * c, head0, qrow0, qb, &q_full);
    if constexpr (kTail)
      tma_load_4d(tiles + F * R * 128, &maps.q_tail, 64 * F, head0, qrow0, qb, &q_full);
  }
  __syncthreads();

  if (threadIdx.x >= 256) {                 // the producer
    regs_dec<40>();
    if (threadIdx.x == 256) {
      for (int i = 0; i < n; ++i) {
        const int st = i % S, key = krow0 + (t0 + i) * KT;
        unsigned char* const stage = tiles + Tile::kQBytes + st * Tile::kStageBytes;
        mbar_wait(&empty[st], ((i / S) & 1) ^ 1);
        mbar_expect_tx(&full[st], Tile::kStageBytes);
#pragma unroll
        for (int c = 0; c < F; ++c) {
          tma_load_5d(stage + c * KT * 128, &maps.k, 64 * c, key, kvh, kb, layer, &full[st]);
          tma_load_5d(stage + Tile::kKVBytes + c * KT * 128, &maps.v, 64 * c, key, kvh, kb, layer,
                      &full[st]);
        }
        if constexpr (kTail) {
          tma_load_5d(stage + F * KT * 128, &maps.k_tail, 64 * F, key, kvh, kb, layer, &full[st]);
          tma_load_5d(stage + Tile::kKVBytes + F * KT * 128, &maps.v_tail, 64 * F, key, kvh, kb,
                      layer, &full[st]);
        }
      }
    }
    return;
  }
  const int wg = threadIdx.x / 128;
  if (wg == 1 && !two) return;

  regs_inc<232>();
  const int warp = threadIdx.x / 32 % 4, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int ra = wg * 64 + warp * 16 + gid;     // the thread's two rows: ra, ra + 8
  int klim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) klim[h] = kCausal ? min(lim, qpos0 + (ra + 8 * h) / p.g + 1) : lim;
  const float sl2 = p.scale * kLog2e;
  float m[2] = {kNegInf, kNegInf};          // running max of the two rows (log2 units)
  float l[2] = {0.f, 0.f};                  // this thread's share of the running sums
  float acc[Tile::kDp / 2], sc[KT / 2], alpha[2];
  uint32_t pa[KT / 16][4];
#pragma unroll
  for (int i = 0; i < Tile::kDp / 2; ++i) acc[i] = 0.f;
  auto stage_at = [&](int i) { return tiles + Tile::kQBytes + (i % S) * Tile::kStageBytes; };
  // K1: a landed stage whose keys cross the cache's limit has its V rows
  // past it cleared (at most the walk's last tile), while its S = Q K^T
  // runs and before its P V
  auto clear_past_limit = [&](int i) {
    if constexpr (kCausal) {
      const int key0 = (t0 + i) * KT;
      if (key0 + KT > lim) wg_clear_v<F>(stage_at(i) + Tile::kKVBytes, max(lim - key0, 0), wg);
    }
  };
  const bool pp = two;                    // the warpgroups take turns at the tensor cores
  auto my_turn = [&] { if (pp) named_sync(1 + wg, 256); };
  auto your_turn = [&] { if (pp) named_arrive(2 - wg, 256); };
  if (pp && wg == 1) named_arrive(1, 256);      // the first warpgroup issues first
  mbar_wait(&q_full, 0);

  // Tile i's S = Q K^T runs on the tensor cores beside tile i - 1's O += P V:
  // its softmax waits for S alone, the rescale of O and the next P for both
  // (wgmma groups complete in order).
  mbar_wait(&full[0], 0);
  fence_acc(sc);
  my_turn();
  wgmma_fence();
  wg_scores<D, kTail>(sc, tiles, stage_at(0), wg);
  wgmma_commit();
  your_turn();
  clear_past_limit(0);
  wgmma_wait<0>();
  fence_acc(sc);
  wg_softmax(sc, t0 * KT, klim, tig, sl2, m, l, alpha);
  wg_pack_p(sc, pa);
  for (int i = 1; i < n; ++i) {
    mbar_wait(&full[i % S], (i / S) & 1);
    fence_acc(sc);
    fence_acc(acc);
    my_turn();
    wgmma_fence();
    wg_scores<D, kTail>(sc, tiles, stage_at(i), wg);
    wgmma_commit();
    wg_pv<D, kTail>(acc, pa, stage_at(i - 1));
    wgmma_commit();
    your_turn();
    clear_past_limit(i);
    wgmma_wait<1>();                        // S of tile i
    fence_acc(sc);
    wg_softmax(sc, (t0 + i) * KT, klim, tig, sl2, m, l, alpha);
    wgmma_wait<0>();                        // O += P V of tile i - 1
    fence_acc(acc);
    if (lane == 0) mbar_arrive(&empty[(i - 1) % S]);   // this warp is done with its stage
    if (alpha[0] != 1.f || alpha[1] != 1.f) {          // a row's max moved: rescale O
#pragma unroll
      for (int e = 0; e < Tile::kDp / 2; ++e) acc[e] *= alpha[(e >> 1) & 1];
    }
    wg_pack_p(sc, pa);
  }
  fence_acc(acc);
  my_turn();
  wgmma_fence();
  wg_pv<D, kTail>(acc, pa, stage_at(n - 1));
  wgmma_commit();
  if (wg == 0) your_turn();                 // the second's last turn needs no answer
  wgmma_wait<0>();
  fence_acc(acc);
  if (lane == 0) mbar_arrive(&empty[(n - 1) % S]);

#pragma unroll
  for (int h = 0; h < 2; ++h) {
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 1);
    l[h] += __shfl_xor_sync(0xffffffffu, l[h], 2);
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h;
    if (r >= rows) continue;
    if (part) {                             // a partial of K1's split: O, max and sum in fp32
      float* const prow = part + (long long)r * D + 2 * tig;
#pragma unroll
      for (int j = 0; j < D / 8; ++j)
        *reinterpret_cast<float2*>(prow + j * 8) = make_float2(acc[4 * j + 2 * h],
                                                               acc[4 * j + 2 * h + 1]);
      if (tig == 0) *reinterpret_cast<float2*>(part_ml + 2 * r) = make_float2(m[h], l[h]);
      continue;
    }
    const float safe = l[h] > 0.f ? l[h] : 1.f;
    __nv_bfloat16* const orow =
        ob + (long long)(r / p.g) * p.o_ss + (long long)(r % p.g) * p.o_sh + 2 * tig;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(orow + j * 8) =
          __floats2bfloat162_rn(acc[4 * j + 2 * h] / safe, acc[4 * j + 2 * h + 1] / safe);
  }
}

// K1's merge, grid (query tiles, Hk, B): for each row of a tile with two or
// more live splits, o = sum_s e^(m_s - M) acc_s / sum_s e^(m_s - M) l_s
// over the splits that saw a valid key of the row (l_s > 0), 0 where none
// did; a warp a row, a lane the column pairs 2 lane and 2 lane + 64.
template <int D>
__global__ void __launch_bounds__(256) prefill_merge_kernel(const WgAttnParams p) {
  const int t = blockIdx.x, kvh = blockIdx.y, b = blockIdx.z;
  const WgSpan sp = prefill_span(p, b, t);
  if (sp.live < 2) return;
  const int rows = min(p.qt, p.sq - t * p.qt) * p.g;
  const long long at = (((long long)b * p.hk + kvh) * p.tiles + t) * p.nsplit * kWgRows;
  const float2* const ml = reinterpret_cast<const float2*>(p.ws_ml + at * 2);
  __nv_bfloat16* const ob =
      p.o + b * p.o_sb + (long long)t * p.qt * p.o_ss + (long long)kvh * p.g * p.o_sh;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  for (int r = warp; r < rows; r += 8) {
    float big = kNegInf, den = 0.f;
    for (int s = 0; s < sp.live; ++s) {
      const float2 x = ml[s * kWgRows + r];
      if (x.y > 0.f) big = fmaxf(big, x.x);
    }
    float2 sum[2] = {make_float2(0.f, 0.f), make_float2(0.f, 0.f)};
    for (int s = 0; s < sp.live; ++s) {
      const float2 x = ml[s * kWgRows + r];
      if (!(x.y > 0.f)) continue;
      const float w = exp2f(x.x - big);
      den += w * x.y;
      const float* const a = p.ws + (at + (long long)s * kWgRows + r) * D + 2 * lane;
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        if (2 * lane + 64 * u >= D) continue;
        const float2 y = *reinterpret_cast<const float2*>(a + 64 * u);
        sum[u].x += w * y.x;
        sum[u].y += w * y.y;
      }
    }
    const float safe = den > 0.f ? den : 1.f;
    __nv_bfloat16* const orow =
        ob + (long long)(r / p.g) * p.o_ss + (long long)(r % p.g) * p.o_sh + 2 * lane;
#pragma unroll
    for (int u = 0; u < 2; ++u)
      if (2 * lane + 64 * u < D)
        *reinterpret_cast<__nv_bfloat162*>(orow + 64 * u) =
            __floats2bfloat162_rn(sum[u].x / safe, sum[u].y / safe);
  }
}

// A bf16 map of `rank` dimensions (innermost first: extents `dims`, element
// strides `strides` of dimensions 1..) read in boxes `box`: a 64-column box
// 128-byte swizzled, a 16-column one (a tail) 32-byte swizzled. A stride of 0
// (an expanded dimension of one entry) is given as 16 bytes, the least the
// driver takes. False where the driver refuses the map.
bool wg_map(CUtensorMap* map, const void* base, int rank, const long long* dims,
            const long long* strides, const int* box) {
  cuuint64_t gd[5], gs[4];
  cuuint32_t bx[5];
  for (int i = 0; i < rank; ++i) {
    gd[i] = (cuuint64_t)dims[i];
    bx[i] = (cuuint32_t)box[i];
  }
  for (int i = 0; i + 1 < rank; ++i) gs[i] = strides[i] ? (cuuint64_t)strides[i] * 2 : 16;
  return tensor_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, base, gd, gs, bx,
                    box[0] == 16 ? CU_TENSOR_MAP_SWIZZLE_32B : CU_TENSOR_MAP_SWIZZLE_128B);
}

// q's maps over q viewed [batch, rows, heads, D] (element strides sb, ss,
// sh): boxes of (64 columns, g heads, qt rows), and the tail's of 16 columns
bool wg_q_maps(WgMaps& maps, const void* q, int d, int heads, int rows, int batch,
               long long sh, long long ss, long long sb, int g, int qt, bool tail) {
  const long long dims[4] = {d, heads, rows, batch}, strides[3] = {sh, ss, sb};
  const int box[4] = {64, g, qt, 1}, box_tail[4] = {16, g, qt, 1};
  return wg_map(&maps.q, q, 4, dims, strides, box) &&
         (!tail || wg_map(&maps.q_tail, q, 4, dims, strides, box_tail));
}

// K's or V's map over x viewed [layers, batch, heads, rows, D] (element
// strides: sl, sb, sh, ss): boxes of (64 columns, 64 keys), and the tail's
bool wg_kv_map(CUtensorMap* map, CUtensorMap* tail, const void* x, int d, int rows, int heads,
               int batch, int layers, long long ss, long long sh, long long sb, long long sl) {
  const long long dims[5] = {d, rows, heads, batch, layers}, strides[4] = {ss, sh, sb, sl};
  const int box[5] = {64, kWgKeys, 1, 1, 1}, box_tail[5] = {16, kWgKeys, 1, 1, 1};
  return wg_map(map, x, 5, dims, strides, box) &&
         (tail == nullptr || wg_map(tail, x, 5, dims, strides, box_tail));
}

template <int D, bool kTail, bool kCausal>
int launch_wgmma_attention(const WgMaps& maps, const WgAttnParams& p, dim3 grid,
                           cudaStream_t stream) {
  const auto kernel = wgmma_attention_kernel<D, kTail, kCausal>;
  const size_t smem = WgTile<D, kTail>::kSmem;
  cudaError_t err =
      cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  kernel<<<grid, kWgThreads, smem, stream>>>(maps, p);
  return (int)cudaGetLastError();
}

// K1 over grid (tiles, Hk, B x nsplit), then its merge where nsplit > 1
template <int D>
int launch_prefill_wgmma(const WgMaps& maps, const WgAttnParams& p, int batch,
                         cudaStream_t stream) {
  int err = launch_wgmma_attention<D, false, true>(
      maps, p, dim3(p.tiles, p.hk, batch * p.nsplit), stream);
  if (err != 0 || p.nsplit == 1) return err;
  prefill_merge_kernel<D><<<dim3(p.tiles, p.hk, batch), 256, 0, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace

}  // namespace livecc
