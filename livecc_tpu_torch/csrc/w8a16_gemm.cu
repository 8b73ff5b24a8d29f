// K5 w8a16_gemm: a product with int8 weights and one scale per output column.
//
// Replaces: the int8 matmuls of the JAX package's serving configuration,
// livecc_tpu/ops/quant.py:dense (:64-68, `(x @ q.astype(x.dtype)) * scale`,
// every text-layer and ViT-block kernel and the merger's) and the quantized
// vocab product of livecc_tpu/models/qwen2_vl/text.py:lm_logits (:370-380).
// They are no Pallas kernel: XLA fuses the int8 -> bf16 convert into the
// matmul's operand read, so device memory sees only int8.
//
// Contract: out[M, N] = x[M, K] @ q[N, K]^T * scale[N]. x is bf16 (rows of
// stride ldx, unit inner stride) or fp32; q is int8, contiguous; scale is in
// x's dtype. Sums run in fp32 (the codes, +-127, are exact in bf16). The
// output in x's dtype takes the plain version's two roundings: the fp32 sum
// rounded to x's dtype, times the scale, rounded again. The fp32 output
// (lm_logits) is the fp32 sum times the scale, with no rounding between.
//
// What bounds it on the H100 (3.35 TB/s, 989 TFLOP/s bf16, so ~295
// operations a byte): a byte of codes carries 2 M operations. At decode (M
// <= 16: B = 1 and 8, a B = 1 verify window of 9) and at the B = 8 verify
// window (M = 72, 144 operations a byte) the weight's bytes: the 7B's
// gate_proj is 67.9 MB, 20 us. From M = 256 on (prefill, the ViT, the
// merger) the operations. The three forms:
//
//   * small (bf16, M <= 16): a split-K GEMV on the tensor cores. A block of
//     4 warps owns 128 output columns and one of `nsplit` ranges of K; each
//     warp owns 4 n8 tiles. Per 64-wide slab of K every thread loads 16 bytes
//     of each of its 4 weight rows (the 4 threads of a row group read 64
//     contiguous bytes, a whole row segment), widens them to bf16 in
//     registers (int8x4_to_bf16) and issues 4 mma.sync m16n8k16 with x as
//     the A operand: rows past M are zero, and the k order inside the slab
//     is permuted alike in A and B (a thread's 16 bytes are 16 consecutive
//     k), which a sum does not see. x is staged in shared memory by chunks
//     of 512 k. The splits fill the card where N alone would not (k_proj has
//     N = 512: 4 column blocks); each writes fp32 partials [nsplit, M, N],
//     and a second kernel sums them in split order, then rounds and scales.
//   * large (bf16, M > 16): wgmma with the operands swapped, out^T[N, M] =
//     q[N, K] x[M, K]^T. The weights are wgmma's A, 64 rows a consumer
//     warpgroup and 128 a block; the tokens are its n, a token tile of 80
//     or 256 (one m64nNk16 per 16 k), so the B = 8 window's 72 rows pad to
//     80, not to a 128-row tile. A block is three warpgroups: a producer
//     whose one thread keeps TMA loads of (x tile, int8 weight tile), 64 k
//     each, in flight through a ring of full and empty mbarriers (as many
//     stages as 227 KB hold: 12 or 5), at 40 registers (setmaxnreg), and
//     two consumers at 232. The x tile lands 128-byte swizzled, as wgmma's
//     K-major shared operand reads it (rows past M and columns past K are
//     zero-filled by TMA, so the main loop has no masks); the weight tile
//     lands 64-byte swizzled, and each consumer thread reads the codes of
//     its A fragment with conflict-free 32-bit loads (rows gid and gid + 8,
//     k 2 tig, +1, +8, +9 of each k16 step: two words and one byte
//     permute), widens them in registers (int8x4_to_bf16) and runs
//     wgmma with A from registers. The fragments are double-buffered by
//     stage: a stage's loads and widening run while the last stage's wgmma
//     group runs (wgmma.wait_group 1), and a stage goes back to the
//     producers once the group that read it is done. A transform pass
//     widening the tile into a swizzled bf16 tile (both operands from
//     shared memory) was not taken: it writes and rereads 16 KB of shared
//     memory a stage, where the register path reads 8 KB once.
//     Every token tile rereads the weights and every weight tile rereads x
//     from L2 (at M = 2048, 1184 blocks of 128 weight rows alone would read
//     2.2 GB of x), so blocks run in clusters of two weight tiles: each
//     producer loads half of the x tile and multicasts it to both blocks,
//     whose consumers release a stage to both producers; and the token
//     tile is 256 above 80 rows (ops/quant.py:large_plan). Timed block by
//     block with clock reads in a development build, the main loop then
//     keeps the tensor cores busy at a 256-token tile (a stage takes about
//     the SM cycles its wgmma need); at the windows' 80-token tile widening
//     and launching take longer than the wgmma. The rest is each block's
//     start, its epilogue and partial waves. The epilogue rounds
//     and scales each accumulator row (one output column; two tokens at a
//     time, packed) and stages the transposed tile in shared memory, so
//     every warp stores whole 16-byte runs along N. The cluster barrier
//     that keeps a block alive while its peer may still arrive on its
//     barriers is split: arrive after the main loop, wait after the stores.
//     Where the output tiles do not fill the card's 132 SMs (down_proj
//     and k_proj at M = 72, down_proj at M = 256), `nsplit` blocks share
//     one tile's K range in a fixed order: each writes fp32 partials
//     [nsplit, M, N] and the small form's merge sums them in split order.
//     The tensor maps are encoded on the host at each call
//     (cuTensorMapEncodeTiled, reached once through
//     cudaGetDriverEntryPointByVersion, so nothing links libcuda) and passed
//     by value as __grid_constant__ parameters, so a captured graph holds
//     them beside the addresses it was captured with.
//   * fp32 x (the tiny model's dtype): one thread per output, an FMA loop.
//
// No atomics: two launches give the same bits.

#include <cstdint>

#include "hopper_common.cuh"

namespace livecc {

constexpr int kW8SmallRows = 16;            // M of the small form: one m16 tile
constexpr int kW8SmallWarps = 4;
constexpr int kW8SmallNt = 4;               // n8 tiles per warp
constexpr int kW8SmallBlockN = kW8SmallWarps * kW8SmallNt * 8;   // 128 columns a block
constexpr int kW8Kt = 64;                   // k per slab (small) or stage (large)
constexpr int kW8XChunk = 512;              // k of x staged per pass (small)
constexpr int kW8FmaThreads = 128;

// The large form: 128 weight rows a block (two consumer warpgroups of 64),
// a producer warpgroup, and per stage an x tile of NT rows of 64 bf16 (128
// bytes, 128-byte swizzle) then a weight tile of 128 rows of 64 codes (64
// bytes, 64-byte swizzle); the ring is aligned to 1024 bytes by hand.
constexpr int kW8Rows = 128;
constexpr int kW8Cluster = 2;               // weight tiles sharing one x tile
constexpr int kW8Threads = 384;
constexpr int kW8QTileBytes = kW8Rows * kW8Kt;
constexpr int kW8SmemLimit = 232448 - 1024 - 256;   // 227 KB less alignment and barriers
constexpr int kW8MaxStages = 12;
constexpr int kW8StageLd = kW8Rows + 4;     // epilogue: fp32 row of the transposed tile
constexpr int kW8StageLdH = kW8Rows + 8;    // and a bf16 one

template <int NT>
struct W8Tile {
  static_assert(NT % (8 * kW8Cluster) == 0 && NT <= 256, "a wgmma n, split in whole 8-row groups");
  static constexpr int kXBytes = NT * kW8Kt * 2;
  static constexpr int kStageBytes = kXBytes + kW8QTileBytes;
  static constexpr int kStages = kW8SmemLimit / kStageBytes < kW8MaxStages
                                     ? kW8SmemLimit / kStageBytes : kW8MaxStages;
  static constexpr int kSmem = kStages * kStageBytes + 1024;
  static_assert(NT * kW8StageLd * 4 <= kStages * kStageBytes, "the epilogue fits the ring");
};

struct W8Params {
  const void* x;
  long long ldx;                            // x row stride, elements
  const int8_t* q;                          // [N, K]
  const void* scale;                        // [N], x's dtype
  void* out;                                // [M, N]
  float* partial;                           // [nsplit, M, N] (small form; a split large form)
  int m, n, k, split_k, nsplit;
  bool out_fp32;
};

namespace {

template <typename T>
__device__ __forceinline__ float scale_at(const W8Params& p, int n) {
  return to_f(static_cast<const T*>(p.scale)[n]);
}

// One output from its fp32 sum: fp32 out is sum * scale; an output in x's
// dtype rounds the sum to it, multiplies by the scale and rounds again.
template <typename T>
__device__ __forceinline__ void store_out(const W8Params& p, int m, int n, float sum) {
  const long long i = (long long)m * p.n + n;
  const float sc = scale_at<T>(p, n);
  if (std::is_same<T, float>::value || p.out_fp32) {
    static_cast<float*>(p.out)[i] = sum * sc;
  } else {
    const float r = __bfloat162float(__float2bfloat16(sum));
    static_cast<__nv_bfloat16*>(p.out)[i] = __float2bfloat16(r * sc);
  }
}

// 16 int8 codes -> 8 words of bf16 pairs (word j: codes 2j, 2j + 1)
__device__ __forceinline__ void widen16(const uint4& w, uint32_t (&b)[8]) {
  int8x4_to_bf16(w.x, b[0], b[1]);
  int8x4_to_bf16(w.y, b[2], b[3]);
  int8x4_to_bf16(w.z, b[4], b[5]);
  int8x4_to_bf16(w.w, b[6], b[7]);
}

template <bool kTwoRows>
__global__ void __launch_bounds__(kW8SmallWarps * 32) w8_small_kernel(W8Params p) {
  __shared__ __align__(16) __nv_bfloat16 sx[kW8SmallRows][kW8XChunk + kMmaPad];
  constexpr int kThreads = kW8SmallWarps * 32;
  constexpr int kChunks = kW8XChunk / 8;    // 16-byte pieces of a staged x row
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int n_warp = blockIdx.x * kW8SmallBlockN + warp * kW8SmallNt * 8;
  const int k_begin = blockIdx.y * p.split_k;
  const int k_end = min(p.k, k_begin + p.split_k);
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  float acc[kW8SmallNt][4];
#pragma unroll
  for (int t = 0; t < kW8SmallNt; ++t) acc[t][0] = acc[t][1] = acc[t][2] = acc[t][3] = 0.f;

  for (int kc = k_begin; kc < k_end; kc += kW8XChunk) {
    const int kc_end = min(k_end, kc + kW8XChunk);
    __syncthreads();                        // the last chunk's readers are done
    for (int c = threadIdx.x; c < kW8SmallRows * kChunks; c += kThreads) {
      const int r = c / kChunks, col = (c % kChunks) * 8;
      const bool ok = r < p.m && kc + col < kc_end;
      cp_async16(&sx[r][col], ok ? x + r * p.ldx + kc + col : x, ok);
    }
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    for (int k0 = kc; k0 < kc_end; k0 += kW8Kt) {
      const int kq = k0 + 16 * tig;         // this thread's 16 consecutive k
      uint4 w[kW8SmallNt];
#pragma unroll
      for (int t = 0; t < kW8SmallNt; ++t) {
        const int row = n_warp + t * 8 + gid;
        w[t] = make_uint4(0u, 0u, 0u, 0u);
        if (row < p.n && kq < kc_end)
          w[t] = __ldg(reinterpret_cast<const uint4*>(p.q + (long long)row * p.k + kq));
      }
      const int xc = kq - kc;
      const uint4 xa0 = *reinterpret_cast<const uint4*>(&sx[gid][xc]);
      const uint4 xa1 = *reinterpret_cast<const uint4*>(&sx[gid][xc + 8]);
      const uint32_t xa[8] = {xa0.x, xa0.y, xa0.z, xa0.w, xa1.x, xa1.y, xa1.z, xa1.w};
      uint32_t xb[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
      if (kTwoRows) {
        const uint4 xb0 = *reinterpret_cast<const uint4*>(&sx[gid + 8][xc]);
        const uint4 xb1 = *reinterpret_cast<const uint4*>(&sx[gid + 8][xc + 8]);
        xb[0] = xb0.x, xb[1] = xb0.y, xb[2] = xb0.z, xb[3] = xb0.w;
        xb[4] = xb1.x, xb[5] = xb1.y, xb[6] = xb1.z, xb[7] = xb1.w;
      }
#pragma unroll
      for (int t = 0; t < kW8SmallNt; ++t) {
        uint32_t b[8];
        widen16(w[t], b);
        // k16 step s: fragment positions 2 tig, +1, +8, +9 hold this thread's
        // k 4s .. 4s + 3, in A (x rows gid, gid + 8) and B (weight row gid) alike
#pragma unroll
        for (int s = 0; s < 4; ++s) {
          const uint32_t a[4] = {xa[2 * s], xb[2 * s], xa[2 * s + 1], xb[2 * s + 1]};
          mma_bf16(acc[t], a, b[2 * s], b[2 * s + 1]);
        }
      }
    }
  }
  float* part = p.partial + (long long)blockIdx.y * p.m * p.n;
#pragma unroll
  for (int t = 0; t < kW8SmallNt; ++t) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = gid + 8 * r;
      if (row >= p.m) continue;
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = n_warp + t * 8 + 2 * tig + c;
        if (col < p.n) part[(long long)row * p.n + col] = acc[t][2 * r + c];
      }
    }
  }
}

// The small form's second pass: the splits' partials summed in split order.
template <typename T>
__global__ void w8_merge_kernel(W8Params p) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long mn = (long long)p.m * p.n;
  if (i >= mn) return;
  float sum = 0.f;
  for (int s = 0; s < p.nsplit; ++s) sum += p.partial[s * mn + i];
  store_out<T>(p, (int)(i / p.n), (int)(i % p.n), sum);
}

template <int NT>
__device__ __forceinline__ void wgmma_rs(float (&d)[NT / 2], const uint32_t (&a)[4], uint64_t b) {
  if constexpr (NT == 80) wgmma_rs_n80(d, a, b);
  else wgmma_rs_n256(d, a, b);
}

// This thread's A fragments of a stage's four k16 steps, widened to bf16:
// weight rows r0 and r0 + 8 of the tile (64 codes a row in the 64-byte
// swizzle: 16-byte chunk c of row r sits at chunk c ^ ((r >> 1) & 3)), k
// 2 tig, +1 and 2 tig + 8, +9 of each step. Word tig / 2 of each half of a
// chunk holds the pairs of tig and its neighbour; one byte permute keeps
// this thread's two pairs. a[s] = {row r0 k 2 tig.., row r0 + 8 k 2 tig..,
// row r0 k 2 tig + 8.., row r0 + 8 k 2 tig + 8..}, mma's m16k16 A layout.
__device__ __forceinline__ void load_a(uint32_t (&a)[4][4], const int8_t* sq, int r0, int tig) {
  const int swz = (r0 >> 1) & 3;            // the same for row r0 + 8
  const uint32_t sel = (tig & 1) ? 0x7632u : 0x5410u;
  const int off = 4 * (tig >> 1);
#pragma unroll
  for (int s = 0; s < 4; ++s) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int8_t* at = sq + (r0 + 8 * h) * kW8Kt + 16 * (s ^ swz) + off;
      const uint32_t lo = *reinterpret_cast<const uint32_t*>(at);
      const uint32_t hi = *reinterpret_cast<const uint32_t*>(at + 8);
      int8x4_to_bf16(__byte_perm(lo, hi, sel), a[s][h], a[s][2 + h]);
    }
  }
}

// One stage of a consumer warpgroup: wait for it, widen its codes into
// fragment buffer B, launch its four wgmma as one group, then wait for the
// previous group (the other buffer) and hand that group's stage back.
template <int NT, int B>
__device__ __forceinline__ void w8_stage(float (&acc)[NT / 2], uint32_t (&a)[2][4][4],
                                         unsigned char* ring, uint64_t* full, uint64_t* empty,
                                         int t, int r0, int lane, uint32_t peer) {
  using Tile = W8Tile<NT>;
  const int s = t % Tile::kStages;
  unsigned char* stage = ring + s * Tile::kStageBytes;
  mbar_wait(&full[s], (t / Tile::kStages) & 1);
  load_a(a[B], reinterpret_cast<const int8_t*>(stage + Tile::kXBytes), r0, lane % 4);
  const uint64_t desc = sw128_desc(stage);
  fence_acc(acc);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kW8Kt / 16; ++kk)
    wgmma_rs<NT>(acc, a[B][kk], desc + 2 * kk);   // 16 k = 32 bytes further along the rows
  wgmma_commit();
  fence_acc(acc);
  wgmma_wait<1>();
  if (t > 0 && lane == 0) {                 // the stage goes back to both blocks' producers
    mbar_arrive(&empty[(t - 1) % Tile::kStages]);
    mbar_arrive_at(&empty[(t - 1) % Tile::kStages], peer);
  }
}

// Block (token tile x, 128-row weight tile y, split z), in clusters of two
// weight tiles: each block's producer loads half of the shared x tile and
// multicasts it to both, so x is read from L2 once per 256 weight rows.
// Threads 0-255: the two consumer warpgroups (weight rows 0-63, 64-127);
// 256-383: the producer.
template <int NT>
__global__ void __cluster_dims__(1, kW8Cluster, 1) __launch_bounds__(kW8Threads, 1)
    w8_wgmma_kernel(const __grid_constant__ CUtensorMap xmap,
                    const __grid_constant__ CUtensorMap qmap, W8Params p) {
  using Tile = W8Tile<NT>;
  constexpr int S = Tile::kStages;
  __shared__ __align__(8) uint64_t full[S], empty[S];
  extern __shared__ unsigned char w8_dyn[];
  unsigned char* ring = w8_dyn + ((1024 - (smem_addr(w8_dyn) & 1023)) & 1023);
  const int m0 = blockIdx.x * NT, n0 = blockIdx.y * kW8Rows, k0 = blockIdx.z * p.split_k;
  const int tiles = (min(p.k, k0 + p.split_k) - k0 + kW8Kt - 1) / kW8Kt;
  const int wg = threadIdx.x / 128;
  if (threadIdx.x == 0) {
    for (int s = 0; s < S; ++s) {
      mbar_init(&full[s], 1);               // the producer's expect_tx, then TMA's bytes
      mbar_init(&empty[s], 8 * kW8Cluster);  // one arrival per consumer warp of the cluster
    }
    mbar_init_fence();
  }
  cluster_arrive();                         // the peer's barriers exist before any copy
  cluster_wait();
  const uint32_t rank = cluster_rank(), peer = rank ^ 1;

  if (wg == 2) {
    regs_dec<40>();
    if (threadIdx.x == 256) {
      for (int t = 0; t < tiles; ++t) {
        const int s = t % S;
        unsigned char* stage = ring + s * Tile::kStageBytes;
        mbar_wait(&empty[s], ((t / S) & 1) ^ 1);
        mbar_expect_tx(&full[s], Tile::kStageBytes);
        tma_load_multicast(stage + rank * (Tile::kXBytes / 2), &xmap, k0 + t * kW8Kt,
                           m0 + rank * (NT / 2), &full[s], (1 << kW8Cluster) - 1);
        tma_load(stage + Tile::kXBytes, &qmap, k0 + t * kW8Kt, n0, &full[s]);
      }
    }
    return;
  }
  regs_inc<232>();
  const int lane = threadIdx.x % 32, gid = lane / 4, tig = lane % 4;
  const int r0 = wg * 64 + (threadIdx.x / 32 % 4) * 16 + gid;   // rows r0, r0 + 8 of the tile
  // the scales of rows r0 and r0 + 8, loaded while the main loop runs (1
  // for partials: the merge scales)
  const bool split = p.nsplit > 1;
  float sc[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int n = n0 + r0 + 8 * h;
    sc[h] = !split && n < p.n ? scale_at<__nv_bfloat16>(p, n) : 1.f;
  }
  float acc[NT / 2];
#pragma unroll
  for (int i = 0; i < NT / 2; ++i) acc[i] = 0.f;
  // stages in pairs, so that on every path into a stage the group still in
  // flight is the other buffer's (ptxas serializes the wgmma's otherwise)
  uint32_t a[2][4][4];
  int t = 0;
  for (; t + 1 < tiles; t += 2) {
    w8_stage<NT, 0>(acc, a, ring, full, empty, t, r0, lane, peer);
    w8_stage<NT, 1>(acc, a, ring, full, empty, t + 1, r0, lane, peer);
  }
  if (t < tiles) w8_stage<NT, 0>(acc, a, ring, full, empty, t, r0, lane, peer);
  wgmma_wait<0>();
  fence_acc(acc);
  // this block's last arrival on its peer's barriers is behind it; it waits
  // for the peer's at its end (no block leaves while its peer may arrive)
  cluster_arrive();

  // Epilogue: the tile transposed into [NT tokens][128 columns] over the
  // ring (both consumers done with it first), then 16-byte runs along N.
  // acc[4 j + 2 h + c] is weight row r0 + 8 h, token 8 j + 2 tig + c.
  asm volatile("bar.sync 1, 256;\n" ::: "memory");
  const int rows = min(NT, p.m - m0), cols = min(kW8Rows, p.n - n0);
  if (split || p.out_fp32) {                // fp32: partials, or sums times the scale
    float* st = reinterpret_cast<float*>(ring);
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          st[(8 * j + 2 * tig + c) * kW8StageLd + r0 + 8 * h] = acc[4 * j + 2 * h + c] * sc[h];
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    float* dst = split ? p.partial + (long long)blockIdx.z * p.m * p.n
                       : static_cast<float*>(p.out);
    for (int i = threadIdx.x; i < rows * 32; i += 256) {   // 32 runs of 4 a row
      const int r = i / 32, c = i % 32 * 4;
      if (c >= cols) continue;
      const float* src = st + r * kW8StageLd + c;
      float* d = dst + (long long)(m0 + r) * p.n + n0 + c;
      if (c + 4 <= cols && p.n % 4 == 0)
        *reinterpret_cast<float4*>(d) = *reinterpret_cast<const float4*>(src);
      else
        for (int e = 0; e < 4 && c + e < cols; ++e) d[e] = src[e];
    }
  } else {                                  // bf16: the two roundings, two tokens at once
    __nv_bfloat16* st = reinterpret_cast<__nv_bfloat16*>(ring);
#pragma unroll
    for (int j = 0; j < NT / 8; ++j)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float2 r = __bfloat1622float2(
            __floats2bfloat162_rn(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]));
        const __nv_bfloat162 o = __floats2bfloat162_rn(r.x * sc[h], r.y * sc[h]);
        st[(8 * j + 2 * tig) * kW8StageLdH + r0 + 8 * h] = o.x;
        st[(8 * j + 2 * tig + 1) * kW8StageLdH + r0 + 8 * h] = o.y;
      }
    asm volatile("bar.sync 1, 256;\n" ::: "memory");
    __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.out);
    for (int i = threadIdx.x; i < rows * 16; i += 256) {   // 16 runs of 8 a row
      const int r = i / 16, c = i % 16 * 8;
      if (c >= cols) continue;
      const __nv_bfloat16* src = st + r * kW8StageLdH + c;
      __nv_bfloat16* d = dst + (long long)(m0 + r) * p.n + n0 + c;
      if (c + 8 <= cols && p.n % 8 == 0)
        *reinterpret_cast<uint4*>(d) = *reinterpret_cast<const uint4*>(src);
      else
        for (int e = 0; e < 8 && c + e < cols; ++e) d[e] = src[e];
    }
  }
  cluster_wait();
}

__global__ void __launch_bounds__(kW8FmaThreads) w8_fma_kernel(W8Params p) {
  const int n = blockIdx.x * kW8FmaThreads + threadIdx.x, m = blockIdx.y;
  if (n >= p.n) return;
  const float* xr = static_cast<const float*>(p.x) + m * p.ldx;
  const int8_t* qr = p.q + (long long)n * p.k;
  float sum = 0.f;
  for (int k = 0; k < p.k; ++k) sum = fmaf(xr[k], static_cast<float>(qr[k]), sum);
  store_out<float>(p, m, n, sum);
}

// A 2-d tensor map over `rows` rows of `inner` elements (row stride
// `ld_bytes`), boxes of box_inner x box_rows; out-of-range elements read 0.
bool w8_map(CUtensorMap* map, CUtensorMapDataType type, const void* base, uint64_t inner,
            uint64_t rows, uint64_t ld_bytes, uint32_t box_inner, uint32_t box_rows,
            CUtensorMapSwizzle swizzle) {
  const cuuint64_t dims[2] = {inner, rows}, strides[1] = {ld_bytes};
  const cuuint32_t box[2] = {box_inner, box_rows};
  return tensor_map(map, type, 2, base, dims, strides, box, swizzle);
}

// The splits' partials summed in split order, rounded and scaled.
int w8_merge(const W8Params& p, cudaStream_t s) {
  const long long mn = (long long)p.m * p.n;
  w8_merge_kernel<__nv_bfloat16><<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(p);
  return (int)cudaGetLastError();
}

template <int NT>
int w8_large(const W8Params& p, cudaStream_t s) {
  using Tile = W8Tile<NT>;
  CUtensorMap xmap, qmap;
  if (!w8_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.x, p.k, p.m, p.ldx * 2, kW8Kt,
              NT / kW8Cluster, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !w8_map(&qmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, p.q, p.k, p.n, p.k, kW8Kt, kW8Rows,
              CU_TENSOR_MAP_SWIZZLE_64B))
    return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(w8_wgmma_kernel<NT>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, Tile::kSmem);
  if (err != cudaSuccess) return (int)err;
  const int tiles = (p.n + kW8Rows - 1) / kW8Rows;     // rounded up to whole clusters
  const dim3 grid((p.m + NT - 1) / NT, (tiles + kW8Cluster - 1) / kW8Cluster * kW8Cluster,
                  p.nsplit);
  w8_wgmma_kernel<NT><<<grid, kW8Threads, Tile::kSmem, s>>>(xmap, qmap, p);
  err = cudaGetLastError();
  return err != cudaSuccess || p.nsplit == 1 ? (int)err : w8_merge(p, s);
}

}  // namespace

}  // namespace livecc

// dtype: x's (livecc::DType). bf16 runs over `nsplit` ranges of `split_k`
// (a multiple of 64) of K: token_tile 0 is the small form (M <= 16; fp32
// partials [nsplit, M, N] from the caller, then the merge), 80 or 256 the
// large form's token tile (partials needed when nsplit > 1). fp32 x
// takes the FMA form, which ignores the plan. Refused (an error, nothing
// launched): bf16 x with K not a multiple of 16, x's row stride not a
// multiple of 8, or x or q not 16-byte aligned; a plan whose splits do not
// cover K, a missing partial, a small form past 16 rows, another token tile.
extern "C" int livecc_w8a16_gemm(int dtype, int out_fp32, const void* x, long long ldx,
                                 const void* q, const void* scale, void* out, void* partial,
                                 int m, int n, int k, int token_tile, int split_k, int nsplit,
                                 void* stream) {
  using namespace livecc;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  W8Params p{x, ldx, static_cast<const int8_t*>(q), scale, out, static_cast<float*>(partial),
             m, n, k, split_k, nsplit, out_fp32 != 0};
  if (m <= 0 || n <= 0 || k <= 0 || ldx < k) return (int)cudaErrorInvalidValue;
  if (dtype == kFloat32) {
    w8_fma_kernel<<<dim3((n + kW8FmaThreads - 1) / kW8FmaThreads, m), kW8FmaThreads, 0, s>>>(p);
    return (int)cudaGetLastError();
  }
  if (dtype != kBFloat16 || k % 16 || ldx % 8 || reinterpret_cast<uintptr_t>(x) % 16 ||
      reinterpret_cast<uintptr_t>(q) % 16)
    return (int)cudaErrorInvalidValue;
  if (nsplit <= 0 || split_k <= 0 || split_k % kW8Kt || (long long)(nsplit - 1) * split_k >= k ||
      (long long)nsplit * split_k < k || (partial == nullptr && (nsplit > 1 || token_tile == 0)))
    return (int)cudaErrorInvalidValue;
  switch (token_tile) {
    case 0: {
      if (m > kW8SmallRows) return (int)cudaErrorInvalidValue;
      const dim3 grid((n + kW8SmallBlockN - 1) / kW8SmallBlockN, nsplit);
      if (m > 8)
        w8_small_kernel<true><<<grid, kW8SmallWarps * 32, 0, s>>>(p);
      else
        w8_small_kernel<false><<<grid, kW8SmallWarps * 32, 0, s>>>(p);
      cudaError_t err = cudaGetLastError();
      return err != cudaSuccess ? (int)err : w8_merge(p, s);
    }
    case 80: return w8_large<80>(p, s);
    case 256: return w8_large<256>(p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
