// K5 w8a16_gemm: a product with int8 weights and one scale per output column.
//
// Replaces: the int8 matmuls of the JAX package's serving configuration,
// livecc_tpu/ops/quant.py:dense (:61-65, `(x @ q.astype(x.dtype)) * scale`,
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
// What bounds it on the H100: at decode (M <= 16 rows: B = 1 and 8, a B = 1
// verify window of 9) the weight's bytes, N * K int8 against ~2 M N K
// operations; the 7B's gate_proj is 67.9 MB, 20 us at 3.35 TB/s. At prefill
// and in the ViT (M of 256 to 10560) the operations. The three forms:
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
//   * large (bf16, M > 16): 128 x 128 output tiles, 8 warps of 64 x 32, K in
//     64-wide tiles through a ring of kW8Stages cp.async stages holding the
//     x tile (bf16, padded rows) and the int8 weight tile; each tile of
//     weights is widened to bf16 in shared memory once (as K1-int8 widens
//     its K/V tiles), then ldmatrix feeds mma.sync; the epilogue rounds and
//     scales from the fp32 accumulators.
//   * fp32 x (the tiny model's dtype): one thread per output, an FMA loop.
//
// No atomics: two launches give the same bits. wgmma fed by TMA (a
// mixed-input product with a producer warp) is later work.

#include <cstdint>

#include "mma_common.cuh"

namespace livecc {

constexpr int kW8SmallRows = 16;            // M of the small form: one m16 tile
constexpr int kW8SmallWarps = 4;
constexpr int kW8SmallNt = 4;               // n8 tiles per warp
constexpr int kW8SmallBlockN = kW8SmallWarps * kW8SmallNt * 8;   // 128 columns a block
constexpr int kW8Kt = 64;                   // k per slab (small) or tile (large)
constexpr int kW8XChunk = 512;              // k of x staged per pass (small)
constexpr int kW8LargeM = 128, kW8LargeN = 128;
constexpr int kW8LargeThreads = 256;        // 8 warps: 2 (M) x 4 (N) of 64 x 32
constexpr int kW8Stages = 3;                // cp.async ring (large)
constexpr int kW8FmaThreads = 128;

struct W8Params {
  const void* x;
  long long ldx;                            // x row stride, elements
  const int8_t* q;                          // [N, K]
  const void* scale;                        // [N], x's dtype
  void* out;                                // [M, N]
  float* partial;                           // [nsplit, M, N] (small form)
  int m, n, k, split_k, nsplit;
  bool out_fp32;
};

// The large form's shared memory: the widened weight tile, then the ring's
// stages of (x tile, int8 weight tile).
constexpr int kW8Ld = kW8Kt + kMmaPad;      // padded bf16 row
constexpr int kW8XTileBytes = kW8LargeM * kW8Ld * 2;
constexpr int kW8QTileBytes = kW8LargeN * kW8Kt;
constexpr int kW8StageBytes = kW8XTileBytes + kW8QTileBytes;
constexpr int kW8LargeSmem = kW8LargeN * kW8Ld * 2 + kW8Stages * kW8StageBytes;   // 96 KB

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

__global__ void __launch_bounds__(kW8LargeThreads, 2) w8_large_kernel(W8Params p) {
  extern __shared__ __align__(16) unsigned char w8_smem[];
  __nv_bfloat16* sW = reinterpret_cast<__nv_bfloat16*>(w8_smem);     // widened [128][kW8Ld]
  unsigned char* ring = w8_smem + kW8LargeN * kW8Ld * 2;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gid = lane / 4, tig = lane % 4;
  const int wm = warp / 4, wn = warp % 4;   // the warp's 64 rows and 32 columns
  const int m0 = blockIdx.y * kW8LargeM, n0 = blockIdx.x * kW8LargeN;
  const int tiles = (p.k + kW8Kt - 1) / kW8Kt;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);

  // tile t of x (128 rows of 64 bf16) and of the weights (128 rows of 64
  // int8) into `stage`; rows past M or N and columns past K zero-filled
  auto load = [&](int t, int stage) {
    __nv_bfloat16* sx = reinterpret_cast<__nv_bfloat16*>(ring + stage * kW8StageBytes);
    int8_t* sq = reinterpret_cast<int8_t*>(ring + stage * kW8StageBytes + kW8XTileBytes);
    const int kt = t * kW8Kt;
    for (int c = tid; c < kW8LargeM * (kW8Kt / 8); c += kW8LargeThreads) {
      const int r = c / (kW8Kt / 8), col = (c % (kW8Kt / 8)) * 8;
      const bool ok = m0 + r < p.m && kt + col < p.k;
      cp_async16(sx + r * kW8Ld + col, ok ? x + (m0 + r) * p.ldx + kt + col : x, ok);
    }
    for (int c = tid; c < kW8LargeN * (kW8Kt / 16); c += kW8LargeThreads) {
      const int r = c / (kW8Kt / 16), col = (c % (kW8Kt / 16)) * 16;
      const bool ok = n0 + r < p.n && kt + col < p.k;
      cp_async16(sq + c * 16, ok ? p.q + (long long)(n0 + r) * p.k + kt + col : p.q, ok);
    }
  };

#pragma unroll
  for (int t = 0; t < kW8Stages - 1; ++t) {
    if (t < tiles) load(t, t);
    cp_async_commit();
  }
  float acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j][0] = acc[i][j][1] = acc[i][j][2] = acc[i][j][3] = 0.f;

  for (int t = 0; t < tiles; ++t) {
    const int stage = t % kW8Stages;
    cp_async_wait<kW8Stages - 2>();
    __syncthreads();                        // tile t is in; every warp is done with tile t - 1
    const int8_t* sq = reinterpret_cast<const int8_t*>(ring + stage * kW8StageBytes +
                                                        kW8XTileBytes);
    for (int c = tid; c < kW8LargeN * (kW8Kt / 16); c += kW8LargeThreads) {
      uint32_t b[8];
      widen16(reinterpret_cast<const uint4*>(sq)[c], b);
      uint4* dst = reinterpret_cast<uint4*>(sW + (c / (kW8Kt / 16)) * kW8Ld + (c % (kW8Kt / 16)) * 16);
      dst[0] = make_uint4(b[0], b[1], b[2], b[3]);
      dst[1] = make_uint4(b[4], b[5], b[6], b[7]);
    }
    // the refill goes to the stage tile t - 1 used
    if (t + kW8Stages - 1 < tiles) load(t + kW8Stages - 1, (t + kW8Stages - 1) % kW8Stages);
    cp_async_commit();
    __syncthreads();                        // the widened tile is in
    const __nv_bfloat16* sx = reinterpret_cast<const __nv_bfloat16*>(ring + stage * kW8StageBytes);
#pragma unroll
    for (int kk = 0; kk < kW8Kt / 16; ++kk) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(a[mt], sx + (wm * 64 + mt * 16 + lane % 16) * kW8Ld + kk * 16 + (lane / 16) * 8);
#pragma unroll
      for (int j = 0; j < 4; j += 2) {
        uint32_t b[4];
        ldmatrix_x4(b, sW + (wn * 32 + j * 8 + lane % 8 + (lane / 16) * 8) * kW8Ld + kk * 16 +
                           ((lane / 8) % 2) * 8);
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_bf16(acc[mt][j], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][j + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();
#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + wm * 64 + mt * 16 + gid + 8 * r;
        if (row >= p.m) continue;
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const int col = n0 + wn * 32 + j * 8 + 2 * tig + c;
          if (col < p.n) store_out<__nv_bfloat16>(p, row, col, acc[mt][j][2 * r + c]);
        }
      }
    }
  }
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

}  // namespace

}  // namespace livecc

// dtype: x's (livecc::DType). nsplit > 0 runs bf16's small form (M <= 16)
// over `nsplit` ranges of `split_k` (a multiple of 64) with `partial`
// ([nsplit, M, N] fp32, from the caller), nsplit == 0 the large form.
// Refused (an error, nothing launched): bf16 x with K not a multiple of 16,
// x's row stride not a multiple of 8, or x or q not 16-byte aligned; a small
// form whose M, split or partial does not fit.
extern "C" int livecc_w8a16_gemm(int dtype, int out_fp32, const void* x, long long ldx,
                                 const void* q, const void* scale, void* out, void* partial,
                                 int m, int n, int k, int split_k, int nsplit, void* stream) {
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
  if (nsplit > 0) {
    if (m > kW8SmallRows || partial == nullptr || split_k <= 0 || split_k % kW8Kt ||
        (long long)(nsplit - 1) * split_k >= k || (long long)nsplit * split_k < k)
      return (int)cudaErrorInvalidValue;
    const dim3 grid((n + kW8SmallBlockN - 1) / kW8SmallBlockN, nsplit);
    if (m > 8)
      w8_small_kernel<true><<<grid, kW8SmallWarps * 32, 0, s>>>(p);
    else
      w8_small_kernel<false><<<grid, kW8SmallWarps * 32, 0, s>>>(p);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    const long long mn = (long long)m * n;
    w8_merge_kernel<__nv_bfloat16><<<(unsigned)((mn + 255) / 256), 256, 0, s>>>(p);
    return (int)cudaGetLastError();
  }
  cudaError_t err = cudaFuncSetAttribute(w8_large_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kW8LargeSmem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((n + kW8LargeN - 1) / kW8LargeN, (m + kW8LargeM - 1) / kW8LargeM);
  w8_large_kernel<<<grid, kW8LargeThreads, kW8LargeSmem, s>>>(p);
  return (int)cudaGetLastError();
}
