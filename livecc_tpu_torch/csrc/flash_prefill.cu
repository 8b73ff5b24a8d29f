// K1 flash_prefill: a chunk of queries appended at a per-row cache offset
// attends causally over the static KV cache.
//
// Replaces: livecc_tpu/ops/pallas/attention.py:flash_prefill (_prefill_kernel),
// the Pallas TPU kernel of the streaming prefill, for a bf16/fp32 cache (the
// int8 branch is flash_prefill_int8.cu; both share tile_attention.cuh).
//
// Contract: q [B, Hq, Sq, D] (strided view), one layer of the cache
// k/v [B, Hk, Smax, D] (the wrapper passes the layer's base pointer of the
// stacked [L, B, Hk, Smax, D] cache, so nothing is sliced or copied),
// offset and kv_limit int32 [B] on the device, read inside the kernel (no
// host sync). Query i of row b sits at position offset[b] + i and attends
// keys kpos <= offset[b] + i with kpos < kv_limit[b]; head h reads KV head
// h // (Hq / Hk). A row with no valid key outputs 0.
//
// What bounds it on the H100: at the streaming shapes (Sq = 1024 bucket,
// Hq = 28, D = 128, ~1.5k keys) the work is ~2 x 2 x Sq x keys x D x Hq
// FLOPs per layer against a few MB of K/V, so it is compute-bound; this first
// version runs the products on the fp32 FMA pipes, not the tensor cores, and
// is far from the 989 TFLOP/s bf16 roof. Its design answers correctness and
// traffic: blocks past the causal/valid frontier are never loaded (the loop
// bound replaces the TPU index-map clamp), each K/V tile is read once per
// 64 queries, and scores never leave shared memory. wgmma tiles with a TMA
// ring are the later speed-up.

#include "tile_attention.cuh"

extern "C" int livecc_flash_prefill(int dtype, const void* q, const void* k, const void* v,
                                    void* o, const int* offset, const int* kv_limit,
                                    int batch, int hq, int hk, int sq, int skv, int d,
                                    const long long* strides, float scale, void* stream) {
  livecc::TileParams p;
  if (!livecc::prefill_params(p, q, k, v, nullptr, nullptr, o, offset, kv_limit, hq, hk, sq,
                              skv, d, strides, scale, false))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == livecc::kFloat32) return livecc::launch_tile_attention<float, true>(p, batch, s);
  if (dtype == livecc::kBFloat16)
    return livecc::launch_tile_attention<__nv_bfloat16, true>(p, batch, s);
  return (int)cudaErrorInvalidValue;
}
