// K2 flash_decode: one query token per row attends over the KV cache.
//
// Replaces: livecc_tpu/ops/pallas/attention.py:253 flash_decode
// (_decode_kernel), the Pallas TPU kernel of every decode step, for a
// bf16/fp32 cache (the int8 branch is flash_decode_int8.cu; both share
// decode_attention.cuh).
//
// Contract: q [B, Hq, 1, D] (strided), one layer of the cache
// k/v [B, Hk, Smax, D] (the wrapper passes the layer's base pointer of the
// stacked cache), kv_limit int32 [B] on the device (read in the kernel, no
// host sync): keys kpos < kv_limit[b] are valid. A row with no valid key
// outputs 0. `workspace` holds the split partials ((2 + D) * B * Hq * nsplit
// fp32, nsplit = ceil(Smax / kDecSplit)), allocated by the wrapper at each
// call; `counters` the B * Hk arrival counters, zero before and after.
// `kv_maps` (two CUtensorMap from livecc_decode_kv_map, or null) are K's and
// V's maps over the stacked cache, `layer` the layer's index into it: with
// them, bf16 q and rows of 128 or 256 bytes, the ring is filled by TMA;
// without, by cp.async.
//
// What bounds it on the H100: bytes (decode_attention.cuh): the valid cache
// (2 x kv x Hk x D x 2 bytes a layer) at ~4 G FLOP a byte, far below the
// card's ~295 FLOP/byte ridge, and at B = 1 launch latency. One launch: each
// split block of kDecSplit keys streams its K then V tiles through a ring fed
// by a producer warp (TMA boxes, or cp.async pieces where the rows do not
// suit TMA), Q.K^T and P.V run on mma.sync for bf16 (the FMA pipes for
// fp32), and the row's last split block merges the partials.

#include "decode_attention.cuh"

// K's or V's tensor map over the stacked cache [layers, batch, hk, smax, d]
// of `elem_bytes` elements (2: bf16, 1: int8; element strides: layer,
// batch, head, row), written into out[128 bytes]
extern "C" int livecc_decode_kv_map(const void* base, int layers, int batch, int hk, int smax,
                                    int d, const long long* strides, int elem_bytes, void* out) {
  CUtensorMap map;
  if (!livecc::decode_kv_map(&map, base, layers, batch, hk, smax, d, strides, elem_bytes))
    return (int)cudaErrorInvalidValue;
  std::memcpy(out, &map, sizeof map);
  return 0;
}

extern "C" int livecc_flash_decode(int dtype, const void* q, const void* k, const void* v,
                                   void* o, const int* kv_limit, int batch, int hq, int hk,
                                   int skv, int d, const long long* strides, float scale,
                                   void* workspace, int* counters, int nsplit,
                                   const void* kv_maps, int layer, void* stream) {
  livecc::DecodeParams p;
  if (!livecc::decode_params(p, q, k, v, nullptr, nullptr, o, kv_limit, batch, hq, hk, skv, d,
                             strides, scale, workspace, counters, nsplit, layer, false))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == livecc::kFloat32) return livecc::launch_decode<float, false>(p, kv_maps, s);
  if (dtype == livecc::kBFloat16)
    return livecc::launch_decode<__nv_bfloat16, false>(p, kv_maps, s);
  return (int)cudaErrorInvalidValue;
}
