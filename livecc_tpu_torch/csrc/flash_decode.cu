// K2 flash_decode: one query token per row attends over the KV cache.
//
// Replaces: livecc_tpu/ops/pallas/attention.py:flash_decode (_decode_kernel),
// the Pallas TPU kernel of every decode step, for a bf16/fp32 cache (the int8
// branch is flash_decode_int8.cu; both share decode_attention.cuh).
//
// Contract: q [B, Hq, 1, D] (strided), one layer of the cache
// k/v [B, Hk, Smax, D] (the wrapper passes the layer's base pointer of the
// stacked cache), kv_limit int32 [B] on the device (read in the kernels, no
// host sync): keys kpos < kv_limit[b] are valid. A row with no valid key
// outputs 0. `workspace` holds the split partials ((2 + D) * B * Hq * nsplit
// fp32, nsplit = ceil(Smax / kDecSplit), kDecSplit = 64 keys), allocated by
// the wrapper.
//
// What bounds it on the H100: decode attention reads the whole valid cache
// (2 x kv x Hk x D x 2 bytes per layer) for ~4 x G FLOPs per byte, far
// below the card's ~295 FLOP/byte ridge, so it is bound by memory traffic,
// and at B = 1 by launch latency. The split-KV design spreads each row's
// keys over Hk x ceil(kv / 64) blocks (52 at B = 1, kv 777)
// instead of Hk, reads each K/V byte once with 16-byte loads, and merges the
// partials in a second small kernel.

#include "decode_attention.cuh"

extern "C" int livecc_flash_decode(int dtype, const void* q, const void* k, const void* v,
                                   void* o, const int* kv_limit, int batch, int hq, int hk,
                                   int skv, int d, const long long* strides, float scale,
                                   void* workspace, int nsplit, void* stream) {
  livecc::DecodeParams p;
  if (!livecc::decode_params(p, q, k, v, nullptr, nullptr, o, kv_limit, batch, hq, hk, skv, d,
                             strides, scale, workspace, nsplit, false))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == livecc::kFloat32) return livecc::launch_decode<float, false>(p, s);
  if (dtype == livecc::kBFloat16) return livecc::launch_decode<__nv_bfloat16, false>(p, s);
  return (int)cudaErrorInvalidValue;
}
