// K2 flash_decode: one query token per row attends over the KV cache.
//
// Replaces: livecc_tpu/ops/pallas/attention.py:flash_decode (_decode_kernel),
// the Pallas TPU kernel of every decode step, for a bf16/fp32 cache (the int8
// branch is flash_decode_int8.cu; both share decode_attention.cuh).
//
// Contract: q [B, Hq, 1, D] (strided), one layer of the cache
// k/v [B, Hk, Smax, D] (the wrapper passes the layer's base pointer of the
// stacked cache), kv_limit int32 [B] on the device (read in the kernel, no
// host sync): keys kpos < kv_limit[b] are valid. A row with no valid key
// outputs 0.
//
// What bounds it on the H100: decode attention reads the whole valid cache
// (2 x kv x Hk x D x 2 bytes per layer) for ~4 x G FLOPs per byte, far
// below the card's ~295 FLOP/byte ridge, so it is bound by memory traffic.
// This first version runs one block per (row, KV head): at B = 1, Hk = 4
// that is 4 blocks on 132 SMs, so it reaches a few percent of the card's
// bandwidth. Splitting the key axis over more blocks (flash-decoding with a
// combine pass) is the known first speed-up, left for a later change.

#include "decode_attention.cuh"

extern "C" int livecc_flash_decode(int dtype, const void* q, const void* k, const void* v,
                                   void* o, const int* kv_limit, int batch, int hq, int hk,
                                   int skv, int d, const long long* strides, float scale,
                                   void* stream) {
  livecc::DecodeParams p;
  if (!livecc::decode_params(p, q, k, v, nullptr, nullptr, o, kv_limit, hq, hk, skv, d,
                             strides, scale, false))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == livecc::kFloat32) return livecc::launch_decode<float, false>(p, batch, s);
  if (dtype == livecc::kBFloat16) return livecc::launch_decode<__nv_bfloat16, false>(p, batch, s);
  return (int)cudaErrorInvalidValue;
}
