// K1-int8 flash_prefill over an int8 KV cache with per-key bf16 scales.
//
// Replaces: the `quantized` branch of
// livecc_tpu/ops/pallas/attention.py:_prefill_kernel (:78-99), which
// flash_prefill (:114) runs when it is given k_scale/v_scale.
//
// Contract: as K1 (flash_prefill.cu) with k/v int8 [B, Hk, Smax, D] (one
// layer of the stacked cache, by base pointer) and k_scale/v_scale bf16
// [B, Hk, 1, Smax] (one layer of the lane-major [L, B, Hk, 1, Smax] scales,
// positions unit-stride); q and the output fp32 or bf16; per-row offset and
// kv_limit int32 [B] on the device. Semantics of the TPU branch:
// s = (q.k * d^-0.5) * k_scale[key] in fp32, causal/valid mask with
// finfo(float32).min, online softmax with l summing p before the value
// scale, p * v_scale[key] kept fp32 for p.v, normalisation after p.v; a row
// with no valid key gives 0.
//
// What bounds it on the H100: as K1, the FMA-pipe products (compute-bound at
// the 1024-token init bucket); the K/V tiles cost half K1's bytes since they
// are read as int8. It reuses K1's tile loop (tile_attention.cuh, QUANT):
// blocks stop at each row's causal/valid frontier, which the pool's
// per-row offsets make different for every row.

#include "tile_attention.cuh"

extern "C" int livecc_flash_prefill_int8(int dtype, const void* q, const void* k,
                                         const void* v, const void* k_scale,
                                         const void* v_scale, void* o, const int* offset,
                                         const int* kv_limit, int batch, int hq, int hk, int sq,
                                         int skv, int d, const long long* strides, float scale,
                                         void* stream) {
  livecc::TileParams p;
  if (!livecc::prefill_params(p, q, k, v, k_scale, v_scale, o, offset, kv_limit, hq, hk, sq,
                              skv, d, strides, scale, true))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == livecc::kFloat32)
    return livecc::launch_tile_attention<float, true, true>(p, batch, s);
  if (dtype == livecc::kBFloat16)
    return livecc::launch_tile_attention<__nv_bfloat16, true, true>(p, batch, s);
  return (int)cudaErrorInvalidValue;
}
