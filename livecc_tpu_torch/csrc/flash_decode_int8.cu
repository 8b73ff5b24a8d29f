// K2-int8 flash_decode over an int8 KV cache with per-key bf16 scales.
//
// Replaces: the `quantized` branch of
// livecc_tpu/ops/pallas/attention.py:_decode_kernel (:220-238), which
// flash_decode (:253) runs when it is given k_scale/v_scale.
//
// Contract: as K2 (flash_decode.cu; `kv_maps` of int8 elements) with k/v
// int8 [B, Hk, Smax, D] (one layer of the stacked cache, by base pointer)
// and k_scale/v_scale bf16
// [B, Hk, 1, Smax] (one layer of the lane-major [L, B, Hk, 1, Smax] scales,
// positions unit-stride). q and the output are fp32 or bf16. Semantics of
// the TPU branch: s = (q.k * d^-0.5) * k_scale[key] in fp32, softmax with l
// summing p before the value scale, p * v_scale[key] kept fp32 for p.v,
// normalisation after p.v (after the merge of the splits here).
//
// What bounds it on the H100: the same bytes as K2 at half the size: each
// K/V element is one int8 byte plus two bf16 scales a key. The same ring
// template (decode_attention.cuh): a tile's scales ride in its stage; with
// bf16 q, q.k runs on mma.sync against K widened to bf16 exactly and so
// does P.V, p * v_scale kept fp32 as three bf16 parts (the FMA pipes for a
// head dim that is not a multiple of 16); the pool runs it at B = 8.

#include "decode_attention.cuh"

extern "C" int livecc_flash_decode_int8(int dtype, const void* q, const void* k, const void* v,
                                        const void* k_scale, const void* v_scale, void* o,
                                        const int* kv_limit, int batch, int hq, int hk, int skv,
                                        int d, const long long* strides, float scale,
                                        void* workspace, int* counters, int nsplit,
                                        const void* kv_maps, int layer, void* stream) {
  livecc::DecodeParams p;
  if (!livecc::decode_params(p, q, k, v, k_scale, v_scale, o, kv_limit, batch, hq, hk, skv, d,
                             strides, scale, workspace, counters, nsplit, layer, true))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == livecc::kFloat32) return livecc::launch_decode<float, true>(p, kv_maps, s);
  if (dtype == livecc::kBFloat16) return livecc::launch_decode<__nv_bfloat16, true>(p, kv_maps, s);
  return (int)cudaErrorInvalidValue;
}
