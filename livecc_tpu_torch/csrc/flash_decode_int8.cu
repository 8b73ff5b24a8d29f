// K2-int8 flash_decode over an int8 KV cache with per-key bf16 scales.
//
// Replaces: the `quantized` branch of
// livecc_tpu/ops/pallas/attention.py:_decode_kernel (:220-238), which
// flash_decode (:253) runs when it is given k_scale/v_scale.
//
// Contract: as K2 (flash_decode.cu) with k/v int8 [B, Hk, Smax, D] (one
// layer of the stacked cache, by base pointer) and k_scale/v_scale bf16
// [B, Hk, 1, Smax] (one layer of the lane-major [L, B, Hk, 1, Smax] scales,
// positions unit-stride). q and the output are fp32 or bf16. Semantics of
// the TPU branch: s = (q.k * d^-0.5) * k_scale[key] in fp32, softmax with l
// summing p before the value scale, p * v_scale[key] kept fp32 for p.v,
// normalisation after p.v (after the merge of the splits here).
//
// What bounds it on the H100: the same memory traffic as K2, at half the
// bytes: each K/V element is one int8 byte (16 per vector load, 8 where a
// row of D = 8 leaves no room for 16) plus two bf16 scales per key. It is
// the same split-KV template as K2 (decode_attention.cuh); the pool runs it
// at B = 8, i.e. Hk x sum_b ceil(kv_b / 64) working blocks.

#include "decode_attention.cuh"

extern "C" int livecc_flash_decode_int8(int dtype, const void* q, const void* k, const void* v,
                                        const void* k_scale, const void* v_scale, void* o,
                                        const int* kv_limit, int batch, int hq, int hk, int skv,
                                        int d, const long long* strides, float scale,
                                        void* workspace, int nsplit, void* stream) {
  livecc::DecodeParams p;
  if (!livecc::decode_params(p, q, k, v, k_scale, v_scale, o, kv_limit, batch, hq, hk, skv, d,
                             strides, scale, workspace, nsplit, true))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == livecc::kFloat32) return livecc::launch_decode<float, true>(p, s);
  if (dtype == livecc::kBFloat16) return livecc::launch_decode<__nv_bfloat16, true>(p, s);
  return (int)cudaErrorInvalidValue;
}
