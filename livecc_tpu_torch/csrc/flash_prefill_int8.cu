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
// What bounds it on the H100: compute (at the pool's tick ~58 GFLOP against
// ~47 MB of int8 K/V). bf16 queries (the model's dtype) run on the tensor
// cores (quant_mma_attention.cuh: int8 K/V tiles through a cp.async ring,
// widened to bf16 in shared memory, p * v_scale as three exact bf16 parts;
// D a multiple of 16 and 16-byte aligned rows, else refused); fp32 queries
// (the tiny test model) on the FMA pipes (tile_attention.cuh, QUANT). The
// dispatch is by the query dtype alone. Blocks stop at each row's
// causal/valid frontier, which the pool's per-row offsets make different for
// every row.

#include "quant_mma_attention.cuh"
#include "tile_attention.cuh"

extern "C" int livecc_flash_prefill_int8(int dtype, const void* q, const void* k,
                                         const void* v, const void* k_scale,
                                         const void* v_scale, void* o, const int* offset,
                                         const int* kv_limit, int batch, int hq, int hk, int sq,
                                         int skv, int d, const long long* strides, float scale,
                                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == livecc::kBFloat16) {
    livecc::QuantMmaParams p;
    p.q = static_cast<const __nv_bfloat16*>(q);
    p.k = static_cast<const int8_t*>(k);
    p.v = static_cast<const int8_t*>(v);
    p.k_scale = static_cast<const __nv_bfloat16*>(k_scale);
    p.v_scale = static_cast<const __nv_bfloat16*>(v_scale);
    p.o = static_cast<__nv_bfloat16*>(o);
    p.offset = offset;
    p.kv_limit = kv_limit;
    p.batch = batch;
    p.hq = hq;
    p.hk = hk;
    p.sq = sq;
    p.skv = skv;
    p.q_sb = strides[0];   p.q_sh = strides[1];   p.q_ss = strides[2];
    p.k_sb = strides[3];   p.k_sh = strides[4];   p.k_ss = strides[5];
    p.v_sb = strides[6];   p.v_sh = strides[7];   p.v_ss = strides[8];
    p.o_sb = strides[9];   p.o_sh = strides[10];  p.o_ss = strides[11];
    p.ks_sb = strides[12]; p.ks_sh = strides[13];
    p.vs_sb = strides[14]; p.vs_sh = strides[15];
    p.scale = scale;
    return livecc::launch_quant_mma_attention(p, d, s);
  }
  livecc::TileParams p;
  if (dtype != livecc::kFloat32 ||
      !livecc::prefill_params(p, q, k, v, k_scale, v_scale, o, offset, kv_limit, hq, hk, sq,
                              skv, d, strides, scale, true))
    return (int)cudaErrorInvalidValue;
  return livecc::launch_tile_attention<float, true, true>(p, batch, s);
}
