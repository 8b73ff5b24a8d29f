// K1 flash_prefill: a chunk of queries appended at a per-row cache offset
// attends causally over the static KV cache.
//
// Replaces: livecc_tpu/ops/pallas/attention.py:flash_prefill (_prefill_kernel),
// the Pallas TPU kernel of the streaming prefill, for a bf16/fp32 cache (the
// int8 branch is flash_prefill_int8.cu).
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
// Hq = 28, D = 128, ~700-1750 keys) the work is ~4 x pairs x D x Hq FLOPs per
// layer against a few MB of K/V, so it is compute-bound. bf16 (the model's
// dtype) runs on the tensor cores (mma_attention.cuh: mma.sync fed by a
// cp.async K/V ring; D a multiple of 16, 16-byte aligned rows); fp32 (the
// tiny test model) on the FMA pipes (tile_attention.cuh). The dispatch is by
// dtype alone. Blocks stop at the causal/valid frontier (the loop bound
// replaces the TPU index-map clamp) and each K/V tile is read once per 64
// queries.

#include "mma_attention.cuh"
#include "tile_attention.cuh"

extern "C" int livecc_flash_prefill(int dtype, const void* q, const void* k, const void* v,
                                    void* o, const int* offset, const int* kv_limit,
                                    int batch, int hq, int hk, int sq, int skv, int d,
                                    const long long* strides, float scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == livecc::kBFloat16) {
    livecc::MmaParams p;
    p.q = static_cast<const __nv_bfloat16*>(q);
    p.k = static_cast<const __nv_bfloat16*>(k);
    p.v = static_cast<const __nv_bfloat16*>(v);
    p.o = static_cast<__nv_bfloat16*>(o);
    p.offset = offset;
    p.kv_limit = kv_limit;
    p.cu_seqlens = nullptr;
    p.hq = hq;
    p.hk = hk;
    p.sq = sq;
    p.skv = skv;
    p.q_sb = strides[0];  p.q_sh = strides[1];  p.q_ss = strides[2];
    p.k_sb = strides[3];  p.k_sh = strides[4];  p.k_ss = strides[5];
    p.v_sb = strides[6];  p.v_sh = strides[7];  p.v_ss = strides[8];
    p.o_sb = strides[9];  p.o_sh = strides[10]; p.o_ss = strides[11];
    p.scale = scale;
    return livecc::launch_mma_attention<true>(p, d, sq, batch, s);
  }
  livecc::TileParams p;
  if (dtype != livecc::kFloat32 ||
      !livecc::prefill_params(p, q, k, v, nullptr, nullptr, o, offset, kv_limit, hq, hk, sq,
                              skv, d, strides, scale, false))
    return (int)cudaErrorInvalidValue;
  return livecc::launch_tile_attention<float, true>(p, batch, s);
}
