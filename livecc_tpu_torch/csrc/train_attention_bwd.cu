// K4 train_attention_bwd: the splash training attention's backward, dq, dk
// and dv from the forward's log-sum-exp.
//
// Replaces: the backward of livecc_tpu/ops/attention.py:_train_splash (JAX's
// Pallas splash kernels with use_fused_bwd_kernel=True: dq and dk/dv in one
// kernel) and of _train_flash_stock (:65); with causal = 0, of splash's
// FullMask form (:109-112), which no training caller asks for.
//
// Two launches on one stream, counted as one call by the wrapper:
//   * dK/dV — one block per (128-key tile, KV head, row) walks the G = 7 q
//     heads of its group and the query tiles from its diagonal on, so every
//     dK/dV row is summed inside one block: no atomics, and K/V are never
//     repeated per q head;
//   * dQ — one block per (128-query tile, q head, row) walks its key tiles.
// The TPU fuses dq into the dK/dV kernel, where the grid runs in order and
// a dq scratch carries across it; blocks on the H100 run in parallel, so a
// fused dq would need atomics (two launches would then differ in their
// bits) or a second pass. Splitting recomputes S and dP once more instead:
// 7 product passes where the fused form has 5.
//
// What bounds it on the H100: ~2.5x the forward's FLOPs (s, dp, dv, dk, dq),
// compute-bound at the training shape. The dispatch is by dtype: bf16 (the
// model's) runs on wgmma fed by TMA from a producer warp
// (train_wgmma_attention_bwd.cuh: transposed dK/dV products with P^T and
// dS^T kept in registers as bf16 A operands, a ring over the live tiles),
// fp32 (the tiny test model) on the FMA pipes (train_attention.cuh).

#include "train_attention.cuh"
#include "train_wgmma_attention_bwd.cuh"

extern "C" int livecc_train_attention_bwd(int dtype, const void* q, const void* k, const void* v,
                                          const int* seg, const void* dout, const float* lse,
                                          const float* di, void* dq, void* dk, void* dv, int batch,
                                          int hq, int hk, int s, int d, int causal,
                                          const long long* strides, void* stream) {
  livecc::TrainAttnParams p = {};
  if (!livecc::train_params(p, hq, hk, s, d, strides, true) || batch <= 0)
    return (int)cudaErrorInvalidValue;
  p.q = q;
  p.k = k;
  p.v = v;
  p.seg = seg;
  p.dout = dout;
  p.lse = const_cast<float*>(lse);
  p.di = di;
  p.dq = dq;
  p.dk = dk;
  p.dv = dv;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == livecc::kBFloat16)
    return livecc::with_head_dim(d, [&](auto dim) {
      constexpr int D = decltype(dim)::value;
      return causal ? livecc::launch_train_bwd_wgmma<D, true>(p, batch, st)
                    : livecc::launch_train_bwd_wgmma<D, false>(p, batch, st);
    });
  if (dtype != livecc::kFloat32) return (int)cudaErrorInvalidValue;
  const int tiles = (s + livecc::kTrainTile - 1) / livecc::kTrainTile;
  const size_t smem = livecc::train_bwd_smem_bytes(d);
  const int err = livecc::launch_train_kernel(
      causal ? livecc::train_dkv_kernel<float, true> : livecc::train_dkv_kernel<float, false>,
      dim3(tiles, hk, batch), livecc::kBwdThreads, smem, p, st);
  if (err) return err;
  return livecc::launch_train_kernel(
      causal ? livecc::train_dq_kernel<float, true> : livecc::train_dq_kernel<float, false>,
      dim3(tiles, hq, batch), livecc::kBwdThreads, smem, p, st);
}
