// K4 train_attention_fwd: the splash training attention's forward, which
// also writes the log-sum-exp that the backward reads.
//
// Replaces: livecc_tpu/ops/attention.py:_train_splash (JAX's Pallas splash
// MQA kernel, built by _splash_kernel; :126) and _train_flash_stock (JAX's
// Pallas flash kernel; :65), which share one contract behind
// train_flash_attention (:39): causal, GQA, segment ids for padding and
// packing; with causal = 0, splash's FullMask form (:109-112), which no
// training caller asks for.
//
// Contract and numerics: see train_attention.cuh. The G = Hq / Hk q heads
// of a group read the same K/V rows (no head repeat).
//
// What bounds it on the H100: at the training shape (S = 8192, Hq = 28,
// D = 128) the causal work is 2 x 2 x S^2/2 x D x Hq FLOPs (~0.48 TFLOP per
// layer and row, less where packed segments cannot meet) against ~80 MB of
// q, k, v and o, so it is compute-bound. The dispatch is by dtype: bf16 (the
// model's) runs on wgmma fed by TMA from a producer warpgroup
// (train_wgmma_attention.cuh: 128-query blocks over a ring of 64-key
// tiles, the live key tiles only, splash's fp32 p kept exactly as three
// bf16 parts; D a multiple of 16, 16-byte aligned rows), fp32 (the tiny
// test model) on the FMA pipes (train_attention.cuh). Both keep the scores
// on chip, never materialize [S, S], and never compute a tile pair that
// the causal mask or the segment ids zero.

#include "train_attention.cuh"
#include "train_wgmma_attention.cuh"

extern "C" int livecc_train_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                          const int* seg, void* o, float* lse, int batch, int hq,
                                          int hk, int s, int d, int causal,
                                          const long long* strides, void* stream) {
  livecc::TrainAttnParams p = {};
  if (!livecc::train_params(p, hq, hk, s, d, strides, false) || batch <= 0)
    return (int)cudaErrorInvalidValue;
  p.q = q;
  p.k = k;
  p.v = v;
  p.seg = seg;
  p.o = o;
  p.lse = lse;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == livecc::kBFloat16)
    return livecc::with_head_dim(d, [&](auto dim) {
      constexpr int D = decltype(dim)::value;
      return causal ? livecc::launch_train_fwd_wgmma<D, true>(p, batch, st)
                    : livecc::launch_train_fwd_wgmma<D, false>(p, batch, st);
    });
  if (dtype != livecc::kFloat32) return (int)cudaErrorInvalidValue;
  const dim3 grid((s + livecc::kTrainTile - 1) / livecc::kTrainTile, hq, batch);
  return livecc::launch_train_kernel(
      causal ? livecc::train_fwd_kernel<float, true> : livecc::train_fwd_kernel<float, false>,
      grid, livecc::kFwdThreads, livecc::train_fwd_smem_bytes(d), p, st);
}
