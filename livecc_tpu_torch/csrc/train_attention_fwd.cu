// K4 train_attention_fwd: the splash training attention's forward, which
// also writes the log-sum-exp that the backward reads.
//
// Replaces: livecc_tpu/ops/attention.py:_train_splash (JAX's Pallas splash
// MQA kernel, built by _splash_kernel; :126) and _train_flash_stock (JAX's
// Pallas flash kernel; :65), which share one contract behind
// train_flash_attention (:39): causal, GQA, segment ids for padding and
// packing.
//
// Contract and numerics: see train_attention.cuh. One block per (64-query
// tile, q head, row) loops over key tiles up to its causal frontier; the
// G = Hq / Hk q heads of a group read the same K/V rows (no head repeat).
//
// What bounds it on the H100: at the training shape (S = 8192, Hq = 28,
// D = 128) the causal work is 2 x 2 x S^2/2 x D x Hq FLOPs (~0.48 TFLOP per
// layer and row, less where packed segments cannot meet) against ~80 MB of
// q, k, v and o, so it is compute-bound; this first version runs the
// products on the fp32 FMA pipes, far from the 989 TFLOP/s bf16 tensor-core
// roof. Its design answers correctness and the data-dependent work: scores
// never leave shared memory, nothing [S, S] is ever materialized, and tile
// pairs that the causal mask or the segment ids zero are never computed.

#include "train_attention.cuh"

extern "C" int livecc_train_attention_fwd(int dtype, const void* q, const void* k, const void* v,
                                          const int* seg, void* o, float* lse, int batch, int hq,
                                          int hk, int s, int d, const long long* strides,
                                          void* stream) {
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
  const dim3 grid((s + livecc::kTrainTile - 1) / livecc::kTrainTile, hq, batch);
  const size_t smem = livecc::train_fwd_smem_bytes(d);
  if (dtype == livecc::kFloat32)
    return livecc::launch_train_kernel(livecc::train_fwd_kernel<float>, grid,
                                       livecc::kFwdThreads, smem, p, st);
  if (dtype == livecc::kBFloat16)
    return livecc::launch_train_kernel(livecc::train_fwd_kernel<__nv_bfloat16>, grid,
                                       livecc::kFwdThreads, smem, p, st);
  return (int)cudaErrorInvalidValue;
}
