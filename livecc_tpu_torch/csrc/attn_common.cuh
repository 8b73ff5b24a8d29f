// Shared pieces of the port's attention kernels (K1 flash_prefill, K2
// flash_decode, their int8 variants, K3 vit_group_attention).
//
// Numerics follow the TPU kernels exactly: scores and the softmax run in
// fp32, masked scores are finfo(float32).min, the probabilities are rounded
// to the value dtype before the p·v product (the Pallas kernels'
// `p.astype(v.dtype)`), the running sum l is taken before that rounding,
// and the output is acc / l with l == 0 (a row that saw no valid key) giving
// exactly 0. The int8 variants keep p in fp32 instead (see
// tile_attention.cuh).

#pragma once

#include <cfloat>
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <type_traits>

namespace livecc {

// dtype codes shared with the Python wrappers (ops/build.py)
enum DType : int { kFloat32 = 0, kBFloat16 = 1 };

constexpr float kNegInf = -FLT_MAX;   // finfo(float32).min, as in the TPU kernels
constexpr int kMaxHeadDim = 128;      // head_dim <= 128, a multiple of 8

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f(int8_t x) { return static_cast<float>(x); }  // exact

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

// Round an fp32 probability to the value dtype and back (identity for fp32).
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// Copy `rows` rows of `d` elements (row stride `stride`, unit inner stride)
// into a padded fp32 shared tile; rows at or past `valid` are zero-filled,
// so masked keys never bring NaN/Inf garbage into a 0 * v product.
template <typename T>
__device__ __forceinline__ void load_tile(float* dst, int ld, const T* src, long long stride,
                                          int row0, int rows, int valid, int d) {
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) {
    const int r = i / d, c = i - (i / d) * d;
    const int gr = row0 + r;
    dst[r * ld + c] = gr < valid ? to_f(src[gr * stride + c]) : 0.f;
  }
}

// Copy `n` lane-major bf16 scales (unit stride) into fp32 shared memory;
// entries at or past `valid` are 0.
__device__ __forceinline__ void load_scales(float* dst, const __nv_bfloat16* src, int n,
                                            int valid) {
  for (int i = threadIdx.x; i < n; i += blockDim.x)
    dst[i] = i < valid ? __bfloat162float(src[i]) : 0.f;
}

}  // namespace livecc
