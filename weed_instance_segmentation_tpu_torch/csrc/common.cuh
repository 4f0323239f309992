// Device helpers and the dtype/head-dim dispatch shared by the attention
// kernels (window_attention.cu, masked_attention.cu). Each library is one
// translation unit that includes this header once.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kSharedLimit = 232448;  // bytes of shared memory a block may use on sm_90

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }
template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

__device__ __forceinline__ float warp_max(float v) {
  for (int off = 16; off > 0; off >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}
__device__ __forceinline__ float warp_sum(float v) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// a row held in registers (the same in every lane) . a shared-memory row
template <int D>
__device__ __forceinline__ float dot_reg(const float (&a)[D], const float* b) {
  float acc = 0.f;
#pragma unroll
  for (int d = 0; d < D; ++d) acc += a[d] * b[d];
  return acc;
}

}  // namespace

// return FN<element type, head dim>(...) for the caller's `head_dim` and
// `bf16` flag; cudaErrorInvalidValue for a head dim the kernels do not take
#define WIS_DISPATCH(FN, ...)                                                             \
  switch (head_dim * 2 + (bf16 ? 1 : 0)) {                                                \
    case 32: return FN<float, 16>(__VA_ARGS__);                                          \
    case 33: return FN<__nv_bfloat16, 16>(__VA_ARGS__);                                  \
    case 64: return FN<float, 32>(__VA_ARGS__);                                          \
    case 65: return FN<__nv_bfloat16, 32>(__VA_ARGS__);                                  \
    case 128: return FN<float, 64>(__VA_ARGS__);                                         \
    case 129: return FN<__nv_bfloat16, 64>(__VA_ARGS__);                                 \
    default: return static_cast<int>(cudaErrorInvalidValue);                             \
  }
