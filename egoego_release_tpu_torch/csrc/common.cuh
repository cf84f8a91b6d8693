// Shared helpers of the denoiser's CUDA kernels (gemm.cu, attention.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace egoego {

constexpr int kThreads = 256;  // every kernel here runs 8 warps per block

__device__ __forceinline__ float load_f(const void* base, size_t off, int is_bf16) {
  return is_bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(base)[off])
                 : static_cast<const float*>(base)[off];
}

__device__ __forceinline__ void store_f(void* base, size_t off, float v, int is_bf16) {
  if (is_bf16) {
    static_cast<__nv_bfloat16*>(base)[off] = __float2bfloat16(v);
  } else {
    static_cast<float*>(base)[off] = v;
  }
}

// Round to the nearest bf16 and back: the rounding point of a bf16 cast.
__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace egoego
