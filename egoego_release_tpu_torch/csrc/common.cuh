// Shared helpers of the CUDA kernels (gemm.cu, attention.cu, mha.cu).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

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

// 16-byte async copy from device to shared memory; pred false zero-fills
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(gmem),
               "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
template <int N>
__device__ __forceinline__ void cp_async_wait() { asm volatile("cp.async.wait_group %0;\n" ::"n"(N)); }

// 3xTF32 (mha.cu, gemm.cu): x = hi + lo. hi is x rounded to the nearest TF32 value (10 mantissa
// bits, ties away from zero: cvt.rna's rounding, done on the bits in two
// instructions, where cvt.rna.tf32.f32 expands to several); lo = x - hi
// exactly, which the tensor core reads truncated to TF32 (|lo| <= 2^-11 |x|,
// so the truncation costs at most 2^-21 |x|). x is finite.
__device__ __forceinline__ void split_tf32(float x, uint32_t& hi, uint32_t& lo) {
  hi = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

}  // namespace egoego
