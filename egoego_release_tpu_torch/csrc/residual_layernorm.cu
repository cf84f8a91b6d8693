// The residual add and LayerNorm of a tensor-parallel DecoderLayer:
//
//     out[r] = LN(p[r] + b + res[r]) * row_mask[r]       (eps 1e-5, f32 statistics)
//
// Replaces, for a layer whose fc and w2 products are split over the tp
// ranks, the LayerNorm epilogue of gemm.cu (kLayerNorm): the epilogue
// holds the whole product of a row, but under tp each rank's kPartial
// product is a partial sum that is complete only after the all-reduce over
// the tp group, so the normalization runs after it, here. The arithmetic is
// the epilogue's and egoego_release_tpu/ops/fused_layer.py _layer_body's:
// (p + b) + res in f32, the row mean, then the mean of the squared
// deviations (two passes over the row held in registers), then
// (y - mean) rsqrt(var + eps) s + b, times the row's mask. The residual is
// f32, or bf16 (read as f32) with bf16 inter-layer activations; the output
// leaves as f32 and/or as its bf16 copy (the next product's A). Each
// residual/output layout is an instantiation of its own, as in gemm.cu.
//
// One block of 128 threads a row, each thread four consecutive columns a
// pass (16-byte loads), N <= 4 x 128 x kMaxPasses. Bound by bytes: at 64 x
// 121 rows of 512 it moves ~55 MB (p, res and out in f32, the bf16 copy)
// against ~0.04 GFLOP, 16.6 us at 3.35 TB/s.

#include "common.cuh"

namespace egoego {

struct RlnArgs {
  const float* p;         // (M, N) the all-reduced partial product
  const float* bias;      // (N,)
  const void* res;        // (M, N) f32, or bf16 with res_bf16
  const float* ln_s;      // (N,)
  const float* ln_b;      // (N,)
  const float* row_mask;  // (M,)
  float* out;             // (M, N) f32, or null
  __nv_bfloat16* out_b;   // (M, N) bf16 copy, or null
  int M, N;
  int res_bf16;
};

constexpr int kRlnThreads = 128;
constexpr int kMaxPasses = 2;  // N <= 1024

__device__ __forceinline__ float block_sum(float v, float* red) {
  v = warp_sum(v);
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kRlnThreads / 32; ++w) t += red[w];
  __syncthreads();  // red is free for the next sum
  return t;
}

template <bool RES_BF16, bool F32_OUT, bool BF16_OUT>
__global__ void __launch_bounds__(kRlnThreads) residual_layernorm_kernel(const RlnArgs a) {
  __shared__ float red[kRlnThreads / 32];
  const int row = blockIdx.x;
  const size_t base = (size_t)row * a.N;
  float y[kMaxPasses][4];
  float s = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPasses; ++k) {
    const int c = 4 * (threadIdx.x + kRlnThreads * k);
    if (c < a.N) {
      const float4 pv = *reinterpret_cast<const float4*>(a.p + base + c);
      const float4 bv = *reinterpret_cast<const float4*>(a.bias + c);
      float4 rv;
      if constexpr (RES_BF16) {
        const uint2 bits = *reinterpret_cast<const uint2*>(static_cast<const __nv_bfloat16*>(a.res) + base + c);
        const float2 lo = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bits.x));
        const float2 hi = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&bits.y));
        rv = make_float4(lo.x, lo.y, hi.x, hi.y);
      } else {
        rv = *reinterpret_cast<const float4*>(static_cast<const float*>(a.res) + base + c);
      }
      y[k][0] = (pv.x + bv.x) + rv.x;
      y[k][1] = (pv.y + bv.y) + rv.y;
      y[k][2] = (pv.z + bv.z) + rv.z;
      y[k][3] = (pv.w + bv.w) + rv.w;
      s += (y[k][0] + y[k][1]) + (y[k][2] + y[k][3]);
    }
  }
  const float mean = block_sum(s, red) / a.N;
  float q = 0.f;
#pragma unroll
  for (int k = 0; k < kMaxPasses; ++k) {
    if (4 * (threadIdx.x + kRlnThreads * k) < a.N) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float d = y[k][e] - mean;
        q += d * d;
      }
    }
  }
  const float inv = rsqrtf(block_sum(q, red) / a.N + 1e-5f);
  const float m = a.row_mask[row];
#pragma unroll
  for (int k = 0; k < kMaxPasses; ++k) {
    const int c = 4 * (threadIdx.x + kRlnThreads * k);
    if (c < a.N) {
      const float4 g = *reinterpret_cast<const float4*>(a.ln_s + c);
      const float4 b = *reinterpret_cast<const float4*>(a.ln_b + c);
      const float4 o = make_float4(((y[k][0] - mean) * inv * g.x + b.x) * m, ((y[k][1] - mean) * inv * g.y + b.y) * m,
                                   ((y[k][2] - mean) * inv * g.z + b.z) * m, ((y[k][3] - mean) * inv * g.w + b.w) * m);
      if constexpr (F32_OUT) *reinterpret_cast<float4*>(a.out + base + c) = o;
      if constexpr (BF16_OUT) {
        union { uint2 bits; __nv_bfloat162 h[2]; } v;
        v.h[0] = __floats2bfloat162_rn(o.x, o.y);
        v.h[1] = __floats2bfloat162_rn(o.z, o.w);
        *reinterpret_cast<uint2*>(a.out_b + base + c) = v.bits;
      }
    }
  }
}

template <bool RES_BF16, bool F32_OUT, bool BF16_OUT>
static cudaError_t launch(const RlnArgs& a, cudaStream_t s) {
  residual_layernorm_kernel<RES_BF16, F32_OUT, BF16_OUT><<<a.M, kRlnThreads, 0, s>>>(a);
  return cudaGetLastError();
}

template <bool RES_BF16>
static cudaError_t launch_res(const RlnArgs& a, cudaStream_t s) {
  if (a.out != nullptr && a.out_b != nullptr) return launch<RES_BF16, true, true>(a, s);
  if (a.out != nullptr) return launch<RES_BF16, true, false>(a, s);
  return launch<RES_BF16, false, true>(a, s);
}

static bool aligned(const void* ptr, size_t bytes) { return reinterpret_cast<size_t>(ptr) % bytes == 0; }

}  // namespace egoego

// Launches one residual LayerNorm; a layout it cannot take returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int egoego_residual_layernorm(const egoego::RlnArgs* a, void* stream) {
  using namespace egoego;
  if (a->M <= 0 || a->N <= 0 || a->N % 4 || a->N > 4 * kRlnThreads * kMaxPasses ||
      (a->out == nullptr && a->out_b == nullptr) || !aligned(a->p, 16) || !aligned(a->bias, 16) ||
      !aligned(a->res, a->res_bf16 ? 8 : 16) || !aligned(a->ln_s, 16) || !aligned(a->ln_b, 16) ||
      !aligned(a->out, 16) || !aligned(a->out_b, 8))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return (int)(a->res_bf16 ? launch_res<true>(*a, s) : launch_res<false>(*a, s));
}

extern "C" int egoego_residual_layernorm_args_size() { return (int)sizeof(egoego::RlnArgs); }
