// Multi-head self-attention of one post-LN DecoderLayer.
//
// Replaces the per-(batch, head) attention loop inside
// egoego_release_tpu/ops/fused_layer.py _layer_body (used by the TPU kernels
// _stem_layer_kernel, _layer_kernel and _layer_epilogue_kernel): scores
// q k^T * scale, keys at or past t_keys set to -inf (pad-to-tile keys only:
// a padding-mask zero inside t_keys stays a visible key), an f32 softmax,
// p rounded to bf16 before p v in bf16 mode, and ctx rounded to bf16 for
// the fc product.
//
// At d_k = 256 a head's Q, K and V do not fit in shared memory together in
// f32 (3 x 128 KB at 128 tokens), so K and then V stream through in tiles;
// the full score rows of a query tile (f32, t_keys wide) stay in shared
// memory, which keeps the exact two-pass softmax of the TPU kernel instead
// of an online rescaling whose rounding points would differ.
//
// What bounds it on the H100: ~4.3 GFLOP per layer at the main path's
// shapes against ~50 MB of q/k/v/ctx traffic, so compute. Two paths, chosen
// from the operands: bf16 at head width 256 (the release model) runs both
// products on the tensor cores (attention_tc_kernel); f32 mode and other
// widths run f32 FMA on the CUDA cores (attention_kernel), one block per
// (16 queries, head, batch).

#include <mma.h>

#include "common.cuh"

namespace egoego {

struct AttnArgs {
  const void* qkv;  // (B*T, ld_qkv): q at [0, H*dk), k at [H*dk, 2H*dk), v after
  void* ctx;        // (B*T, ld_ctx): head h at [h*dv, (h+1)*dv)
  int B, T, t_keys, n_head, d_k, d_v, ld_qkv, ld_ctx;
  int is_bf16;
  float scale;
};

constexpr int kBQ = 16;   // queries per block
constexpr int kBKV = 32;  // keys per streamed tile

__device__ __forceinline__ int round_up(int x, int m) { return (x + m - 1) / m * m; }

__global__ void __launch_bounds__(kThreads) attention_kernel(const AttnArgs p) {
  extern __shared__ __align__(16) float sm[];
  const int tk_pad = round_up(p.t_keys, kBKV);
  const int ld_kv = (p.d_k > p.d_v ? p.d_k : p.d_v) + 1;
  float* Qs = sm;                   // kBQ x d_k
  float* KV = Qs + kBQ * p.d_k;     // kBKV x ld_kv
  float* S = KV + kBKV * ld_kv;     // kBQ x tk_pad

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const size_t row0 = (size_t)b * p.T;
  const int k_col = p.n_head * p.d_k + h * p.d_k;
  const int v_col = 2 * p.n_head * p.d_k + h * p.d_v;

  for (int i = tid; i < kBQ * p.d_k; i += kThreads) {
    const int r = i / p.d_k, c = i % p.d_k;
    Qs[i] = (q0 + r < p.T) ? load_f(p.qkv, (row0 + q0 + r) * p.ld_qkv + h * p.d_k + c, p.is_bf16) : 0.f;
  }

  // Pass 1: scores. Thread (key lane, warp) computes rows warp and warp + 8.
  for (int j0 = 0; j0 < tk_pad; j0 += kBKV) {
    __syncthreads();
    for (int i = tid; i < kBKV * p.d_k; i += kThreads) {
      const int n = i / p.d_k, c = i % p.d_k;
      KV[n * ld_kv + c] =
          (j0 + n < p.t_keys) ? load_f(p.qkv, (row0 + j0 + n) * p.ld_qkv + k_col + c, p.is_bf16) : 0.f;
    }
    __syncthreads();
    const float* kr = KV + lane * ld_kv;
    const float* qa = Qs + warp * p.d_k;
    const float* qb = Qs + (warp + 8) * p.d_k;
    float s0 = 0.f, s1 = 0.f;
    for (int c = 0; c < p.d_k; ++c) {
      const float kv = kr[c];
      s0 = fmaf(qa[c], kv, s0);
      s1 = fmaf(qb[c], kv, s1);
    }
    const int key = j0 + lane;
    S[warp * tk_pad + key] = key < p.t_keys ? s0 * p.scale : -INFINITY;
    S[(warp + 8) * tk_pad + key] = key < p.t_keys ? s1 * p.scale : -INFINITY;
  }
  __syncthreads();

  // Softmax over each score row in f32; warp w owns rows w and w + 8.
  for (int r = warp; r < kBQ; r += 8) {
    float* row = S + r * tk_pad;
    float mx = -INFINITY;
    for (int j = lane; j < p.t_keys; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < p.t_keys; j += 32) sum += expf(row[j] - mx);
    sum = warp_sum(sum);
    for (int j = lane; j < tk_pad; j += 32) {
      float pj = j < p.t_keys ? expf(row[j] - mx) / sum : 0.f;
      row[j] = p.is_bf16 ? round_bf16(pj) : pj;
    }
  }

  // Pass 2: ctx = p v. Thread d owns output column d for all 16 queries.
  float acc[kBQ];
#pragma unroll
  for (int q = 0; q < kBQ; ++q) acc[q] = 0.f;
  for (int j0 = 0; j0 < tk_pad; j0 += kBKV) {
    __syncthreads();
    for (int i = tid; i < kBKV * p.d_v; i += kThreads) {
      const int n = i / p.d_v, c = i % p.d_v;
      KV[n * ld_kv + c] =
          (j0 + n < p.t_keys) ? load_f(p.qkv, (row0 + j0 + n) * p.ld_qkv + v_col + c, p.is_bf16) : 0.f;
    }
    __syncthreads();
    if (tid < p.d_v) {
      for (int n = 0; n < kBKV; ++n) {
        const float v = KV[n * ld_kv + tid];
#pragma unroll
        for (int q = 0; q < kBQ; ++q) acc[q] = fmaf(S[q * tk_pad + j0 + n], v, acc[q]);
      }
    }
  }
  if (tid < p.d_v) {
#pragma unroll
    for (int q = 0; q < kBQ; ++q) {
      if (q0 + q < p.T) store_f(p.ctx, (row0 + q0 + q) * p.ld_ctx + h * p.d_v + tid, acc[q], p.is_bf16);
    }
  }
}

// bf16 mode at head width 256 (the release model): the two products on
// the tensor cores (WMMA, f32 accumulation), 32 queries per block, keys
// and values streamed in 64-row bf16 tiles. Scores are scaled and stored
// f32, the softmax is the same exact two-pass f32 one, p is rounded to bf16
// for p v, and ctx is rounded to bf16 once on the way out.
constexpr int kTQ = 32;   // queries per block
constexpr int kTKV = 64;  // keys per streamed tile
constexpr int kHD = 256;  // head width of this path (d_k = d_v)
constexpr int kLDH = kHD + 8;

struct TcLayout {
  int tk_pad, lds, ldp;
  size_t q, kv, s, p, total;
  __host__ __device__ explicit TcLayout(int t_keys) {
    tk_pad = (t_keys + kTKV - 1) / kTKV * kTKV;
    lds = tk_pad + 4;
    ldp = tk_pad + 8;
    q = 0;
    kv = q + (size_t)kTQ * kLDH * 2;
    s = kv + (size_t)kTKV * kLDH * 2;
    p = s + (size_t)kTQ * lds * 4;
    total = p + (size_t)kTQ * ldp * 2;
  }
};

__global__ void __launch_bounds__(kThreads) attention_tc_kernel(const AttnArgs p) {
  using namespace nvcuda;
  extern __shared__ __align__(128) unsigned char smem[];
  const TcLayout L(p.t_keys);
  __nv_bfloat16* Qs = reinterpret_cast<__nv_bfloat16*>(smem + L.q);
  __nv_bfloat16* KVs = reinterpret_cast<__nv_bfloat16*>(smem + L.kv);
  float* S = reinterpret_cast<float*>(smem + L.s);
  __nv_bfloat16* P = reinterpret_cast<__nv_bfloat16*>(smem + L.p);
  float* Cs = reinterpret_cast<float*>(smem + L.kv);  // ctx staging, after the last v tile

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kTQ, h = blockIdx.y, b = blockIdx.z;
  const __nv_bfloat16* qkv = static_cast<const __nv_bfloat16*>(p.qkv);
  const size_t row0 = (size_t)b * p.T;
  const int k_col = p.n_head * kHD + h * kHD;
  const int v_col = 2 * p.n_head * kHD + h * kHD;
  constexpr int VPR = kHD / 8;  // 16-byte vectors per row

  // rows [r0, r0 + rows) of the head's column block `col` into dst (zeros past `limit`)
  auto load_rows = [&](__nv_bfloat16* dst, int r0, int rows, int limit, int col) {
    for (int i = tid; i < rows * VPR; i += kThreads) {
      const int r = i / VPR, c = (i % VPR) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);
      if (r0 + r < limit) v = *reinterpret_cast<const uint4*>(qkv + (row0 + r0 + r) * p.ld_qkv + col + c);
      *reinterpret_cast<uint4*>(dst + r * kLDH + c) = v;
    }
  };

  load_rows(Qs, q0, kTQ, p.T, h * kHD);
  {  // scores: warp w owns the 16x16 block (w / 4, w % 4) of each 32x64 tile
    const int fm = warp / 4, fn = warp % 4;
    for (int j0 = 0; j0 < L.tk_pad; j0 += kTKV) {
      __syncthreads();
      load_rows(KVs, j0, kTKV, p.t_keys, k_col);
      __syncthreads();
      wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc;
      wmma::fill_fragment(acc, 0.f);
#pragma unroll 4
      for (int kk = 0; kk < kHD; kk += 16) {
        wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::col_major> fb;
        wmma::load_matrix_sync(fa, Qs + fm * 16 * kLDH + kk, kLDH);
        wmma::load_matrix_sync(fb, KVs + fn * 16 * kLDH + kk, kLDH);
        wmma::mma_sync(acc, fa, fb, acc);
      }
#pragma unroll
      for (int i = 0; i < acc.num_elements; ++i) acc.x[i] *= p.scale;
      wmma::store_matrix_sync(S + fm * 16 * L.lds + j0 + fn * 16, acc, L.lds, wmma::mem_row_major);
    }
  }
  __syncthreads();

  // softmax rows in f32; warp w owns rows 4w .. 4w + 3
  for (int r = warp * 4; r < warp * 4 + 4; ++r) {
    const float* row = S + r * L.lds;
    float mx = -INFINITY;
    for (int j = lane; j < p.t_keys; j += 32) mx = fmaxf(mx, row[j]);
    mx = warp_max(mx);
    float sum = 0.f;
    for (int j = lane; j < p.t_keys; j += 32) sum += expf(row[j] - mx);
    sum = warp_sum(sum);
    for (int j = lane; j < L.tk_pad; j += 32)
      P[r * L.ldp + j] = __float2bfloat16(j < p.t_keys ? expf(row[j] - mx) / sum : 0.f);
  }

  // ctx = p v: warp w owns rows (w % 2) * 16 and columns (w / 2) * 64 .. + 64
  const int fm = warp % 2, fn0 = (warp / 2) * 4;
  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[4];
#pragma unroll
  for (int f = 0; f < 4; ++f) wmma::fill_fragment(acc[f], 0.f);
  for (int j0 = 0; j0 < L.tk_pad; j0 += kTKV) {
    __syncthreads();
    load_rows(KVs, j0, kTKV, p.t_keys, v_col);
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kTKV; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa;
      wmma::load_matrix_sync(fa, P + fm * 16 * L.ldp + j0 + kk, L.ldp);
#pragma unroll
      for (int f = 0; f < 4; ++f) {
        wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb;
        wmma::load_matrix_sync(fb, KVs + kk * kLDH + (fn0 + f) * 16, kLDH);
        wmma::mma_sync(acc[f], fa, fb, acc[f]);
      }
    }
  }
  __syncthreads();
  constexpr int LDC = kHD + 4;
#pragma unroll
  for (int f = 0; f < 4; ++f)
    wmma::store_matrix_sync(Cs + fm * 16 * LDC + (fn0 + f) * 16, acc[f], LDC, wmma::mem_row_major);
  __syncthreads();
  __nv_bfloat16* ctx = static_cast<__nv_bfloat16*>(p.ctx);
  for (int i = tid; i < kTQ * VPR; i += kThreads) {
    const int r = i / VPR, c = (i % VPR) * 8;
    if (q0 + r >= p.T) continue;
    union { uint4 u; __nv_bfloat162 h2[4]; } o;
    const float* src = Cs + r * LDC + c;
#pragma unroll
    for (int e = 0; e < 4; ++e) o.h2[e] = __floats2bfloat162_rn(src[2 * e], src[2 * e + 1]);
    *reinterpret_cast<uint4*>(ctx + (row0 + q0 + r) * p.ld_ctx + h * kHD + c) = o.u;
  }
}

}  // namespace egoego

extern "C" int egoego_attention(const egoego::AttnArgs* p, void* stream) {
  using namespace egoego;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (p->is_bf16 && p->d_k == kHD && p->d_v == kHD && p->ld_qkv % 8 == 0 && p->ld_ctx % 8 == 0 &&
      reinterpret_cast<size_t>(p->qkv) % 16 == 0 && reinterpret_cast<size_t>(p->ctx) % 16 == 0) {
    const TcLayout L(p->t_keys);
    cudaError_t err = cudaFuncSetAttribute(attention_tc_kernel,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
    if (err != cudaSuccess) return (int)err;
    const dim3 grid((p->T + kTQ - 1) / kTQ, p->n_head, p->B);
    attention_tc_kernel<<<grid, kThreads, L.total, s>>>(*p);
    return (int)cudaGetLastError();
  }
  if (p->d_v > kThreads) return (int)cudaErrorInvalidValue;
  const int tk_pad = (p->t_keys + kBKV - 1) / kBKV * kBKV;
  const int ld_kv = (p->d_k > p->d_v ? p->d_k : p->d_v) + 1;
  const size_t smem = sizeof(float) * ((size_t)kBQ * p->d_k + (size_t)kBKV * ld_kv + (size_t)kBQ * tk_pad);
  cudaError_t err =
      cudaFuncSetAttribute(attention_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p->T + kBQ - 1) / kBQ, p->n_head, p->B);
  attention_kernel<<<grid, kThreads, smem, s>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" int egoego_attn_args_size() { return (int)sizeof(egoego::AttnArgs); }
