// Tiled GEMM with fused epilogues: the matrix products of the denoise step.
//
// Replaces the matmuls inside the TPU kernels of egoego_release_tpu/ops:
//   fused_step.py  _stem_layer_kernel      (stem split-K + noise token + pos)
//   fused_layer.py _layer_body             (QKV, fc+LN, w1+ReLU, w2+LN)
//   fused_step.py  _layer_epilogue_kernel  (linear_out, clip, posterior
//                                           update, overlap inpaint)
// On the TPU one kernel held a whole layer's weights (~5 MB bf16) in VMEM.
// An H100 SM has 227 KB of shared memory, so here each product is its own
// launch and the elementwise work that followed it in the TPU kernel rides
// in that launch's epilogue, so no intermediate makes an extra trip through
// device memory.
//
// What bounds it on the H100: at the main path's shapes (64 windows x 121
// tokens, d_model 512) a layer is ~45 GFLOP against ~40 MB of traffic, far
// above the card's 295 FLOP/byte balance point, so the tensor cores bound
// it. The bf16 mode runs the products on them (WMMA 16x16x16, f32
// accumulation) from 128x128 tiles, fed by a three-stage cp.async
// pipeline of 16-byte copies, so the next tiles' loads are in flight while
// the current one is multiplied. The f32 mode is plain FMA on the CUDA
// cores (no TF32), for parity checks. wgmma and TMA are later work.
//
// Rounding points follow _layer_body: A is rounded to bf16 as it is loaded
// (x.astype(cdt)), the epilogue adds the f32 bias and rounds the output to
// bf16 only where the TPU kernel cast it (q/k/v, the ReLU hidden). LayerNorm
// statistics, the carry and the posterior update stay f32.

#include <mma.h>

#include "common.cuh"

using namespace nvcuda;

namespace egoego {

enum GemmMode : int {
  kBias = 0,      // out = A W + b
  kBiasRelu = 1,  // out = max(A W + b, 0)
  kLayerNorm = 2, // out = LN(A W + b + res) * mask[row]        (block owns rows)
  kStem = 3,      // out[b, 0] = emb + pos[0]; out[b, t+1] = [x|xc][b, t] W + b + pos[t+1]
  kStep = 4,      // out = a1 clip(A[b, t+1] W + b) + a2 x + a3 noise, then inpaint
};

struct GemmArgs {
  const void* a;          // (rows, lda), f32 or bf16
  const void* a2;         // kStem: x_cond, laid out like a
  const void* w;          // (K, ldw) row-major, bf16 in bf16 mode, f32 in f32 mode
  const float* bias;      // (N,)
  const float* res;       // kLayerNorm: residual (M, N)
  const float* ln_s;      // kLayerNorm: (N,)
  const float* ln_b;      // kLayerNorm: (N,)
  const float* row_mask;  // kLayerNorm: (M,) padding mask
  const float* pos;       // kStem: (t_data + 1, N) position rows
  const float* emb;       // kStem: (N,) noise-level token
  const float* x;         // kStep: (M, N) carry x_t
  const float* noise;     // kStep: (M, N)
  const float* ipv;       // kStep: (M, N) inpaint values, or null
  const float* ipm;       // kStep: (M,) inpaint row mask, or null
  void* out;              // (M, ldo)
  int M, N, K;
  int lda, ldw, ldo;
  int k_split;            // kStem: columns taken from a; the rest come from a2
  int a_bf16, out_bf16, compute_bf16;
  int mode;
  int t_data;             // kStem/kStep: frames per window (tokens = t_data + 1)
  float c1, c2, c3;       // kStep: the update scalars a1, a2, a3
};

// Row of A that feeds output row r (-1: a row of zeros).
__device__ __forceinline__ int a_row(const GemmArgs& p, int r) {
  if (p.mode == kStem) {
    const int tt = p.t_data + 1;
    const int t = r % tt;
    return t == 0 ? -1 : (r / tt) * p.t_data + t - 1;
  }
  if (p.mode == kStep) return (r / p.t_data) * (p.t_data + 1) + r % p.t_data + 1;
  return r;
}

__device__ __forceinline__ float load_a(const GemmArgs& p, int arow, int k) {
  if (arow < 0 || k >= p.K) return 0.f;
  if (p.mode == kStem && k >= p.k_split)
    return load_f(p.a2, (size_t)arow * p.lda + (k - p.k_split), p.a_bf16);
  return load_f(p.a, (size_t)arow * p.lda + k, p.a_bf16);
}

constexpr int kBK = 32;

// Epilogue of one element of the non-LayerNorm modes: acc = (A W)[R, C].
__device__ __forceinline__ float epilogue_value(const GemmArgs& p, float v, int R, int C) {
  const size_t e = (size_t)R * p.N + C;
  switch (p.mode) {
    case kBiasRelu:
      return fmaxf(v + p.bias[C], 0.f);
    case kStem: {
      const int t = R % (p.t_data + 1);
      return (t == 0 ? p.emb[C] : v + p.bias[C]) + p.pos[(size_t)t * p.N + C];
    }
    case kStep: {
      const float x0 = fminf(fmaxf(v + p.bias[C], -1.f), 1.f);
      const float xn = __fadd_rn(__fadd_rn(__fmul_rn(p.c1, x0), __fmul_rn(p.c2, p.x[e])),
                                 __fmul_rn(p.c3, p.noise[e]));
      return p.ipv != nullptr ? xn + p.ipm[R] * (p.ipv[e] - xn) : xn;
    }
    default:  // kBias
      return v + p.bias[C];
  }
}

// The epilogue on the f32 accumulator tile Cs (BM x BN, row stride LDC).
template <int BM, int BN, int LDC>
__device__ __forceinline__ void epilogue(const GemmArgs& p, const float* Cs, int m0, int n0) {
  const int tid = threadIdx.x;
  if (p.mode == kLayerNorm) {
    // One warp per row; the block holds all N <= BN columns of its rows.
    constexpr int PER_LANE = BN / 32;
    const int warp = tid >> 5, lane = tid & 31;
    float* out = static_cast<float*>(p.out);
    for (int r = warp; r < BM; r += 8) {
      const int R = m0 + r;
      if (R >= p.M) break;
      float y[PER_LANE];
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const int c = lane + 32 * j;
        y[j] = c < p.N ? (Cs[r * LDC + c] + p.bias[c]) + p.res[(size_t)R * p.N + c] : 0.f;
        s += y[j];
      }
      const float mean = warp_sum(s) / p.N;
      float v = 0.f;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const int c = lane + 32 * j;
        const float d = y[j] - mean;
        v += c < p.N ? d * d : 0.f;
      }
      const float inv = rsqrtf(warp_sum(v) / p.N + 1e-5f);
      const float m = p.row_mask[R];
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const int c = lane + 32 * j;
        if (c < p.N) out[(size_t)R * p.ldo + c] = ((y[j] - mean) * inv * p.ln_s[c] + p.ln_b[c]) * m;
      }
    }
    return;
  }

  // four consecutive columns per thread: one 16-byte read of the tile, and
  // one 8-byte (bf16) or 16-byte (f32) store where the row layout allows
  const bool vec = p.ldo % 4 == 0 && p.N % 4 == 0 && reinterpret_cast<size_t>(p.out) % 16 == 0;
  for (int i = tid; i < BM * BN / 4; i += kThreads) {
    const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
    const int R = m0 + r, C = n0 + c;
    if (R >= p.M || C >= p.N) continue;
    const float4 acc = *reinterpret_cast<const float4*>(Cs + r * LDC + c);
    float v[4] = {acc.x, acc.y, acc.z, acc.w};
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if (C + j < p.N) v[j] = epilogue_value(p, v[j], R, C + j);
    }
    const size_t o = (size_t)R * p.ldo + C;
    if (vec && p.out_bf16) {
      union { uint2 u; __nv_bfloat162 h[2]; } b;
      b.h[0] = __floats2bfloat162_rn(v[0], v[1]);
      b.h[1] = __floats2bfloat162_rn(v[2], v[3]);
      *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.out) + o) = b.u;
    } else if (vec) {
      *reinterpret_cast<float4*>(static_cast<float*>(p.out) + o) = make_float4(v[0], v[1], v[2], v[3]);
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        if (C + j < p.N) store_f(p.out, o + j, v[j], p.out_bf16);
      }
    }
  }
}

// bf16 tensor-core GEMM: 8 warps as WARPS_M x (8 / WARPS_M), FM x FN
// fragments of 16x16 each. STAGES-deep cp.async pipeline: each stage holds
// the raw A tile (f32 or bf16, as stored) and the bf16 W tile; before the
// products the raw A tile is rounded to bf16 into one compute buffer.
// A that cannot be copied in 16-byte pieces (the stem's 198-wide rows)
// is loaded element by element into the same f32 staging.
template <int BM, int BN, int BK, int WARPS_M, int STAGES>
struct Bf16Tile {
  static constexpr int WARPS_N = 8 / WARPS_M;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;
  static constexpr int FM = WM / 16, FN = WN / 16;
  static constexpr int LDA = BK + 8, LDW = BN + 8, LDC = BN + 4;
  static constexpr size_t kRawA = (size_t)BM * BK * 4;
  static constexpr size_t kStage = kRawA + (size_t)BK * LDW * 2;
  static constexpr size_t kMain = STAGES * kStage + (size_t)BM * LDA * 2;
  static constexpr size_t kEpi = (size_t)BM * LDC * 4;
  static constexpr size_t kSmem = kMain > kEpi ? kMain : kEpi;
};

template <int BM, int BN, int BK, int WARPS_M, int STAGES>
__global__ void __launch_bounds__(kThreads) gemm_bf16_kernel(const GemmArgs p) {
  using T = Bf16Tile<BM, BN, BK, WARPS_M, STAGES>;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int arows[BM];
  float* Cs = reinterpret_cast<float*>(smem);
  __nv_bfloat16* Ab = reinterpret_cast<__nv_bfloat16*>(smem + STAGES * T::kStage);

  const int tid = threadIdx.x, warp = tid >> 5;
  const int wm = warp / T::WARPS_N, wn = warp % T::WARPS_N;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  for (int i = tid; i < BM; i += kThreads) arows[i] = (m0 + i < p.M) ? a_row(p, m0 + i) : -1;
  const int a_vec = p.a_bf16 ? 8 : 4;  // elements per 16-byte piece
  const bool a_async = p.mode != kStem && p.K % a_vec == 0 && p.lda % a_vec == 0 &&
                       reinterpret_cast<size_t>(p.a) % 16 == 0;
  const bool raw_bf16 = a_async && p.a_bf16;
  const __nv_bfloat16* W = static_cast<const __nv_bfloat16*>(p.w);
  __syncthreads();

  const int nk = (p.K + BK - 1) / BK;
  auto issue = [&](int kt) {
    if (kt < nk) {
      unsigned char* st = smem + (kt % STAGES) * T::kStage;
      const int k0 = kt * BK;
      if (a_async) {
        const int per_row = BK / a_vec;
        const size_t esz = p.a_bf16 ? 2 : 4;
        for (int c = tid; c < BM * per_row; c += kThreads) {
          const int r = c / per_row, k = k0 + (c % per_row) * a_vec;
          const int arow = arows[r];
          const bool ok = arow >= 0 && k < p.K;
          const unsigned char* src = static_cast<const unsigned char*>(p.a) +
                                     (ok ? ((size_t)arow * p.lda + k) * esz : 0);
          cp_async16(st + (size_t)c * 16, src, ok);
        }
      } else {
        float* raw = reinterpret_cast<float*>(st);
        for (int i = tid; i < BM * BK; i += kThreads) raw[i] = load_a(p, arows[i / BK], k0 + i % BK);
      }
      __nv_bfloat16* Ws = reinterpret_cast<__nv_bfloat16*>(st + T::kRawA);
      for (int c = tid; c < BK * BN / 8; c += kThreads) {
        const int r = c / (BN / 8), cc = (c % (BN / 8)) * 8;
        const int k = k0 + r, n = n0 + cc;
        const bool ok = k < p.K && n < p.ldw;
        cp_async16(Ws + r * T::LDW + cc, ok ? W + (size_t)k * p.ldw + n : W, ok);
      }
    }
    cp_async_commit();
  };
  // raw A tile of stage `st` -> bf16 compute buffer Ab
  auto convert = [&](const unsigned char* st) {
    for (int c = tid; c < BM * BK / 8; c += kThreads) {
      const int r = c / (BK / 8), cc = (c % (BK / 8)) * 8;
      uint4 v;
      if (raw_bf16) {
        v = reinterpret_cast<const uint4*>(st)[c];
      } else {
        const float4* f = reinterpret_cast<const float4*>(st) + 2 * c;
        const float4 f0 = f[0], f1 = f[1];
        union { uint4 u; __nv_bfloat162 h[4]; } o;
        o.h[0] = __floats2bfloat162_rn(f0.x, f0.y);
        o.h[1] = __floats2bfloat162_rn(f0.z, f0.w);
        o.h[2] = __floats2bfloat162_rn(f1.x, f1.y);
        o.h[3] = __floats2bfloat162_rn(f1.z, f1.w);
        v = o.u;
      }
      *reinterpret_cast<uint4*>(Ab + r * T::LDA + cc) = v;
    }
  };

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[T::FM][T::FN];
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) issue(s);
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();
    __syncthreads();  // tile kt is in shared memory; the products of kt - 1 are done
    const unsigned char* st = smem + (kt % STAGES) * T::kStage;
    convert(st);
    issue(kt + STAGES - 1);
    __syncthreads();
    const __nv_bfloat16* Ws = reinterpret_cast<const __nv_bfloat16*>(st + T::kRawA);
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, __nv_bfloat16, wmma::row_major> fa[T::FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, __nv_bfloat16, wmma::row_major> fb[T::FN];
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
        wmma::load_matrix_sync(fa[i], Ab + (wm * T::WM + i * 16) * T::LDA + kk, T::LDA);
#pragma unroll
      for (int j = 0; j < T::FN; ++j)
        wmma::load_matrix_sync(fb[j], Ws + kk * T::LDW + wn * T::WN + j * 16, T::LDW);
#pragma unroll
      for (int i = 0; i < T::FM; ++i)
#pragma unroll
        for (int j = 0; j < T::FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();
  __syncthreads();
#pragma unroll
  for (int i = 0; i < T::FM; ++i)
#pragma unroll
    for (int j = 0; j < T::FN; ++j)
      wmma::store_matrix_sync(Cs + (wm * T::WM + i * 16) * T::LDC + wn * T::WN + j * 16, acc[i][j],
                              T::LDC, wmma::mem_row_major);
  __syncthreads();
  epilogue<BM, BN, T::LDC>(p, Cs, m0, n0);
}

// f32 GEMM on the CUDA cores: thread (tx, ty) owns rows ty + 8i, columns tx + 32j.
template <int BM, int BN>
struct F32Tile {
  static constexpr int LDA = kBK + 1, LDW = BN, LDC = BN + 4;
  static constexpr size_t kMain = (size_t)(BM * LDA + kBK * LDW) * 4;
  static constexpr size_t kEpi = (size_t)BM * LDC * 4;
  static constexpr size_t kSmem = kMain > kEpi ? kMain : kEpi;
};

template <int BM, int BN>
__global__ void __launch_bounds__(kThreads) gemm_f32_kernel(const GemmArgs p) {
  using T = F32Tile<BM, BN>;
  constexpr int RM = BM / 8, RN = BN / 32;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ int arows[BM];
  float* Cs = reinterpret_cast<float*>(smem);
  float* As = Cs;
  float* Ws = As + BM * T::LDA;
  const float* W = static_cast<const float*>(p.w);

  const int tid = threadIdx.x, tx = tid & 31, ty = tid >> 5;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  for (int i = tid; i < BM; i += kThreads) arows[i] = (m0 + i < p.M) ? a_row(p, m0 + i) : -1;
  __syncthreads();

  float acc[RM][RN];
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += kBK) {
    for (int i = tid; i < BM * kBK; i += kThreads) {
      const int r = i / kBK, c = i % kBK;
      As[r * T::LDA + c] = load_a(p, arows[r], k0 + c);
    }
    for (int i = tid; i < kBK * BN; i += kThreads) {
      const int r = i / BN, c = i % BN;
      const int k = k0 + r, n = n0 + c;
      Ws[r * T::LDW + c] = (k < p.K && n < p.N) ? W[(size_t)k * p.ldw + n] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBK; ++kk) {
      float a[RM];
#pragma unroll
      for (int i = 0; i < RM; ++i) a[i] = As[(ty + 8 * i) * T::LDA + kk];
#pragma unroll
      for (int j = 0; j < RN; ++j) {
        const float b = Ws[kk * T::LDW + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][j] = fmaf(a[i], b, acc[i][j]);
      }
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < RM; ++i)
#pragma unroll
    for (int j = 0; j < RN; ++j) Cs[(ty + 8 * i) * T::LDC + tx + 32 * j] = acc[i][j];
  __syncthreads();
  epilogue<BM, BN, T::LDC>(p, Cs, m0, n0);
}

template <typename Kernel>
static cudaError_t launch(Kernel kernel, size_t smem, int bm, int bn, const GemmArgs& p,
                          cudaStream_t stream) {
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + bn - 1) / bn, (p.M + bm - 1) / bm);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace egoego

extern "C" int egoego_gemm(const egoego::GemmArgs* p, void* stream) {
  using namespace egoego;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ln = p->mode == kLayerNorm;
  if (ln && p->N > 512) return (int)cudaErrorInvalidValue;
  if (p->compute_bf16) {
    if (p->ldw % 8 != 0) return (int)cudaErrorInvalidValue;  // 16-byte weight rows
    if (ln) return (int)launch(gemm_bf16_kernel<32, 512, 32, 1, 2>, Bf16Tile<32, 512, 32, 1, 2>::kSmem, 32, 512, *p, s);
    return (int)launch(gemm_bf16_kernel<128, 128, 32, 2, 3>, Bf16Tile<128, 128, 32, 2, 3>::kSmem, 128, 128, *p, s);
  }
  if (ln) return (int)launch(gemm_f32_kernel<32, 512>, F32Tile<32, 512>::kSmem, 32, 512, *p, s);
  return (int)launch(gemm_f32_kernel<64, 128>, F32Tile<64, 128>::kSmem, 64, 128, *p, s);
}

extern "C" int egoego_gemm_args_size() { return (int)sizeof(egoego::GemmArgs); }
