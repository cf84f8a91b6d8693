// Tiled GEMMs with fused epilogues: the matrix products of the denoise step.
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
// it. Three kernels, and the mode alone picks one:
//
// gemm_wgmma_kernel, the four products of every DecoderLayer in bf16
// (kBias for QKV, kLayerNorm for fc and w2, kBiasRelu for w1). wgmma is the
// only instruction that reaches the card's full bf16 rate, so: one producer
// warpgroup, of which one thread issues TMA loads (cp.async.bulk.tensor) of
// 64-deep k-tiles of A (M, K) and W (N, K), both bf16 and K-major, into a
// ring of shared-memory stages with the 128-byte swizzle, each stage guarded
// by a full and an empty mbarrier; two consumer warpgroups run
// wgmma.m64n256k16 on each stage as it lands, keep one k-tile of products in
// flight, and hand the stage back when its products are done. setmaxnreg
// gives the consumers the registers of their 128-float accumulators. The
// bias/ReLU modes take 128 x 256 tiles (each warpgroup 64 rows), 4 stages of
// 48 KB, and write bf16 through 9 KB of staging a warpgroup (store_block),
// so that every store instruction writes whole 128-byte rows (from the
// fragment itself each would write 8 rows of 16 bytes). The LayerNorm modes
// need whole rows, so 64 x 512 tiles (each warpgroup one 256-column half),
// 3 stages of 72 KB, and write f32 and its bf16 copy. The 128-float
// accumulators allow one block an SM, so the kernel is persistent (one
// block an SM, tiles round-robin) and runs its epilogue on the accumulators
// in registers (wgmma_epilogue): the ring stays the producer's, which
// loads the next tile while the consumers finish this one. The LayerNorm
// row statistics cross the two warpgroups through 1 KB of shared memory.
// TMA zero-fills rows and k-columns past the edges; the epilogue masks its
// stores. A is bf16 in device memory: the epilogues that write the f32
// inputs of the next products (the stem, the LayerNorms) also write a bf16
// copy (out_b), which is the rounding _layer_body does at the product
// (x.astype(cdt)), so no number changes. The TMA descriptors are encoded on
// the host for each call by cuTensorMapEncodeTiled, looked up in libcuda at
// run time (the library links only the CUDA runtime).
//
// gemm_bf16_kernel, the stem's and the update's products (kStem, kStep):
// WMMA 16x16x16 from 128x128 tiles fed by a three-stage cp.async pipeline.
// Their A is not one tiled box for TMA: the stem's rows are 198 f32 wide
// (792 bytes, not a multiple of 16) and split over x and x_cond; the
// update skips token 0 of every window (a_row).
//
// gemm_f32_kernel, every mode in f32 on the CUDA cores (no TF32), for
// parity checks.
//
// Rounding points follow _layer_body: A is rounded to bf16 before the
// product, the epilogue adds the f32 bias and rounds the output to bf16
// only where the TPU kernel cast it (q/k/v, the ReLU hidden). LayerNorm
// statistics, the carry and the posterior update stay f32.

#include <cuda.h>
#include <dlfcn.h>
#include <mma.h>

#include <cstdint>

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
  const void* w;          // (K, ldw) row-major, or (N, ldw = K) if w_nk; bf16 in bf16 mode, f32 in f32 mode
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
  void* out_b;            // kLayerNorm/kStem: bf16 copy of the f32 out, or null
  int M, N, K;
  int lda, ldw, ldo;
  int k_split;            // kStem: columns taken from a; the rest come from a2
  int a_bf16, out_bf16, compute_bf16;
  int mode;
  int t_data;             // kStem/kStep: frames per window (tokens = t_data + 1)
  int w_nk;               // w is (N, K): the layer modes
  int wgmma;              // set by egoego_gemm: 1 if it launched gemm_wgmma_kernel
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

__device__ __forceinline__ void store8_bf16(__nv_bfloat16* dst, const float (&v)[8]) {
  union { uint4 u; __nv_bfloat162 h[4]; } b;
#pragma unroll
  for (int j = 0; j < 4; ++j) b.h[j] = __floats2bfloat162_rn(v[2 * j], v[2 * j + 1]);
  *reinterpret_cast<uint4*>(dst) = b.u;
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
    __nv_bfloat16* out_b = static_cast<__nv_bfloat16*>(p.out_b);
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
        if (c >= p.N) continue;
        const float o = ((y[j] - mean) * inv * p.ln_s[c] + p.ln_b[c]) * m;
        out[(size_t)R * p.ldo + c] = o;
        if (out_b != nullptr) out_b[(size_t)R * p.ldo + c] = __float2bfloat16(o);
      }
    }
    return;
  }

  // eight consecutive columns per thread: two 16-byte reads of the tile
  // and 16-byte stores where the row layout allows
  const bool vec = p.ldo % 8 == 0 && p.N % 8 == 0 && reinterpret_cast<size_t>(p.out) % 16 == 0 &&
                   reinterpret_cast<size_t>(p.out_b) % 16 == 0;
  for (int i = tid; i < BM * BN / 8; i += kThreads) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const int R = m0 + r, C = n0 + c;
    if (R >= p.M || C >= p.N) continue;
    const float4 a0 = *reinterpret_cast<const float4*>(Cs + r * LDC + c);
    const float4 a1 = *reinterpret_cast<const float4*>(Cs + r * LDC + c + 4);
    float v[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (C + j < p.N) v[j] = epilogue_value(p, v[j], R, C + j);
    }
    const size_t o = (size_t)R * p.ldo + C;
    if (vec) {
      if (p.out_bf16) {
        store8_bf16(static_cast<__nv_bfloat16*>(p.out) + o, v);
      } else {
        float4* f = reinterpret_cast<float4*>(static_cast<float*>(p.out) + o);
        f[0] = make_float4(v[0], v[1], v[2], v[3]);
        f[1] = make_float4(v[4], v[5], v[6], v[7]);
      }
      if (p.out_b != nullptr) store8_bf16(static_cast<__nv_bfloat16*>(p.out_b) + o, v);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (C + j >= p.N) break;
        store_f(p.out, o + j, v[j], p.out_bf16);
        if (p.out_b != nullptr) store_f(p.out_b, o + j, v[j], 1);
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

// -- gemm_wgmma_kernel: TMA + mbarrier ring + wgmma (see the note at the top) --

constexpr int kWgBK = 64;         // k-tile depth: 64 bf16 = one 128-byte swizzle row
constexpr int kWgThreads = 384;   // consumer warpgroups 0 and 1 (threads 0-255), producer 2

// In the bias/ReLU modes each consumer warpgroup stages its bf16 output
// through 64 rows of 128 bytes (64 columns) of shared memory, padded to 144
// bytes so that the fragment's stores hit every bank once.
struct OutStage {
  static constexpr int kRow = 144;
  static constexpr int kBytes = 64 * kRow;
};

// BM x BN tile, STAGES-deep ring. SPLIT_N: the two consumer warpgroups take
// the two 256-column halves of BM = 64 rows (the LayerNorm modes, BN = 512);
// otherwise each takes 64 of BM = 128 rows at BN = 256.
template <int BM, int BN, int STAGES, bool SPLIT_N>
struct WgTile {
  static_assert(SPLIT_N ? (BM == 64 && BN == 512) : (BM == 128 && BN == 256), "two m64n256 warpgroups");
  static constexpr int kA = BM * kWgBK * 2, kB = BN * kWgBK * 2, kStage = kA + kB;
  static constexpr size_t kRing = (size_t)STAGES * kStage;
  static constexpr size_t kOut = SPLIT_N ? 0 : 2 * OutStage::kBytes;
  // ring (1024-byte aligned for the swizzle), output staging, barriers
  static constexpr size_t kSmem = kRing + kOut + 2 * STAGES * sizeof(uint64_t) + 1024;
  static_assert(kSmem <= 227 * 1024, "shared memory of one block");
};

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Returns once the barrier's phase of this parity has completed. A phase
// that never completes (a fault in the ring's accounting) traps after ~2^34
// cycles (~9 s) instead of holding the card forever.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const long long t0 = clock64();
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (!done && clock64() - t0 > (1ll << 34)) __trap();
  }
}

// TMA: the box at (inner coordinate c0, row c1) of the map into shared
// memory; the barrier counts its bytes.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows with the 128-byte
// swizzle, at a 1024-byte aligned base (+ 32 bytes per k16 step): 8-row
// groups 1024 bytes apart (SBO 64 x 16 B); LBO is not read for this layout.
__device__ __forceinline__ uint64_t wg_desc(const void* tile) {
  return ((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// d (64 x 256 f32, the m64n256 fragment) += A (64 x 16) W^T (16 x 256), both from shared memory.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t desc_a, uint64_t desc_w) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127""}, %128, %129, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(desc_a), "l"(desc_w), "r"(1));  // scale-d 1: d += A W^T
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// barrier 1 over the two consumer warpgroups only (the producer has left)
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }
// barrier 2 + wg over consumer warpgroup wg alone
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// Stores a consumer warpgroup's 64 x 256 block of bf16 outputs, held in the
// m64n256 fragment (element 4j + 2h + e: row rl + 8h, column 8j + 2q + e,
// with rl = 16 warp + lane / 4 and q = lane % 4), at (r0, c0) of out: 64
// columns at a time through the warpgroup's staging rows, from which each
// thread stores 16-byte pieces, eight threads to a row, so every store
// instruction writes whole rows of 128 bytes. N % 8 == 0.
__device__ __forceinline__ void store_block(const GemmArgs& p, const float (&acc)[128], unsigned char* stage, int r0,
                                            int c0) {
  const int t = threadIdx.x % 128, lane = t % 32, wg = threadIdx.x / 128;
  const int rl = 16 * (t / 32) + lane / 4, q = lane % 4;
#pragma unroll
  for (int j0 = 0; j0 < 32; j0 += 8) {
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<__nv_bfloat162*>(stage + (rl + 8 * h) * OutStage::kRow + (8 * jj + 2 * q) * 2) =
            __floats2bfloat162_rn(acc[4 * (j0 + jj) + 2 * h], acc[4 * (j0 + jj) + 2 * h + 1]);
      }
    }
    warpgroup_sync(wg);
#pragma unroll
    for (int i = t; i < 64 * 8; i += 128) {
      const int row = i / 8, piece = i % 8;
      const int R = r0 + row, C = c0 + 8 * (j0 + piece);
      if (R < p.M && C < p.N) {
        const uint4 v = *reinterpret_cast<const uint4*>(stage + row * OutStage::kRow + piece * 16);
        *reinterpret_cast<uint4*>(static_cast<__nv_bfloat16*>(p.out) + (size_t)R * p.ldo + C) = v;
      }
    }
    warpgroup_sync(wg);  // the staging rows are free again
  }
}

// The wgmma kernel's epilogue, on the accumulators where they are: element
// 4j + {0, 1} of a thread is (row r, columns c + 8j + {0, 1}) and 4j + {2, 3}
// is row r + 8, with r = row0 + 16 warp + lane / 4 and c = col0 + 2 (lane % 4)
// (the m64nNk16 fragment). So each row of the warpgroup's 64 x 256 block
// lies in one quad of lanes, and every load is a column pair. The bias/ReLU
// modes turn the values into outputs in place and store them through
// `stage` (store_block); the LayerNorm modes store column pairs straight
// from the fragment (staging their f32 rows too gained them under 10% and
// cost a ring stage and spills). Same arithmetic as epilogue() for these
// modes; N % 8 == 0.
template <bool SPLIT_N>
__device__ __forceinline__ void wgmma_epilogue(const GemmArgs& p, float (&acc)[128], unsigned char* stage, int m0,
                                               int n0, int row0, int col0) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32;
  const int c = n0 + col0 + 2 * (lane % 4);
  if constexpr (!SPLIT_N) {  // kBias, kBiasRelu
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int C = c + 8 * j;
      if (C < p.N) {
        const float2 b = *reinterpret_cast<const float2*>(p.bias + C);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& v0 = acc[4 * j + 2 * h];
          float& v1 = acc[4 * j + 2 * h + 1];
          v0 += b.x, v1 += b.y;
          if (p.mode == kBiasRelu) v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f);
        }
      }
    }
    store_block(p, acc, stage, m0 + row0, n0 + col0);
  } else {  // kLayerNorm: the two warpgroups hold the two column halves of the same 64 rows
    __shared__ float part[2][2][64];  // [statistic][warpgroup][row]: row sums over each half
    const int wg = threadIdx.x / 128, rl = 16 * warp + lane / 4;
    const int R[2] = {m0 + row0 + rl, m0 + row0 + rl + 8};
    auto store = [&](int r, int C, float v0, float v1, void* out, int is_bf16) {
      const size_t o = (size_t)r * p.ldo + C;
      if (is_bf16) {
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(out) + o) = __floats2bfloat162_rn(v0, v1);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + o) = make_float2(v0, v1);
      }
    };
    // y = (A W + b) + res, in place; columns past N stay 0 and out of the sums
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int C = c + 8 * j;
      if (C < p.N) {
        const float2 b = *reinterpret_cast<const float2*>(p.bias + C);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float2 r = R[h] < p.M ? *reinterpret_cast<const float2*>(p.res + (size_t)R[h] * p.N + C)
                                      : make_float2(0.f, 0.f);
          float& y0 = acc[4 * j + 2 * h];
          float& y1 = acc[4 * j + 2 * h + 1];
          y0 = (y0 + b.x) + r.x;
          y1 = (y1 + b.y) + r.y;
          s[h] += y0 + y1;
        }
      }
    }
    // a row statistic: the quad's sum, then both warpgroups' halves
    auto row_total = [&](float (&v)[2], int stat) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        v[h] += __shfl_xor_sync(0xffffffffu, v[h], 1);
        v[h] += __shfl_xor_sync(0xffffffffu, v[h], 2);
        if (lane % 4 == 0) part[stat][wg][rl + 8 * h] = v[h];
      }
      consumer_sync();
#pragma unroll
      for (int h = 0; h < 2; ++h) v[h] = part[stat][0][rl + 8 * h] + part[stat][1][rl + 8 * h];
    };
    row_total(s, 0);
    const float mean[2] = {s[0] / p.N, s[1] / p.N};
    float q[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      if (c + 8 * j < p.N) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const float d0 = acc[4 * j + 2 * h] - mean[h], d1 = acc[4 * j + 2 * h + 1] - mean[h];
          q[h] += d0 * d0 + d1 * d1;
        }
      }
    }
    row_total(q, 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const float inv = rsqrtf(q[h] / p.N + 1e-5f), m = R[h] < p.M ? p.row_mask[R[h]] : 0.f;
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int C = c + 8 * j;
        if (C < p.N && R[h] < p.M) {
          const float2 g = *reinterpret_cast<const float2*>(p.ln_s + C);
          const float2 b = *reinterpret_cast<const float2*>(p.ln_b + C);
          const float o0 = ((acc[4 * j + 2 * h] - mean[h]) * inv * g.x + b.x) * m;
          const float o1 = ((acc[4 * j + 2 * h + 1] - mean[h]) * inv * g.y + b.y) * m;
          store(R[h], C, o0, o1, p.out, 0);
          if (p.out_b != nullptr) store(R[h], C, o0, o1, p.out_b, 1);
        }
      }
    }
  }
}

template <int BM, int BN, int STAGES, bool SPLIT_N>
__global__ void __launch_bounds__(kWgThreads, 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
                      const GemmArgs p) {
  using T = WgTile<BM, BN, STAGES, SPLIT_N>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>((reinterpret_cast<size_t>(smem_raw) + 1023) & ~size_t(1023));
  unsigned char* out_stage = ring + T::kRing;  // OutStage::kBytes per consumer warpgroup (bias/ReLU modes)
  uint64_t* full = reinterpret_cast<uint64_t*>(out_stage + T::kOut);
  uint64_t* empty = full + STAGES;
  // persistent: block b takes tiles b, b + gridDim.x, ..., columns fastest;
  // the ring runs on across tiles, so the next tile's loads overlap this
  // tile's epilogue
  const int n_tiles = (p.N + BN - 1) / BN, tiles = n_tiles * ((p.M + BM - 1) / BM);
  const int nk = (p.K + kWgBK - 1) / kWgBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, plus the TMA bytes
      mbar_init(&empty[s], 2);  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    // producer: one thread keeps the ring full; it = k-tiles issued so far
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 256) {
      int it = 0;
      for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
        const int m0 = t / n_tiles * BM, n0 = t % n_tiles * BN;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
          unsigned char* st = ring + (size_t)s * T::kStage;
          mbar_expect_tx(&full[s], T::kStage);
          tma_load_2d(st, &map_a, &full[s], kt * kWgBK, m0);
#pragma unroll
          for (int h = 0; h < BN / 256; ++h)
            tma_load_2d(st + T::kA + h * 256 * 128, &map_w, &full[s], kt * kWgBK, n0 + h * 256);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows row0.. row0 + 63 and columns col0.. col0 + 255 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int row0 = SPLIT_N ? 0 : 64 * wg, col0 = SPLIT_N ? 256 * wg : 0;
    const bool leader = threadIdx.x % 128 == 0;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      float acc[128];
#pragma unroll
      for (int i = 0; i < 128; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const unsigned char* st = ring + (size_t)s * T::kStage;
        const uint64_t da = wg_desc(st + row0 * 128), dw = wg_desc(st + T::kA + col0 * 128);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk) wgmma_m64n256k16(acc, da + 2 * kk, dw + 2 * kk);
        wgmma_commit();
        // the products of the previous k-tile are done: hand its stage back
        wgmma_wait<1>();
        if (kt > 0 && leader) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
      if (leader) mbar_arrive(&empty[(it - 1) % STAGES]);
      wgmma_epilogue<SPLIT_N>(p, acc, out_stage + wg * OutStage::kBytes, t / n_tiles * BM, t % n_tiles * BN,
                              row0, col0);
    }
  }
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
      Ws[r * T::LDW + c] = (k < p.K && n < p.N) ? W[p.w_nk ? (size_t)n * p.ldw + k : (size_t)k * p.ldw + n] : 0.f;
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

// cuTensorMapEncodeTiled from libcuda.so.1, which the CUDA runtime has loaded
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static EncodeTiled encode_tiled() {
  static EncodeTiled fn = [] {
    void* lib = dlopen("libcuda.so.1", RTLD_NOW | RTLD_NOLOAD);
    if (lib == nullptr) lib = dlopen("libcuda.so.1", RTLD_NOW);
    return lib == nullptr ? nullptr : reinterpret_cast<EncodeTiled>(dlsym(lib, "cuTensorMapEncodeTiled"));
  }();
  return fn;
}

// TMA map of a row-major bf16 (rows, cols) matrix with row stride ld,
// boxes of box_rows x 64 columns with the 128-byte swizzle; out-of-bounds
// elements read as zeros.
static bool tma_map(CUtensorMap* map, const void* base, int rows, int cols, int ld, int box_rows) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kWgBK, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int BM, int BN, int STAGES, bool SPLIT_N>
static cudaError_t launch_wgmma(const GemmArgs& p, cudaStream_t stream) {
  using T = WgTile<BM, BN, STAGES, SPLIT_N>;
  CUtensorMap map_a, map_w;
  if (!tma_map(&map_a, p.a, p.M, p.K, p.lda, BM) || !tma_map(&map_w, p.w, p.N, p.K, p.ldw, 256))
    return cudaErrorInvalidValue;
  auto kernel = gemm_wgmma_kernel<BM, BN, STAGES, SPLIT_N>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (err != cudaSuccess) return err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const int tiles = ((p.N + BN - 1) / BN) * ((p.M + BM - 1) / BM);
  kernel<<<tiles < sms ? tiles : sms, kWgThreads, T::kSmem, stream>>>(map_a, map_w, p);  // one block an SM
  return cudaGetLastError();
}

}  // namespace egoego

// Launches one product; the mode and the compute type alone pick the kernel.
// Sets p->wgmma to 1 when it launched gemm_wgmma_kernel.
extern "C" int egoego_gemm(egoego::GemmArgs* p, void* stream) {
  using namespace egoego;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const bool ln = p->mode == kLayerNorm;
  p->wgmma = 0;
  if (ln && p->N > 512) return (int)cudaErrorInvalidValue;
  if (p->compute_bf16 && (p->mode == kBias || p->mode == kBiasRelu || ln)) {
    // bf16 A (M, K) and W (N, K), K-major; out bf16 (f32 for the LayerNorm);
    // 16-byte aligned rows and bases; N % 8 == 0
    if (!p->a_bf16 || !p->w_nk || p->out_bf16 == (int)ln || p->K % 8 != 0 || p->N % 8 != 0 || p->lda % 8 != 0 ||
        p->ldw % 8 != 0 || p->ldo % 8 != 0 || reinterpret_cast<size_t>(p->a) % 16 != 0 ||
        reinterpret_cast<size_t>(p->w) % 16 != 0 || reinterpret_cast<size_t>(p->out) % 16 != 0 ||
        reinterpret_cast<size_t>(p->out_b) % 16 != 0)
      return (int)cudaErrorInvalidValue;
    const cudaError_t err = ln ? launch_wgmma<64, 512, 3, true>(*p, s) : launch_wgmma<128, 256, 4, false>(*p, s);
    p->wgmma = err == cudaSuccess;
    return (int)err;
  }
  if (p->compute_bf16) {  // kStem, kStep
    if (p->ldw % 8 != 0 || p->w_nk) return (int)cudaErrorInvalidValue;  // 16-byte weight rows
    return (int)launch(gemm_bf16_kernel<128, 128, 32, 2, 3>, Bf16Tile<128, 128, 32, 2, 3>::kSmem, 128, 128, *p, s);
  }
  if (ln) return (int)launch(gemm_f32_kernel<32, 512>, F32Tile<32, 512>::kSmem, 32, 512, *p, s);
  return (int)launch(gemm_f32_kernel<64, 128>, F32Tile<64, 128>::kSmem, 64, 128, *p, s);
}

extern "C" int egoego_gemm_args_size() { return (int)sizeof(egoego::GemmArgs); }
