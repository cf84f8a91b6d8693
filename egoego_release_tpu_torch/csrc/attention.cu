// Multi-head self-attention of one post-LN DecoderLayer.
//
// Replaces the per-(batch, head) attention loop inside
// egoego_release_tpu/ops/fused_layer.py _layer_body (used by the TPU kernels
// _stem_layer_kernel, _layer_kernel and _layer_epilogue_kernel): scores
// q k^T * scale, keys at or past t_keys set to -inf (pad-to-tile keys only:
// a padding-mask zero inside t_keys stays a visible key), an exact f32
// softmax (the row's max, exp, the sum, a divide: no online rescaling, whose
// rounding points would differ), p rounded to bf16 before p v in bf16 mode,
// and ctx rounded to bf16 for the fc product. Its plain version is
// ops/fused_layer.py attention_plain.
//
// Three kernels; the wrapper (ops/cuda_kernels.py attention) picks one and
// names it in AttnArgs.kernel, and a layout that kernel cannot take is
// refused, never handed to another:
//
//  - attention_wgmma_kernel: bf16 at head width 256 (the release model)
//    with T <= 128 tokens, so every path at the release window (121 tokens,
//    31 at the tail). What bounds it on the H100: ~3.8 GFLOP against ~63 MB
//    of q, k, v and ctx at 64 x 121 tokens, so bytes (0.019 ms at 3.35 TB/s
//    against 0.004 ms of bf16 tensor-core time), and a block must keep the
//    memory busy while another computes. One block per (64 queries, head,
//    batch), one warpgroup (the m64 of wgmma): one thread issues the TMA
//    loads of Q and K at the start (a 3-D map over qkv viewed as (columns,
//    T, B), 64-column boxes at the 128-byte swizzle; rows past T read as
//    zeros), each 64-column box on its own mbarrier, so q k^T starts on the
//    first box to land; V's box c takes K's box c's buffer as soon as q k^T
//    is done with it, so V lands while q k^T and the softmax run, and p v
//    starts on V's first box. A whole score row fits in one wgmma accumulator
//    (m64nNk16, N = 32, 64 or 128 keys, the smallest that holds t_keys), so
//    the two-pass softmax runs in registers (the quad of lanes that holds a
//    row reduces with two shuffles), and p, rounded to bf16, becomes the A
//    operand of p v straight from the accumulator's registers (RS wgmma,
//    m64n64k16 per V box, V through the transpose-B immediate: V is stored
//    (key, d_v), MN-major for B). ctx is rounded to bf16, staged in the
//    block's Q rows (XOR-swizzled 16-byte pieces) and stored in whole
//    512-byte rows. Shared memory: Q 32 KB, K then V 8 KB per 32 keys; with
//    ~250 registers a thread, two blocks an SM (512 blocks at 64 x 121
//    tokens), each one's loads under the other's products. The two query
//    blocks of a (batch, head) are neighbours in the grid, so the second
//    reads K and V from L2. No producer warp: with one tile a block, every
//    load is in flight before it is needed. Where the time goes:
//    tools/attention_variants.py.
//  - attention_tc_kernel: bf16 at head width 256 past 128 tokens (the CLIs'
//    --window > 127), where K and V no longer fit beside Q: WMMA (16x16x16,
//    f32 accumulation), 32 queries a block, K and V streamed in 64-row
//    tiles, the score rows in f32 shared memory.
//  - attention_kernel: f32 mode and other head widths, f32 FMA on the CUDA
//    cores, one block per (16 queries, head, batch); K and V stream through
//    in tiles and the full score rows of a query tile stay in shared memory.

#include <mma.h>

#include "common.cuh"
#include "hopper.cuh"

namespace egoego {

struct AttnArgs {
  const void* qkv;  // (B*T, ld_qkv): q at [0, H*dk), k at [H*dk, 2H*dk), v after
  void* ctx;        // (B*T, ld_ctx): head h at [h*dv, (h+1)*dv)
  int B, T, t_keys, n_head, d_k, d_v, ld_qkv, ld_ctx;
  int is_bf16;
  int kernel;  // the wrapper's pick: kCudaCore, kWmma or kWgmma
  float scale;
};

enum AttnKernel : int { kCudaCore = 0, kWmma = 1, kWgmma = 2 };

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

// bf16 mode at head width 256 past 128 tokens: the two products on the
// tensor cores (WMMA, f32 accumulation), 32 queries per block, keys and
// values streamed in 64-row bf16 tiles. Scores are scaled and stored f32,
// the softmax is the same exact two-pass f32 one, p is rounded to bf16 for
// p v, and ctx is rounded to bf16 once on the way out.
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

// -- attention_wgmma_kernel (see the note at the top) -------------------------

constexpr int kWgRows = 64;    // queries of one consumer warpgroup (the m64 of wgmma)
constexpr int kBox = 64 * 2;   // bytes of one row of a 64-column TMA box: one 128-byte swizzle row
constexpr int kBoxes = kHD / 64;  // 64-column boxes of a head

// Shared memory of a block for key tile NK: K, later V, 4 boxes of NK
// rows; Q, 4 boxes of 64 rows; an mbarrier per box of Q and K, and per box
// of V.
template <int NK>
struct WgAttn {
  static_assert(NK == 32 || NK == 64 || NK == 128, "key tile");
  static constexpr int kBoxKV = NK * kBox;                   // one 64-column box of K or V
  static constexpr int kKV = kBoxes * kBoxKV;                // K or V of the head
  static constexpr int kBoxQ = kWgRows * kBox;               // one box of the Q rows
  static constexpr int kQ = kBoxes * kBoxQ;                  // the Q rows; later the ctx staging
  static constexpr size_t kSmem = kKV + kQ + 2 * kBoxes * sizeof(uint64_t) + 1024;
};

// d (64 x N f32, the m64nN fragment) += A (64 x 16) B^T (16 x N), A and B
// K-major in shared memory (128-byte swizzle)
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t desc_a, uint64_t desc_b);

template <>
__device__ __forceinline__ void wgmma_ss<32>(float (&d)[16], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, %16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<64>(float (&d)[32], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

template <>
__device__ __forceinline__ void wgmma_ss<128>(float (&d)[64], uint64_t desc_a, uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(desc_a), "l"(desc_b), "r"(1));
}

// d (64 x 64 f32) += A (64 x 16 bf16, in registers as the m64nNk16 A
// fragment) B (16 x 64, MN-major in shared memory: the transpose-B
// immediate is 1)
__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t (&a)[4], uint64_t desc_b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b), "r"(1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  union { __nv_bfloat162 h; uint32_t u; } v;
  v.h = __floats2bfloat162_rn(lo, hi);
  return v.u;
}

// One block (one warpgroup) per (64 queries, head, batch). Element 4j +
// 2r + e of a thread's m64nN fragment is (row 16 warp + lane / 4 + 8 r,
// column 8 j + 2 (lane % 4) + e) of the block's tile, so each row lies in
// one quad of lanes.
template <int NK>
__global__ void __launch_bounds__(128, 2)
    attention_wgmma_kernel(const __grid_constant__ CUtensorMap map_q, const __grid_constant__ CUtensorMap map_kv,
                           const AttnArgs p) {
  using L = WgAttn<NK>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* KVs = reinterpret_cast<unsigned char*>((reinterpret_cast<size_t>(smem_raw) + 1023) & ~size_t(1023));
  unsigned char* Qs = KVs + L::kKV;
  uint64_t* bar = reinterpret_cast<uint64_t*>(Qs + L::kQ);  // [c] Q and K box c, [kBoxes + c] V box c
  const int q0 = kWgRows * blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int v_col = (2 * p.n_head + h) * kHD;

  if (tid == 0) {
    for (int i = 0; i < 2 * kBoxes; ++i) mbar_init(&bar[i], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    const int q_col = h * kHD, k_col = (p.n_head + h) * kHD;
#pragma unroll
    for (int c = 0; c < kBoxes; ++c) {
      mbar_expect_tx(&bar[c], L::kBoxQ + L::kBoxKV);
      tma_load_3d(Qs + c * L::kBoxQ, &map_q, &bar[c], q_col + 64 * c, q0, b);
      tma_load_3d(KVs + c * L::kBoxKV, &map_kv, &bar[c], k_col + 64 * c, 0, b);
    }
  }
  __syncthreads();  // the barriers are initialised

  // s = q k^T over d_k = 256: 4 k16 steps per box, a commit group per box
  float s[NK / 2];
#pragma unroll
  for (int i = 0; i < NK / 2; ++i) s[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < kBoxes; ++c) {
    mbar_wait(&bar[c], 0);
    const uint64_t da = wg_desc(Qs + c * L::kBoxQ), db = wg_desc(KVs + c * L::kBoxKV);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) wgmma_ss<NK>(s, da + 2 * kk, db + 2 * kk);
    wgmma_commit();
  }
  // as the products finish with K's box c, V's box c takes its buffer
  auto load_v = [&](int c) {
    __syncthreads();
    if (tid == 0) {
      mbar_expect_tx(&bar[kBoxes + c], L::kBoxKV);
      tma_load_3d(KVs + c * L::kBoxKV, &map_kv, &bar[kBoxes + c], v_col + 64 * c, 0, b);
    }
  };
  static_assert(kBoxes == 4, "one wait per box below");
  wgmma_wait<3>();
  load_v(0);
  wgmma_wait<2>();
  load_v(1);
  wgmma_wait<1>();
  load_v(2);
  wgmma_wait<0>();
  load_v(3);

  // the exact softmax of each row in f32: scale, mask, the row's max, exp,
  // the sum; p = e / sum rounded to bf16, packed as p v's A fragments
  const int q4 = lane % 4;
  float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = s[4 * j + 2 * r + e];
        v = 8 * j + 2 * q4 + e < p.t_keys ? v * p.scale : -INFINITY;
        mx[r] = fmaxf(mx[r], v);
      }
    }
  }
  float sum[2] = {0.f, 0.f};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
    mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
  }
#pragma unroll
  for (int j = 0; j < NK / 8; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        float& v = s[4 * j + 2 * r + e];
        v = expf(v - mx[r]);
        sum[r] += v;
      }
    }
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
    sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
  }
  // p = e / sum, the IEEE quotient (what a true divide gives), from the
  // row's correctly rounded reciprocal y: q = e y, then twice q + (e - q
  // sum) y, each residual exact in an fma. The first correction leaves q
  // within about half an ulp of e / sum; from there, with y within half an
  // ulp of 1 / sum, the second gives e / sum rounded to nearest (Markstein's
  // theorem; outside f32's subnormal range, far below a bf16 p's
  // resolution). Five instructions an element where a divide takes a dozen
  // and a branch.
  float y[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) y[r] = __frcp_rn(sum[r]);
  auto quotient = [&](float e, int r) {
    float q = e * y[r];
    q = fmaf(fmaf(-q, sum[r], e), y[r], q);
    return fmaf(fmaf(-q, sum[r], e), y[r], q);
  };
  // k16 step kk of p v takes keys 16 kk .. 16 kk + 15: fragment columns j =
  // 2 kk (registers 0: row r, 1: row r + 8) and 2 kk + 1 (registers 2, 3)
  uint32_t pa[NK / 16][4];
#pragma unroll
  for (int kk = 0; kk < NK / 16; ++kk) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = i % 2, base = 8 * kk + 4 * (i / 2) + 2 * r;
      pa[kk][i] = pack_bf16(quotient(s[base], r), quotient(s[base + 1], r));
    }
  }

  // ctx = p v over the NK keys (V's rows past T read as zeros, and p is
  // exactly 0 at keys past t_keys), box by box as V lands: the m64n64
  // products of V's box c are columns 64 c.. of the m64n256 fragment o,
  // its elements 32 c..
  float o[128];
#pragma unroll
  for (int i = 0; i < 128; ++i) o[i] = 0.f;
  wgmma_fence();
#pragma unroll
  for (int c = 0; c < kBoxes; ++c) {
    mbar_wait(&bar[kBoxes + c], 0);
#pragma unroll
    for (int kk = 0; kk < NK / 16; ++kk)
      wgmma_rs_n64(o + 32 * c, pa[kk], wg_desc_mn(KVs + c * L::kBoxKV + kk * 16 * kBox, L::kBoxKV));
  }
  wgmma_commit();
  wgmma_wait<0>();

  // ctx rounded to bf16 into the Q rows (the products are done with them):
  // row r's 16-byte piece j at piece j ^ (r % 8), so the fragment's 4-byte
  // stores and the 16-byte loads below meet every bank once; then whole
  // 512-byte rows of ctx, 32 threads to a row
  const int rl = 16 * warp + lane / 4;
#pragma unroll
  for (int j = 0; j < 32; ++j) {
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = rl + 8 * r;
      *reinterpret_cast<uint32_t*>(Qs + row * (kHD * 2) + ((j ^ (row % 8)) * 16) + 4 * q4) =
          pack_bf16(o[4 * j + 2 * r], o[4 * j + 2 * r + 1]);
    }
  }
  __syncthreads();
  __nv_bfloat16* ctx = static_cast<__nv_bfloat16*>(p.ctx);
#pragma unroll 4
  for (int i = tid; i < kWgRows * 32; i += 128) {
    const int row = i / 32, piece = i % 32, t = q0 + row;
    if (t < p.T)
      *reinterpret_cast<uint4*>(ctx + ((size_t)b * p.T + t) * p.ld_ctx + h * kHD + piece * 8) =
          *reinterpret_cast<const uint4*>(Qs + row * (kHD * 2) + ((piece ^ (row % 8)) * 16));
  }
}

// TMA maps over qkv viewed as (columns, T, B), boxes of 64 columns by 64
// query rows (map_q) or NK key rows (map_kv); the launch, one block per
// (64 queries, head, batch).
template <int NK>
static cudaError_t launch_wgmma(const AttnArgs& p, cudaStream_t stream) {
  const cuuint64_t dims[3] = {(cuuint64_t)p.ld_qkv, (cuuint64_t)p.T, (cuuint64_t)p.B};
  const cuuint64_t strides[2] = {(cuuint64_t)p.ld_qkv * 2, (cuuint64_t)p.ld_qkv * 2 * p.T};
  const cuuint32_t box_q[3] = {64, kWgRows, 1}, box_kv[3] = {64, NK, 1};
  CUtensorMap map_q, map_kv;
  if (!tma_map_bf16(&map_q, p.qkv, 3, dims, strides, box_q) ||
      !tma_map_bf16(&map_kv, p.qkv, 3, dims, strides, box_kv))
    return cudaErrorInvalidValue;
  const size_t smem = WgAttn<NK>::kSmem;
  auto kernel = attention_wgmma_kernel<NK>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  kernel<<<dim3((p.T + kWgRows - 1) / kWgRows, p.n_head, p.B), 128, smem, stream>>>(map_q, map_kv, p);
  return cudaGetLastError();
}

}  // namespace egoego

extern "C" int egoego_attention(const egoego::AttnArgs* p, void* stream) {
  using namespace egoego;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int invalid = (int)cudaErrorInvalidValue;
  if (p->B <= 0 || p->T <= 0 || p->t_keys <= 0 || p->t_keys > p->T) return invalid;
  // the tensor-core kernels: bf16 at head width 256, 16-byte rows and bases
  const bool tc = p->is_bf16 && p->d_k == kHD && p->d_v == kHD && p->ld_qkv % 8 == 0 && p->ld_ctx % 8 == 0 &&
                  p->ld_qkv >= 3 * kHD * p->n_head && p->ld_ctx >= kHD * p->n_head &&
                  reinterpret_cast<size_t>(p->qkv) % 16 == 0 && reinterpret_cast<size_t>(p->ctx) % 16 == 0;
  switch (p->kernel) {
    case kWgmma: {
      if (!tc || p->T > 128 || p->B > 65535) return invalid;
      return (int)(p->t_keys <= 32 ? launch_wgmma<32>(*p, s)
                                   : p->t_keys <= 64 ? launch_wgmma<64>(*p, s) : launch_wgmma<128>(*p, s));
    }
    case kWmma: {
      if (!tc) return invalid;
      const TcLayout L(p->t_keys);
      cudaError_t err = cudaFuncSetAttribute(attention_tc_kernel,
                                             cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.total);
      if (err != cudaSuccess) return (int)err;
      const dim3 grid((p->T + kTQ - 1) / kTQ, p->n_head, p->B);
      attention_tc_kernel<<<grid, kThreads, L.total, s>>>(*p);
      return (int)cudaGetLastError();
    }
    case kCudaCore: {
      if (p->d_v > kThreads) return invalid;
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
    default:
      return invalid;
  }
}

extern "C" int egoego_attn_args_size() { return (int)sizeof(egoego::AttnArgs); }
