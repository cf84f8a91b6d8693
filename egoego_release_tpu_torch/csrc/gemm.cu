// Tiled GEMMs with fused epilogues: the matrix products of the denoise step.
//
// Replaces the matmuls inside the TPU kernels of egoego_release_tpu/ops:
//   fused_step.py  _stem_layer_kernel      (the stem x Wsx + xc Wsc + b, the
//                                           noise token, the position rows)
//   fused_layer.py _layer_body             (QKV, fc+LN, w1+ReLU, w2+LN)
//   fused_step.py  _layer_epilogue_kernel  (linear_out, clip, posterior
//                                           update, overlap inpaint)
// On the TPU one kernel held a whole layer's weights (~5 MB bf16) in VMEM.
// An H100 SM has 227 KB of shared memory, so here each product is its own
// launch and the elementwise work that followed it in the TPU kernel rides
// in that launch's epilogue, so no intermediate makes an extra trip through
// device memory. Two kernels; the mode and the compute type alone pick one.
//
// gemm_wgmma_kernel, every product in bf16. wgmma is the only instruction
// that reaches the card's full bf16 rate, so: one producer warpgroup, of
// which one thread issues TMA loads (cp.async.bulk.tensor) of 64-deep
// k-tiles of A (rows, K) and W (N, K), both bf16 and K-major, into a ring of
// shared-memory stages with the 128-byte swizzle, each stage guarded by a
// full and an empty mbarrier; two consumer warpgroups run wgmma on each
// stage as it lands, keep one k-tile of products in flight, and hand the
// stage back when its products are done. setmaxnreg gives the consumers the
// registers of their accumulators, which allow one block an SM, so the
// kernel is persistent (one block an SM, tiles round-robin) and runs its
// epilogue on the accumulators in registers (wgmma_epilogue): the ring stays
// the producer's, which loads the next tile while the consumers finish this
// one. TMA zero-fills rows and k-columns past the edges; the epilogues mask
// their stores. A is bf16 in device memory: the epilogues that write the
// inputs of later products also write a bf16 copy (out_b), which is the
// rounding the TPU kernels do at the product (x.astype(cdt)), so no number
// changes. The TMA descriptors are encoded on the host for each call by
// cuTensorMapEncodeTiled, looked up in libcuda at run time (the library
// links only the CUDA runtime). One instantiation per epilogue:
//
//  - kBias (QKV), kBiasRelu (w1): 128 x 256 tiles (each warpgroup 64 rows,
//    m64n256k16), 4 stages of 48 KB; bf16 out through 9 KB of staging a
//    warpgroup (store_block), so every store instruction writes whole
//    128-byte rows. QKV is bound by its operations, w1 by bytes.
//  - kLayerNorm (fc, w2): whole rows, so 64 x 512 tiles (each warpgroup one
//    256-column half), 3 stages of 72 KB; f32 out and its bf16 copy; the row
//    statistics cross the two warpgroups through 1 KB of shared memory.
//    Bound by bytes. With bf16 inter-layer activations (the TPU kernels'
//    act dtype, fused_step_act_bf16) fc reads its residual, the layer input,
//    as bf16 (res_bf16; the add stays f32) and w2 writes the layer output
//    as bf16 alone (out null, out_b), as the f32 kernel does too. Each of
//    these layouts is an instantiation of its own (kEpiLnResBf16,
//    kEpiLnBf16Out, kEpiLnBf16), so the f32-activation epilogue carries no
//    branch for them.
//  - kStem (the stem of _stem_layer_kernel). Bound by bytes: 3.1 GFLOP
//    against ~30 MB at 64 x 121 tokens. Its A on the TPU was two f32 tensors
//    of 198-wide rows (792 bytes, no TMA box). Here it is one packed bf16
//    buffer xa (B T, 400) = [bf16(x) | bf16(x_cond) | 0] of 800-byte rows,
//    whose x part the previous step's update writes (the window's first
//    step casts it), against W (512, 400). The product runs over the B T
//    data rows in 128 x 256 tiles, 120 of them at 64 x 121 tokens: one wave.
//    The epilogue maps product row r to output row r + r / T + 1 and adds
//    the bias and position row r % T + 1; the warpgroup that holds a
//    window's first data row also writes its token 0 (emb + pos[0]). A tile
//    straddles windows, so the f32 h and its bf16 copy leave through staging
//    rows one output row at a time (store_block_f32), every store
//    instruction whole 128-byte rows of f32, and bias and position rows are
//    added there from 16-byte loads.
//  - kStep (linear_out and the update of _layer_epilogue_kernel). Bound by
//    bytes: 1.6 GFLOP against ~30 MB of x, noise, inpaint values and
//    outputs. A is the last layer's bf16 copy (B (T+1), 512), the product
//    runs over all B (T+1) rows and drops token 0 of each window in the
//    epilogue (0.8% more products, and the same 2-D tensor map as every other
//    mode instead of a 3-D one); W (200, 512); N = 198 in 64 x 208 tiles,
//    each warpgroup a 104-column half (m64n104k16), so 121 blocks at 64 x
//    121 tokens where 128-row tiles would give 61. A tile's output rows are
//    one contiguous span of the f32 (B T, 198) arrays, so the epilogue
//    stages clip(A W + b) in shared memory and streams x, noise, the inpaint
//    values (and the row's inpaint mask) and x_next through the span in
//    16-byte pieces, all 256 consumer threads on consecutive addresses, each
//    with the loads of eight pieces in flight before it stores any (an L2
//    prefetch of the span at the tile's start, tried, moved nothing); then
//    it writes bf16(x_next) into the x part of xa, 16 bytes a store.
//  - kPartial (fc and w2 of a tensor-parallel layer): the f32 product A W
//    alone, no bias, in the LayerNorm modes' 64 x 512 tiles, stored from
//    the fragment. Each tp rank holds a slice of K, so its product is a
//    partial sum: the caller all-reduces it over the tp group, and
//    csrc/residual_layernorm.cu then adds the bias and the residual and
//    normalizes. Bound by bytes (K = 512 / tp). Its own instantiation
//    (kEpiPartial), so the LayerNorm epilogues carry no branch for it.
//
// gemm_f32_kernel, every mode in f32 on the CUDA cores (no TF32), for
// parity checks; there the stem reads x and x_cond (f32) itself.
//
// Rounding points follow _layer_body: A is rounded to bf16 before the
// product, the epilogue adds the f32 bias and rounds the output to bf16
// only where the TPU kernel cast it (q/k/v, the ReLU hidden; with bf16
// activations the layer output, out_shape dtype adt). LayerNorm statistics,
// the carry and the posterior update stay f32.

#include "common.cuh"
#include "hopper.cuh"

namespace egoego {

enum GemmMode : int {
  kBias = 0,      // out = A W + b
  kBiasRelu = 1,  // out = max(A W + b, 0)
  kLayerNorm = 2, // out = LN(A W + b + res) * mask[row]        (block owns rows)
  kStem = 3,      // out[b, 0] = emb + pos[0]; out[b, t+1] = [x|xc][b, t] W + b + pos[t+1]
  kStep = 4,      // out = a1 clip(A[b, t+1] W + b) + a2 x + a3 noise, then inpaint
  kPartial = 5,   // out = A W (f32; no bias: a tensor-parallel partial sum)
};

struct GemmArgs {
  const void* a;          // (rows, lda), f32 or bf16; kStem in bf16: xa (B t_data, lda)
  const void* a2;         // kStem in f32: x_cond, laid out like a
  const void* w;          // (N or more rows, ldw), K-major as nn.Linear; bf16 in bf16 mode, f32 in f32 mode
  const float* bias;      // (N,)
  const void* res;        // kLayerNorm: residual (M, N), f32 or (res_bf16) bf16
  const float* ln_s;      // kLayerNorm: (N,)
  const float* ln_b;      // kLayerNorm: (N,)
  const float* row_mask;  // kLayerNorm: (M,) padding mask
  const float* pos;       // kStem: (t_data + 1, N) position rows
  const float* emb;       // kStem: (N,) noise-level token
  const float* x;         // kStep: (M, N) carry x_t
  const float* noise;     // kStep: (M, N)
  const float* ipv;       // kStep: (M, N) inpaint values, or null
  const float* ipm;       // kStep: (M,) inpaint row mask, or null
  void* out;              // (M, ldo); kLayerNorm: null when out_b takes the output alone (bf16 activations)
  void* out_b;            // bf16 (M, ldb): kLayerNorm/kStem the f32 out rounded; kStep the x part of xa; or null
  int M, N, K;            // M: rows of out
  int lda, ldw, ldo, ldb;
  int k_split;            // kStem in f32: columns taken from a; the rest come from a2
  int a_bf16, out_bf16, compute_bf16;
  int res_bf16;           // kLayerNorm: the residual is bf16 (read as f32, the add stays f32)
  int mode;
  int t_data;             // kStem/kStep: frames per window (tokens = t_data + 1)
  int wgmma;              // set by egoego_gemm: 1 if it launched gemm_wgmma_kernel
  float c1, c2, c3;       // kStep: the update scalars a1, a2, a3
};

// Rows of the product: kStem multiplies the B t_data data rows (out has a
// token 0 more per window), kStep all B (t_data + 1) token rows of A (out
// drops token 0), the others one row per output row.
__host__ __device__ __forceinline__ int prod_rows(const GemmArgs& p) {
  if (p.mode == kStem) return p.M / (p.t_data + 1) * p.t_data;
  if (p.mode == kStep) return p.M / p.t_data * (p.t_data + 1);
  return p.M;
}

// f32 kernel: row of A that feeds output row r (-1: a row of zeros).
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

// The epilogues of gemm_wgmma_kernel, one instantiation each. kLayerNorm
// takes one of four, by its residual's and its output's types:
// kEpiLayerNorm an f32 residual and an f32 out (with its bf16 copy when
// out_b is given); with bf16 activations kEpiLnResBf16 a bf16 residual,
// kEpiLnBf16Out an output that leaves as out_b alone, kEpiLnBf16 both. The
// f32 kernel takes the same choice as a template argument.
// kEpiPartial is kPartial's, in both kernels.
enum WgEpilogue : int {
  kEpiBias, kEpiLayerNorm, kEpiStem, kEpiStep, kEpiLnResBf16, kEpiLnBf16Out, kEpiLnBf16, kEpiPartial
};

__host__ __device__ constexpr bool ln_epilogue(int e) {
  return e == kEpiLayerNorm || (e >= kEpiLnResBf16 && e <= kEpiLnBf16);
}
__host__ __device__ constexpr bool ln_res_bf16(int e) { return e == kEpiLnResBf16 || e == kEpiLnBf16; }
__host__ __device__ constexpr bool ln_f32_out(int e) { return e == kEpiLayerNorm || e == kEpiLnResBf16; }

// kLayerNorm's epilogue for the layout of p (see WgEpilogue).
inline int ln_epilogue_of(const GemmArgs& p) {
  return p.res_bf16 ? (p.out != nullptr ? kEpiLnResBf16 : kEpiLnBf16)
                    : (p.out != nullptr ? kEpiLayerNorm : kEpiLnBf16Out);
}

// The f32 kernel's epilogue on its f32 accumulator tile Cs (BM x BN, row
// stride LDC); f32 out. LN (a kLayerNorm epilogue of WgEpilogue) fixes
// kLayerNorm's residual and output types; kEpiPartial stores the product.
template <int BM, int BN, int LDC, int LN>
__device__ __forceinline__ void epilogue(const GemmArgs& p, const float* Cs, int m0, int n0) {
  const int tid = threadIdx.x;
  float* out = static_cast<float*>(p.out);
  if (LN != kEpiPartial && p.mode == kLayerNorm) {
    // One warp per row; the block holds all N <= BN columns of its rows.
    constexpr int PER_LANE = BN / 32;
    const int warp = tid >> 5, lane = tid & 31;
    for (int r = warp; r < BM; r += 8) {
      const int R = m0 + r;
      if (R >= p.M) break;
      float y[PER_LANE];
      float s = 0.f;
#pragma unroll
      for (int j = 0; j < PER_LANE; ++j) {
        const int c = lane + 32 * j;
        y[j] = c < p.N ? (Cs[r * LDC + c] + p.bias[c]) + load_f(p.res, (size_t)R * p.N + c, ln_res_bf16(LN)) : 0.f;
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
        if constexpr (ln_f32_out(LN)) {
          out[(size_t)R * p.ldo + c] = o;
        } else {
          static_cast<__nv_bfloat16*>(p.out_b)[(size_t)R * p.ldb + c] = __float2bfloat16(o);
        }
      }
    }
    return;
  }

  // eight consecutive columns per thread: two 16-byte reads of the tile
  // and 16-byte stores where the row layout allows
  const bool vec = p.ldo % 8 == 0 && p.N % 8 == 0 && reinterpret_cast<size_t>(p.out) % 16 == 0;
  for (int i = tid; i < BM * BN / 8; i += kThreads) {
    const int r = i / (BN / 8), c = (i % (BN / 8)) * 8;
    const int R = m0 + r, C = n0 + c;
    if (R >= p.M || C >= p.N) continue;
    const float4 a0 = *reinterpret_cast<const float4*>(Cs + r * LDC + c);
    const float4 a1 = *reinterpret_cast<const float4*>(Cs + r * LDC + c + 4);
    float v[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
    if constexpr (LN != kEpiPartial) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (C + j < p.N) v[j] = epilogue_value(p, v[j], R, C + j);
      }
    }
    float* o = out + (size_t)R * p.ldo + C;
    if (vec) {
      reinterpret_cast<float4*>(o)[0] = make_float4(v[0], v[1], v[2], v[3]);
      reinterpret_cast<float4*>(o)[1] = make_float4(v[4], v[5], v[6], v[7]);
    } else {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        if (C + j >= p.N) break;
        o[j] = v[j];
      }
    }
  }
}

// -- gemm_wgmma_kernel: TMA + mbarrier ring + wgmma (see the note at the top) --

constexpr int kWgBK = 64;         // k-tile depth: 64 bf16 = one 128-byte swizzle row
constexpr int kWgThreads = 384;   // consumer warpgroups 0 and 1 (threads 0-255), producer 2

// Staging rows of one consumer warpgroup: in the bias/ReLU modes 64 rows of
// 128 bytes of bf16 (64 columns), padded to 144 bytes so that the fragment's
// bf16x2 stores hit every bank once; in kStem 64 rows of 32 floats, padded
// to 40 (160 bytes) so that its float2 stores do.
struct OutStage {
  static constexpr int kRow = 144;
  static constexpr int kBytes = 64 * kRow;
};
struct F32Stage {
  static constexpr int kRow = 160;
  static constexpr int kBytes = 64 * kRow;
};

// BM x BN tile, STAGES-deep ring, epilogue EPI. kSplitN (kLayerNorm's, kStep):
// the two consumer warpgroups take the two column halves of BM = 64 rows;
// otherwise each takes 64 of BM = 128 rows across all BN columns.
template <int BM, int BN, int STAGES, int EPI>
struct WgTile {
  static constexpr int kEpi = EPI;
  static constexpr bool kSplitN = ln_epilogue(EPI) || EPI == kEpiStep || EPI == kEpiPartial;
  static constexpr int kWN = kSplitN ? BN / 2 : BN;  // columns of one warpgroup's m64nWNk16
  static constexpr int kWBox = BN > 256 ? 256 : BN;  // rows of W in one TMA box
  static_assert(BM == (kSplitN ? 64 : 128) && kWN % 8 == 0 && kWN <= 256 && BN % kWBox == 0,
                "two m64nNk16 warpgroups");
  static constexpr int kA = BM * kWgBK * 2, kB = BN * kWgBK * 2, kStage = kA + kB;
  static constexpr size_t kRing = (size_t)STAGES * kStage;
  // staging: per warpgroup (bias/ReLU, stem), or the block's x0 tile (step)
  static constexpr int kStageWg = EPI == kEpiBias ? OutStage::kBytes : EPI == kEpiStem ? F32Stage::kBytes : 0;
  static constexpr size_t kOut = EPI == kEpiStep ? (size_t)BM * BN * 4 : 2 * kStageWg;
  // ring (1024-byte aligned for the swizzle), staging, barriers
  static constexpr size_t kSmem = kRing + kOut + 2 * STAGES * sizeof(uint64_t) + 1024;
  static_assert(kSmem <= 227 * 1024, "shared memory of one block");
};

// d (64 x 256 f32, the m64n256 fragment) += A (64 x 16) W^T (16 x 256), both from shared memory.
__device__ __forceinline__ void wgmma_k16(float (&d)[128], uint64_t desc_a, uint64_t desc_w) {
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

// d (64 x 104 f32, the m64n104 fragment of kStep's column halves) += A (64 x 16) W^T (16 x 104).
__device__ __forceinline__ void wgmma_k16(float (&d)[52], uint64_t desc_a, uint64_t desc_w) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %54, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51}, %52, %53, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "l"(desc_a), "l"(desc_w), "r"(1));  // scale-d 1: d += A W^T
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

// kStem: stores a consumer warpgroup's 64 x 256 block of products (same
// fragment), product rows r0.. (data frame r % T of window r / T) and
// columns c0.., plus the bias and position row r % T + 1, to output row
// r + r / T + 1 of out and, rounded to bf16, of out_b: 32 columns at a time
// through the staging rows, from which each thread takes 16-byte pieces,
// eight threads to a row, adds bias and position row in 16-byte loads (the
// four pieces of a thread at once; from the fragment they would be 64
// float2 loads a thread, which the accumulators' registers leave the
// compiler no room to keep in flight), and stores 16 bytes of f32 and 8 of
// bf16. N % 8 == 0.
__device__ __forceinline__ void store_block_f32(const GemmArgs& p, const float (&acc)[128], unsigned char* stage,
                                                int r0, int c0, int rows) {
  const int t = threadIdx.x % 128, lane = t % 32, wg = threadIdx.x / 128;
  const int rl = 16 * (t / 32) + lane / 4, q = lane % 4;
#pragma unroll
  for (int j0 = 0; j0 < 32; j0 += 4) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        *reinterpret_cast<float2*>(stage + (rl + 8 * h) * F32Stage::kRow + (8 * jj + 2 * q) * 4) =
            make_float2(acc[4 * (j0 + jj) + 2 * h], acc[4 * (j0 + jj) + 2 * h + 1]);
      }
    }
    warpgroup_sync(wg);
    const int C = c0 + 8 * j0 + 4 * (t % 8);  // the same columns in each of the thread's four rows
    const float4 b = C < p.N ? *reinterpret_cast<const float4*>(p.bias + C) : make_float4(0.f, 0.f, 0.f, 0.f);
    float4 ps[4];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int r = r0 + t / 8 + 16 * u;
      ps[u] = r < rows && C < p.N ? *reinterpret_cast<const float4*>(p.pos + (size_t)(r % p.t_data + 1) * p.N + C)
                                  : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int row = t / 8 + 16 * u, r = r0 + row;
      if (r < rows && C < p.N) {
        const float4 a = *reinterpret_cast<const float4*>(stage + row * F32Stage::kRow + (t % 8) * 16);
        const float4 v = make_float4((a.x + b.x) + ps[u].x, (a.y + b.y) + ps[u].y, (a.z + b.z) + ps[u].z,
                                     (a.w + b.w) + ps[u].w);
        const size_t R = r + r / p.t_data + 1;
        *reinterpret_cast<float4*>(static_cast<float*>(p.out) + R * p.ldo + C) = v;
        union { uint2 bits; __nv_bfloat162 h[2]; } vb;
        vb.h[0] = __floats2bfloat162_rn(v.x, v.y);
        vb.h[1] = __floats2bfloat162_rn(v.z, v.w);
        *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.out_b) + R * p.ldb + C) = vb.bits;
      }
    }
    warpgroup_sync(wg);  // the staging rows are free again
  }
}

// kStep: the output rows [lo, hi) of the tile at product row m0 (see the
// kStep branch of wgmma_epilogue)
__device__ __forceinline__ int step_span_lo(int m0, int t) { return m0 / (t + 1) * t + max(m0 % (t + 1) - 1, 0); }
__device__ __forceinline__ int step_span_hi(int m0, int rows, int t) {
  const int last = min(m0 + 64, rows) - 1;
  return last / (t + 1) * t + last % (t + 1);
}

__device__ __forceinline__ float lane_of(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// The wgmma kernel's epilogue, on the accumulators where they are: element
// 4j + {0, 1} of a thread is (row r, columns c + 8j + {0, 1}) and 4j + {2, 3}
// is row r + 8, with r = row0 + 16 warp + lane / 4 and c = col0 + 2 (lane % 4)
// (the m64nNk16 fragment). So each row of the warpgroup's block lies in one
// quad of lanes, and every load is a column pair. The bias/ReLU modes turn
// the values into outputs in place and store them through `stage`
// (store_block); the LayerNorm modes store column pairs straight from the
// fragment (staging their f32 rows too gained them under 10% and cost a ring
// stage and spills); kStem and kStep as the note at the top says. Same
// arithmetic as the f32 kernel's epilogue().
template <typename T>
__device__ __forceinline__ void wgmma_epilogue(const GemmArgs& p, float (&acc)[T::kWN / 2], unsigned char* stage,
                                               int m0, int n0, int row0, int col0) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32, rl = 16 * warp + lane / 4;
  const int c = n0 + col0 + 2 * (lane % 4);
  if constexpr (T::kEpi == kEpiBias) {  // kBias, kBiasRelu
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
  } else if constexpr (ln_epilogue(T::kEpi)) {  // the two warpgroups hold the two column halves of 64 rows
    __shared__ float part[2][2][64];  // [statistic][warpgroup][row]: row sums over each half
    const int wg = threadIdx.x / 128;
    const int R[2] = {m0 + row0 + rl, m0 + row0 + rl + 8};
    // y = (A W + b) + res, in place; columns past N stay 0 and out of the sums
    float s[2] = {0.f, 0.f};
#pragma unroll
    for (int j = 0; j < 32; ++j) {
      const int C = c + 8 * j;
      if (C < p.N) {
        const float2 b = *reinterpret_cast<const float2*>(p.bias + C);
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float2 r = make_float2(0.f, 0.f);
          if (R[h] < p.M) {
            const size_t e = (size_t)R[h] * p.N + C;
            if constexpr (ln_res_bf16(T::kEpi))
              r = __bfloat1622float2(
                  *reinterpret_cast<const __nv_bfloat162*>(static_cast<const __nv_bfloat16*>(p.res) + e));
            else
              r = *reinterpret_cast<const float2*>(static_cast<const float*>(p.res) + e);
          }
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
          if constexpr (ln_f32_out(T::kEpi))
            *reinterpret_cast<float2*>(static_cast<float*>(p.out) + (size_t)R[h] * p.ldo + C) = make_float2(o0, o1);
          if (!ln_f32_out(T::kEpi) || p.out_b != nullptr)
            *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out_b) + (size_t)R[h] * p.ldb + C) =
                __floats2bfloat162_rn(o0, o1);
        }
      }
    }
  } else if constexpr (T::kEpi == kEpiPartial) {  // the two warpgroups hold the two column halves of 64 rows
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int R = m0 + row0 + rl + 8 * h;
      if (R < p.M) {
        float* o = static_cast<float*>(p.out) + (size_t)R * p.ldo;
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int C = c + 8 * j;
          if (C < p.N) *reinterpret_cast<float2*>(o + C) = make_float2(acc[4 * j + 2 * h], acc[4 * j + 2 * h + 1]);
        }
      }
    }
  } else if constexpr (T::kEpi == kEpiStem) {
    const int t = p.t_data, rows = prod_rows(p);
    store_block_f32(p, acc, stage, m0 + row0, n0 + col0, rows);
    // token 0 (emb + pos[0]) of each window whose first data row is among this warpgroup's 64 rows
    const int r_lo = m0 + row0, r_hi = min(r_lo + 64, rows);
    for (int b = (r_lo + t - 1) / t; b * t < r_hi; ++b) {
      const int C = n0 + col0 + 2 * (threadIdx.x % 128);
      if (C < p.N) {
        const float2 e = *reinterpret_cast<const float2*>(p.emb + C);
        const float2 ps = *reinterpret_cast<const float2*>(p.pos + C);
        const float v0 = e.x + ps.x, v1 = e.y + ps.y;
        const size_t R = (size_t)b * (t + 1);
        *reinterpret_cast<float2*>(static_cast<float*>(p.out) + R * p.ldo + C) = make_float2(v0, v1);
        *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out_b) + R * p.ldb + C) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
  } else {  // kEpiStep: the two warpgroups hold the two column halves of the same 64 product rows
    // Product row r is token k = r % (T+1) of window r / (T+1): token 0 is
    // dropped, token k > 0 is output row (r / (T+1)) T + k - 1, so the tile's
    // output rows are one contiguous span [o_lo, o_hi), and its outputs one
    // flat span of the (M, N) arrays. xs holds the span's x0, then x_next.
    float* xs = reinterpret_cast<float*>(stage);
    const int t = p.t_data, tt = t + 1, rows = prod_rows(p), tid = threadIdx.x;
    const int o_lo = step_span_lo(m0, t), o_hi = step_span_hi(m0, rows, t);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int r = m0 + rl + 8 * h, k = r % tt;
      if (r < rows && k != 0) {
        float* dst = xs + (r / tt * t + k - 1 - o_lo) * p.N;
#pragma unroll
        for (int j = 0; j < T::kWN / 8; ++j) {
          const int C = c + 8 * j;
          if (C < p.N) {
            const float2 b = *reinterpret_cast<const float2*>(p.bias + C);
            *reinterpret_cast<float2*>(dst + C) = make_float2(fminf(fmaxf(acc[4 * j + 2 * h] + b.x, -1.f), 1.f),
                                                              fminf(fmaxf(acc[4 * j + 2 * h + 1] + b.y, -1.f), 1.f));
          }
        }
      }
    }
    consumer_sync();
    // x_next = a1 x0 + a2 x + a3 noise, then the inpaint, over the flat span
    // [f0, f1): 16-byte pieces of x, noise, the inpaint values and out,
    // consecutive threads on consecutive pieces (the span's ends, which need
    // not be 16-byte aligned, element by element)
    const int f0 = o_lo * p.N, f1 = o_hi * p.N;
    const bool inpaint = p.ipv != nullptr;
    float* out = static_cast<float*>(p.out);
    auto next = [&](float x0, float x, float nz, float v, float m) {
      const float xn = __fadd_rn(__fadd_rn(__fmul_rn(p.c1, x0), __fmul_rn(p.c2, x)), __fmul_rn(p.c3, nz));
      return inpaint ? xn + m * (v - xn) : xn;
    };
    constexpr int kInFlight = 8;  // pieces a thread loads before it stores any
    for (int f_first = (f0 & ~3) + 4 * tid; f_first < f1; f_first += 4 * 256 * kInFlight) {
      // a piece's loads, the inpaint mask of its row and the next (a piece
      // may straddle two rows), and how many of its elements lie in the first
      float4 xv[kInFlight], nv[kInFlight], vv[kInFlight];
      float m0v[kInFlight], m1v[kInFlight];
      int split[kInFlight];
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int f = f_first + 4 * 256 * u;
        if (f >= f0 && f + 4 <= f1) {
          const int row = f / p.N;
          split[u] = (row + 1) * p.N - f;
          xv[u] = *reinterpret_cast<const float4*>(p.x + f);
          nv[u] = *reinterpret_cast<const float4*>(p.noise + f);
          vv[u] = inpaint ? *reinterpret_cast<const float4*>(p.ipv + f) : make_float4(0.f, 0.f, 0.f, 0.f);
          m0v[u] = inpaint ? p.ipm[row] : 0.f;
          m1v[u] = inpaint && split[u] < 4 ? p.ipm[row + 1] : m0v[u];
        }
      }
#pragma unroll
      for (int u = 0; u < kInFlight; ++u) {
        const int f = f_first + 4 * 256 * u;
        if (f >= f0 && f + 4 <= f1) {
          float* s = xs + (f - f0);  // f0 and f are even: 8-byte aligned
          const float2 s0 = *reinterpret_cast<const float2*>(s), s1 = *reinterpret_cast<const float2*>(s + 2);
          const float4 x0 = make_float4(s0.x, s0.y, s1.x, s1.y);
          float o[4];
#pragma unroll
          for (int e = 0; e < 4; ++e)
            o[e] = next(lane_of(x0, e), lane_of(xv[u], e), lane_of(nv[u], e), lane_of(vv[u], e),
                        e < split[u] ? m0v[u] : m1v[u]);
          *reinterpret_cast<float4*>(out + f) = make_float4(o[0], o[1], o[2], o[3]);
          *reinterpret_cast<float2*>(s) = make_float2(o[0], o[1]);
          *reinterpret_cast<float2*>(s + 2) = make_float2(o[2], o[3]);
        } else {
          for (int g = max(f, f0); g < min(f + 4, f1); ++g) {
            const float o = next(xs[g - f0], p.x[g], p.noise[g], inpaint ? p.ipv[g] : 0.f,
                                 inpaint ? p.ipm[g / p.N] : 0.f);
            out[g] = o;
            xs[g - f0] = o;
          }
        }
      }
    }
    consumer_sync();
    // bf16(x_next) into the x part of xa (out_b, row stride ldb): 16-byte
    // pieces of 8 columns, then the last N % 8 columns in pairs
    if (p.out_b != nullptr) {
      const int pieces = p.N / 8, per_row = pieces + p.N % 8 / 2;
      for (int i = tid; i < (o_hi - o_lo) * per_row; i += 256) {
        const int row = i / per_row, k = i % per_row;
        const float* s = xs + row * p.N;
        __nv_bfloat16* dst = static_cast<__nv_bfloat16*>(p.out_b) + (size_t)(o_lo + row) * p.ldb;
        if (k < pieces) {
          union { uint4 u; __nv_bfloat162 h[4]; } b;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 v = *reinterpret_cast<const float2*>(s + 8 * k + 2 * e);
            b.h[e] = __floats2bfloat162_rn(v.x, v.y);
          }
          *reinterpret_cast<uint4*>(dst + 8 * k) = b.u;
        } else {
          const int C = 8 * pieces + 2 * (k - pieces);
          const float2 v = *reinterpret_cast<const float2*>(s + C);
          *reinterpret_cast<__nv_bfloat162*>(dst + C) = __floats2bfloat162_rn(v.x, v.y);
        }
      }
    }
    consumer_sync();  // xs is free for the next tile
  }
}

template <int BM, int BN, int STAGES, int EPI>
__global__ void __launch_bounds__(kWgThreads, 1)
    gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
                      const GemmArgs p) {
  using T = WgTile<BM, BN, STAGES, EPI>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>((reinterpret_cast<size_t>(smem_raw) + 1023) & ~size_t(1023));
  unsigned char* out_stage = ring + T::kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_stage + T::kOut);
  uint64_t* empty = full + STAGES;
  // persistent: block b takes tiles b, b + gridDim.x, ..., columns fastest;
  // the ring runs on across tiles, so the next tile's loads overlap this
  // tile's epilogue
  const int n_tiles = (p.N + BN - 1) / BN, tiles = n_tiles * ((prod_rows(p) + BM - 1) / BM);
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
          for (int h = 0; h < BN / T::kWBox; ++h)
            tma_load_2d(st + T::kA + h * T::kWBox * 128, &map_w, &full[s], kt * kWgBK, n0 + h * T::kWBox);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns rows row0.. row0 + 63 and columns col0.. col0 + kWN - 1 of each tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int row0 = T::kSplitN ? 0 : 64 * wg, col0 = T::kSplitN ? T::kWN * wg : 0;
    const bool leader = threadIdx.x % 128 == 0;
    int it = 0;
    for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
      float acc[T::kWN / 2];
#pragma unroll
      for (int i = 0; i < T::kWN / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const unsigned char* st = ring + (size_t)s * T::kStage;
        const uint64_t da = wg_desc(st + row0 * 128), dw = wg_desc(st + T::kA + col0 * 128);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk) wgmma_k16(acc, da + 2 * kk, dw + 2 * kk);
        wgmma_commit();
        // the products of the previous k-tile are done: hand its stage back
        wgmma_wait<1>();
        if (kt > 0 && leader) mbar_arrive(&empty[(it - 1) % STAGES]);
      }
      wgmma_wait<0>();
      if (leader) mbar_arrive(&empty[(it - 1) % STAGES]);
      wgmma_epilogue<T>(p, acc, out_stage + wg * T::kStageWg, t / n_tiles * BM, t % n_tiles * BN, row0, col0);
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

template <int BM, int BN, int LN>
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
      Ws[r * T::LDW + c] = (k < p.K && n < p.N) ? W[(size_t)n * p.ldw + k] : 0.f;
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
  epilogue<BM, BN, T::LDC, LN>(p, Cs, m0, n0);
}

template <int BM, int BN, int LN = kEpiLayerNorm>
static cudaError_t launch_f32(const GemmArgs& p, cudaStream_t stream) {
  auto kernel = gemm_f32_kernel<BM, BN, LN>;
  const size_t smem = F32Tile<BM, BN>::kSmem;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  kernel<<<grid, kThreads, smem, stream>>>(p);
  return cudaGetLastError();
}

// TMA map of a row-major bf16 (rows, cols) matrix with row stride ld,
// boxes of box_rows x 64 columns with the 128-byte swizzle; out-of-bounds
// elements read as zeros.
static bool tma_map(CUtensorMap* map, const void* base, int rows, int cols, int ld, int box_rows) {
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 2};
  const cuuint32_t box[2] = {(cuuint32_t)kWgBK, (cuuint32_t)box_rows};
  return tma_map_bf16(map, base, 2, dims, strides, box);
}

template <int BM, int BN, int STAGES, int EPI>
static cudaError_t launch_wgmma(const GemmArgs& p, cudaStream_t stream) {
  using T = WgTile<BM, BN, STAGES, EPI>;
  const int rows = prod_rows(p);
  CUtensorMap map_a, map_w;
  if (!tma_map(&map_a, p.a, rows, p.K, p.lda, BM) || !tma_map(&map_w, p.w, p.N, p.K, p.ldw, T::kWBox))
    return cudaErrorInvalidValue;
  auto kernel = gemm_wgmma_kernel<BM, BN, STAGES, EPI>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (err != cudaSuccess) return err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const int tiles = ((p.N + BN - 1) / BN) * ((rows + BM - 1) / BM);
  kernel<<<tiles < sms ? tiles : sms, kWgThreads, T::kSmem, stream>>>(map_a, map_w, p);  // one block an SM
  return cudaGetLastError();
}

static bool aligned16(const void* ptr) { return reinterpret_cast<size_t>(ptr) % 16 == 0; }

}  // namespace egoego

// Launches one product; the mode and the compute type alone pick the kernel.
// Sets p->wgmma to 1 when it launched gemm_wgmma_kernel. A layout that the
// picked kernel cannot take returns cudaErrorInvalidValue and launches
// nothing.
extern "C" int egoego_gemm(egoego::GemmArgs* p, void* stream) {
  using namespace egoego;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int invalid = (int)cudaErrorInvalidValue;
  p->wgmma = 0;
  if (p->M <= 0 || p->N <= 0 || p->K <= 0 || p->mode < kBias || p->mode > kPartial ||
      ((p->mode == kStem || p->mode == kStep) && p->t_data <= 0))
    return invalid;
  // a bf16 residual, and an output that leaves as its bf16 copy alone, only in kLayerNorm
  if ((p->res_bf16 && p->mode != kLayerNorm) || (p->out == nullptr && (p->mode != kLayerNorm || p->out_b == nullptr)))
    return invalid;
  if (!p->compute_bf16) {  // f32 A and W; f32 out, or in kLayerNorm with bf16 activations a bf16 out_b alone
    if (p->a_bf16 || p->out_bf16 || (p->out_b != nullptr && p->out != nullptr) ||
        (p->mode == kLayerNorm && p->N > 512))
      return invalid;
    if (p->mode == kPartial) return (int)launch_f32<64, 128, kEpiPartial>(*p, s);
    if (p->mode != kLayerNorm) return (int)launch_f32<64, 128>(*p, s);
    switch (ln_epilogue_of(*p)) {
      case kEpiLayerNorm: return (int)launch_f32<32, 512, kEpiLayerNorm>(*p, s);
      case kEpiLnResBf16: return (int)launch_f32<32, 512, kEpiLnResBf16>(*p, s);
      case kEpiLnBf16Out: return (int)launch_f32<32, 512, kEpiLnBf16Out>(*p, s);
      default: return (int)launch_f32<32, 512, kEpiLnBf16>(*p, s);
    }
  }
  // bf16: A (rows, K) and W (N, K), K-major, 16-byte rows and bases
  bool ok = p->a_bf16 && p->K % 8 == 0 && p->lda % 8 == 0 && p->ldw % 8 == 0 && aligned16(p->a) &&
            aligned16(p->w) && aligned16(p->out) && aligned16(p->res) && (p->out_b == nullptr || (aligned16(p->out_b) && p->ldb % 8 == 0));
  cudaError_t err;
  switch (p->mode) {
    case kBias:
    case kBiasRelu:  // bf16 out
      if (!(ok && p->out_bf16 && p->N % 8 == 0 && p->ldo % 8 == 0)) return invalid;
      err = launch_wgmma<128, 256, 4, kEpiBias>(*p, s);
      break;
    case kLayerNorm:  // f32 out (and its bf16 copy) or the bf16 out alone, whole rows in one tile
      if (!(ok && !p->out_bf16 && p->N % 8 == 0 && p->N <= 512 && p->ldo % 8 == 0)) return invalid;
      switch (ln_epilogue_of(*p)) {
        case kEpiLayerNorm: err = launch_wgmma<64, 512, 3, kEpiLayerNorm>(*p, s); break;
        case kEpiLnResBf16: err = launch_wgmma<64, 512, 3, kEpiLnResBf16>(*p, s); break;
        case kEpiLnBf16Out: err = launch_wgmma<64, 512, 3, kEpiLnBf16Out>(*p, s); break;
        default: err = launch_wgmma<64, 512, 3, kEpiLnBf16>(*p, s);
      }
      break;
    case kPartial:  // f32 out, no bias, no copy
      if (!(ok && !p->out_bf16 && p->out_b == nullptr && p->N % 8 == 0 && p->ldo % 8 == 0)) return invalid;
      err = launch_wgmma<64, 512, 3, kEpiPartial>(*p, s);
      break;
    case kStem:  // A = xa (B t_data, K); f32 out (B (t_data + 1), N) and its bf16 copy
      if (!(ok && !p->out_bf16 && p->out_b != nullptr && p->N % 8 == 0 && p->ldo % 8 == 0 &&
            p->M % (p->t_data + 1) == 0))
        return invalid;
      err = launch_wgmma<128, 256, 4, kEpiStem>(*p, s);
      break;
    default:  // kStep: A (B (t_data + 1), K); f32 out, x, noise, ipv (B t_data, N) with rows of N; out_b xa
      if (!(ok && !p->out_bf16 && p->N % 2 == 0 && p->N <= 208 && p->ldo == p->N && p->M % p->t_data == 0 &&
            (size_t)p->M * p->N < (1u << 31) && aligned16(p->x) && aligned16(p->noise) && aligned16(p->ipv) &&
            (p->ipv == nullptr || p->ipm != nullptr) && (p->out_b == nullptr || p->ldb >= p->N)))
        return invalid;
      err = launch_wgmma<64, 208, 4, kEpiStep>(*p, s);
  }
  p->wgmma = err == cudaSuccess;
  return (int)err;
}

extern "C" int egoego_gemm_args_size() { return (int)sizeof(egoego::GemmArgs); }
