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
// device memory. Three kernels on the route: in bf16 the LayerNorm products
// run on gemm_wgmma_ln_kernel and the others on gemm_wgmma_kernel; in f32
// every product runs on gemm_tf32x3_kernel.
//
// gemm_wgmma_kernel, every bf16 product but the LayerNorms'. wgmma is the
// only instruction that reaches the card's full bf16 rate, so: one producer
// warpgroup, of which one thread issues TMA loads (cp.async.bulk.tensor) of
// 64-deep k-tiles of A (rows, K) and W (N, K), both bf16 and K-major, into a ring of
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
//    m64n256k16), 4 stages of 48 KB. QKV is bound by its operations (24.4
//    GFLOP against 59 MB at 64 x 121 tokens), w1 by bytes (4.1 GFLOP
//    against 16 MB). K = 512 is only 8 k-tiles, so a tile's 64 KB of bf16
//    outputs weigh nearly as much as its products, and stored by the
//    consumers' own instructions they left the tensor cores idle. Here each
//    warpgroup adds the bias (8 loads in flight at a time, none
//    conditional), rounds its 64 x 256 outputs into staging boxes of 64
//    rows x 64 columns with the 128-byte swizzle, two boxes at a time (the
//    ring leaves 32 KB), and its leader hands each box to a TMA store
//    (store_block_tma) and goes straight on: the second round waits only
//    for the first's reads of the staging, the next tile only for the
//    second's, and the writes to device memory run under the next tile's
//    products. TMA writes no row past M nor column past N. A block's last
//    tile has no next tile to hide its stores (w1 at 64 x 121: 122 tiles,
//    one a block); ops/cuda_kernels.py gemm_tiles counts both kinds.
//  - kLayerNorm (fc, w2) runs on gemm_wgmma_ln_kernel (below), a kernel of
//    its own: the LayerNorm needs whole rows, and a whole-row 64 x 512 tile
//    gave 121 blocks at 64 x 121 tokens, a lone block an SM with no next
//    tile whose loads could hide its epilogue, which took three quarters of
//    the launch. There a cluster of four CTAs shares each block of 64 rows,
//    a CTA the 128 columns of one quarter (two warpgroups of m64n64k16), two
//    CTAs an SM, persistent over the row blocks (the grid: the clusters the
//    card holds at once, cudaOccupancyMaxActiveClusters). Each k-tile of A
//    reaches the four CTAs by TMA multicast, 16 rows from each; a stage goes
//    back to every CTA's producer as soon as its products are done (3
//    stages of 24 KB). The producer brings the tile's residual into shared
//    memory by TMA while the products run; the row statistics are summed
//    over the quad, the two warpgroups and then the four CTAs, whose
//    partials reach every CTA's shared memory (st.async into distributed
//    shared memory) and are added there in rank order, so every CTA and
//    every layout gets the same f32 statistics. The f32 rows leave from the
//    fragment (each store instruction whole 32-byte sectors), the bf16 rows
//    through the residual's buffer by TMA stores (from the fragment they
//    would be 16-byte pieces of sectors). Bound by bytes (f32 residual in,
//    f32 out and its bf16 copy).
//    With bf16 inter-layer activations (the TPU kernels' act dtype,
//    fused_step_act_bf16) fc reads its residual, the layer input, as bf16
//    (res_bf16; the add stays f32) and w2 writes the layer output as bf16
//    alone (out null, out_b), as gemm_tf32x3_kernel does too. Each of these
//    layouts is an instantiation of its own (kEpiLnResBf16, kEpiLnBf16Out,
//    kEpiLnBf16), so the f32-activation epilogue carries no branch for them.
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
//    A pred_noise model's output is the noise, not x0: its update (step_noise,
//    two more scalars r1, r2) stages the unclipped A W + b and takes x0 =
//    clip(r1 x - r2 (A W + b)) in the pass that already reads x, one more
//    multiply-add an element. It is an instantiation of its own
//    (kEpiStepNoise), so the pred_x0 epilogue keeps its code. The 3 or 5
//    scalars are read from device memory (scal), not passed by value, so
//    one captured step (a CUDA graph, ops/fused_step.py StepGraph) replays
//    every step of a schedule with the row its host copies in first.
//  - kPartial (fc and w2 of a tensor-parallel layer): the f32 product A W
//    alone, no bias, in 64 x 512 tiles (each warpgroup one 256-column
//    half), stored from the fragment. Each tp rank holds a slice of K, so its product is a
//    partial sum: the caller all-reduces it over the tp group, and
//    csrc/residual_layernorm.cu then adds the bias and the residual and
//    normalizes. Bound by bytes (K = 512 / tp). Its own instantiation
//    (kEpiPartial), so the LayerNorm epilogues carry no branch for it.
//
// gemm_tf32x3_kernel, every product in f32 compute (the CLIs' default
// numerics), on the tensor cores at f32 accuracy: a TMA ring of k-tiles, two
// consumer warpgroups, persistent, the same epilogues on the accumulators.
// One TF32 pass keeps 10 mantissa bits, which misses the f32 kernels' 1e-4
// at K = 1024 (tests/test_torch_f32_tensor_cores.py), so each product is
// 3xTF32, as csrc/mha.cu does it: x = hi + lo, hi x rounded to TF32 on the
// bits, lo = x - hi exactly (the tensor core reads it truncated to TF32, at
// most 2^-21 |x| off), and A W = Ahi Whi + Ahi Wlo + Alo Whi (Alo Wlo,
// ~2^-22 relative, is dropped). W is constant over a chain, so it arrives
// split: w = Whi and w_lo = Wlo (cuda_kernels.split_tf32, once per model in
// the f32 step parameters), both (N, K) f32 and K-major, by TMA. A is read
// from its stage into registers as the m64nNk8 tf32 A fragment and split
// there, and the three products are wgmma.m64nNk8.f32.tf32.tf32 with A from
// registers and W from shared memory. A 32-deep f32 k-tile of a 512-wide W
// hi and lo is 128 KB, so the k-tiles are 16 deep, in rows of 64 bytes with
// the 64-byte swizzle.
// The tensor cores add each product into their f32 accumulator truncated,
// not rounded to nearest: over K = 512-1024 (3 K / 8 adds into one
// accumulator) that bias cost the f32 step 5-9x the error of an f32 GEMM
// on the CUDA cores against the plain version, and the f32 chains their 1e-3
// card-vs-CPU bound (chip_smoke.py phase 14). So each k-tile's six products
// of a chunk of 128 columns (104 in kStep) go into a zeroed register chunk,
// which the CUDA cores then add into the f32 accumulator rounding to
// nearest: each truncated sum is one k-tile's. That chunk needs registers
// beside the 128 of the accumulators, and registers go to a block in units
// of four warps, so a producer warp or warpgroup beside the consumers (288
// or 384 threads) would hold every thread to 168: the block is the two
// consumer warpgroups alone (256 threads, up to 255 registers), and thread
// 0 refills each stage once both have handed it back.
// An f32 product is bound by operations at every shape of the step: three
// tensor-core products per f32 product, 3 x 2 M N K / 495 TFLOP/s. Tiles,
// stages and shared memory of each instantiation (A + Whi + Wlo a stage):
//  - kBias, kBiasRelu (QKV, w1): 128 x 256, 5 stages of 40 KB (200 KB);
//    f32 out stored from the fragment.
//  - kLayerNorm (four layouts, as above) and kPartial: 64 x 512, 3 stages
//    of 68 KB (204 KB).
//  - kStem: 128 x 256, 4 stages of 40 KB and 20 KB of f32 staging (180 KB).
//    A is an f32 xa (B t_data, K) = [x | x_cond | 0] at the padded width
//    (x and x_cond have 792-byte rows, which TMA cannot map); f32 h only.
//  - kStep: 64 x 208, 4 stages of 30 KB and the 52 KB x0 span (172 KB); it
//    writes x_next into the f32 xa's x part (out_b) for the next stem.
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
  kStep = 4,      // out = a1 clip(A[b, t+1] W + b) + a2 x + a3 noise, then inpaint (step_noise: x0 = clip(r1 x - r2 (A W + b)))
  kPartial = 5,   // out = A W (f32; no bias: a tensor-parallel partial sum)
};

struct GemmArgs {
  const void* a;          // (rows, lda), f32 or bf16; kStem: xa (B t_data, lda)
  const void* w;          // (N or more rows, ldw), K-major as nn.Linear; bf16 in bf16 mode; f32 mode: Whi
  const void* w_lo;       // f32 mode: Wlo = W - Whi, laid out like w
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
  const float* scal;      // kStep: the update scalars a1, a2, a3 (step_noise: then r1, r2), read on the card
  void* out;              // (M, ldo); kLayerNorm: null when out_b takes the output alone (bf16 activations)
  void* out_b;            // bf16 (M, ldb): kLayerNorm/kStem the f32 out rounded; kStep the x part of xa; or null
  int M, N, K;            // M: rows of out
  int lda, ldw, ldo, ldb;
  int a_bf16, out_bf16, compute_bf16;
  int res_bf16;           // kLayerNorm: the residual is bf16 (read as f32, the add stays f32)
  int mode;
  int t_data;             // kStem/kStep: frames per window (tokens = t_data + 1)
  int kernel;             // set by egoego_gemm: the GemmKernel launched
  int step_noise;         // kStep: the output is a noise prediction (x0 = r1 x - r2 out before the clip)
  int tiles, grid;        // set by egoego_gemm on gemm_wgmma_kernel: its output tiles and the blocks launched
};

enum GemmKernel : int { kKernelWgmma = 0, kKernelTf32x3 = 1 };

// Rows of the product: kStem multiplies the B t_data data rows (out has a
// token 0 more per window), kStep all B (t_data + 1) token rows of A (out
// drops token 0), the others one row per output row.
__host__ __device__ __forceinline__ int prod_rows(const GemmArgs& p) {
  if (p.mode == kStem) return p.M / (p.t_data + 1) * p.t_data;
  if (p.mode == kStep) return p.M / p.t_data * (p.t_data + 1);
  return p.M;
}

// The epilogues of gemm_wgmma_kernel, one instantiation each. kLayerNorm
// takes one of four, by its residual's and its output's types:
// kEpiLayerNorm an f32 residual and an f32 out (with its bf16 copy when
// out_b is given); with bf16 activations kEpiLnResBf16 a bf16 residual,
// kEpiLnBf16Out an output that leaves as out_b alone, kEpiLnBf16 both.
// gemm_tf32x3_kernel takes the same choice as a template argument.
// kEpiPartial is kPartial's, in both kernels. kStep takes kEpiStep, or
// kEpiStepNoise with step_noise.
enum WgEpilogue : int {
  kEpiBias, kEpiLayerNorm, kEpiStem, kEpiStep, kEpiLnResBf16, kEpiLnBf16Out, kEpiLnBf16, kEpiPartial, kEpiStepNoise
};

__host__ __device__ constexpr bool step_epilogue(int e) { return e == kEpiStep || e == kEpiStepNoise; }

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

// -- gemm_wgmma_kernel: TMA + mbarrier ring + wgmma (see the note at the top) --

constexpr int kWgBK = 64;         // k-tile depth: 64 bf16 = one 128-byte swizzle row
constexpr int kWgThreads = 384;   // consumer warpgroups 0 and 1 (threads 0-255), producer 2

// Staging rows of one consumer warpgroup in kStem: 64 rows of 32 floats,
// padded to 40 (160 bytes) so that the fragment's float2 stores hit every
// bank once.
struct F32Stage {
  static constexpr int kRow = 160;
  static constexpr int kBytes = 64 * kRow;
};

// BM x BN tile, STAGES-deep ring, epilogue EPI. kSplitN (kStep, kPartial):
// the two consumer warpgroups take the two column halves of BM = 64 rows;
// otherwise each takes 64 of BM = 128 rows across all BN columns.
template <int BM, int BN, int STAGES, int EPI>
struct WgTile {
  static constexpr int kEpi = EPI;
  static constexpr bool kTf32 = false;  // bf16 operands (TfTile: gemm_tf32x3_kernel's f32 layouts)
  static constexpr bool kSplitN = step_epilogue(EPI) || EPI == kEpiPartial;
  static constexpr int kWN = kSplitN ? BN / 2 : BN;  // columns of one warpgroup's m64nWNk16
  static constexpr int kWBox = BN > 256 ? 256 : BN;  // rows of W in one TMA box
  static_assert(BM == (kSplitN ? 64 : 128) && kWN % 8 == 0 && kWN <= 256 && BN % kWBox == 0,
                "two m64nNk16 warpgroups");
  static constexpr int kA = BM * kWgBK * 2, kB = BN * kWgBK * 2, kStage = kA + kB;
  static constexpr size_t kRing = (size_t)STAGES * kStage;
  // bias/ReLU: a warpgroup's 64 x 256 bf16 outputs leave as TMA boxes of
  // 64 rows x 64 columns (8 KB, sw128), two at a time: the 4-stage ring
  // leaves room for half of them (3 stages and all four were slower)
  static constexpr int kOutBoxes = 2;
  // staging: per warpgroup (bias/ReLU, stem), or the block's x0 tile (step)
  static constexpr int kStageWg = EPI == kEpiBias ? kOutBoxes * 8192 : EPI == kEpiStem ? F32Stage::kBytes : 0;
  static constexpr size_t kOut = step_epilogue(EPI) ? (size_t)BM * BN * 4 : 2 * kStageWg;
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

// d (64 x 64 f32, the m64n64 fragment) += A (64 x 16) W^T (16 x 64), both from shared memory.
__device__ __forceinline__ void wgmma_k16(float (&d)[32], uint64_t desc_a, uint64_t desc_w) {
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
      : "l"(desc_a), "l"(desc_w), "r"(1));  // scale-d 1: d += A W^T
}

// barrier 1 over the two consumer warpgroups only (the producer has left)
__device__ __forceinline__ void consumer_sync() { asm volatile("bar.sync 1, 256;\n" ::: "memory"); }
// barrier 2 + wg over consumer warpgroup wg alone
__device__ __forceinline__ void warpgroup_sync(int wg) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(2 + wg) : "memory");
}

// Byte offset of element (r, c) of a 64-row tile of E-byte elements held as
// TMA boxes of 64 rows x 128 bytes, side by side, with the 128-byte swizzle
// (the 16-byte chunk k of row r at k ^ (r % 8)): the fragment's column pairs
// (rows 8 apart) meet in a bank at most twice (f32) or never (bf16).
template <int E>
__device__ __forceinline__ int sw128(int r, int c) {
  const int box = c / (128 / E), byte = c % (128 / E) * E;
  return box * 8192 + r * 128 + ((byte >> 4) ^ (r & 7)) * 16 + (byte & 15);
}

// Stores (lo, hi), rounded to bf16, at the shared-memory address addr (smem_u32).
__device__ __forceinline__ void st_shared_bf16x2(uint32_t addr, float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(addr), "r"(*reinterpret_cast<const uint32_t*>(&v)));
}

// Stores a consumer warpgroup's 64 x 256 block of products, held in the
// m64n256 fragment (element 4j + 2h + e: row rl + 8h, column 8j + 2q + e,
// with rl = 16 warp + lane / 4 and q = lane % 4), plus the bias (and the
// ReLU in kBiasRelu), as bf16 at (r0, c0) of out (the TMA map map_out):
// T::kOutBoxes boxes of 64 columns at a time are rounded into the
// warpgroup's staging (sw128: every bf16x2 store of a warp hits each bank
// once), then the warpgroup's leader stores them by TMA, one bulk group a
// box, and goes on. Before the staging is written again (the next
// round, or the next tile's epilogue) the leader waits only until those
// stores have read it; their writes to device memory run on under the next
// tile's products. TMA writes no element past the map's edges (rows past M,
// columns past N).
template <typename T>
__device__ __forceinline__ void store_block_tma(const GemmArgs& p, const float (&acc)[128], unsigned char* stage,
                                                const CUtensorMap* map_out, int r0, int c0) {
  const int t = threadIdx.x % 128, lane = t % 32, wg = threadIdx.x / 128;
  const int rl = 16 * (t / 32) + lane / 4, q = lane % 4;
  const bool relu = p.mode == kBiasRelu;
  const uint32_t st = smem_u32(stage);
#pragma unroll
  for (int b0 = 0; b0 < 4; b0 += T::kOutBoxes) {
    if (t == 0) bulk_wait_read();  // the staging's previous stores have read it
    warpgroup_sync(wg);
#pragma unroll
    for (int b = 0; b < T::kOutBoxes; ++b) {
      // the bias pairs of the box's columns: no load is conditional (a
      // column past N reads N - 2's, which the TMA store clips), so the
      // eight are in flight at once
      float2 bias[8];
#pragma unroll
      for (int jj = 0; jj < 8; ++jj)
        bias[jj] = *reinterpret_cast<const float2*>(p.bias + min(c0 + 64 * (b0 + b) + 8 * jj + 2 * q, p.N - 2));
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const int j = 8 * (b0 + b) + jj;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float v0 = acc[4 * j + 2 * h] + bias[jj].x, v1 = acc[4 * j + 2 * h + 1] + bias[jj].y;
          if (relu) v0 = fmaxf(v0, 0.f), v1 = fmaxf(v1, 0.f);
          st_shared_bf16x2(st + sw128<2>(rl + 8 * h, 64 * b + 8 * jj + 2 * q), v0, v1);
        }
      }
    }
    fence_proxy_async();  // the staging writes, seen by the TMA
    warpgroup_sync(wg);
    if (t == 0 && r0 < p.M) {
      for (int b = 0; b < T::kOutBoxes; ++b)
        if (c0 + 64 * (b0 + b) < p.N) tma_store_2d(map_out, stage + b * 8192, c0 + 64 * (b0 + b), r0);
    }
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
// compiler no room to keep in flight), and stores 16 bytes of f32 and, with
// kCopy (bf16 compute), 8 of bf16. N % 8 == 0.
template <bool kCopy>
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
        if constexpr (kCopy) {
          union { uint2 bits; __nv_bfloat162 h[2]; } vb;
          vb.h[0] = __floats2bfloat162_rn(v.x, v.y);
          vb.h[1] = __floats2bfloat162_rn(v.z, v.w);
          *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(p.out_b) + R * p.ldb + C) = vb.bits;
        }
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
// the values into outputs in place and store them through `stage` by TMA
// (store_block_tma); kStem and kStep as the note at the top says. In
// gemm_tf32x3_kernel (T::kTf32) the bias/ReLU modes store f32 column pairs
// from the fragment, the stem writes no bf16 copy, the update writes f32
// x_next into xa, and the LayerNorm modes (the bf16 ones run on
// gemm_wgmma_ln_kernel) store column pairs straight from the fragment.
template <typename T>
__device__ __forceinline__ void wgmma_epilogue(const GemmArgs& p, float (&acc)[T::kWN / 2], unsigned char* stage,
                                               int m0, int n0, int row0, int col0,
                                               const CUtensorMap* map_out = nullptr) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32, rl = 16 * warp + lane / 4;
  const int c = n0 + col0 + 2 * (lane % 4);
  if constexpr (T::kEpi == kEpiBias && !T::kTf32) {  // kBias, kBiasRelu in bf16
    store_block_tma<T>(p, acc, stage, map_out, m0 + row0, n0 + col0);
  } else if constexpr (T::kEpi == kEpiBias) {  // kBias, kBiasRelu in f32: f32 column pairs from the fragment
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
#pragma unroll
    for (int h = 0; h < 2; ++h) {  // each quad of lanes writes 32 contiguous bytes of a row
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
    store_block_f32<!T::kTf32>(p, acc, stage, m0 + row0, n0 + col0, rows);
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
        if constexpr (!T::kTf32)
          *reinterpret_cast<__nv_bfloat162*>(static_cast<__nv_bfloat16*>(p.out_b) + R * p.ldb + C) =
              __floats2bfloat162_rn(v0, v1);
      }
    }
  } else {  // kEpiStep(Noise): the two warpgroups hold the two column halves of the same 64 product rows
    // Product row r is token k = r % (T+1) of window r / (T+1): token 0 is
    // dropped, token k > 0 is output row (r / (T+1)) T + k - 1, so the tile's
    // output rows are one contiguous span [o_lo, o_hi), and its outputs one
    // flat span of the (M, N) arrays. xs holds the span's x0 (kEpiStepNoise:
    // the unclipped A W + b), then x_next.
    constexpr bool noise_model = T::kEpi == kEpiStepNoise;
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
            if constexpr (noise_model)
              *reinterpret_cast<float2*>(dst + C) = make_float2(acc[4 * j + 2 * h] + b.x, acc[4 * j + 2 * h + 1] + b.y);
            else
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
    // the step's scalars from device memory (a captured step replays with the values of its step)
    const float c1 = p.scal[0], c2 = p.scal[1], c3 = p.scal[2];
    const float c4 = noise_model ? p.scal[3] : 0.f, c5 = noise_model ? p.scal[4] : 0.f;
    auto next = [&](float x0, float x, float nz, float v, float m) {
      if constexpr (noise_model) x0 = fminf(fmaxf(__fsub_rn(__fmul_rn(c4, x), __fmul_rn(c5, x0)), -1.f), 1.f);
      const float xn = __fadd_rn(__fadd_rn(__fmul_rn(c1, x0), __fmul_rn(c2, x)), __fmul_rn(c3, nz));
      return inpaint ? xn + m * (v - xn) : xn;
    };
    // pieces a thread loads before it stores any (in gemm_tf32x3_kernel 8 spill)
    constexpr int kInFlight = T::kTf32 ? 4 : 8;
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
    // x_next into the x part of xa (out_b, row stride ldb): in f32 compute
    // f32 column pairs; in bf16, bf16(x_next) in 16-byte pieces of 8
    // columns, then the last N % 8 columns in pairs
    if constexpr (T::kTf32) {
      if (p.out_b != nullptr) {
        const int pairs = p.N / 2;
        for (int i = tid; i < (o_hi - o_lo) * pairs; i += 256) {
          const int row = i / pairs, C = 2 * (i % pairs);
          *reinterpret_cast<float2*>(static_cast<float*>(p.out_b) + (size_t)(o_lo + row) * p.ldb + C) =
              *reinterpret_cast<const float2*>(xs + row * p.N + C);
        }
      }
    } else if (p.out_b != nullptr) {
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
                      const __grid_constant__ CUtensorMap map_out, const GemmArgs p) {
  using T = WgTile<BM, BN, STAGES, EPI>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>((reinterpret_cast<size_t>(smem_raw) + 1023) & ~size_t(1023));
  unsigned char* out_stage = ring + T::kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_stage + T::kOut);
  uint64_t* empty = full + STAGES;
  // persistent: block b takes tiles b, b + gridDim.x, ..., columns fastest;
  // the ring runs on across tiles, so the next tile's loads overlap this
  // tile's epilogue (and in bf16 bias/ReLU the next tile's products this
  // tile's stores)
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
      wgmma_epilogue<T>(p, acc, out_stage + wg * T::kStageWg, t / n_tiles * BM, t % n_tiles * BN, row0, col0,
                        &map_out);
    }
    if (EPI == kEpiBias && leader) bulk_wait_read();  // the last stores have read the staging before it goes
  }
}

// -- gemm_wgmma_ln_kernel: the bf16 LayerNorm products on a cluster (see the note at the top) --

constexpr int kLnThreads = 288;  // consumer warpgroups 0 and 1 (threads 0-255), producer warp 8
constexpr int kLnCluster = 4;    // CTAs of a cluster: the column quarters of a block of 64 rows
constexpr int kLnStages = 3;

// CTA n of a cluster holds 64 rows and the BN = 128 columns from n BN, each
// consumer warpgroup a 64-column half (m64n64k16). Each k-tile of A reaches
// the cluster's CTAs by multicast, 16 rows from each. EPI: one of the four
// LayerNorm layouts.
template <int EPI>
struct LnTile {
  static_assert(ln_epilogue(EPI), "a LayerNorm layout");
  static constexpr int kEpi = EPI;
  static constexpr int kBN = 512 / kLnCluster, kWN = kBN / 2;
  static constexpr int kASlice = 64 / kLnCluster;  // rows of each k-tile of A a CTA loads for the cluster
  static constexpr int kA = 64 * 128, kStage = kA + kBN * 128;
  static constexpr size_t kRing = (size_t)kLnStages * kStage;
  // the tile's residual, then its bf16 output rows, as TMA boxes of 64 rows
  // x 128 bytes with the 128-byte swizzle (sw128)
  static constexpr int kRes = 64 * kBN * 4;
  static constexpr int kResBoxes = kBN * (ln_res_bf16(EPI) ? 2 : 4) / 128;
  // ring (1024-byte aligned for the swizzle), residual and bf16 rows, bias,
  // LayerNorm scale and shift, row statistics (the cluster's CTAs' and the
  // two warpgroups'), barriers
  static constexpr size_t kSmem = kRing + kRes + (3 * kBN + (2 * kLnCluster + 4) * 64) * sizeof(float) +
                                  (2 * kLnStages + 4) * sizeof(uint64_t) + 1024;
  static_assert(2 * (kSmem + 1024) <= 228 * 1024, "two CTAs an SM");
};

// The LayerNorm epilogue of one tile on a cluster: the consumer warpgroup
// wg holds, in its m64nWN fragment (as wgmma_epilogue's), columns n0 + col0..
// of rows m0..; buf holds the tile's residual (TMA), cst the CTA's bias,
// scale and shift, mk the row mask of the thread's two rows. The row
// statistics are f32 sums over the quad, the two warpgroups and then the
// cluster's CTAs, which send their partials into every CTA's stat
// (distributed shared memory); each CTA adds them in rank order, so every
// layout and every CTA gets the same statistics from the same values. jt:
// the CTA's tile count.
template <typename T>
__device__ __forceinline__ void ln_cluster_epilogue(const GemmArgs& p, float (&acc)[T::kWN / 2], unsigned char* buf,
                                                    const float* cst, float* stat, float* part, const float (&mk)[2],
                                                    const CUtensorMap* map_outb, uint64_t* res_full, uint64_t* res_empty, uint64_t* stat_full,
                                                    int m0, int n0, int col0, int rank, int jt) {
  const int lane = threadIdx.x % 32, warp = (threadIdx.x % 128) / 32, rl = 16 * warp + lane / 4;
  const int wg = threadIdx.x / 128, cl = col0 + 2 * (lane % 4);  // cl: the thread's column in the CTA's slice
  const float* bias = cst;
  const float* ln_s = cst + T::kBN;
  const float* ln_b = cst + 2 * T::kBN;
  mbar_wait(res_full, jt & 1);
  // y = (A W + b) + res, in place; columns past N stay 0 and out of the sums
  // (the TMA read zeros past M and N)
  float s[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < T::kWN / 8; ++j) {
    const int c = cl + 8 * j;
    if (n0 + c < p.N) {
      const float2 b = *reinterpret_cast<const float2*>(bias + c);
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        float2 r;
        if constexpr (ln_res_bf16(T::kEpi))
          r = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(buf + sw128<2>(rl + 8 * h, c)));
        else
          r = *reinterpret_cast<const float2*>(buf + sw128<4>(rl + 8 * h, c));
        float& y0 = acc[4 * j + 2 * h];
        float& y1 = acc[4 * j + 2 * h + 1];
        y0 = (y0 + b.x) + r.x;
        y1 = (y1 + b.y) + r.y;
        s[h] += y0 + y1;
      }
    }
  }
  // a row statistic: the quad's sum, the two warpgroups' halves, then the
  // cluster's CTAs' partials in rank order
  auto row_total = [&](float (&v)[2], int stat_i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      v[h] += __shfl_xor_sync(0xffffffffu, v[h], 1);
      v[h] += __shfl_xor_sync(0xffffffffu, v[h], 2);
      if (lane % 4 == 0) part[(2 * stat_i + wg) * 64 + rl + 8 * h] = v[h];
    }
    consumer_sync();
    if (threadIdx.x == 0) mbar_expect_tx(&stat_full[stat_i], kLnCluster * 64 * sizeof(float));
    if (wg == 0 && lane % 4 == 0) {  // 32 threads a CTA send its 64 row partials to every CTA of the cluster
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rl + 8 * h;
        const float t = part[2 * stat_i * 64 + row] + part[(2 * stat_i + 1) * 64 + row];
        float* slot = stat + (stat_i * kLnCluster + rank) * 64 + row;
#pragma unroll
        for (int c = 0; c < kLnCluster; ++c) st_async(cluster_addr(slot, c), t, cluster_addr(&stat_full[stat_i], c));
      }
    }
    mbar_wait(&stat_full[stat_i], jt & 1);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float t = 0.f;
#pragma unroll
      for (int c = 0; c < kLnCluster; ++c) t += stat[(stat_i * kLnCluster + c) * 64 + rl + 8 * h];
      v[h] = t;
    }
  };
  row_total(s, 0);
  const float mean[2] = {s[0] / p.N, s[1] / p.N};
  float q[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < T::kWN / 8; ++j) {
    if (n0 + cl + 8 * j < p.N) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float d0 = acc[4 * j + 2 * h] - mean[h], d1 = acc[4 * j + 2 * h + 1] - mean[h];
        q[h] += d0 * d0 + d1 * d1;
      }
    }
  }
  row_total(q, 1);
  // the outputs: the f32 rows from the fragment (each store instruction
  // writes whole 32-byte sectors, a quad's 8 columns of 8 rows), the bf16
  // rows staged in place of the residual (whose reads all came before the
  // first row_total's barrier) and stored by TMA
  const bool bf16_rows = !ln_f32_out(T::kEpi) || p.out_b != nullptr;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const float inv = rsqrtf(q[h] / p.N + 1e-5f);
    const int R = m0 + rl + 8 * h;
#pragma unroll
    for (int j = 0; j < T::kWN / 8; ++j) {
      const int c = cl + 8 * j;
      if (n0 + c < p.N) {
        const float2 g = *reinterpret_cast<const float2*>(ln_s + c);
        const float2 b = *reinterpret_cast<const float2*>(ln_b + c);
        const float o0 = ((acc[4 * j + 2 * h] - mean[h]) * inv * g.x + b.x) * mk[h];
        const float o1 = ((acc[4 * j + 2 * h + 1] - mean[h]) * inv * g.y + b.y) * mk[h];
        if (ln_f32_out(T::kEpi) && R < p.M)
          *reinterpret_cast<float2*>(static_cast<float*>(p.out) + (size_t)R * p.ldo + n0 + c) = make_float2(o0, o1);
        if (bf16_rows)
          *reinterpret_cast<__nv_bfloat162*>(buf + sw128<2>(rl + 8 * h, c)) = __floats2bfloat162_rn(o0, o1);
      }
    }
  }
  if (bf16_rows) {  // the staged boxes to out_b (rows past M and columns past N are not written)
    fence_proxy_async();  // the staging writes, seen by the TMA
    consumer_sync();
    if (threadIdx.x == 0) {
      for (int b = 0; b * 64 < T::kBN; ++b) tma_store_2d(map_outb, buf + b * 8192, n0 + b * 64, m0);
      bulk_wait_read();
    }
  }
  if (threadIdx.x == 0) mbar_arrive(res_empty);  // buf may take the next tile's residual
}

template <int EPI>
__global__ void __launch_bounds__(kLnThreads, 2)
    gemm_wgmma_ln_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
                         const __grid_constant__ CUtensorMap map_res, const __grid_constant__ CUtensorMap map_outb,
                         const GemmArgs p) {
  using T = LnTile<EPI>;
  constexpr int STAGES = kLnStages;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>((reinterpret_cast<size_t>(smem_raw) + 1023) & ~size_t(1023));
  unsigned char* buf = ring + T::kRing;                    // the tile's residual, then its bf16 rows
  float* cst = reinterpret_cast<float*>(buf + T::kRes);    // bias, ln_s, ln_b of the CTA's columns
  float* stat = cst + 3 * T::kBN;                          // [statistic][CTA][row], written by the cluster's CTAs
  float* part = stat + 2 * kLnCluster * 64;                // [statistic][warpgroup][row]
  uint64_t* full = reinterpret_cast<uint64_t*>(part + 4 * 64);
  uint64_t* empty = full + STAGES;
  uint64_t* res_full = empty + STAGES;
  uint64_t* res_empty = res_full + 1;
  uint64_t* stat_full = res_empty + 1;  // [statistic]
  const int rank = cluster_ctarank(), n0 = rank * T::kBN;
  // persistent: cluster c takes the blocks of 64 rows c, c + clusters, ...
  const int row_blocks = (p.M + 63) / 64, nk = (p.K + kWgBK - 1) / kWgBK;
  const int cid = cluster_id_x(), clusters = cluster_count_x();

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);                   // the producer's arrive, plus the bytes from the peers' TMA
      mbar_init(&empty[s], 2 * kLnCluster);     // each consumer warpgroup of the cluster (A reaches them all)
    }
    mbar_init(res_full, 1);       // the producer's arrive, plus the residual's bytes
    mbar_init(res_empty, 1);      // the bf16 rows have left buf
    mbar_init(&stat_full[0], 1);  // thread 0's arrive, plus the bytes of the cluster's CTAs' partials
    mbar_init(&stat_full[1], 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster_sync();  // every CTA's barriers are set before a peer loads or arrives into it

  if (threadIdx.x >= 256) {
    // producer warp: one thread keeps the ring full (it = k-tiles issued so
    // far) and loads each tile's residual into buf
    if (threadIdx.x == 256) {
      int it = 0, jt = 0;
      for (int g = cid; g < row_blocks; g += clusters, ++jt) {
        const int m0 = g * 64;
        for (int kt = 0; kt < nk; ++kt, ++it) {
          const int s = it % STAGES;
          if (it >= STAGES) mbar_wait(&empty[s], (it / STAGES - 1) & 1);
          unsigned char* st = ring + (size_t)s * T::kStage;
          mbar_expect_tx(&full[s], T::kStage);
          tma_load_2d_multicast(st + rank * T::kASlice * 128, &map_a, &full[s], kt * kWgBK, m0 + rank * T::kASlice,
                                (1u << kLnCluster) - 1);
          tma_load_2d(st + T::kA, &map_w, &full[s], kt * kWgBK, n0);
          // the tile's residual, once its first k-tiles are on their way
          if (kt == (nk < STAGES ? nk : STAGES) - 1) {
            constexpr int kBoxCols = ln_res_bf16(EPI) ? 64 : 32;
            if (jt > 0) mbar_wait(res_empty, (jt - 1) & 1);
            mbar_expect_tx(res_full, T::kResBoxes * 8192);
            for (int b = 0; b < T::kResBoxes; ++b)
              tma_load_2d(buf + b * 8192, &map_res, res_full, n0 + b * kBoxCols, m0);
          }
        }
      }
    }
    __syncwarp();
  } else {
    // consumers: warpgroup wg owns columns n0 + col0.. n0 + col0 + kWN - 1 of each tile's 64 rows
    const int wg = threadIdx.x / 128, col0 = T::kWN * wg;
    const bool leader = threadIdx.x % 128 == 0;
    for (int i = threadIdx.x; i < T::kBN; i += 256) {
      const bool in = n0 + i < p.N;
      cst[i] = in ? p.bias[n0 + i] : 0.f;
      cst[T::kBN + i] = in ? p.ln_s[n0 + i] : 0.f;
      cst[2 * T::kBN + i] = in ? p.ln_b[n0 + i] : 0.f;
    }
    consumer_sync();
    const int rl = 16 * ((threadIdx.x % 128) / 32) + threadIdx.x % 32 / 4;
    int it = 0, jt = 0;
    for (int g = cid; g < row_blocks; g += clusters, ++jt) {
      const int m0 = g * 64;
      // the row mask of the thread's two rows, read while the products run
      const float mk[2] = {m0 + rl < p.M ? p.row_mask[m0 + rl] : 0.f,
                           m0 + rl + 8 < p.M ? p.row_mask[m0 + rl + 8] : 0.f};
      float acc[T::kWN / 2];
#pragma unroll
      for (int i = 0; i < T::kWN / 2; ++i) acc[i] = 0.f;
      for (int kt = 0; kt < nk; ++kt, ++it) {
        const int s = it % STAGES;
        mbar_wait(&full[s], (it / STAGES) & 1);
        const unsigned char* st = ring + (size_t)s * T::kStage;
        const uint64_t da = wg_desc(st), dw = wg_desc(st + T::kA + col0 * 128);
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kWgBK / 16; ++kk) wgmma_k16(acc, da + 2 * kk, dw + 2 * kk);
        wgmma_commit();
        // hand the stage back to every CTA's producer (each loads part of A
        // into it) as soon as its products are done: the ring, not the
        // tensor cores, sets the pace
        wgmma_wait<0>();
        if (leader)
          for (int c = 0; c < kLnCluster; ++c) mbar_arrive_remote(cluster_addr(&empty[s], c));
      }
      ln_cluster_epilogue<T>(p, acc, buf, cst, stat, part, mk, &map_outb, res_full, res_empty, stat_full, m0, n0,
                             col0, rank, jt);
    }
  }
  cluster_sync();  // no CTA leaves while a peer may still load or arrive into its shared memory
}

// -- gemm_tf32x3_kernel: f32 products as 3xTF32 wgmma (see the note at the top) --

constexpr int kTfBK = 16;  // k-tile depth: 16 f32 = one 64-byte swizzle row
// Two consumer warpgroups and no producer warp: thread 0 also keeps the TMA
// ring full. 256 threads leave each up to 255 registers, which the
// accumulators, a k-tile's products and the A fragments need (~200);
// registers are allocated to a block in units of four warps, so a
// producer warp or warpgroup beside them (288 or 384 threads) holds every
// thread to 168 and spills.
constexpr int kTfThreads = 256;

// BM x BN tile, STAGES-deep ring of (A, Whi, Wlo) k-tiles, epilogue EPI;
// the warpgroups split the tile as WgTile's do.
template <int BM, int BN, int STAGES, int EPI>
struct TfTile {
  static constexpr int kEpi = EPI;
  static constexpr bool kTf32 = true;
  static constexpr bool kSplitN = ln_epilogue(EPI) || step_epilogue(EPI) || EPI == kEpiPartial;
  static constexpr int kWN = kSplitN ? BN / 2 : BN;  // columns of one warpgroup's m64nWNk8
  static constexpr int kWBox = BN > 256 ? 256 : BN;  // rows of W in one TMA box
  static constexpr int kChunk = kWN == 104 ? 104 : 128;  // columns of a k-tile's products in registers
  static_assert(BM == (kSplitN ? 64 : 128) && kWN % kChunk == 0 && kWN <= 256 && BN % kWBox == 0,
                "two warpgroups of m64n128k8 or m64n104k8 chunks");
  static constexpr int kA = BM * kTfBK * 4, kB = BN * kTfBK * 4, kStage = kA + 2 * kB;
  static_assert(kA % 512 == 0 && kB % 512 == 0, "sub-tiles on the 64-byte swizzle's 512-byte period");
  static constexpr size_t kRing = (size_t)STAGES * kStage;
  static constexpr int kStageWg = EPI == kEpiStem ? F32Stage::kBytes : 0;
  static constexpr size_t kOut = step_epilogue(EPI) ? (size_t)BM * BN * 4 : 2 * kStageWg;
  static constexpr size_t kSmem = kRing + kOut + 2 * STAGES * sizeof(uint64_t) + 1024;
  static_assert(kSmem <= 227 * 1024, "shared memory of one block");
};

// wgmma descriptor of a K-major f32 (tf32) tile of 64-byte rows with the
// 64-byte swizzle, at a 512-byte aligned base (+ 32 bytes per k8 step):
// 8-row groups 512 bytes apart (SBO 32 x 16 B); LBO is not read.
__device__ __forceinline__ uint64_t wg_desc_sw64(const void* tile) {
  return ((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) | (32ull << 32) | (2ull << 62);
}

// d = A (64 x 8 tf32, the m64nNk8 tf32 A fragment in registers) W^T (8 x 128,
// K-major in shared memory), d the m64n128 fragment
__device__ __forceinline__ void wgmma_tf32_set(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_w) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51]), "=f"(d[52]), "=f"(d[53]), "=f"(d[54]), "=f"(d[55]),
        "=f"(d[56]), "=f"(d[57]), "=f"(d[58]), "=f"(d[59]), "=f"(d[60]), "=f"(d[61]), "=f"(d[62]), "=f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_w), "r"(0));  // scale-d
}

// d += A (64 x 8 tf32, the m64nNk8 tf32 A fragment in registers) W^T (8 x 128,
// K-major in shared memory), d the m64n128 fragment
__device__ __forceinline__ void wgmma_tf32_acc(float (&d)[64], const uint32_t (&a)[4], uint64_t desc_w) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_w), "r"(1));  // scale-d
}

// d = A (64 x 8 tf32, the m64nNk8 tf32 A fragment in registers) W^T (8 x 104,
// K-major in shared memory), d the m64n104 fragment
__device__ __forceinline__ void wgmma_tf32_set(float (&d)[52], const uint32_t (&a)[4], uint64_t desc_w) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51"
      "}, {%52, %53, %54, %55}, %56, p, 1, 1;\n"
      "}\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3]), "=f"(d[4]), "=f"(d[5]), "=f"(d[6]), "=f"(d[7]),
        "=f"(d[8]), "=f"(d[9]), "=f"(d[10]), "=f"(d[11]), "=f"(d[12]), "=f"(d[13]), "=f"(d[14]), "=f"(d[15]),
        "=f"(d[16]), "=f"(d[17]), "=f"(d[18]), "=f"(d[19]), "=f"(d[20]), "=f"(d[21]), "=f"(d[22]), "=f"(d[23]),
        "=f"(d[24]), "=f"(d[25]), "=f"(d[26]), "=f"(d[27]), "=f"(d[28]), "=f"(d[29]), "=f"(d[30]), "=f"(d[31]),
        "=f"(d[32]), "=f"(d[33]), "=f"(d[34]), "=f"(d[35]), "=f"(d[36]), "=f"(d[37]), "=f"(d[38]), "=f"(d[39]),
        "=f"(d[40]), "=f"(d[41]), "=f"(d[42]), "=f"(d[43]), "=f"(d[44]), "=f"(d[45]), "=f"(d[46]), "=f"(d[47]),
        "=f"(d[48]), "=f"(d[49]), "=f"(d[50]), "=f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_w), "r"(0));  // scale-d
}

// d += A (64 x 8 tf32, the m64nNk8 tf32 A fragment in registers) W^T (8 x 104,
// K-major in shared memory), d the m64n104 fragment
__device__ __forceinline__ void wgmma_tf32_acc(float (&d)[52], const uint32_t (&a)[4], uint64_t desc_w) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %57, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n104k8.f32.tf32.tf32 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51"
      "}, {%52, %53, %54, %55}, %56, p, 1, 1;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_w), "r"(1));  // scale-d
}

// One consumer thread's share of a k-tile's A: the m64nNk8 tf32 A fragment
// of both k8 steps. Element i of step j is row ra + 8 (i % 2), column
// 8 j + q + 4 (i / 2) of the 64-byte-swizzled tile (ra = 16 warp + lane / 4,
// q = lane % 4; the swizzle XORs 16-byte chunk c of row r with (r / 2) % 4,
// the same for rows ra and ra + 8), split into hi and lo.
__device__ __forceinline__ void load_split_a(const unsigned char* tile, int ra, int q, uint32_t (&hi)[2][4],
                                             uint32_t (&lo)[2][4]) {
  const int sw = (ra >> 1) & 3;
#pragma unroll
  for (int j = 0; j < 2; ++j) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int chunk = 2 * j + i / 2;
      const float x = *reinterpret_cast<const float*>(tile + (ra + 8 * (i % 2)) * 64 + ((chunk ^ sw) << 4) + 4 * q);
      split_tf32(x, hi[j][i], lo[j][i]);
    }
  }
}

template <int BM, int BN, int STAGES, int EPI>
__global__ void __launch_bounds__(kTfThreads, 1)
    gemm_tf32x3_kernel(const __grid_constant__ CUtensorMap map_a, const __grid_constant__ CUtensorMap map_w,
                       const __grid_constant__ CUtensorMap map_wlo, const GemmArgs p) {
  using T = TfTile<BM, BN, STAGES, EPI>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = reinterpret_cast<unsigned char*>((reinterpret_cast<size_t>(smem_raw) + 1023) & ~size_t(1023));
  unsigned char* out_stage = ring + T::kRing;
  uint64_t* full = reinterpret_cast<uint64_t*>(out_stage + T::kOut);
  uint64_t* empty = full + STAGES;
  // persistent, as gemm_wgmma_kernel
  const int n_tiles = (p.N + BN - 1) / BN, tiles = n_tiles * ((prod_rows(p) + BM - 1) / BM);
  const int nk = (p.K + kTfBK - 1) / kTfBK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);   // the producer's arrive, plus the TMA bytes
      mbar_init(&empty[s], 2);  // one arrive per consumer warpgroup
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // this block's k-tiles in order: it = j nk + kt is k-tile kt of its j-th tile
  const int total = (tiles - blockIdx.x + gridDim.x - 1) / gridDim.x * nk;
  auto issue = [&](int it) {  // the TMA loads of k-tile it into stage it % STAGES
    const int t = blockIdx.x + it / nk * gridDim.x, kt = it % nk, s = it % STAGES;
    const int m0 = t / n_tiles * BM, n0 = t % n_tiles * BN;
    unsigned char* st = ring + (size_t)s * T::kStage;
    mbar_expect_tx(&full[s], T::kStage);
    tma_load_2d(st, &map_a, &full[s], kt * kTfBK, m0);
#pragma unroll
    for (int h = 0; h < BN / T::kWBox; ++h) {
      tma_load_2d(st + T::kA + h * T::kWBox * 64, &map_w, &full[s], kt * kTfBK, n0 + h * T::kWBox);
      tma_load_2d(st + T::kA + T::kB + h * T::kWBox * 64, &map_wlo, &full[s], kt * kTfBK, n0 + h * T::kWBox);
    }
  };
  if (threadIdx.x == 0)
    for (int it = 0; it < STAGES && it < total; ++it) issue(it);

  // warpgroup wg owns rows row0.. row0 + 63 and columns col0.. col0 + kWN - 1 of each tile
  const int wg = threadIdx.x / 128;
  const int row0 = T::kSplitN ? 0 : 64 * wg, col0 = T::kSplitN ? T::kWN * wg : 0;
  const int lane = threadIdx.x % 32, ra = row0 + 16 * ((threadIdx.x % 128) / 32) + lane / 4;
  const bool leader = threadIdx.x % 128 == 0;
  unsigned char* stage = out_stage + wg * T::kStageWg;  // the epilogue's staging
  int it = 0;
  for (int t = blockIdx.x; t < tiles; t += gridDim.x) {
    float acc[T::kWN / 2];
#pragma unroll
    for (int i = 0; i < T::kWN / 2; ++i) acc[i] = 0.f;
    for (int kt = 0; kt < nk; ++kt, ++it) {
      const int s = it % STAGES;
      mbar_wait(&full[s], (it / STAGES) & 1);
      const unsigned char* st = ring + (size_t)s * T::kStage;
      uint32_t hi[2][4], lo[2][4];
      load_split_a(st, ra, lane % 4, hi, lo);
      // chunk by chunk of kChunk columns: the k-tile's six products into
      // part on the tensor cores, then part into acc on the CUDA cores
      // (round to nearest; see the note at the top)
#pragma unroll
      for (int c = 0; c < T::kWN / T::kChunk; ++c) {
        const unsigned char* wt = st + T::kA + (col0 + c * T::kChunk) * 64;
        const uint64_t dh = wg_desc_sw64(wt), dl = wg_desc_sw64(wt + T::kB);
        float part[T::kChunk / 2];
        wgmma_fence();
        wgmma_tf32_set(part, lo[0], dh);  // the small terms first
        wgmma_tf32_acc(part, hi[0], dl);
        wgmma_tf32_acc(part, hi[0], dh);
        wgmma_tf32_acc(part, lo[1], dh + 2);
        wgmma_tf32_acc(part, hi[1], dl + 2);
        wgmma_tf32_acc(part, hi[1], dh + 2);
        wgmma_commit();
        wgmma_wait<0>();  // the other warpgroup keeps the tensor cores busy meanwhile
#pragma unroll
        for (int i = 0; i < T::kChunk / 2; ++i) acc[c * (T::kChunk / 2) + i] += part[i];
      }
      if (leader) mbar_arrive(&empty[s]);  // every product that read the stage is done
      // thread 0 refills the stage once both warpgroups have handed it back
      if (threadIdx.x == 0 && it + STAGES < total) {
        mbar_wait(&empty[s], (it / STAGES) & 1);
        issue(it + STAGES);
      }
      __syncwarp();
    }
    wgmma_epilogue<T>(p, acc, stage, t / n_tiles * BM, t % n_tiles * BN, row0, col0);
  }
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
static cudaError_t launch_wgmma(GemmArgs& p, cudaStream_t stream) {
  using T = WgTile<BM, BN, STAGES, EPI>;
  const int rows = prod_rows(p);
  // A, W; the bf16 out of bias/ReLU, stored by TMA boxes of 64 x 64
  CUtensorMap map_a, map_w, map_out = {};
  if (!tma_map(&map_a, p.a, rows, p.K, p.lda, BM) || !tma_map(&map_w, p.w, p.N, p.K, p.ldw, T::kWBox) ||
      (EPI == kEpiBias && !tma_map(&map_out, p.out, p.M, p.N, p.ldo, 64)))
    return cudaErrorInvalidValue;
  auto kernel = gemm_wgmma_kernel<BM, BN, STAGES, EPI>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (err != cudaSuccess) return err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  p.tiles = ((p.N + BN - 1) / BN) * ((rows + BM - 1) / BM);
  p.grid = p.tiles < sms ? p.tiles : sms;  // one block an SM
  kernel<<<p.grid, kWgThreads, T::kSmem, stream>>>(map_a, map_w, map_out, p);
  return cudaGetLastError();
}

// TMA map of a row-major f32 (rows, cols) matrix with row stride ld, boxes
// of box_rows x box_cols with the swizzle of box_cols x 4 bytes (kTfBK: 64,
// the 3xTF32 k-tiles; 32: 128, the LayerNorm cluster kernel's residual);
// out-of-bounds elements read as zeros.
static bool tma_map_f32(CUtensorMap* map, const void* base, int rows, int cols, int ld, int box_rows,
                        int box_cols = kTfBK) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)ld * 4};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<void*>(base), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, box_cols == 32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int EPI>
static cudaError_t launch_wgmma_ln(const GemmArgs& p, cudaStream_t stream) {
  using T = LnTile<EPI>;
  // A, W; the residual; the bf16 output (where the layout writes it)
  CUtensorMap map_a, map_w, map_res, map_outb = {};
  if (!tma_map(&map_a, p.a, p.M, p.K, p.lda, T::kASlice) || !tma_map(&map_w, p.w, p.N, p.K, p.ldw, T::kBN) ||
      !(ln_res_bf16(EPI) ? tma_map(&map_res, p.res, p.M, p.N, p.N, 64)
                         : tma_map_f32(&map_res, p.res, p.M, p.N, p.N, 64, 32)) ||
      (p.out_b != nullptr && !tma_map(&map_outb, p.out_b, p.M, p.N, p.ldb, 64)))
    return cudaErrorInvalidValue;
  auto kernel = gemm_wgmma_ln_kernel<EPI>;
  cudaLaunchAttribute cluster;
  cluster.id = cudaLaunchAttributeClusterDimension;
  cluster.val.clusterDim.x = kLnCluster, cluster.val.clusterDim.y = 1, cluster.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.blockDim = dim3(kLnThreads);
  cfg.dynamicSmemBytes = T::kSmem;
  cfg.attrs = &cluster;
  cfg.numAttrs = 1;
  // once per instantiation: the shared-memory size, then the clusters that
  // the card holds at once (two CTAs an SM), the persistent grid's size
  static const int max_clusters = [&] {
    int n = 0;
    cudaLaunchConfig_t one = cfg;
    one.gridDim = dim3(kLnCluster);
    if (cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem) != cudaSuccess ||
        cudaOccupancyMaxActiveClusters(&n, kernel, &one) != cudaSuccess)
      return 0;
    return n;
  }();
  if (max_clusters <= 0) return cudaErrorInvalidConfiguration;
  const int row_blocks = (p.M + 63) / 64;
  cfg.gridDim = dim3(kLnCluster * (row_blocks < max_clusters ? row_blocks : max_clusters));
  cfg.stream = stream;
  const cudaError_t err = cudaLaunchKernelEx(&cfg, kernel, map_a, map_w, map_res, map_outb, p);
  return err != cudaSuccess ? err : cudaGetLastError();
}

template <int BM, int BN, int STAGES, int EPI>
static cudaError_t launch_tf32(const GemmArgs& p, cudaStream_t stream) {
  using T = TfTile<BM, BN, STAGES, EPI>;
  const int rows = prod_rows(p);
  CUtensorMap map_a, map_w, map_wlo;
  if (!tma_map_f32(&map_a, p.a, rows, p.K, p.lda, BM) || !tma_map_f32(&map_w, p.w, p.N, p.K, p.ldw, T::kWBox) ||
      !tma_map_f32(&map_wlo, p.w_lo, p.N, p.K, p.ldw, T::kWBox))
    return cudaErrorInvalidValue;
  auto kernel = gemm_tf32x3_kernel<BM, BN, STAGES, EPI>;
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)T::kSmem);
  if (err != cudaSuccess) return err;
  int device, sms;
  if ((err = cudaGetDevice(&device)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device)) != cudaSuccess)
    return err;
  const int tiles = ((p.N + BN - 1) / BN) * ((rows + BM - 1) / BM);
  kernel<<<tiles < sms ? tiles : sms, kTfThreads, T::kSmem, stream>>>(map_a, map_w, map_wlo, p);  // one block an SM
  return cudaGetLastError();
}

static bool aligned16(const void* ptr) { return reinterpret_cast<size_t>(ptr) % 16 == 0; }

// The f32-compute route: gemm_tf32x3_kernel, one instantiation per epilogue
// and layout. A (rows, K) f32, Whi (w) and Wlo (w_lo) (N, K) f32, K-major,
// with 16-byte rows and bases; f32 out, or in kLayerNorm with bf16
// activations the bf16 out_b alone; kStep may write x_next into the f32 xa
// (out_b, row stride ldb).
static cudaError_t tf32_route(const GemmArgs& p, cudaStream_t s) {
  const bool ok = !p.a_bf16 && !p.out_bf16 && p.w_lo != nullptr && p.K % 4 == 0 &&
                  p.lda % 4 == 0 && p.ldw % 4 == 0 && aligned16(p.a) && aligned16(p.w) && aligned16(p.w_lo) &&
                  aligned16(p.out) && aligned16(p.res) && aligned16(p.out_b);
  if (!ok || (p.out_b != nullptr && p.out != nullptr && p.mode != kStep)) return cudaErrorInvalidValue;
  switch (p.mode) {
    case kBias:
    case kBiasRelu:  // f32 out in column pairs
      if (p.N % 2 || p.ldo % 2) return cudaErrorInvalidValue;
      return launch_tf32<128, 256, 5, kEpiBias>(p, s);
    case kLayerNorm:  // whole rows in one tile
      if (p.N % 8 || p.N > 512 || p.ldo % 8 || (p.out_b != nullptr && p.ldb % 8)) return cudaErrorInvalidValue;
      switch (ln_epilogue_of(p)) {
        case kEpiLayerNorm: return launch_tf32<64, 512, 3, kEpiLayerNorm>(p, s);
        case kEpiLnResBf16: return launch_tf32<64, 512, 3, kEpiLnResBf16>(p, s);
        case kEpiLnBf16Out: return launch_tf32<64, 512, 3, kEpiLnBf16Out>(p, s);
        default: return launch_tf32<64, 512, 3, kEpiLnBf16>(p, s);
      }
    case kPartial:
      if (p.N % 8 || p.ldo % 8) return cudaErrorInvalidValue;
      return launch_tf32<64, 512, 3, kEpiPartial>(p, s);
    case kStem:  // A = the f32 xa (B t_data, K); f32 out (B (t_data + 1), N)
      if (p.N % 8 || p.ldo % 8 || p.M % (p.t_data + 1)) return cudaErrorInvalidValue;
      return launch_tf32<128, 256, 4, kEpiStem>(p, s);
    default:  // kStep: as in bf16; out_b the f32 xa
      if (!(p.N % 2 == 0 && p.N <= 208 && p.ldo == p.N && p.M % p.t_data == 0 && (size_t)p.M * p.N < (1u << 31) &&
            aligned16(p.x) && aligned16(p.noise) && aligned16(p.ipv) && (p.ipv == nullptr || p.ipm != nullptr) &&
            (p.out_b == nullptr || (p.ldb >= p.N && p.ldb % 2 == 0))))
        return cudaErrorInvalidValue;
      return p.step_noise ? launch_tf32<64, 208, 4, kEpiStepNoise>(p, s) : launch_tf32<64, 208, 4, kEpiStep>(p, s);
  }
}

// The argument checks of egoego_gemm, the one C entry.
static bool valid_args(const GemmArgs& p) {
  if (p.M <= 0 || p.N <= 0 || p.K <= 0 || p.mode < kBias || p.mode > kPartial ||
      ((p.mode == kStem || p.mode == kStep) && p.t_data <= 0) || (p.step_noise && p.mode != kStep) ||
      (p.mode == kStep && p.scal == nullptr))
    return false;
  // a bf16 residual, and an output that leaves as its bf16 copy alone, only in kLayerNorm
  return !((p.res_bf16 && p.mode != kLayerNorm) || (p.out == nullptr && (p.mode != kLayerNorm || p.out_b == nullptr)));
}

}  // namespace egoego

// Launches one product; the compute type alone picks the kernel: bf16
// gemm_wgmma_kernel, f32 gemm_tf32x3_kernel. Sets p->kernel to the
// GemmKernel launched. A layout that the picked kernel cannot take returns
// cudaErrorInvalidValue and launches nothing.
extern "C" int egoego_gemm(egoego::GemmArgs* p, void* stream) {
  using namespace egoego;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int invalid = (int)cudaErrorInvalidValue;
  p->kernel = -1;
  p->tiles = p->grid = 0;
  if (!valid_args(*p)) return invalid;
  if (!p->compute_bf16) {
    const cudaError_t err = tf32_route(*p, s);
    if (err == cudaSuccess) p->kernel = kKernelTf32x3;
    return (int)err;
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
    case kLayerNorm:  // f32 out (and its bf16 copy) or the bf16 out alone, whole rows on one cluster
      if (!(ok && !p->out_bf16 && p->N % 8 == 0 && p->N <= 512 && p->ldo % 8 == 0)) return invalid;
      switch (ln_epilogue_of(*p)) {
        case kEpiLayerNorm: err = launch_wgmma_ln<kEpiLayerNorm>(*p, s); break;
        case kEpiLnResBf16: err = launch_wgmma_ln<kEpiLnResBf16>(*p, s); break;
        case kEpiLnBf16Out: err = launch_wgmma_ln<kEpiLnBf16Out>(*p, s); break;
        default: err = launch_wgmma_ln<kEpiLnBf16>(*p, s);
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
      err = p->step_noise ? launch_wgmma<64, 208, 4, kEpiStepNoise>(*p, s) : launch_wgmma<64, 208, 4, kEpiStep>(*p, s);
  }
  if (err == cudaSuccess) p->kernel = kKernelWgmma;
  return (int)err;
}

extern "C" int egoego_gemm_args_size() { return (int)sizeof(egoego::GemmArgs); }
