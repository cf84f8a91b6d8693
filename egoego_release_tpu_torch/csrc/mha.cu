// Unmasked multi-head attention over long sequences: f32 in, f32 out, on
// the tensor cores at f32 accuracy (3xTF32).
//
// Replaces egoego_release_tpu/ops/attention.py _mha_kernel (via
// fused_attention, the pallas_call at :63): per (batch, head), scores
// q k^T * scale, keys at or past t_keys masked, an f32 softmax, then p v,
// written in f32. The JAX package routes a MultiHeadAttention there when it
// has 256 or more query tokens and no mask: the HeadFormer of stage 1 at a
// window of 256 frames or more, in f32.
//
// Why 3xTF32 and not one TF32 pass. A TF32 operand keeps 10 mantissa bits.
// Attention at (1, 4, 256, 256) with randn inputs, both products emulated on
// the CPU as this kernel does them, against a float64 reference
// (tests/test_torch_attention.py test_tf32_passes_against_float64): one
// TF32 pass errs above 1e-4, 3xTF32 below 1e-5, as plain f32 does. The
// stage-1 path is held at 1e-4, so one pass is out. Each operand x is
// split into hi + lo (split_tf32) and a product is lo*hi + hi*lo + hi*hi:
// three mma.sync.m16n8k8 TF32 products into f32 accumulators (lo*lo, ~2^-22
// relative, is dropped). Operands are split on the fly, from shared memory
// into registers; no hi/lo copy is stored.
//
// What bounds it on the H100: at the stage-1 shapes (T = 256-1024, head
// width 256) a head does 2 T^2 (d_k + d_v) FLOP on 4 T (2 d_k + 2 d_v)
// bytes, three TF32 products each, so operations: 3 FLOPs / 495 TFLOP/s,
// e.g. 3.3 us at (2, 4, 256, 256) against 0.6 us for its bytes. mma.sync
// reaches only part of the 495 TFLOP/s (wgmma the rest; chip_smoke.py
// measures it), and the kernel also loses to re-reading K and V, through
// L2, once per query block (PERF.md).
//
// Tiling. 8 warps a block, which owns 16 MT queries (MT m16 row tiles) of
// one (batch, head): grid (ceil(T / (16 MT)), H, B). K and V stream through
// shared memory in 64-key tiles; warp w takes row tile w / KG and key group
// w % KG (KG = 8 / MT) of every tile, with its own running max and sum and
// a 16 x d_v accumulator (128 registers a thread at 256). The key groups
// merge through shared memory once, at the end.
// - MT = 4 (64 queries, 2 key groups of 32 keys): K and V are read once per
//   64 queries, and each K or V fragment split feeds four score or output
//   tiles; about twice as fast per query as MT = 1.
// - MT = 1 (16 queries, 8 key groups of 8 keys): four times the blocks, for
//   grids with fewer than half as many 64-query blocks as SMs.
// Blocks at chip_smoke.py's four shapes: (2, 4, 256) MT = 1, 128 blocks
// (path D's shape: one on 128 of the 132 SMs); (8, 4, 256) MT = 4, 128;
// (4, 4, 300) MT = 4, 80; (2, 4, 1024) MT = 4, 128.
//
// Fragments (g = lane / 4, t = lane % 4; a k8 step's A is 16 x 8, B 8 x 8):
// - q k^T. The 8 head-width columns of a k step are permuted so that lane t
//   takes columns 4t..4t+3 of every 16 for two steps: one 16-byte load per
//   Q row and per key feeds two steps.
// - p v. The probabilities are neither staged through shared memory nor
//   shuffled: within each 8-key score tile, k slot t of p v is key 2t and
//   slot t + 4 key 2t + 1, which makes the score tile's C fragment (c0, c1,
//   c2, c3) the A fragment (c0, c2, c1, c3) of p v in the same lane. The
//   output columns of every 32 are permuted (n slot g of n tile j is column
//   4g + j), so one 16-byte load of a V row feeds four n tiles and each lane
//   holds 8 adjacent columns of its rows.
// - Tiles are copied at a width that is a power of two (at least 32 and d),
//   zero-filled past d, with row strides of that width + 16 floats (Q, K)
//   and + 4 (V), which keep every 16-byte fragment load free of bank
//   conflicts. Head widths need only be multiples of 4: the products run
//   over d_k rounded up to 16 columns and d_v rounded up to 32.
//
// Shared memory at head width 256: Q 16 MT x 272, K 64 x 272, V 64 x 260
// floats (154 KB at MT = 1, 206 KB at MT = 4), one block an SM. The tiles
// arrive by cp.async, each one's copy in flight while the block computes on
// the other operand: V of a tile during its scores, K of the next tile
// during p v. Two block barriers a tile: each makes one operand's copy
// visible and frees the other operand's tile for its next copy.

#include <cstdint>

#include "common.cuh"

namespace egoego {

struct MhaArgs {
  const float* q;  // element (b, h, t, c) at b * q_sb + h * q_sh + t * q_st + c
  const float* k;
  const float* v;
  float* out;      // (b, h, t, c) at b * o_sb + h * o_sh + t * o_st + c
  long long q_sb, q_sh, q_st, k_sb, k_sh, k_st, v_sb, v_sh, v_st, o_sb, o_sh, o_st;
  int B, H, T, t_keys, d_k, d_v;
  float scale;
};

constexpr int kWarps = 8;
constexpr int kMhaThreads = 32 * kWarps;
constexpr int kBK = 64;        // keys per streamed tile
constexpr int kMaxD = 256;
constexpr int kGroups = kMaxD / 32;  // 32-column groups of the output, four n8 tiles each

__host__ __device__ constexpr int round_up(int x, int m) { return (x + m - 1) / m * m; }

// the least power of two >= x that is at least 32
__host__ __device__ inline int pow2_32(int x) {
  int p = 32;
  while (p < x) p *= 2;
  return p;
}

struct MhaLayout {
  int dk16, dv32;  // widths the products run over: d_k to 16 columns, d_v to 32
  int wqk, wv;     // tile widths copied, zero-filled past d: powers of two, which tile 256 threads evenly
  int ldqk, ldv;   // row strides
  size_t k, v, bytes;
  __host__ __device__ MhaLayout(int d_k, int d_v, int bq) {
    dk16 = round_up(d_k, 16);
    dv32 = round_up(d_v, 32);
    wqk = pow2_32(d_k);
    wv = pow2_32(d_v);
    ldqk = wqk + 16;
    ldv = wv + 4;
    k = (size_t)bq * ldqk;
    v = k + (size_t)kBK * ldqk;
    // the tiles, or at the end the key groups' output slices (kWarps x 16
    // rows in all) from K on
    const size_t tiles = v + (size_t)kBK * ldv, slices = k + (size_t)kWarps * 16 * ldv;
    bytes = sizeof(float) * (tiles > slices ? tiles : slices);
  }
};

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// Copies of a tile of width w floats (a power of two from 32 to 256), 16
// bytes each: thread tid takes column 4 (tid % (w / 4)) of rows
// tid / (w / 4), + dr, + 2 dr, ...
struct TileCopy {
  int r0, c, dr;
  __device__ TileCopy(int w, int tid) : r0(tid / (w / 4)), c(4 * (tid % (w / 4))), dr(kMhaThreads / (w / 4)) {}
  // Queue the copy of rows [row0, row0 + rows) of an (n_rows, d) operand
  // into a tile of row stride ld; rows at or past n_rows and columns at or
  // past d (a multiple of 4) are zero-filled.
  __device__ __forceinline__ void operator()(float* dst, int ld, const float* src, long long st, int row0,
                                             int rows, int n_rows, int d) const {
    const bool col = c < d;
    const float* s = src + (row0 + r0) * st + c;
    float* o = dst + r0 * ld + c;
    for (int r = r0; r < rows; r += dr, s += dr * st, o += dr * ld) {
      const bool ok = col && row0 + r < n_rows;
      cp_async16(o, ok ? s : src, ok);
    }
  }
};

// c (16 x 8) += a (16 x 8) b (8 x 8) on the tensor cores, TF32 operands
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A block owns 16 MT queries (MT m16 row tiles) of one (batch, head). Warp
// w takes row tile w / KG and key group w % KG: NT = MT 8-key score tiles
// of every 64-key tile.
template <int MT>
__global__ void __launch_bounds__(kMhaThreads, 1) mha_kernel(const MhaArgs p) {
  constexpr int kBQ = 16 * MT;
  constexpr int KG = kWarps / MT;  // key groups
  constexpr int NT = kBK / (8 * KG);
  // with one score tile a warp, the three products of each k step go to
  // separate accumulators, so that six mma chains interleave
  constexpr int kTerms = NT == 1 ? 3 : 1;
  static_assert(KG * MT == kWarps && NT * 8 * KG == kBK, "MT must divide the warps");
  extern __shared__ __align__(16) float sm[];
  const MhaLayout L(p.d_k, p.d_v, kBQ);
  float* Qs = sm;        // kBQ x ldqk
  float* Ks = sm + L.k;  // kBK x ldqk
  float* Vs = sm + L.v;  // kBK x ldv

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5, g = lane >> 2, t = lane & 3;
  const int mt = warp / KG, kg = warp % KG;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const float* q = p.q + b * p.q_sb + h * p.q_sh;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh;

  const TileCopy copy_qk(L.wqk, tid), copy_v(L.wv, tid);
  // Q rows [q0, q0 + kBQ) and the first K tile: one group
  copy_qk(Qs, L.ldqk, q, p.q_st, q0, kBQ, p.T, p.d_k);
  copy_qk(Ks, L.ldqk, k, p.k_st, 0, kBK, p.t_keys, p.d_k);
  cp_async_commit();

  // this lane's fragment rows: Q row 16 mt + g (and + 8); key 8 NT kg + g
  // (+ 8n for score tile n); V rows 8 NT kg + 2t and + 1 (+ 8n for k step n)
  const float* qf = Qs + (16 * mt + g) * L.ldqk + 4 * t;
  const float* kf = Ks + (8 * NT * kg + g) * L.ldqk + 4 * t;
  const float* vf = Vs + (8 * NT * kg + 2 * t) * L.ldv + 4 * g;
  const int n_groups = L.dv32 / 32;

  float m[2] = {-INFINITY, -INFINITY};  // running max of rows g and g + 8 over the key group
  float l[2] = {0.f, 0.f};              // this lane's share of their running sums
  float acc[kGroups][4][4];             // [32-column group][n tile][C fragment]
#pragma unroll
  for (int c = 0; c < kGroups; ++c)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[c][j][e] = 0.f;

  for (int j0 = 0; j0 < p.t_keys; j0 += kBK) {
    cp_async_wait<0>();  // this K tile (and Q) have landed
    __syncthreads();     // ... for every thread, and p v of the previous tile is done with Vs
    // V of this tile streams in while the scores are computed
    copy_v(Vs, L.ldv, v, p.v_st, j0, kBK, p.t_keys, p.d_v);
    cp_async_commit();

    float s[2][kTerms][NT][4] = {};  // [k step parity][product][score tile]
#pragma unroll 2
    for (int c = 0; c < L.dk16; c += 16) {
      const float4 xa = ld4(qf + c), xb = ld4(qf + 8 * L.ldqk + c);
      uint32_t ah[2][4], al[2][4];  // A of k steps 0 (columns 4t, 4t + 1) and 1 (4t + 2, 4t + 3)
      split_tf32(xa.x, ah[0][0], al[0][0]);
      split_tf32(xb.x, ah[0][1], al[0][1]);
      split_tf32(xa.y, ah[0][2], al[0][2]);
      split_tf32(xb.y, ah[0][3], al[0][3]);
      split_tf32(xa.z, ah[1][0], al[1][0]);
      split_tf32(xb.z, ah[1][1], al[1][1]);
      split_tf32(xa.w, ah[1][2], al[1][2]);
      split_tf32(xb.w, ah[1][3], al[1][3]);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float4 y = ld4(kf + 8 * n * L.ldqk + c);
        uint32_t bh[4], bl[4];
        split_tf32(y.x, bh[0], bl[0]);
        split_tf32(y.y, bh[1], bl[1]);
        split_tf32(y.z, bh[2], bl[2]);
        split_tf32(y.w, bh[3], bl[3]);
#pragma unroll
        for (int st = 0; st < 2; ++st) {  // lo hi + hi lo + hi hi
          mma_tf32(s[st][0][n], al[st], bh[2 * st], bh[2 * st + 1]);
          mma_tf32(s[st][1 % kTerms][n], ah[st], bl[2 * st], bl[2 * st + 1]);
          mma_tf32(s[st][2 % kTerms][n], ah[st], bh[2 * st], bh[2 * st + 1]);
        }
      }
    }

    // online softmax over the key group: lane (g, t) holds keys 8 NT kg +
    // 8n + 2t (C fragment 0, 2) and + 1 (1, 3) of rows g (0, 1) and g + 8
    // (2, 3); a row's 4 lanes are lane bits 0-1
    const int key0 = j0 + 8 * NT * kg + 2 * t;
    float sc[NT][4], alpha[2];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[0][kTerms - 1][n][e] + s[1][kTerms - 1][n][e];
#pragma unroll
        for (int a = kTerms - 2; a >= 0; --a) x = (s[0][a][n][e] + s[1][a][n][e]) + x;
        sc[n][e] = key0 + 8 * n + (e & 1) < p.t_keys ? x * p.scale : -INFINITY;
      }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NT; ++n) mx = fmaxf(mx, fmaxf(sc[n][2 * r], sc[n][2 * r + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[r], mx);
      // a key group may have seen only masked keys so far (T < 64): keep exp finite
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      alpha[r] = expf(m[r] - m_use);  // 0 on the group's first live tile
      m[r] = m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int e = 2 * r; e < 2 * r + 2; ++e) {
          sc[n][e] = expf(sc[n][e] - m_use);  // exp(-inf) = 0 masks
          sum += sc[n][e];
        }
      l[r] = l[r] * alpha[r] + sum;
    }
    cp_async_wait<0>();  // this V tile has landed
    __syncthreads();     // ... for every thread, and the scores are done with Ks
    // the next K tile streams in during p v
    if (j0 + kBK < p.t_keys) {
      copy_qk(Ks, L.ldqk, k, p.k_st, j0 + kBK, kBK, p.t_keys, p.d_k);
      cp_async_commit();
    }

    if (__any_sync(0xffffffffu, alpha[0] != 1.f || alpha[1] != 1.f)) {  // a row max moved
#pragma unroll
      for (int c = 0; c < kGroups; ++c)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          acc[c][j][0] *= alpha[0];
          acc[c][j][1] *= alpha[0];
          acc[c][j][2] *= alpha[1];
          acc[c][j][3] *= alpha[1];
        }
    }
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t ph[4], pl[4];  // the A fragment of k step n: (c0, c2, c1, c3) of score tile n
      split_tf32(sc[n][0], ph[0], pl[0]);
      split_tf32(sc[n][2], ph[1], pl[1]);
      split_tf32(sc[n][1], ph[2], pl[2]);
      split_tf32(sc[n][3], ph[3], pl[3]);
#pragma unroll
      for (int c = 0; c < kGroups; ++c) {
        if (c < n_groups) {
          // B of n tiles 0-3: V rows 2t and 2t + 1 of k step n, column 4g + j
          const float4 y0 = ld4(vf + 8 * n * L.ldv + 32 * c), y1 = ld4(vf + (8 * n + 1) * L.ldv + 32 * c);
          const float b0[4] = {y0.x, y0.y, y0.z, y0.w}, b1[4] = {y1.x, y1.y, y1.z, y1.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            uint32_t h0, l0, h1, l1;
            split_tf32(b0[j], h0, l0);
            split_tf32(b1[j], h1, l1);
            mma_tf32(acc[c][j], pl, h0, h1);
            mma_tf32(acc[c][j], ph, l0, l1);
            mma_tf32(acc[c][j], ph, h0, h1);
          }
        }
      }
    }
  }

  // merge the key groups: row max and sum per group into the Q tile (no
  // longer read), then each warp's accumulator scaled by exp(m_kg - M) / L
  // into its group's kBQ-row slice from K on, summed by the whole block
  float* m_sm = Qs;             // [kg][row]
  float* l_sm = Qs + KG * kBQ;  // [kg][row]
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (t == 0) {
      m_sm[kg * kBQ + 16 * mt + 8 * r + g] = m[r];
      l_sm[kg * kBQ + 16 * mt + 8 * r + g] = l[r];
    }
  }
  __syncthreads();
  float* slice = Ks + kg * kBQ * L.ldv + 8 * t;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int row = 16 * mt + 8 * r + g;
    float mx = m_sm[row];
#pragma unroll
    for (int w = 1; w < KG; ++w) mx = fmaxf(mx, m_sm[w * kBQ + row]);  // finite: group 0 holds key 0
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < KG; ++w) sum += l_sm[w * kBQ + row] * expf(m_sm[w * kBQ + row] - mx);
    const float f = expf(m[r] - mx) / sum;
#pragma unroll
    for (int c = 0; c < kGroups; ++c) {
      if (c < n_groups) {
        // n tile j holds columns 8t + j (fragment 0, 2) and 8t + 4 + j (1, 3)
        float* o = slice + row * L.ldv + 32 * c;
        const float(&a)[4][4] = acc[c];
        st4(o, make_float4(a[0][2 * r] * f, a[1][2 * r] * f, a[2][2 * r] * f, a[3][2 * r] * f));
        st4(o + 4, make_float4(a[0][2 * r + 1] * f, a[1][2 * r + 1] * f, a[2][2 * r + 1] * f, a[3][2 * r + 1] * f));
      }
    }
  }
  __syncthreads();
  float* out = p.out + b * p.o_sb + h * p.o_sh;
  const int d4 = p.d_v / 4;
  for (int idx = tid; idx < kBQ * d4; idx += kMhaThreads) {
    const int r = idx / d4, c = (idx - r * d4) * 4;
    if (q0 + r >= p.T) break;  // rows only grow with idx
    float4 a = ld4(Ks + r * L.ldv + c);
#pragma unroll
    for (int w = 1; w < KG; ++w) {
      const float4 x = ld4(Ks + (w * kBQ + r) * L.ldv + c);
      a.x += x.x;
      a.y += x.y;
      a.z += x.z;
      a.w += x.w;
    }
    st4(out + (q0 + r) * p.o_st + c, a);
  }
}

}  // namespace egoego

extern "C" int egoego_mha(const egoego::MhaArgs* p, void* stream) {
  using namespace egoego;
  if (p->d_k < 4 || p->d_v < 4 || p->d_k > kMaxD || p->d_v > kMaxD || p->d_k % 4 || p->d_v % 4 ||
      p->t_keys < 1 || p->t_keys > p->T || p->H > 65535 || p->B > 65535)
    return (int)cudaErrorInvalidValue;
  // 64-query blocks read K and V a quarter as often and split each K and V
  // fragment for four row tiles, about twice as fast per query as 16-query
  // blocks (PERF.md); they pay once there are half as many of them as SMs
  // per device, read or set once: its SM count, and the dynamic shared
  // memory each instance may take
  constexpr int kMaxDevices = 64;
  static int n_sm[kMaxDevices], smem_allowed[kMaxDevices][2];
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!n_sm[dev] && (err = cudaDeviceGetAttribute(&n_sm[dev], cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return (int)err;
  const int mt = 2LL * p->B * p->H * ((p->T + 63) / 64) >= n_sm[dev] ? 4 : 1;
  const MhaLayout L(p->d_k, p->d_v, 16 * mt);
  const auto kernel = mt == 4 ? mha_kernel<4> : mha_kernel<1>;
  int& allowed = smem_allowed[dev][mt == 4];
  if ((int)L.bytes > allowed) {
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
    if (err != cudaSuccess) return (int)err;
    allowed = (int)L.bytes;
  }
  const dim3 grid((p->T + 16 * mt - 1) / (16 * mt), p->H, p->B);
  kernel<<<grid, kMhaThreads, L.bytes, static_cast<cudaStream_t>(stream)>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" int egoego_mha_args_size() { return (int)sizeof(egoego::MhaArgs); }
