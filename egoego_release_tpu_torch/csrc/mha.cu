// Unmasked multi-head attention over long sequences, f32.
//
// Replaces egoego_release_tpu/ops/attention.py _mha_kernel (via
// fused_attention): per (batch, head), scores q k^T * scale with f32
// accumulation, keys at or past t_keys masked, an f32 softmax with p kept
// f32, then p v, written in f32. The JAX package routes a MultiHeadAttention
// there when it has 256 or more query tokens and no mask: the HeadFormer of
// stage 1 at a window of 256 frames or more, in f32.
//
// The TPU kernel held a head's whole (T, T) score block in VMEM. Here a
// block owns 32 queries of one (batch, head) and streams K and V through
// shared memory in 32-row tiles with an online softmax: a running row max
// and sum in f32 and f32 accumulators for the 32 x d_v output. The tiles
// arrive by cp.async, each one's copy in flight while the block computes
// on the other operand: V of a tile during its scores, K of the next tile
// during p v. Shared memory is 32 (d_k + 4) + 2 x 32 (max(d_k, d_v) + 4) +
// 32 x 36 + 64 floats whatever T is (~104 KB at head width 256, two blocks
// an SM), unlike csrc/attention.cu, whose resident score rows grow with the
// key count.
//
// What bounds it on the H100: at the stage-1 shapes (T = 256-1024, head
// width 256) 2 T^2 (d_k + d_v) FLOP against 4 T (2 d_k + 2 d_v) bytes per
// head, so operations, at the card's f32 CUDA-core rate (no TF32: the
// stage-1 path is held at 1e-4). Both products are register-tiled so that
// shared-memory loads do not bound them: for q k^T a thread holds a 4 x 2
// tile of scores and reads 16-byte vectors of q and k (6 loads for 32
// FMAs); for p v a thread holds an 8 x 8 tile of the output (4 loads for
// 64 FMAs). Operands are read as float4, so head widths and the row, head
// and batch strides must be multiples of 4 floats (the wrapper checks).

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

constexpr int kMhaThreads = 128;  // 4 warps
constexpr int kBQ = 32;           // queries per block: warp w owns output rows 8w..8w+7
constexpr int kBK = 32;           // keys per streamed tile
constexpr int kMaxD = 256;        // lane l owns output columns 4l..4l+3 and 128+4l..128+4l+3
constexpr int kLdP = kBQ + 4;     // row stride of the transposed probability tile
static_assert(kBQ == kBK && kBQ == 32 && kMhaThreads == 128, "the thread-to-tile maps assume these");

struct MhaLayout {
  int ldq, ldkv;  // row strides of the Q and K/V tiles: +4 keeps rows 16-byte aligned and on distinct banks
  size_t k, v, pt, alpha, inv_l, bytes;
  __host__ __device__ MhaLayout(int d_k, int d_v) {
    ldq = d_k + 4;
    ldkv = (d_k > d_v ? d_k : d_v) + 4;
    k = (size_t)kBQ * ldq;
    v = k + (size_t)kBK * ldkv;
    pt = v + (size_t)kBK * ldkv;
    alpha = pt + (size_t)kBK * kLdP;
    inv_l = alpha + kBQ;
    bytes = sizeof(float) * (inv_l + kBQ);
  }
};

__device__ __forceinline__ float4 ld4(const float* p) { return *reinterpret_cast<const float4*>(p); }

__device__ __forceinline__ void st4(float* p, float4 v) { *reinterpret_cast<float4*>(p) = v; }

// Queue the copy of rows [row0, row0 + kBK) of a (T, d) operand into a tile
// of row stride ld, 16 bytes a copy; rows at or past n_rows are zero-filled.
// Thread tid copies column group tid % (d / 4) of every (kMhaThreads / (d / 4))-th row.
__device__ __forceinline__ void copy_tile(float* dst, int ld, const float* src, long long st, int row0,
                                          int n_rows, int d, int tid) {
  const int d4 = d / 4, step = kMhaThreads / d4, r0 = tid / d4, c = (tid - r0 * d4) * 4;
  if (r0 >= step) return;
  for (int r = r0; r < kBK; r += step) {
    const bool ok = row0 + r < n_rows;
    cp_async16(dst + r * ld + c, ok ? src + (row0 + r) * st + c : src, ok);
  }
}

__global__ void __launch_bounds__(kMhaThreads, 2) mha_kernel(const MhaArgs p) {
  extern __shared__ __align__(16) float sm[];
  const MhaLayout L(p.d_k, p.d_v);
  float* Qs = sm;              // kBQ x ldq
  float* Ks = sm + L.k;        // kBK x ldkv
  float* Vs = sm + L.v;        // kBK x ldkv
  float* Pt = sm + L.pt;       // kBK x kLdP: probabilities of the tile, key-major
  float* alpha = sm + L.alpha; // kBQ rescale factors of the tile
  float* inv_l = sm + L.inv_l; // kBQ reciprocal row sums

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int q0 = blockIdx.x * kBQ, h = blockIdx.y, b = blockIdx.z;
  const float* q = p.q + b * p.q_sb + h * p.q_sh;
  const float* k = p.k + b * p.k_sb + h * p.k_sh;
  const float* v = p.v + b * p.v_sb + h * p.v_sh;

  // Q rows [q0, q0 + kBQ) (kBQ == kBK, so the tile copier serves) and the
  // first K tile: one group
  copy_tile(Qs, L.ldq, q, p.q_st, q0, p.T, p.d_k, tid);
  copy_tile(Ks, L.ldkv, k, p.k_st, 0, p.t_keys, p.d_k, tid);
  cp_async_commit();

  // scores: ty owns rows 4ty..4ty+3, tx owns keys tx and tx + 16 of the tile;
  // the 16 lanes of one ty are lane bits 0-3, so row reductions are 4 shuffles
  const int ty = tid >> 4, tx = tid & 15;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }
  // output: rows 8 warp + r, columns c0..c0+3 and c1..c1+3
  const int c0 = lane * 4, c1 = 128 + lane * 4;
  const bool has0 = c0 < p.d_v, has1 = c1 < p.d_v;
  float acc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) acc[r][c] = 0.f;

  for (int j0 = 0; j0 < p.t_keys; j0 += kBK) {
    // V of this tile streams in while the scores are computed; p v of the
    // previous tile is done reading Vs (the barrier at the loop's end)
    copy_tile(Vs, L.ldkv, v, p.v_st, j0, p.t_keys, p.d_v, tid);
    cp_async_commit();
    cp_async_wait<1>();  // every group but this V: the K tile (and Q) have landed
    __syncthreads();

    float s[4][2];
#pragma unroll
    for (int i = 0; i < 4; ++i) s[i][0] = s[i][1] = 0.f;
    const float* qr = Qs + ty * 4 * L.ldq;
    const float* ka = Ks + tx * L.ldkv;
    const float* kb = Ks + (tx + 16) * L.ldkv;
    for (int c = 0; c < p.d_k; c += 4) {
      const float4 k0 = ld4(ka + c), k1 = ld4(kb + c);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float4 qv = ld4(qr + i * L.ldq + c);
        s[i][0] = fmaf(qv.x, k0.x, fmaf(qv.y, k0.y, fmaf(qv.z, k0.z, fmaf(qv.w, k0.w, s[i][0]))));
        s[i][1] = fmaf(qv.x, k1.x, fmaf(qv.y, k1.y, fmaf(qv.z, k1.z, fmaf(qv.w, k1.w, s[i][1]))));
      }
    }

    // online softmax; key j0 < t_keys is live, so every row max is finite
    const bool live0 = j0 + tx < p.t_keys, live1 = j0 + tx + 16 < p.t_keys;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float a0 = live0 ? s[i][0] * p.scale : -INFINITY;
      const float a1 = live1 ? s[i][1] * p.scale : -INFINITY;
      float mx = fmaxf(a0, a1);
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float p0 = expf(a0 - m_new), p1 = expf(a1 - m_new);  // exp(-inf) = 0 masks
      float sum = p0 + p1;
#pragma unroll
      for (int o = 8; o > 0; o >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float a = expf(m[i] - m_new);  // 0 on the first tile
      l[i] = l[i] * a + sum;
      m[i] = m_new;
      Pt[tx * kLdP + ty * 4 + i] = p0;
      Pt[(tx + 16) * kLdP + ty * 4 + i] = p1;
      if (tx == 0) alpha[ty * 4 + i] = a;
    }
    __syncthreads();  // Pt and alpha written; Ks is no longer read

    // the next K tile streams in during p v (an empty group after the last)
    if (j0 + kBK < p.t_keys) copy_tile(Ks, L.ldkv, k, p.k_st, j0 + kBK, p.t_keys, p.d_k, tid);
    cp_async_commit();
    cp_async_wait<1>();  // every group but the next K: this V tile has landed
    __syncthreads();
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      const float a = alpha[warp * 8 + r];
#pragma unroll
      for (int c = 0; c < 8; ++c) acc[r][c] *= a;
    }
    const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll 4
    for (int n = 0; n < kBK; ++n) {
      const float4 pa = ld4(Pt + n * kLdP + warp * 8), pb = ld4(Pt + n * kLdP + warp * 8 + 4);
      const float pr[8] = {pa.x, pa.y, pa.z, pa.w, pb.x, pb.y, pb.z, pb.w};
      const float4 v0 = has0 ? ld4(Vs + n * L.ldkv + c0) : zero;
      const float4 v1 = has1 ? ld4(Vs + n * L.ldkv + c1) : zero;
#pragma unroll
      for (int r = 0; r < 8; ++r) {
        acc[r][0] = fmaf(pr[r], v0.x, acc[r][0]);
        acc[r][1] = fmaf(pr[r], v0.y, acc[r][1]);
        acc[r][2] = fmaf(pr[r], v0.z, acc[r][2]);
        acc[r][3] = fmaf(pr[r], v0.w, acc[r][3]);
        acc[r][4] = fmaf(pr[r], v1.x, acc[r][4]);
        acc[r][5] = fmaf(pr[r], v1.y, acc[r][5]);
        acc[r][6] = fmaf(pr[r], v1.z, acc[r][6]);
        acc[r][7] = fmaf(pr[r], v1.w, acc[r][7]);
      }
    }
    __syncthreads();  // Vs, Pt and alpha are free for the next tile
  }
  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < 4; ++i) inv_l[ty * 4 + i] = 1.f / l[i];
  }
  __syncthreads();
  float* out = p.out + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int row = warp * 8 + r;
    if (q0 + row >= p.T) break;
    const float s = inv_l[row];
    float* o = out + (q0 + row) * p.o_st;
    if (has0) st4(o + c0, make_float4(acc[r][0] * s, acc[r][1] * s, acc[r][2] * s, acc[r][3] * s));
    if (has1) st4(o + c1, make_float4(acc[r][4] * s, acc[r][5] * s, acc[r][6] * s, acc[r][7] * s));
  }
}

}  // namespace egoego

extern "C" int egoego_mha(const egoego::MhaArgs* p, void* stream) {
  using namespace egoego;
  if (p->d_k < 4 || p->d_v < 4 || p->d_k > kMaxD || p->d_v > kMaxD || p->d_k % 4 || p->d_v % 4 ||
      p->t_keys < 1 || p->t_keys > p->T || p->H > 65535 || p->B > 65535)
    return (int)cudaErrorInvalidValue;
  const MhaLayout L(p->d_k, p->d_v);
  cudaError_t err =
      cudaFuncSetAttribute(mha_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)L.bytes);
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((p->T + kBQ - 1) / kBQ, p->H, p->B);
  mha_kernel<<<grid, kMhaThreads, L.bytes, static_cast<cudaStream_t>(stream)>>>(*p);
  return (int)cudaGetLastError();
}

extern "C" int egoego_mha_args_size() { return (int)sizeof(egoego::MhaArgs); }
