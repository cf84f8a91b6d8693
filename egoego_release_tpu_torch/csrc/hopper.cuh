// Hopper (sm_90a) building blocks shared by the wgmma kernels (gemm.cu,
// attention.cu): mbarriers, TMA loads and stores, thread-block clusters,
// wgmma shared-memory descriptors and the wgmma fence/commit/wait, and on
// the host the TMA map encoder.
#pragma once

#include <cuda.h>
#include <dlfcn.h>

#include <cstdint>

namespace egoego {

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

// TMA: the box at (inner coordinate c0, row c1) of the map into the same
// shared-memory offset of every CTA of the cluster in cta_mask; each CTA's
// barrier at the offset of bar counts the bytes it receives.
__device__ __forceinline__ void tma_load_2d_multicast(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                                      uint16_t cta_mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1, {%3, %4}], [%2], %5;\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1),
      "h"(cta_mask)
      : "memory");
}

// TMA: shared memory into the box at (inner coordinate c0, row c1) of the
// map, as the newest bulk group of the thread; elements past the map's
// edges are not written.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map, const void* src, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, %3}], [%1];\n"
      "cp.async.bulk.commit_group;\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(src)), "r"(c0), "r"(c1)
      : "memory");
}

// Returns once the thread's bulk stores have read their shared memory.
__device__ __forceinline__ void bulk_wait_read() { asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory"); }

// Orders the thread's writes to shared memory before later bulk copies (the async proxy) read it.
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// -- thread-block clusters --

__device__ __forceinline__ uint32_t cluster_ctarank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_id_x() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%clusterid.x;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_count_x() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%nclusterid.x;\n" : "=r"(r));
  return r;
}

// Every thread of every CTA of the cluster (each warp converged): writes
// before it are visible to the whole cluster after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The shared::cluster address of `ptr`'s location in CTA `rank` of the cluster.
__device__ __forceinline__ uint32_t cluster_addr(const void* ptr, uint32_t rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(ptr)), "r"(rank));
  return r;
}

// Arrive on a barrier of a CTA of the cluster (cluster_addr): a consumer
// handing a stage back to a producer that loads into this CTA.
__device__ __forceinline__ void mbar_arrive_remote(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cluster.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

// Store v at addr in a CTA of the cluster (cluster_addr); that CTA's
// barrier at bar (cluster_addr, the same CTA) counts the 4 bytes, and a wait
// on it sees the value.
__device__ __forceinline__ void st_async(uint32_t addr, float v, uint32_t bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.f32 [%0], %1, [%2];\n" ::"r"(addr), "f"(v),
               "r"(bar)
               : "memory");
}

// TMA: the box at (c0, c1, c2) of a 3-D map, as tma_load_2d.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// wgmma descriptor of a K-major tile of 128-byte rows with the 128-byte
// swizzle, at a 1024-byte aligned base (+ 32 bytes per k16 step): 8-row
// groups 1024 bytes apart (SBO 64 x 16 B); LBO is not read for this layout.
__device__ __forceinline__ uint64_t wg_desc(const void* tile) {
  return ((smem_u32(tile) & 0x3FFFF) >> 4) | (1ull << 16) | (64ull << 32) | (1ull << 62);
}

// wgmma descriptor of an MN-major operand with the 128-byte swizzle (B of
// a product over its rows, read through the transpose-B immediate): each k
// row holds 64 consecutive n values in 128 bytes, 8-row groups of k lie
// 1024 bytes apart (SBO), and the next 64 values of n lie `lbo` bytes on
// (LBO); the base is 1024-byte aligned (+ 2048 bytes per k16 step).
__device__ __forceinline__ uint64_t wg_desc_mn(const void* tile, uint32_t lbo) {
  return ((smem_u32(tile) & 0x3FFFF) >> 4) | ((uint64_t)((lbo >> 4) & 0x3FFF) << 16) | (64ull << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
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

// TMA map of a bf16 tensor of `rank` dimensions (dims[0] innermost, byte
// strides of dims 1.. in strides), boxes of box[] elements with the 128-byte
// swizzle (box[0] = 64); out-of-bounds elements read as zeros.
static bool tma_map_bf16(CUtensorMap* map, const void* base, cuuint32_t rank, const cuuint64_t* dims,
                         const cuuint64_t* strides, const cuuint32_t* box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank, const_cast<void*>(base), dims, strides, box,
                elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

}  // namespace egoego
