// Hopper's asynchronous machinery shared by the kernels that use it
// (sm_90a): mbarriers, TMA tile loads and stores, their tensor maps (host
// side, one cached descriptor per array and box), and the warpgroup MMA
// (wgmma) plumbing: shared-memory descriptors, fence / commit / wait, and
// the register hand-over between warpgroups (setmaxnreg).
//
// Used by q4_matmul.cu (TMA tile loads on mbarriers; its bulk-M bf16
// instance also wgmma and warpgroup roles) and int8_matmul.cu (TMA loads
// and stores, wgmma, a producer warpgroup). encode_map finds
// cuTensorMapEncodeTiled through cudaGetDriverEntryPoint, so nothing links
// against libcuda.

#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <mutex>
#include <unordered_map>

#include "hopper.cuh"

namespace hopper {

// ---------------------------------------------------------------------------
// mbarriers
// ---------------------------------------------------------------------------

// COUNT arrivals complete a phase (one thread initialises; then
// fence.mbarrier_init and a block barrier before any use).
template <int COUNT = 1>
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "n"(COUNT));
}

// One arrival that also expects `bytes` of asynchronous copies to land.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Spin until the phase of parity `phase` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t phase) {
  uint32_t done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(phase)
        : "memory");
}

// ---------------------------------------------------------------------------
// TMA
// ---------------------------------------------------------------------------

// Copy the box at element coordinates (c0 innermost, c1) of `map` into
// shared memory at dst; the bytes complete on `bar`. Past the array's
// edges the box is zero-filled, and the full box's bytes still count.
__device__ __forceinline__ void tma_2d(void* dst, const CUtensorMap* map,
                                       int c0, int c1, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
      "r"(smem_addr(bar))
      : "memory");
}

// Copy the box at element coordinates (c0, c1) of `map` from shared
// memory at src to global memory (clipped at the array's edges), in the
// current bulk group. The writes to src by other threads must be fenced
// (fence_proxy_async) and synchronised first.
__device__ __forceinline__ void tma_store_2d(const CUtensorMap* map,
                                             const void* src, int c0,
                                             int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group [%0, {%2, "
      "%3}], [%1];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_addr(src)), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's bulk groups are still reading
// their shared memory.
template <int N>
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read %0;\n" ::"n"(N) : "memory");
}

// Wait until at most N of this thread's bulk groups are still running.
template <int N>
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group %0;\n" ::"n"(N) : "memory");
}

// Make this thread's shared-memory writes visible to the async proxy (TMA
// stores, wgmma) before a barrier hands them over.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Barrier `id` (1-15; 0 is __syncthreads') over `threads` threads.
__device__ __forceinline__ void named_bar_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// Arrive at barrier `id` over `threads` threads without waiting for it.
__device__ __forceinline__ void named_bar_arrive(int id, int threads) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

// A 2-D TMA descriptor of a row-major [rows, cols] array with the given
// row stride, boxes of box_rows x box_cols elements. A descriptor is a
// function of these arguments alone, so each is encoded once and kept
// (the weights' on every call, the activations' as the caching allocator
// hands their addresses out again): the driver's encoder costs about a
// microsecond of host time a call.
struct MapKey {
  uint64_t ptr, cols, rows, row_bytes;
  uint32_t type, box_cols, box_rows, swizzle;
  bool operator==(const MapKey& o) const {
    return memcmp(this, &o, sizeof(MapKey)) == 0;
  }
};
struct MapKeyHash {
  size_t operator()(const MapKey& k) const {
    size_t h = 1469598103934665603ull;
    const unsigned char* p = reinterpret_cast<const unsigned char*>(&k);
    for (size_t i = 0; i < sizeof(MapKey); ++i)
      h = (h ^ p[i]) * 1099511628211ull;
    return h;
  }
};

inline bool encode_map(CUtensorMap* map, CUtensorMapDataType type,
                       const void* ptr, uint64_t cols, uint64_t rows,
                       uint64_t row_bytes, uint32_t box_cols,
                       uint32_t box_rows, CUtensorMapSwizzle swizzle) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = [] {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult q;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &q) != cudaSuccess ||
        q != cudaDriverEntryPointSuccess)
      fn = nullptr;
    return reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }();
  static std::mutex lock;
  static std::unordered_map<MapKey, CUtensorMap, MapKeyHash> cache;
  if (encode == nullptr) return false;
  MapKey key;
  memset(&key, 0, sizeof(key));  // no uninitialised padding in the hash
  key.ptr = reinterpret_cast<uint64_t>(ptr);
  key.cols = cols;
  key.rows = rows;
  key.row_bytes = row_bytes;
  key.type = type;
  key.box_cols = box_cols;
  key.box_rows = box_rows;
  key.swizzle = swizzle;
  std::lock_guard<std::mutex> guard(lock);
  const auto hit = cache.find(key);
  if (hit != cache.end()) {
    *map = hit->second;
    return true;
  }
  const cuuint64_t dims[2] = {cols, rows};
  const cuuint64_t strides[1] = {row_bytes};
  const cuuint32_t box[2] = {box_cols, box_rows};
  const cuuint32_t step[2] = {1, 1};
  if (encode(map, type, 2, const_cast<void*>(ptr), dims, strides, box, step,
             CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) != CUDA_SUCCESS)
    return false;
  if (cache.size() >= 4096) cache.clear();  // bound the host memory
  cache.emplace(key, *map);
  return true;
}

// ---------------------------------------------------------------------------
// wgmma
// ---------------------------------------------------------------------------

// The shared-memory descriptor of a K-major operand tile written by TMA
// with the 128-byte swizzle: rows of 128 bytes, eight rows (1,024 bytes)
// to a swizzle atom, the tile 1,024-byte aligned. Start address >> 4 in
// bits 0-13; the leading byte offset (bits 16-29) is unused by swizzled
// K-major layouts and set to 1; the stride byte offset (bits 32-45) is the
// 1,024 bytes from one group of eight rows to the next; layout type 1 =
// 128-byte swizzle (bits 62-63). A step of k inside the 128-byte row
// advances the start address by its bytes: the hardware applies the
// swizzle to the address it computes.
__device__ __forceinline__ uint64_t desc_sw128(const void* tile) {
  return (uint64_t)((smem_addr(tile) & 0x3FFFF) >> 4) | (uint64_t)1 << 16 |
         (uint64_t)(1024 >> 4) << 32 | (uint64_t)1 << 62;
}

// Order this warpgroup's register and shared-memory accesses before the
// wgmma that follows.
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

// Close the wgmma issued since the last commit into one group.
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of an accumulator
// register across this point (wgmma writes it behind the compiler's back).
__device__ __forceinline__ void fence_operand(int& r) {
  asm volatile("" : "+r"(r)::"memory");
}
__device__ __forceinline__ void fence_operand(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}

// Hand registers between warpgroups: every warp of the warpgroup executes
// it, and the kernel must split into its roles in one if-else that never
// rejoins, or ptxas ignores it.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

}  // namespace hopper
