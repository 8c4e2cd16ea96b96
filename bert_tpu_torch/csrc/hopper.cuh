// Warp-level tensor-core and asynchronous-copy primitives shared by the
// kernels (sm_90a): 16-, 8- and 4-byte cp.async into shared memory with
// zero fill, ldmatrix (plain and transposed), the bf16 mma.sync.m16n8k16
// with f32 accumulation, and the three-way bf16 split by which the f32
// instances run f32 products on the bf16 tensor cores.
//
// Fragment layout of mma.m16n8k16 (PTX ISA), with g = lane / 4 and
// t = lane % 4: A (16x16, row-major) a0 = (g, 2t..2t+1), a1 = (g+8, 2t..),
// a2 = (g, 2t+8..), a3 = (g+8, 2t+8..); B (16x8, "col") b0 = (k 2t..2t+1,
// n g), b1 = (k 2t+8.., n g); C (16x8) c0, c1 = (g, 2t..2t+1), c2, c3 =
// (g+8, 2t..2t+1). Each .b32 register holds two bf16, the lower column in
// the low half.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace hopper {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Copy 16 bytes from global to shared memory without passing through
// registers; when `pred` is false nothing is read and the 16 bytes are
// zero-filled. Both addresses must be 16-byte aligned.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 16 : 0));
}

// The same for 4 bytes (4-byte aligned), for rows whose stride is not a
// multiple of 16 bytes.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0));
}

// And for 8 bytes (8-byte aligned).
__device__ __forceinline__ void cp_async8(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 8 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// Four 8x8 bf16 matrices from shared memory; lanes 8i..8i+7 give the row
// addresses of matrix i. Lane l receives (row l/4, cols 2(l%4)..+1) of each.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// Transposed: lane l receives (rows 2(l%4)..+1, col l/4) of each matrix,
// which turns a row-major [k][n] tile into B fragments.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a @ b on the tensor cores: bf16 inputs, f32 accumulation.
__device__ __forceinline__ void mma_bf16(float (&c)[4],
                                         const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 (nearest even) in one .b32 register,
// `lo` in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<__nv_bfloat162*>(&v));
}

// Two f32 values split three ways: v = hi + mid + lo exactly, each part a
// bf16 rounded to nearest even (hi = bf16(v), mid = bf16(v - hi), lo =
// bf16(v - hi - mid); both differences are exact in f32, and what is left
// after mid fits lo's 8 bits). p[0], p[1], p[2] = hi, mid, lo, each a
// .b32 of two bf16, `a` in the low half. Exact for finite values below
// bf16's largest finite (3.39e38).
__device__ __forceinline__ void split_bf16x3(float a, float b,
                                             uint32_t (&p)[3]) {
  p[0] = pack_bf16(a, b);
  const float2 h = unpack_bf16(p[0]);
  a = __fsub_rn(a, h.x);  // _rn: never contracted with a's producer
  b = __fsub_rn(b, h.y);
  p[1] = pack_bf16(a, b);
  const float2 m = unpack_bf16(p[1]);
  p[2] = pack_bf16(__fsub_rn(a, m.x), __fsub_rn(b, m.y));
}

// The six products of split f32 operands (the TPU's Precision.HIGHEST):
// product p multiplies part x6_a(p) of A by part x6_b(p) of B (0 = hi, 1 =
// mid, 2 = lo), smallest first: lo*hi, mid*mid, hi*lo, mid*hi, hi*mid,
// hi*hi. The terms left out (mid*lo, lo*mid, lo*lo) are below 2^-24 of
// hi*hi.
__device__ __forceinline__ constexpr int x6_a(int p) {
  return p == 0 ? 2 : p == 1 || p == 3 ? 1 : 0;
}
__device__ __forceinline__ constexpr int x6_b(int p) {
  return p == 2 ? 2 : p == 1 || p == 4 ? 1 : 0;
}

// The number of SMs of the current device, read once.
inline int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    if (n <= 0) n = 132;
  }
  return n;
}

}  // namespace hopper
