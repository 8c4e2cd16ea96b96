// Fused Q4 dequantize + matmul for Hopper (sm_90a): out[M,N] (f32) =
// x[M,K] @ dequant(W)[K,N], with W in the group-local layout of
// bert_tpu_torch/quant.py: packed[K/2,N] uint8, where packed row 32g+r holds
// logical row 64g+r in its low nibble and row 64g+32+r in its high nibble;
// scales[K/32,N] f32 and, for Q4_1, mins[K/32,N] f32.
//
// Replaces: bert_tpu/ops/q4_matmul.py::_q4_matmul_kernel (launched by
// _q4_matmul_pallas, routed by q4_matmul). Same arithmetic: each weight is
// dequantized in f32 ((c-8)*s for Q4_0, c*s+m for Q4_1), rounded to x's
// type, and multiplied with x accumulating in f32. W never reaches device
// memory in dense form.
//
// What bounds it on the H100: at the main path's shapes almost nothing.
// At M=1024, K=384, N=1152 (MiniLM QKV) it must move 5.8 MB (x 0.8 MB in
// bf16, packed W 0.2 MB, scales 0.06 MB, the f32 output 4.7 MB) and do
// 0.9 GFLOP: 1.7 us at 3.35 TB/s against 0.9 us at 989 TFLOP/s, so the
// bound is bytes, and mostly the f32 output the contract asks for.
// This simple design does not reach it: it multiplies on the CUDA cores
// (no wgmma), so it is bound by shared-memory reads and FMA issue.
// Each 256-thread block owns a 64x64 output tile and walks K one 64-row
// group at a time: it stages the x tile and the group's 32 packed rows plus
// 2 scale rows (and 2 min rows) in shared memory, dequantizes the packed
// band into a 64x64 shared W tile, and each thread accumulates a 4x4
// register tile. Threads that map to N read neighbouring bytes of packed,
// scales and mins, so every global load is coalesced. Ragged M and N edges
// are masked; K must be a multiple of 64 (the wrapper checks).
// Tensor cores, TMA and a Hopper weight layout come in later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;       // output rows per block
constexpr int BN = 64;       // output columns per block
constexpr int BK = 64;       // one group-local group of K rows
constexpr int QK = 32;       // quantization block
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// Round an f32 value to T and widen it back (exact for both types).
template <typename T> __device__ __forceinline__ float round_to(float v);
template <> __device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16(v));
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    q4_matmul_kernel(const T* __restrict__ x,
                     const uint8_t* __restrict__ packed,
                     const float* __restrict__ scales,
                     const float* __restrict__ mins, float* __restrict__ out,
                     int M, int K, int N) {
  __shared__ float xs[BK][BM + 4];  // x tile, transposed: xs[k][m]
  __shared__ float ws[BK][BN];      // dequantized W tile, rounded to T
  __shared__ float ss[2][BN];       // the group's two scale rows
  __shared__ float ms[2][BN];       // and its two min rows (Q4_1)

  const int tid = threadIdx.x;
  const int tx = tid % 16, ty = tid / 16;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const bool q4_1 = mins != nullptr;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    const int g = k0 / BK;
    // x tile: consecutive threads read consecutive k of one row
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int m = m0 + r;
      xs[c][r] = (m < M) ? to_f32(x[(size_t)m * K + k0 + c]) : 0.f;
    }
    // scale (and min) rows 2g and 2g+1 of this block's columns
    if (tid < 2 * BN) {
      const int b = tid / BN, c = tid % BN;
      const int n = n0 + c;
      const size_t off = (size_t)(2 * g + b) * N + n;
      ss[b][c] = (n < N) ? scales[off] : 0.f;
      if (q4_1) ms[b][c] = (n < N) ? mins[off] : 0.f;
    }
    __syncthreads();
    // dequantize the group's 32 packed rows into 64 rows of W
    for (int i = tid; i < QK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int n = n0 + c;
      const uint32_t byte =
          (n < N) ? packed[(size_t)(g * QK + r) * N + n] : 0u;
      const int lo = byte & 0xF, hi = byte >> 4;
      float wlo, whi;
      if (q4_1) {  // c*s+m, two roundings as in the Pallas kernel (no fma)
        wlo = __fadd_rn(__fmul_rn((float)lo, ss[0][c]), ms[0][c]);
        whi = __fadd_rn(__fmul_rn((float)hi, ss[1][c]), ms[1][c]);
      } else {
        wlo = __fmul_rn((float)(lo - 8), ss[0][c]);
        whi = __fmul_rn((float)(hi - 8), ss[1][c]);
      }
      ws[r][c] = round_to<T>(wlo);
      ws[QK + r][c] = round_to<T>(whi);
    }
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < BK; ++k) {
      float a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = xs[k][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) b[j] = ws[k][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

template <typename T>
int launch(const void* x, const void* packed, const void* scales,
           const void* mins, void* out, int M, int K, int N, void* stream) {
  if (M <= 0 || N <= 0 || K <= 0 || K % BK != 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  q4_matmul_kernel<T><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const uint8_t*)packed, (const float*)scales,
      (const float*)mins, (float*)out, M, K, N);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int q4_matmul_f32(const void* x, const void* packed,
                             const void* scales, const void* mins, void* out,
                             int M, int K, int N, void* stream) {
  return launch<float>(x, packed, scales, mins, out, M, K, N, stream);
}

extern "C" int q4_matmul_bf16(const void* x, const void* packed,
                              const void* scales, const void* mins, void* out,
                              int M, int K, int N, void* stream) {
  return launch<__nv_bfloat16>(x, packed, scales, mins, out, M, K, N, stream);
}
