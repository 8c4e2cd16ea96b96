// Fused (pre-bias + residual +) LayerNorm for Hopper (sm_90a):
// out[M,D] = LN(x [+ pre_bias] [+ residual]) over the last axis, f32 mean
// and biased variance, then (v - mean) * rsqrt(var + eps) * scale + bias,
// cast to x's type. x, residual and out are T [M,D]; pre_bias, scale and
// bias are f32 [D]. residual and pre_bias are nullable.
//
// Replaces: bert_tpu/ops/layer_norm.py::_ln_kernel, _ln_res_kernel and
// _ln_res_pb_kernel (launched by _ln_pallas, entry fused_layer_norm). One
// kernel with nullable operands covers all three bodies. As in the Pallas
// kernels, the operands are widened to f32 BEFORE the adds
// ((x + pre_bias) + residual, in f32).
//
// What bounds it on the H100: bytes. It does ~10 flops per element and
// must read x (and the residual) and write out once: at M=1024, D=384 in
// bf16 with a residual that is 2.4 MB, 0.7 us at 3.35 TB/s.
// The simple design: one warp per row (D <= 1024, so at most 32 values per
// lane), 8 rows per 256-thread block. A lane reads elements lane, lane+32,
// ... so every warp-wide load is one coalesced run; the row stays in
// registers across the two reductions (the mean, then the variance of the
// deviations), so each input byte is read once and each output byte written
// once. Short rows leave warps lightly loaded; vector loads and several rows
// per warp come in later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int WARPS = 8;           // rows per block
constexpr int MAX_PER_LANE = 32;   // D <= 32 * 32 = 1024

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <typename T>
__global__ void __launch_bounds__(WARPS * 32)
    layer_norm_kernel(const T* __restrict__ x, const T* __restrict__ residual,
                      const float* __restrict__ pre_bias,
                      const float* __restrict__ scale,
                      const float* __restrict__ bias, T* __restrict__ out,
                      int M, int D, float eps) {
  const int lane = threadIdx.x % 32;
  const int row = blockIdx.x * WARPS + threadIdx.x / 32;
  if (row >= M) return;  // whole warp leaves together
  const size_t base = (size_t)row * D;

  float v[MAX_PER_LANE];
  float sum = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_PER_LANE; ++i) {
    const int c = i * 32 + lane;
    float t = 0.f;
    if (c < D) {
      t = to_f32(x[base + c]);
      if (pre_bias != nullptr) t += pre_bias[c];
      if (residual != nullptr) t += to_f32(residual[base + c]);
    }
    v[i] = t;
    sum += t;
  }
  const float mean = warp_sum(sum) / (float)D;

  float sq = 0.f;
#pragma unroll
  for (int i = 0; i < MAX_PER_LANE; ++i) {
    const int c = i * 32 + lane;
    if (c < D) {
      const float d = v[i] - mean;
      sq += d * d;
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / (float)D + eps);

#pragma unroll
  for (int i = 0; i < MAX_PER_LANE; ++i) {
    const int c = i * 32 + lane;
    if (c < D) out[base + c] = from_f32<T>((v[i] - mean) * rstd * scale[c] + bias[c]);
  }
}

template <typename T>
int launch(const void* x, const void* residual, const void* pre_bias,
           const void* scale, const void* bias, void* out, int M, int D,
           float eps, void* stream) {
  if (M <= 0 || D <= 0 || D > 32 * MAX_PER_LANE) return (int)cudaErrorInvalidValue;
  const int blocks = (M + WARPS - 1) / WARPS;
  layer_norm_kernel<T><<<blocks, WARPS * 32, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const T*)residual, (const float*)pre_bias,
      (const float*)scale, (const float*)bias, (T*)out, M, D, eps);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int layer_norm_f32(const void* x, const void* residual,
                              const void* pre_bias, const void* scale,
                              const void* bias, void* out, int M, int D,
                              float eps, void* stream) {
  return launch<float>(x, residual, pre_bias, scale, bias, out, M, D, eps,
                       stream);
}

extern "C" int layer_norm_bf16(const void* x, const void* residual,
                               const void* pre_bias, const void* scale,
                               const void* bias, void* out, int M, int D,
                               float eps, void* stream) {
  return launch<__nv_bfloat16>(x, residual, pre_bias, scale, bias, out, M, D,
                               eps, stream);
}
