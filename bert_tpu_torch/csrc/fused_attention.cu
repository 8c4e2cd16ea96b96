// Fused masked softmax attention over the head-interleaved QKV projection,
// for Hopper (sm_90a): qkv[B,T,3D] (T = f32 or bf16) + an additive f32 bias
// → context out[B,T,D], with D = H*dh. For head h, q, k and v each take dh
// lanes at 3*dh*h, 3*dh*h + dh and 3*dh*h + 2*dh of a row
// (bert_tpu_torch/params.py); the kernel reads them in place and writes
// head h's context to lanes h*dh of out, so no relayout touches memory.
// The bias is key-side [B,T] (padding) or pairwise [B,T,T] (packed rows,
// block-diagonal), selected by `pairwise`; masked entries hold the finite
// NEG_INF = -1e9, so a fully masked row softmaxes to a uniform row, never
// NaN. No value here stands in for -inf.
//
// Replaces: bert_tpu/ops/fused_attention.py::_fused_attn_kernel (entry
// fused_qkv_attention). Same arithmetic: 1/sqrt(dh) is folded into q in
// q's type; scores and softmax are f32; the unnormalized probabilities are
// rounded to q's type before they meet v and before they are summed; the
// division by the sum is deferred to the dh-wide context. The Pallas
// kernel's G-row packing, block mask and head chunking existed for the
// 128x128 MXU and Mosaic's VMEM and are not carried over.
//
// What bounds it on the H100: at the main path's shapes, bytes. Packed
// MiniLM rows (B=16, T=64, H=12, dh=32, bf16, pairwise bias) must read
// qkv (2.4 MB) and the bias (0.26 MB) and write the context (0.8 MB):
// 1.0 us at 3.35 TB/s, against 0.1 us for its 101 MFLOP on the tensor
// cores. At T=512 the flops grow with T^2 and lead.
// The simple design: one 64-thread block per (query tile of 64 rows, head,
// batch row); each thread owns one query row, holding q and its context
// accumulator in registers. Key/value tiles of 32 rows stream through
// shared memory (with the tile's bias, staged by coalesced loads; each
// thread parks its row of the tile's scores there too, which keeps the
// unrolled code, and so the build, small), and an online softmax in f32
// rescales the accumulator once per tile — so T=512
// at dh=64 in f32 fits, where a whole-T tile (K plus V: 256 KB) would not.
// The products run on the CUDA cores; mma/wgmma tiles come in later work.

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;   // queries per block, one per thread
constexpr int BKV = 32;  // keys per shared-memory tile

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
// Round an f32 value to T and widen it back (exact for both types).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f32(from_f32<T>(v));
}

template <typename T, int DH>
__global__ void __launch_bounds__(BQ)
    fused_attention_kernel(const T* __restrict__ qkv,
                           const float* __restrict__ bias,
                           T* __restrict__ out, int seq, int H, int pairwise,
                           float scale) {
  __shared__ float ks[BKV][DH];
  __shared__ float vs[BKV][DH];
  __shared__ float bs[BQ][BKV + 1];  // pairwise bias tile (+1: no conflicts)
  __shared__ float kb[BKV];          // key-side bias tile
  __shared__ float sc[BKV][BQ];      // the tile's scores, a column per thread

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int D = H * DH;
  const size_t row_stride = 3 * (size_t)D;
  const T* base = qkv + (size_t)b * seq * row_stride + (size_t)h * 3 * DH;
  const int qi = q0 + tid;
  const bool active = qi < seq;

  // q, pre-scaled in q's type as the Pallas kernel does
  float q[DH], acc[DH];
  const float scale_t = round_to<T>(scale);
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    q[d] = active ? round_to<T>(to_f32(base[(size_t)qi * row_stride + d]) *
                                scale_t)
                  : 0.f;
    acc[d] = 0.f;
  }
  float m = -FLT_MAX;  // running max; finite, so m - m_new never yields NaN
  float l = 0.f;       // running sum of the rounded probabilities

  for (int k0 = 0; k0 < seq; k0 += BKV) {
    const int nk = min(BKV, seq - k0);
    __syncthreads();  // the previous tile has been consumed
    for (int i = tid; i < BKV * DH; i += BQ) {
      const int j = i / DH, d = i % DH;
      float kv = 0.f, vv = 0.f;
      if (j < nk) {
        const T* r = base + (size_t)(k0 + j) * row_stride;
        kv = to_f32(r[DH + d]);
        vv = to_f32(r[2 * DH + d]);
      }
      ks[j][d] = kv;
      vs[j][d] = vv;
    }
    if (pairwise) {
      for (int i = tid; i < BQ * BKV; i += BQ) {
        const int r = i / BKV, j = i % BKV;
        const int qr = q0 + r;
        bs[r][j] = (qr < seq && j < nk)
                       ? bias[((size_t)b * seq + qr) * seq + k0 + j]
                       : 0.f;
      }
    } else if (tid < BKV) {
      kb[tid] = tid < nk ? bias[(size_t)b * seq + k0 + tid] : 0.f;
    }
    __syncthreads();

    // nk is the same for every thread of the block: no divergence
    float tmax = -FLT_MAX;
#pragma unroll 2
    for (int j = 0; j < nk; ++j) {
      float dot = 0.f;
#pragma unroll
      for (int d = 0; d < DH; ++d) dot = fmaf(q[d], ks[j][d], dot);
      const float sj = dot + (pairwise ? bs[tid][j] : kb[j]);
      sc[j][tid] = sj;
      tmax = fmaxf(tmax, sj);
    }
    const float m_new = fmaxf(m, tmax);
    const float corr = expf(m - m_new);
    l *= corr;
#pragma unroll
    for (int d = 0; d < DH; ++d) acc[d] *= corr;
#pragma unroll 2
    for (int j = 0; j < nk; ++j) {
      const float p = round_to<T>(expf(sc[j][tid] - m_new));
      l += p;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
    m = m_new;
  }

  if (active) {
    T* o = out + ((size_t)b * seq + qi) * D + (size_t)h * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] = from_f32<T>(acc[d] / l);
  }
}

template <typename T>
int launch(const void* qkv, const void* bias, void* out, int B, int seq,
           int H, int dh, int pairwise, float scale, void* stream) {
  if (B <= 0 || seq <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const dim3 grid((seq + BQ - 1) / BQ, H, B);
  cudaStream_t st = (cudaStream_t)stream;
  if (dh == 32) {
    fused_attention_kernel<T, 32><<<grid, BQ, 0, st>>>(
        (const T*)qkv, (const float*)bias, (T*)out, seq, H, pairwise, scale);
  } else if (dh == 64) {
    fused_attention_kernel<T, 64><<<grid, BQ, 0, st>>>(
        (const T*)qkv, (const float*)bias, (T*)out, seq, H, pairwise, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_attention_f32(const void* qkv, const void* bias,
                                   void* out, int B, int seq, int H, int dh,
                                   int pairwise, float scale, void* stream) {
  return launch<float>(qkv, bias, out, B, seq, H, dh, pairwise, scale,
                       stream);
}

extern "C" int fused_attention_bf16(const void* qkv, const void* bias,
                                    void* out, int B, int seq, int H, int dh,
                                    int pairwise, float scale, void* stream) {
  return launch<__nv_bfloat16>(qkv, bias, out, B, seq, H, dh, pairwise, scale,
                               stream);
}
