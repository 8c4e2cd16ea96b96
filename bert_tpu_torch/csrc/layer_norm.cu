// Fused (pre-bias + residual +) LayerNorm for Hopper (sm_90a):
// out[M,D] = LN(x [+ pre_bias] [+ residual]) over the last axis, f32 mean
// and biased variance, then (v - mean) * rsqrt(var + eps) * scale + bias,
// cast once to the output type. x is Tin [M,D], residual and out are Tout
// [M,D]; pre_bias, scale and bias are f32 [D]. residual and pre_bias are
// nullable. Three type pairs: f32 -> f32, bf16 -> bf16, and f32 -> bf16,
// where each x element is first rounded to bf16 and widened back, so that
// the f32 product of a matmul goes in as it is and the result is bit for
// bit x.to(bf16) followed by the bf16 kernel (one launch and one round
// trip of the product through device memory fewer).
//
// Replaces: bert_tpu/ops/layer_norm.py::_ln_kernel, _ln_res_kernel and
// _ln_res_pb_kernel (launched by _ln_pallas, entry fused_layer_norm). One
// kernel with nullable operands covers all three bodies. As in the Pallas
// kernels, the operands are widened to f32 BEFORE the adds
// ((x + pre_bias) + residual, in f32); the variance is the mean of the
// squared deviations, two passes over the row held in registers (no
// Welford, no E[v^2] - mean^2). Only the order of the row's sum differs.
//
// What bounds it on the H100: bytes, and at the paths' sizes the latency
// of moving them. It must read x (and the residual) and write out once:
// 1024x384 bf16 with a residual is 2.36 MB, 0.71 us at 3.35 TB/s. That is
// about one DRAM round trip, so what sets the time is how soon every load
// of a row is in flight and how few dependent steps follow (two
// reductions, a store). The first design (a warp per row, one 2-byte load a
// lane per element, the f32 parameters re-read per element, 32-way
// predicated loops, 8 rows a block) had few bytes in flight and many
// instructions between them. This design:
//   - moves 16 bytes a lane-access (8 bf16 or 4 f32; f32 x beside bf16
//     out: 8 elements in two 16-byte loads) where D % 8 == 0 (bf16 out) or
//     D % 4 == 0 (f32 out), 4 bytes (2 bf16) where D is even, one element
//     otherwise: a template parameter N, the elements of a vector, chosen
//     by D; the wrapper checks that every operand is aligned for its path
//     and raises, and this source checks again and refuses the launch;
//   - gives each row a group of G = 8, 16 or 32 lanes, each holding V
//     vectors (a template parameter), picked at launch for the fewest
//     masked slots (D = 384 bf16: 48 vectors = 16 lanes x 3; D = 312: 39 =
//     8 x 5, one slot masked); lane l's slot i is vector i*G + l, so each
//     slot is one coalesced run, and only the last slot can lie past the
//     row. The sums are butterflies of __shfl_xor_sync within the group,
//     which leave every lane the same value;
//   - loads scale, bias and pre_bias for the lane's columns once per thread,
//     before the row, and keeps them in registers for every row the thread
//     walks; issues every load of a row before the first reduction;
//   - sizes blocks (1 to 8 warps) so that small M still gives at least two
//     blocks an SM where the rows allow it.
// A row in registers is at most 32 floats a lane (G = 32, V * N <= 32:
// D <= 1024 on the 16-byte paths, 512 on the 4-byte path, 256 on the
// scalar path); ptxas (-v) reports no spill for any instance (27-191
// registers). Wider rows go to a simple instance with one 256-thread
// block per row that forms v = x (+ pre_bias) (+ residual) anew on each of
// its three passes (sum, squared deviations, write), re-reading x and the
// residual, which L2 serves; it has no upper limit on D.
//
// The codes form (entries layer_norm_codes_*; CODES in the kernels) also
// writes the W8A8 activation codes of the output for an int8 product
// that takes it (replacing bert_tpu/ops/int8_matmul.py::
// quantize_activations_i8 on the LayerNorm's output, and the launch and
// the read of the output that quantizing it apart costs): codes[M, Kp]
// int8 (Kp = D rounded up to 32, a zero tail) and sx[M] f32, formed from
// the ROUNDED outputs, which stay in registers for one more group
// reduction, the max |out|; the codes are then int8_matmul.cu's
// arithmetic on the same registers, N codes a store. It adds 1 byte an
// element and 4 a row to the bytes moved (f32 x, bf16 residual and out at
// 8,192 x 768: 50.3 MB -> 56.6 MB, 0.0169 ms). The wide instance takes
// the max in its write pass and reads its own output back for the codes.
// The outputs are the plain form's bit for bit: the same expression, in
// instances of their own (CODES), so that the extra registers the codes
// take are not the plain form's.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <climits>
#include <type_traits>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int ROW_BLOCK = 256;  // threads of the block-per-row instance

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(bf16 v) { return __bfloat162float(v); }
template <typename T> __device__ __forceinline__ T from_f32(float v);
template <> __device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ bf16 from_f32<bf16>(float v) {
  return __float2bfloat16(v);
}

// x widened to f32; where the output type is narrower, rounded to it first
// (the f32-input form: bit for bit a cast of x before the kernel)
template <typename Tin, typename Tout>
__device__ __forceinline__ float widen(Tin v) {
  if constexpr (std::is_same<Tin, Tout>::value)
    return to_f32(v);
  else
    return to_f32(from_f32<Tout>(to_f32(v)));
}

// N elements of T moved as one access of min(16, N * sizeof(T)) bytes (an
// f32 vector of 8 moves as two 16-byte accesses)
template <typename T, int N>
struct alignas(N * sizeof(T) < 16 ? N * sizeof(T) : 16) Vec {
  T v[N];
};

template <typename T, int N>
__device__ __forceinline__ Vec<T, N> ld(const T* p) {
  return *reinterpret_cast<const Vec<T, N>*>(p);
}

template <int N>
__device__ __forceinline__ void ld_f32(float (&f)[N], const float* p) {
  const Vec<float, N> v = ld<float, N>(p);
#pragma unroll
  for (int e = 0; e < N; ++e) f[e] = v.v[e];
}

// the sum over a group of G lanes (a power of two dividing 32) by a
// butterfly: every lane of the group ends with the same value
__device__ __forceinline__ float group_sum(float v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float group_max(float v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// ---------------------------------------------------------------------------
// the codes form: the W8A8 activation codes of the rounded output
// ---------------------------------------------------------------------------

// int8_matmul.cu's arithmetic (bert_tpu's quantize_activations_i8): sx =
// amax / 127 (IEEE), inv = 1 / sx (IEEE; 0 for a zero row), code =
// clamp(rint(v * inv), -127, 127) with rint's round half to even; codes
// rows padded with zeros to Kp, the s8 wgmma's depth of 32.
constexpr int KP_ALIGN = 32;

__device__ __forceinline__ int padded(int D) {
  return (D + KP_ALIGN - 1) / KP_ALIGN * KP_ALIGN;
}

__device__ __forceinline__ float scale_of(float amax) {
  return __fdiv_rn(amax, 127.f);
}
__device__ __forceinline__ float inverse(float s) {
  return s > 0.f ? __frcp_rn(s) : 0.f;
}
__device__ __forceinline__ uint32_t code(float v, float inv) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(q)));
}

// the N codes of a vector of outputs, written by one store of N bytes
template <typename T, int N>
__device__ __forceinline__ void store_codes(int8_t* p, const Vec<T, N>& o,
                                            float inv) {
  uint32_t w[(N + 3) / 4] = {};
#pragma unroll
  for (int e = 0; e < N; ++e)
    w[e / 4] |= code(to_f32(o.v[e]), inv) << 8 * (e % 4);
  if constexpr (N == 8)
    *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
  else if constexpr (N == 4)
    *reinterpret_cast<uint32_t*>(p) = w[0];
  else if constexpr (N == 2)
    *reinterpret_cast<uint16_t*>(p) = static_cast<uint16_t>(w[0]);
  else
    *p = static_cast<int8_t>(w[0]);
}

// vectors a lane may hold: at most 32 floats of the row (and at most 8)
constexpr int vmax(int N) { return N >= 8 ? 32 / N : 8; }

// ---------------------------------------------------------------------------
// the row in registers: a group of G lanes per row, V vectors of N a lane
// ---------------------------------------------------------------------------

// One block an SM is enough: without that bound, ptxas spilled in two
// instances to fit a lower register count. CODES: the codes form, which
// also writes codes[M, Kp] and sx[M] of the rounded output.
template <typename Tin, typename Tout, int N, int V, bool CODES>
__global__ void __launch_bounds__(256, 1)
    ln_rows_kernel(const Tin* __restrict__ x,
                   const Tout* __restrict__ residual,
                   const float* __restrict__ pre_bias,
                   const float* __restrict__ scale,
                   const float* __restrict__ bias, Tout* __restrict__ out,
                   int8_t* __restrict__ codes, float* __restrict__ sx,
                   int M, int D, int G, float eps) {
  const int nv = D / N;  // vectors a row
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);  // lane within the row's group
  const int lg = __ffs(G) - 1;    // G = 2^lg
  const int rows_per_warp = 32 >> lg;
  const int warps = blockDim.x >> 5;
  // slot i holds vector i*G + gl; only the last slot can lie past the row
  const bool tail = (V - 1) * G + gl < nv;
  auto has = [&](int i) { return i < V - 1 || tail; };

  float sc[V][N], bi[V][N], pb[V][N];
#pragma unroll
  for (int i = 0; i < V; ++i) {
#pragma unroll
    for (int e = 0; e < N; ++e) sc[i][e] = bi[i][e] = pb[i][e] = 0.f;
    if (has(i)) {
      const int c = (i * G + gl) * N;
      ld_f32<N>(sc[i], scale + c);
      ld_f32<N>(bi[i], bias + c);
      if (pre_bias != nullptr) ld_f32<N>(pb[i], pre_bias + c);
    }
  }

  // warp-uniform trip count: every lane takes part in every shuffle
  const int step = gridDim.x * warps * rows_per_warp;
  for (int r0 = (blockIdx.x * warps + (threadIdx.x >> 5)) * rows_per_warp;
       r0 < M; r0 += step) {
    const int row = r0 + (lane >> lg);
    const bool live = row < M;
    const size_t base = (size_t)row * D;

    Vec<Tin, N> xr[V];
    Vec<Tout, N> rr[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      xr[i] = Vec<Tin, N>{};
      rr[i] = Vec<Tout, N>{};
      if (live && has(i)) {
        const size_t c = base + (size_t)(i * G + gl) * N;
        xr[i] = ld<Tin, N>(x + c);
        if (residual != nullptr) rr[i] = ld<Tout, N>(residual + c);
      }
    }

    float v[V][N];
    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int e = 0; e < N; ++e) {
        float t = widen<Tin, Tout>(xr[i].v[e]) + pb[i][e];
        if (residual != nullptr) t += to_f32(rr[i].v[e]);
        v[i][e] = has(i) ? t : 0.f;
        sum += v[i][e];
      }
    const float mean = group_sum(sum, G) / (float)D;

    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float d = v[i][e] - mean;
        if (has(i)) sq += d * d;
      }
    const float rstd = rsqrtf(group_sum(sq, G) / (float)D + eps);

    if constexpr (!CODES) {
#pragma unroll
      for (int i = 0; i < V; ++i) {
        if (!live || !has(i)) continue;
        Vec<Tout, N> o;
#pragma unroll
        for (int e = 0; e < N; ++e)
          o.v[e] =
              from_f32<Tout>((v[i][e] - mean) * rstd * sc[i][e] + bi[i][e]);
        *reinterpret_cast<Vec<Tout, N>*>(out + base +
                                         (size_t)(i * G + gl) * N) = o;
      }
    } else {
      // the same outputs, kept for one more reduction: the max |output|
      // as rounded (a masked slot's is 0), then the codes from the same
      // registers
      Vec<Tout, N> o[V];
      float amax = 0.f;
#pragma unroll
      for (int i = 0; i < V; ++i)
#pragma unroll
        for (int e = 0; e < N; ++e) {
          o[i].v[e] =
              from_f32<Tout>((v[i][e] - mean) * rstd * sc[i][e] + bi[i][e]);
          amax = fmaxf(amax, fabsf(to_f32(o[i].v[e])));
        }
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (live && has(i))
          *reinterpret_cast<Vec<Tout, N>*>(out + base +
                                           (size_t)(i * G + gl) * N) = o[i];
      const float s = scale_of(group_max(amax, G));
      const float inv = inverse(s);
      if (live) {
        const int kp = padded(D);
        int8_t* cr = codes + (size_t)row * kp;
        if (gl == 0) sx[row] = s;
#pragma unroll
        for (int i = 0; i < V; ++i)
          if (has(i)) store_codes<Tout, N>(cr + (i * G + gl) * N, o[i], inv);
        for (int c = D + gl; c < kp; c += G) cr[c] = 0;
      }
    }
  }
}

// ---------------------------------------------------------------------------
// wide rows: one block per row, v formed anew on each of three passes
// ---------------------------------------------------------------------------

// the sum over the block; every warp adds the warps' partials in one order
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = group_sum(v, 32);
  __syncthreads();  // the previous call's readers are done with red
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  return group_sum(lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f, 32);
}

__device__ __forceinline__ float block_max(float v, float* red) {
  v = group_max(v, 32);
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  return group_max(lane < (int)(blockDim.x >> 5) ? red[lane] : 0.f, 32);
}

// CODES: the codes form. The third pass also takes the max |output| as
// rounded; a fourth reads the block's own stores back (visible to it
// after block_max's barrier) and writes the codes.
template <typename Tin, typename Tout, int N, bool CODES>
__global__ void __launch_bounds__(ROW_BLOCK)
    ln_block_kernel(const Tin* __restrict__ x,
                    const Tout* __restrict__ residual,
                    const float* __restrict__ pre_bias,
                    const float* __restrict__ scale,
                    const float* __restrict__ bias, Tout* __restrict__ out,
                    int8_t* __restrict__ codes, float* __restrict__ sx,
                    int M, int D, float eps) {
  __shared__ float red[32];
  const int nv = D / N;
  for (int row = blockIdx.x; row < M; row += gridDim.x) {
    const size_t base = (size_t)row * D;
    // v = x (+ pre_bias) (+ residual) of vector c, in f32
    auto value = [&](int c, float (&v)[N]) {
      const Vec<Tin, N> xv = ld<Tin, N>(x + base + (size_t)c * N);
      float p[N];
#pragma unroll
      for (int e = 0; e < N; ++e) p[e] = 0.f;
      if (pre_bias != nullptr) ld_f32<N>(p, pre_bias + c * N);
      Vec<Tout, N> rv{};
      if (residual != nullptr)
        rv = ld<Tout, N>(residual + base + (size_t)c * N);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        v[e] = widen<Tin, Tout>(xv.v[e]) + p[e];
        if (residual != nullptr) v[e] += to_f32(rv.v[e]);
      }
    };
    float v[N];
    float s = 0.f;
    for (int c = threadIdx.x; c < nv; c += blockDim.x) {
      value(c, v);
#pragma unroll
      for (int e = 0; e < N; ++e) s += v[e];
    }
    const float mean = block_sum(s, red) / (float)D;
    float sq = 0.f;
    for (int c = threadIdx.x; c < nv; c += blockDim.x) {
      value(c, v);
#pragma unroll
      for (int e = 0; e < N; ++e) {
        const float d = v[e] - mean;
        sq += d * d;
      }
    }
    const float rstd = rsqrtf(block_sum(sq, red) / (float)D + eps);
    float amax = 0.f;
    for (int c = threadIdx.x; c < nv; c += blockDim.x) {
      value(c, v);
      float sc[N], bi[N];
      ld_f32<N>(sc, scale + c * N);
      ld_f32<N>(bi, bias + c * N);
      Vec<Tout, N> o;
#pragma unroll
      for (int e = 0; e < N; ++e) {
        o.v[e] = from_f32<Tout>((v[e] - mean) * rstd * sc[e] + bi[e]);
        if constexpr (CODES) amax = fmaxf(amax, fabsf(to_f32(o.v[e])));
      }
      *reinterpret_cast<Vec<Tout, N>*>(out + base + (size_t)c * N) = o;
    }
    if constexpr (CODES) {
      const float s = scale_of(block_max(amax, red));
      const float inv = inverse(s);
      const int kp = padded(D);
      int8_t* cr = codes + (size_t)row * kp;
      if (threadIdx.x == 0) sx[row] = s;
      for (int c = threadIdx.x; c < nv; c += blockDim.x)
        store_codes<Tout, N>(
            cr + c * N,
            *reinterpret_cast<const Vec<Tout, N>*>(out + base + (size_t)c * N),
            inv);
      for (int c = D + threadIdx.x; c < kp; c += blockDim.x) cr[c] = 0;
    }
  }
}

// ---------------------------------------------------------------------------
// launch
// ---------------------------------------------------------------------------

struct Args {
  const void *x, *residual, *pre_bias, *scale, *bias;
  void* out;
  int M, D;
  float eps;
  cudaStream_t st;
  void* codes = nullptr;  // the codes form: codes[M, Kp] int8 and sx[M]
  void* sx = nullptr;
};

template <typename Tin, typename Tout, int N, int V>
int launch_rows(const Args& a, int G) {
  const int sms = hopper::sm_count();
  const long long warps_needed = ((long long)a.M + 32 / G - 1) / (32 / G);
  // the fewest warps a block (down to one) that still gives every SM two
  // blocks, so that small M spreads over the card
  int tb = 256;
  while (tb > 32 && (warps_needed * 32 + tb - 1) / tb < 2LL * sms) tb >>= 1;
  const long long blocks = (warps_needed * 32 + tb - 1) / tb;
  // more blocks than the card holds at once walk the rows instead
  const int grid = (int)(blocks < (long long)sms * (2048 / tb)
                             ? blocks
                             : (long long)sms * (2048 / tb));
  auto kernel = a.codes != nullptr ? ln_rows_kernel<Tin, Tout, N, V, true>
                                   : ln_rows_kernel<Tin, Tout, N, V, false>;
  kernel<<<grid, tb, 0, a.st>>>(
      (const Tin*)a.x, (const Tout*)a.residual, (const float*)a.pre_bias,
      (const float*)a.scale, (const float*)a.bias, (Tout*)a.out,
      (int8_t*)a.codes, (float*)a.sx, a.M, a.D, G, a.eps);
  return (int)cudaGetLastError();
}

template <typename Tin, typename Tout, int N, int V = 1>
int dispatch_v(const Args& a, int G, int v) {
  if constexpr (V > vmax(N)) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (v == V) return launch_rows<Tin, Tout, N, V>(a, G);
    return dispatch_v<Tin, Tout, N, V + 1>(a, G, v);
  }
}

template <typename Tin, typename Tout, int N>
int launch_n(const Args& a) {
  const int nv = a.D / N;
  if (nv > 32 * vmax(N)) {  // wider than a row in registers
    const int sms = hopper::sm_count();
    const int grid = a.M < sms * 8 ? a.M : sms * 8;
    auto kernel = a.codes != nullptr ? ln_block_kernel<Tin, Tout, N, true>
                                     : ln_block_kernel<Tin, Tout, N, false>;
    kernel<<<grid, ROW_BLOCK, 0, a.st>>>(
        (const Tin*)a.x, (const Tout*)a.residual, (const float*)a.pre_bias,
        (const float*)a.scale, (const float*)a.bias, (Tout*)a.out,
        (int8_t*)a.codes, (float*)a.sx, a.M, a.D, a.eps);
    return (int)cudaGetLastError();
  }
  // G lanes a row, V vectors a lane: the fewest masked slots, then the
  // most lanes
  int best_g = 0, best_v = 0, waste = INT_MAX;
  for (int g = 32; g >= 8; g >>= 1)
    for (int v = 1; v <= vmax(N); ++v)
      if (g * v >= nv && g * v - nv < waste) {
        waste = g * v - nv;
        best_g = g;
        best_v = v;
      }
  return dispatch_v<Tin, Tout, N>(a, best_g, best_v);
}

bool aligned(const void* p, uintptr_t n) {
  return reinterpret_cast<uintptr_t>(p) % n == 0;
}

template <typename Tin, typename Tout>
int launch(const Args& a) {
  if (a.M <= 0 || a.D <= 0) return (int)cudaErrorInvalidValue;
  // the vector by the row's byte stride in the output type (the wrapper
  // picks the same and checks the same alignments first)
  int n;
  if constexpr (std::is_same<Tout, bf16>::value)
    n = a.D % 8 == 0 ? 8 : a.D % 2 == 0 ? 2 : 1;
  else
    n = a.D % 4 == 0 ? 4 : 1;
  auto need = [n](size_t elem) {
    return (uintptr_t)(n * elem < 16 ? n * elem : 16);
  };
  if (!aligned(a.x, need(sizeof(Tin))) ||
      !aligned(a.residual, need(sizeof(Tout))) ||
      !aligned(a.out, need(sizeof(Tout))) || !aligned(a.scale, need(4)) ||
      !aligned(a.bias, need(4)) || !aligned(a.pre_bias, need(4)) ||
      !aligned(a.codes, n))  // rows of Kp bytes: n-byte code stores
    return (int)cudaErrorMisalignedAddress;
  if constexpr (std::is_same<Tout, bf16>::value) {
    if (n == 8) return launch_n<Tin, Tout, 8>(a);
    if (n == 2) return launch_n<Tin, Tout, 2>(a);
    return launch_n<Tin, Tout, 1>(a);
  } else {
    if (n == 4) return launch_n<Tin, Tout, 4>(a);
    return launch_n<Tin, Tout, 1>(a);
  }
}

}  // namespace

extern "C" int layer_norm_f32(const void* x, const void* residual,
                              const void* pre_bias, const void* scale,
                              const void* bias, void* out, int M, int D,
                              float eps, void* stream) {
  return launch<float, float>({x, residual, pre_bias, scale, bias, out, M, D,
                               eps, (cudaStream_t)stream});
}

extern "C" int layer_norm_bf16(const void* x, const void* residual,
                               const void* pre_bias, const void* scale,
                               const void* bias, void* out, int M, int D,
                               float eps, void* stream) {
  return launch<bf16, bf16>({x, residual, pre_bias, scale, bias, out, M, D,
                             eps, (cudaStream_t)stream});
}

// x f32 (a matmul's product), residual and out bf16
extern "C" int layer_norm_f32_bf16(const void* x, const void* residual,
                                   const void* pre_bias, const void* scale,
                                   const void* bias, void* out, int M, int D,
                                   float eps, void* stream) {
  return launch<float, bf16>({x, residual, pre_bias, scale, bias, out, M, D,
                              eps, (cudaStream_t)stream});
}

// The codes form of each: also codes[M, Kp] int8 (Kp = D rounded up to 32,
// zero tail) and sx[M] f32, the W8A8 activation codes of the rounded out
extern "C" int layer_norm_codes_f32(const void* x, const void* residual,
                                    const void* pre_bias, const void* scale,
                                    const void* bias, void* out, void* codes,
                                    void* sx, int M, int D, float eps,
                                    void* stream) {
  if (codes == nullptr || sx == nullptr) return (int)cudaErrorInvalidValue;
  return launch<float, float>({x, residual, pre_bias, scale, bias, out, M, D,
                               eps, (cudaStream_t)stream, codes, sx});
}

extern "C" int layer_norm_codes_bf16(const void* x, const void* residual,
                                     const void* pre_bias, const void* scale,
                                     const void* bias, void* out, void* codes,
                                     void* sx, int M, int D, float eps,
                                     void* stream) {
  if (codes == nullptr || sx == nullptr) return (int)cudaErrorInvalidValue;
  return launch<bf16, bf16>({x, residual, pre_bias, scale, bias, out, M, D,
                             eps, (cudaStream_t)stream, codes, sx});
}

extern "C" int layer_norm_codes_f32_bf16(const void* x, const void* residual,
                                         const void* pre_bias,
                                         const void* scale, const void* bias,
                                         void* out, void* codes, void* sx,
                                         int M, int D, float eps,
                                         void* stream) {
  if (codes == nullptr || sx == nullptr) return (int)cudaErrorInvalidValue;
  return launch<float, bf16>({x, residual, pre_bias, scale, bias, out, M, D,
                              eps, (cudaStream_t)stream, codes, sx});
}
