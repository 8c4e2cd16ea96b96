// W8A8 int8 matmul for Hopper (sm_90a): per-row int8 activations times
// per-column int8 weights on the int8 tensor cores, in two kernels.
//
// Replaces: bert_tpu/ops/int8_matmul.py::quantize_activations_i8 (:83) and
// ::int8_matmul (:94). Those are XLA, not Pallas, by design (their module
// says why); on the H100 there is no XLA to write them, so each is a kernel
// here. Same arithmetic, bit for bit on finite inputs:
//   quantize_rows_i8: sx = amax / 127 (an IEEE division), inv = 1 / sx (or
//     0 for a zero row; IEEE), code = clamp(rint(x * inv), -127, 127) with
//     rint's round half to even (jnp.round), never -128;
//   int8_matmul: acc = sum over K of code_x * code_w in int32 (exact: K *
//     127^2 < 2^31, which the wrapper checks), then out = (float(acc) *
//     sx[m]) * sw[n], two f32 roundings in that order.
// No --use_fast_math (_kernels.NVCC_FLAGS): every division and rounding
// here is IEEE's.
//
// Layouts. Codes rows are padded to Kp = ceil(K / 32) * 32 with zeros: the
// activations' codes[M, Kp] (written by quantize_rows_i8) and the weight's
// w[N, Kp], K contiguous. The s8 mma's B operand wants K contiguous per
// column and ldmatrix has no transposing form for 8-bit data, so the
// weight is stored transposed once, at load; the padding keeps every row
// in whole 16-byte copies (K = 312 or 600 included) and zero codes add
// nothing to an exact sum.
//
// What bounds them on the H100. quantize_rows_i8 moves bytes: x in (2 or 4
// bytes an element), codes out (1 byte), almost no arithmetic. int8_matmul
// at bert-base's shapes at M = 8,192 tokens moves 7-13 MB of codes in and
// writes an f32 [M, N] out: at QKV (K 768, N 2,304) 83.6 MB in all, 75.5 of
// it the f32 output, 0.0249 ms at 3.35 TB/s, against 29 G int8 ops, 0.0147
// ms at 1,979 TOPS, so bytes bound it; FFN-down (K 3,072, N 768) is bound by
// operations (0.0195 ms). The f32 output is the contract q4_matmul has
// (the LayerNorm's f32-input form and dense(..., f32_out=True) take it).
//
// Design (simple first). quantize_rows_i8: one warp per row, 16-byte loads
// where the row allows (else one element a lane), the amax reduced by
// shuffles, then a second pass over the row (from L1/L2) writes the codes
// 4 or 8 at a time and the zero tail. int8_matmul: 256-thread blocks (2 x 4
// warps) own a 128 x 128 output tile, each warp 64 x 32; K is walked 64
// codes at a time through a 3-slot ring of cp.async copies (16 bytes a
// thread, zero-filled past M, N and Kp) into shared memory rows padded to
// 80 bytes, so that ldmatrix reads them without bank conflicts. The s8
// fragments of mma.m16n8k32 have the byte layout of the bf16 fragments of
// m16n8k16, so plain ldmatrix.x4 loads A from the codes tile and B from the
// [n][k] weight tile. Each warp runs 16 mma.sync.m16n8k32 (s8 x s8 -> s32)
// per 32-deep step; the epilogue scales in f32 and stores float2 pairs,
// masking the M and N edges. No wgmma, TMA or warp specialisation yet:
// those wait for the times (PERF.md).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int KP_ALIGN = 32;  // the s8 mma's depth; codes rows pad to it

int padded_k(int K) { return (K + KP_ALIGN - 1) / KP_ALIGN * KP_ALIGN; }

// ---------------------------------------------------------------------------
// quantize_rows_i8: x[M, K] -> codes[M, Kp] int8, sx[M] f32
// ---------------------------------------------------------------------------

namespace quant {

constexpr int WARPS = 8;  // rows per block

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// VEC elements at p, widened to f32: one 16-byte load when VEC > 1.
template <typename T, int VEC>
__device__ __forceinline__ void load_row(const T* __restrict__ p,
                                         float (&v)[VEC]) {
  if constexpr (VEC == 1) {
    v[0] = to_f32(p[0]);
  } else {
    static_assert(VEC * sizeof(T) == 16, "16-byte vectors");
    const uint4 raw = *reinterpret_cast<const uint4*>(p);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < VEC; ++i) v[i] = to_f32(e[i]);
  }
}

// round half to even (rintf), clamp to +-127; the product is one f32
// rounding, as jnp's x * inv
__device__ __forceinline__ uint32_t code(float v, float inv) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(q)));
}

template <typename T, int VEC>
__global__ void __launch_bounds__(WARPS * 32)
    quantize_rows_kernel(const T* __restrict__ x, int8_t* __restrict__ codes,
                         float* __restrict__ sx, int M, int K, int Kp) {
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.x * WARPS + (threadIdx.x >> 5);
  if (row >= M) return;  // the whole warp: row is the warp's
  const T* xr = x + (size_t)row * K;
  int8_t* cr = codes + (size_t)row * Kp;

  float amax = 0.f;
  for (int c = lane * VEC; c < K; c += 32 * VEC) {
    float v[VEC];
    load_row<T, VEC>(xr + c, v);
#pragma unroll
    for (int i = 0; i < VEC; ++i) amax = fmaxf(amax, fabsf(v[i]));
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  const float s = __fdiv_rn(amax, 127.f);
  const float inv = s > 0.f ? __frcp_rn(s) : 0.f;  // a zero row: codes 0
  if (lane == 0) sx[row] = s;

  for (int c = lane * VEC; c < K; c += 32 * VEC) {
    float v[VEC];
    load_row<T, VEC>(xr + c, v);
    if constexpr (VEC == 1) {
      cr[c] = static_cast<int8_t>(code(v[0], inv));
    } else {
      uint32_t w[VEC / 4];
#pragma unroll
      for (int j = 0; j < VEC / 4; ++j)
        w[j] = code(v[4 * j], inv) | code(v[4 * j + 1], inv) << 8 |
               code(v[4 * j + 2], inv) << 16 | code(v[4 * j + 3], inv) << 24;
      if constexpr (VEC == 4)
        *reinterpret_cast<uint32_t*>(cr + c) = w[0];
      else
        *reinterpret_cast<uint2*>(cr + c) = make_uint2(w[0], w[1]);
    }
  }
  for (int c = K + lane; c < Kp; c += 32) cr[c] = 0;
}

// 16-byte loads when every row starts 16-byte aligned, else one element.
template <typename T>
int launch(const void* x, void* codes, void* sx, int M, int K,
           cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const dim3 grid((M + WARPS - 1) / WARPS);
  const bool wide = (size_t)K * sizeof(T) % 16 == 0 &&
                    reinterpret_cast<uintptr_t>(x) % 16 == 0;
  if (wide)
    quantize_rows_kernel<T, VEC><<<grid, WARPS * 32, 0, stream>>>(
        (const T*)x, (int8_t*)codes, (float*)sx, M, K, padded_k(K));
  else
    quantize_rows_kernel<T, 1><<<grid, WARPS * 32, 0, stream>>>(
        (const T*)x, (int8_t*)codes, (float*)sx, M, K, padded_k(K));
  return (int)cudaGetLastError();
}

}  // namespace quant

// ---------------------------------------------------------------------------
// int8_matmul: codes[M, Kp] x w[N, Kp] -> f32 out[M, N]
// ---------------------------------------------------------------------------

namespace mm {

constexpr int BM = 128, BN = 128;  // output tile of a block
constexpr int BK = 64;             // codes (bytes) of K per ring slot
constexpr int STAGES = 3;
constexpr int THREADS = 256;       // 2 x 4 warps, each 64 x 32
constexpr int LD = BK + 16;        // 80-byte rows: ldmatrix conflict-free

struct Smem {
  int8_t a[STAGES][BM][LD];
  int8_t b[STAGES][BN][LD];
};

// c += a @ b on the int8 tensor cores: s8 inputs, s32 accumulation. The
// fragments (PTX ISA, m16n8k32 .s8): A a0 = (g, 4t..4t+3), a1 = (g+8, ..),
// a2 = (g, 16+4t..), a3 = (g+8, 16+4t..); B b0 = (k 4t..4t+3, n g), b1 =
// (k 16+4t.., n g); C c0, c1 = (g, 2t..2t+1), c2, c3 = (g+8, ..), with
// g = lane / 4, t = lane % 4 and four codes to a .b32 register.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Copy slot st's tiles of K step kt: BM rows of codes and BN rows of w,
// BK bytes each, 16 bytes a copy; zero-filled past M, N and Kp.
__device__ __forceinline__ void load_tiles(Smem& s, int st, int kt,
                                           const int8_t* __restrict__ codes,
                                           const int8_t* __restrict__ w,
                                           int M, int Kp, int N, int m0,
                                           int n0) {
  const int k0 = kt * BK;
#pragma unroll
  for (int i = threadIdx.x; i < BM * (BK / 16); i += THREADS) {
    const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
    const bool ok = m0 + r < M && k0 + c < Kp;
    hopper::cp_async16(&s.a[st][r][c],
                       codes + (ok ? (size_t)(m0 + r) * Kp + k0 + c : 0), ok);
  }
#pragma unroll
  for (int i = threadIdx.x; i < BN * (BK / 16); i += THREADS) {
    const int r = i / (BK / 16), c = (i % (BK / 16)) * 16;
    const bool ok = n0 + r < N && k0 + c < Kp;
    hopper::cp_async16(&s.b[st][r][c],
                       w + (ok ? (size_t)(n0 + r) * Kp + k0 + c : 0), ok);
  }
}

__device__ __forceinline__ float scaled(int acc, float a, float b) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), a), b);
}

__device__ __forceinline__ void store2(float* __restrict__ out, int M, int N,
                                       int m, int n, float v0, float v1) {
  if (m >= M) return;
  float* o = out + (size_t)m * N + n;
  if ((N & 1) == 0) {  // n is even, so n < N means n + 1 < N
    if (n < N) *reinterpret_cast<float2*>(o) = make_float2(v0, v1);
  } else {
    if (n < N) o[0] = v0;
    if (n + 1 < N) o[1] = v1;
  }
}

__global__ void __launch_bounds__(THREADS, 1)
    int8_matmul_kernel(const int8_t* __restrict__ codes,
                       const int8_t* __restrict__ w,
                       const float* __restrict__ sx,
                       const float* __restrict__ sw, float* __restrict__ out,
                       int M, int Kp, int N) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(smem_raw);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * BN;
  const int steps = (Kp + BK - 1) / BK;

  int acc[4][4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0;

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j) {
    if (j < steps) load_tiles(s, j, j, codes, w, M, Kp, N, m0, n0);
    hopper::cp_async_commit();
  }
  for (int kt = 0; kt < steps; ++kt) {
    hopper::cp_async_wait<STAGES - 2>();  // step kt has landed (this thread)
    __syncthreads();  // ... for all; slot (kt - 1) % STAGES is free
    const int next = kt + STAGES - 1;
    if (next < steps)
      load_tiles(s, next % STAGES, next, codes, w, M, Kp, N, m0, n0);
    hopper::cp_async_commit();

    const int st = kt % STAGES;
#pragma unroll
    for (int kk = 0; kk < BK / 32; ++kk) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        hopper::ldsm_x4(a[mt], &s.a[st][wm * 64 + mt * 16 + (lane & 15)]
                                   [kk * 32 + (lane >> 4) * 16]);
      uint32_t b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        // matrices: (n 0-7, k 0-15), (n 0-7, k 16-31), (n 8-15, k 0-15),
        // (n 8-15, k 16-31) -> b0, b1 of n-tile 2np, then of 2np + 1
        uint32_t r[4];
        hopper::ldsm_x4(r, &s.b[st][wn * 32 + np * 16 + (lane >> 4) * 8 +
                                    (lane & 7)]
                               [kk * 32 + ((lane >> 3) & 1) * 16]);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          mma_s8(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
  }

#pragma unroll
  for (int mt = 0; mt < 4; ++mt) {
    const int m = m0 + wm * 64 + mt * 16 + (lane >> 2);
    const float sa = m < M ? sx[m] : 0.f;
    const float sb = m + 8 < M ? sx[m + 8] : 0.f;
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + wn * 32 + nt * 8 + (lane & 3) * 2;
      const float w0 = n < N ? sw[n] : 0.f;
      const float w1 = n + 1 < N ? sw[n + 1] : 0.f;
      const int* c = acc[mt][nt];
      store2(out, M, N, m, n, scaled(c[0], sa, w0), scaled(c[1], sa, w1));
      store2(out, M, N, m + 8, n, scaled(c[2], sb, w0),
             scaled(c[3], sb, w1));
    }
  }
}

// The ring is 60 KB of shared memory, above the 48 KB default: the limit
// is raised once.
int launch(const void* codes, const void* w, const void* sx, const void* sw,
           void* out, int M, int Kp, int N, cudaStream_t stream) {
  constexpr int smem = sizeof(Smem);
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_matmul_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  int8_matmul_kernel<<<grid, THREADS, smem, stream>>>(
      (const int8_t*)codes, (const int8_t*)w, (const float*)sx,
      (const float*)sw, (float*)out, M, Kp, N);
  return (int)cudaGetLastError();
}

}  // namespace mm

}  // namespace

extern "C" int quantize_rows_i8_f32(const void* x, void* codes, void* sx,
                                    int M, int K, void* stream) {
  if (M <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  return quant::launch<float>(x, codes, sx, M, K, (cudaStream_t)stream);
}

extern "C" int quantize_rows_i8_bf16(const void* x, void* codes, void* sx,
                                     int M, int K, void* stream) {
  if (M <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  return quant::launch<__nv_bfloat16>(x, codes, sx, M, K,
                                      (cudaStream_t)stream);
}

extern "C" int int8_matmul(const void* codes, const void* w, const void* sx,
                           const void* sw, void* out, int M, int Kp, int N,
                           void* stream) {
  if (M <= 0 || N <= 0 || Kp <= 0 || Kp % KP_ALIGN != 0)
    return (int)cudaErrorInvalidValue;
  return mm::launch(codes, w, sx, sw, out, M, Kp, N, (cudaStream_t)stream);
}
