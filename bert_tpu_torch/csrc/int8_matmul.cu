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
//     127^2 < 2^31, which the wrapper checks), then p = (float(acc) *
//     sx[m]) * sw[n], two f32 roundings in that order. Three epilogues:
//     (a) out = p in f32 (the LayerNorm's f32-input form takes it);
//     (b) out = r(r(p) + r(b)) in the compute type, r its rounding (bf16:
//     round to nearest even; f32: none, the add one f32 rounding), with
//     an optional bias b stored in that type: bit for bit the cast and
//     the bias add bert_tpu's dense does after its product
//     (bert_tpu/model.py:73);
//     (c) out = r(gelu(form (b))), GELU in f32 exactly as PyTorch's CUDA
//     F.gelu computes it (FFN-up, bert_tpu/model.py:158).
// No --use_fast_math (_kernels.NVCC_FLAGS): every division and rounding
// here is IEEE's.
//
// Layouts. Codes rows are padded to Kp = ceil(K / 32) * 32 with zeros: the
// activations' codes[M, Kp] (written by quantize_rows_i8) and the weight's
// w[N, Kp], K contiguous. wgmma takes 8-bit operands only K-major, for A
// and B alike, so the weight is stored transposed once, at load; zero
// codes add nothing to an exact sum, and a row stride of a multiple of 32
// bytes is what TMA asks for (16).
//
// What bounds them on the H100. quantize_rows_i8 moves bytes: x in (2 or 4
// bytes an element), codes out (1 byte), about one operation a byte
// against the card's ridge of about 295: at 8,192 x 3,072 bf16 75.5 MB,
// 0.0225 ms at 3.35 TB/s; at 8,192 x 768, 0.0056 ms. int8_matmul
// at bert-base's shapes at M = 8,192 tokens reads 7-13 MB of codes; form
// (a) writes an f32 [M, N], form (b) a bf16 one. QKV (K 768, N 2,304) in
// form (b) with its bias moves 45.8 MB, 0.0137 ms at 3.35 TB/s, against
// 29.0 G int8 operations, 0.0147 ms at 1,979 TOP/s: operations bound it
// (in form (a) the 75.5 MB f32 output made it 0.0250 ms, bytes). FFN-up
// (b): 0.0195 ms, operations; attention-out (a): 0.0096 ms, bytes;
// FFN-down (a): 0.0195 ms, operations.
//
// Design of quantize_rows_i8: one read of x. Below the ridge the only gain
// is fewer bytes and more of them in flight, so the row is held in
// registers, as csrc/layer_norm.cu holds its rows: a group of G = 8, 16
// or 32 lanes a row, V units of U elements a lane (U = 16 where K allows
// it: two 16-byte loads of bf16, four of f32, and one 16-byte store of
// codes; else 8, 4 or 1), G and V picked at launch for the fewest masked
// slots (K = 768 bf16: 16 lanes x 3 units; 3,072: 32 x 6). Every load of
// a row is issued before its reduction (a butterfly within the group),
// and the codes come from the same registers; the zero tail runs to Kp.
// Blocks of up to 8 warps walk the rows, up to 48 registers of raw x a
// lane, so that enough rows are in flight to fill 132 SMs at M = 8,192
// (K = 3,072: 24 KB of loads in flight a block). The rows in shared
// memory by one cp.async.bulk on an mbarrier were the other choice; it
// was not built: with the row in registers the kernel already reaches
// the share of its bound in PERF.md, and shared memory would only add a
// copy. Rows wider than the registers (past 1,536 f32 or 3,072 bf16
// elements with U = 16) take a simple instance, one block a row, that
// reads the row a second time for the codes, as the LayerNorm's wide
// instance does; no model width takes it but f32 rows past 1,536. An
// amax given by the producer (form (c) reducing it in its epilogue) was
// built and measured slower on both sides (PERF.md): this kernel took
// longer without its own reduction than with it, and form (c) longer with
// the per-row atomics than without.
//
// Design of int8_matmul: persistent, warp-specialised blocks on TMA and
// wgmma. One block per SM (three warpgroups, 384 threads) walks the 128 x
// 128 output tiles t = blockIdx.x, + gridDim.x, ..., row-block major, so
// that the blocks running together cover a few row blocks and every
// column block: each weight tile is read by many blocks at once, from L2.
//  - The producer warpgroup (setmaxnreg down to 40 registers; one thread
//    works) keeps a ring of 6 stages full, in the order the block's tiles
//    and their K steps come: per stage a 128 x 128-code tile of A (the
//    activation codes) and of B (the weight), two cp.async.bulk.tensor.2d
//    loads in the 128-byte swizzle completing on the stage's full
//    mbarrier; TMA zero-fills past M, N and Kp. It waits on the stage's
//    empty mbarrier before reusing it.
//  - Two consumer warpgroups (setmaxnreg up to 232) in ping-pong: each
//    takes every other tile of the block whole, rows 0-63 and 64-127 in
//    two accumulators (64 s32 a thread each). Per stage it issues eight
//    wgmma.mma_async.m64n128k32.s32.s8.s8 (two halves, four k32 steps),
//    both operands from shared memory through descriptors (a k32 step
//    advances the start address 32 bytes inside the swizzled 128-byte
//    rows), one commit group per stage, and releases the previous stage
//    (128 arrivals) once wgmma.wait_group 1 shows its group retired.
//  - A warpgroup starts a tile's products only after the other one has
//    issued those of the tile before (a turn mbarrier each way), then
//    runs its epilogue while the other one's products run: the epilogue's
//    arithmetic beside the same warps' own wgmma went slowly on the card,
//    beside another warpgroup's it does not (PERF.md). The order also
//    keeps a warpgroup from waiting on a stage's full barrier while an
//    earlier phase of it is still pending.
//  - Form (c) adds GELU to each finished pair, in the same slot, beside
//    the other warpgroup's products. GELU is about 40 operations an
//    output, so at FFN-up it, not the products, sets the pace: form (c)
//    takes about 1.6 times form (b) (PERF.md). Other
//    homes for it were built and measured slower (PERF.md): the
//    producer warpgroup's three idle warps finishing the staged chunks
//    (under its 40 registers), the consumer applying it to the staged
//    chunk after the pair stores, and GELU out of line; erff's one
//    branch per element costs nothing measurable.
//  - The epilogue's gathers (sx of the thread's four rows; sw and the
//    bias of 32 columns a chunk, one a lane, handed out by shuffles) are
//    loaded before the tile's products. Thread t of warp w holds rows 16 w
//    + t / 4 and + 8 of each half, columns 8 j + 2 (t % 4) and + 1 (the
//    f32 layout of the bf16 m64nNk16). A 64 x 32 chunk's pairs are
//    computed branch-free, written to a staging buffer in the output map's
//    swizzle (two a warpgroup), and stored by one TMA store
//    (cp.async.bulk.tensor, clipped at the M and N edges) after a
//    fence.proxy.async and a named barrier of the warpgroup. An output
//    whose row stride is not a multiple of 16 bytes (an odd N in bf16)
//    takes masked pair stores from the registers instead.
// Why 128 x 128: a warpgroup's tile fills 128 accumulator registers a
// thread, and at M = 8,192 on 132 SMs the 128-wide tiles split the
// narrow products better than 256-wide ones would: 384 tiles (2.9 waves)
// against 192 (1.45 waves) at N = 768.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"
#include "hopper_tma.cuh"

namespace {

constexpr int KP_ALIGN = 32;  // the s8 wgmma's depth; codes rows pad to it

int padded_k(int K) { return (K + KP_ALIGN - 1) / KP_ALIGN * KP_ALIGN; }

// ---------------------------------------------------------------------------
// quantize_rows_i8: x[M, K] -> codes[M, Kp] int8, sx[M] f32
// ---------------------------------------------------------------------------

namespace quant {

constexpr int VMAX = 8;          // units a lane holds, at most
constexpr int WIDE_BLOCK = 256;  // threads of the block-per-row instance

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

// the elements of a row a lane may hold: 48 registers of raw x
template <typename T>
constexpr int lane_elems() {
  return 192 / (int)sizeof(T);
}
template <typename T, int U>
constexpr int vmax() {
  return lane_elems<T>() / U < VMAX ? lane_elems<T>() / U : VMAX;
}

// U consecutive elements of T, moved as min(16, U * sizeof(T))-byte
// accesses (a unit of 16 f32 is four 16-byte loads)
template <typename T, int U>
struct alignas(U * sizeof(T) < 16 ? U * sizeof(T) : 16) Unit {
  T v[U];
};

// round half to even (rintf), clamp to +-127; the product is one f32
// rounding, as jnp's x * inv
__device__ __forceinline__ uint32_t code(float v, float inv) {
  const float q = fminf(fmaxf(rintf(__fmul_rn(v, inv)), -127.f), 127.f);
  return static_cast<uint32_t>(static_cast<uint8_t>(static_cast<int8_t>(q)));
}

// the U codes of a unit, packed four to a word and written by one store
// of U bytes (16, 8, 4 or 1)
template <typename T, int U>
__device__ __forceinline__ void store_codes(int8_t* __restrict__ p,
                                            const Unit<T, U>& u, float inv) {
  if constexpr (U == 1) {
    *p = static_cast<int8_t>(code(to_f32(u.v[0]), inv));
  } else {
    uint32_t w[U / 4];
#pragma unroll
    for (int j = 0; j < U / 4; ++j)
      w[j] = code(to_f32(u.v[4 * j]), inv) |
             code(to_f32(u.v[4 * j + 1]), inv) << 8 |
             code(to_f32(u.v[4 * j + 2]), inv) << 16 |
             code(to_f32(u.v[4 * j + 3]), inv) << 24;
    if constexpr (U == 16)
      *reinterpret_cast<uint4*>(p) = make_uint4(w[0], w[1], w[2], w[3]);
    else if constexpr (U == 8)
      *reinterpret_cast<uint2*>(p) = make_uint2(w[0], w[1]);
    else
      *reinterpret_cast<uint32_t*>(p) = w[0];
  }
}

__device__ __forceinline__ float group_max(float v, int G) {
  for (int o = G >> 1; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// sx = amax / 127 (IEEE), inv = 1 / sx (IEEE), or 0 for a zero row
__device__ __forceinline__ float scale_of(float amax) {
  return __fdiv_rn(amax, 127.f);
}
__device__ __forceinline__ float inverse(float s) {
  return s > 0.f ? __frcp_rn(s) : 0.f;  // a zero row: codes 0
}

// The row in registers: a group of G lanes a row, V units of U elements a
// lane (lane l's slot i is unit i * G + l, so each slot is one coalesced
// run and only the last slot can lie past the row). Every load of the row
// is issued before the reduction; the codes are formed from the same
// registers.
template <typename T, int U, int V>
__global__ void __launch_bounds__(256, 1)
    quantize_rows_kernel(const T* __restrict__ x,
                         int8_t* __restrict__ codes, float* __restrict__ sx,
                         int M, int K, int Kp, int G) {
  const int nu = K / U;  // units a row
  const int lane = threadIdx.x & 31;
  const int gl = lane & (G - 1);
  const int lg = __ffs(G) - 1;  // G = 2^lg
  const int rows_per_warp = 32 >> lg;
  const int warps = blockDim.x >> 5;
  const bool tail = (V - 1) * G + gl < nu;
  auto has = [&](int i) { return i < V - 1 || tail; };

  // warp-uniform trip count: every lane takes part in every shuffle
  const int step = gridDim.x * warps * rows_per_warp;
  for (int r0 = (blockIdx.x * warps + (threadIdx.x >> 5)) * rows_per_warp;
       r0 < M; r0 += step) {
    const int row = r0 + (lane >> lg);
    const bool live = row < M;
    const T* xr = x + (size_t)row * K;
    Unit<T, U> u[V];
#pragma unroll
    for (int i = 0; i < V; ++i) {
      u[i] = Unit<T, U>{};
      if (live && has(i))
        u[i] = *reinterpret_cast<const Unit<T, U>*>(xr + (i * G + gl) * U);
    }
    float a = 0.f;
#pragma unroll
    for (int i = 0; i < V; ++i)
#pragma unroll
      for (int e = 0; e < U; ++e) a = fmaxf(a, fabsf(to_f32(u[i].v[e])));
    a = group_max(a, G);
    if (live) {
      const float s = scale_of(a);
      const float inv = inverse(s);
      if (gl == 0) sx[row] = s;
      int8_t* cr = codes + (size_t)row * Kp;
#pragma unroll
      for (int i = 0; i < V; ++i)
        if (has(i)) store_codes<T, U>(cr + (i * G + gl) * U, u[i], inv);
      for (int c = K + gl; c < Kp; c += G) cr[c] = 0;
    }
  }
}

// Rows wider than the registers hold (more than 32 * vmax units): one
// block per row, a pass for the amax and a second for the codes that
// reads the row again, from L2. No model width takes it but f32 rows past
// 1,536 (PERF.md).
template <typename T, int U>
__global__ void __launch_bounds__(WIDE_BLOCK, 1)
    quantize_wide_kernel(const T* __restrict__ x,
                         int8_t* __restrict__ codes, float* __restrict__ sx,
                         int M, int K, int Kp) {
  __shared__ float red[WIDE_BLOCK / 32];
  const int nu = K / U;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int row = blockIdx.x; row < M; row += gridDim.x) {
    const T* xr = x + (size_t)row * K;
    float a = 0.f;
    for (int c = threadIdx.x; c < nu; c += WIDE_BLOCK) {
      const Unit<T, U> u = *reinterpret_cast<const Unit<T, U>*>(xr + c * U);
#pragma unroll
      for (int e = 0; e < U; ++e) a = fmaxf(a, fabsf(to_f32(u.v[e])));
    }
    a = group_max(a, 32);
    __syncthreads();  // the previous row's readers are done with red
    if (lane == 0) red[warp] = a;
    __syncthreads();
    a = group_max(lane < WIDE_BLOCK / 32 ? red[lane] : 0.f, 32);
    const float s = scale_of(a);
    const float inv = inverse(s);
    if (threadIdx.x == 0) sx[row] = s;
    int8_t* cr = codes + (size_t)row * Kp;
    for (int c = threadIdx.x; c < nu; c += WIDE_BLOCK)
      store_codes<T, U>(cr + c * U,
                        *reinterpret_cast<const Unit<T, U>*>(xr + c * U),
                        inv);
    for (int c = K + threadIdx.x; c < Kp; c += WIDE_BLOCK) cr[c] = 0;
  }
}

struct Args {
  const void* x;
  int8_t* codes;
  float* sx;
  int M, K;
  cudaStream_t st;
};

template <typename T, int U, int V>
int launch_rows(const Args& a, int G) {
  const int sms = hopper::sm_count();
  const long long warps_needed = ((long long)a.M + 32 / G - 1) / (32 / G);
  // the fewest warps a block (down to one) that still gives every SM two
  // blocks, so that small M spreads over the card
  int tb = 256;
  while (tb > 32 && (warps_needed * 32 + tb - 1) / tb < 2LL * sms) tb >>= 1;
  const long long blocks = (warps_needed * 32 + tb - 1) / tb;
  const long long most = (long long)sms * (2048 / tb);
  quantize_rows_kernel<T, U, V>
      <<<(int)(blocks < most ? blocks : most), tb, 0, a.st>>>(
          (const T*)a.x, a.codes, a.sx, a.M, a.K, padded_k(a.K), G);
  return (int)cudaGetLastError();
}

template <typename T, int U, int V = 1>
int dispatch_v(const Args& a, int G, int v) {
  if constexpr (V > vmax<T, U>()) {
    return (int)cudaErrorInvalidValue;
  } else {
    if (v == V) return launch_rows<T, U, V>(a, G);
    return dispatch_v<T, U, V + 1>(a, G, v);
  }
}

template <typename T, int U>
int launch_u(const Args& a) {
  const int nu = a.K / U;
  if (nu > 32 * vmax<T, U>()) {  // wider than a row in registers
    const int sms = hopper::sm_count();
    quantize_wide_kernel<T, U>
        <<<a.M < sms * 8 ? a.M : sms * 8, WIDE_BLOCK, 0, a.st>>>(
            (const T*)a.x, a.codes, a.sx, a.M, a.K, padded_k(a.K));
    return (int)cudaGetLastError();
  }
  // G lanes a row, V units a lane: the fewest masked slots, then the most
  // lanes (the LayerNorm's rule)
  int best_g = 0, best_v = 0, waste = 1 << 30;
  for (int g = 32; g >= 8; g >>= 1)
    for (int v = 1; v <= vmax<T, U>(); ++v)
      if (g * v >= nu && g * v - nu < waste) {
        waste = g * v - nu;
        best_g = g;
        best_v = v;
      }
  return dispatch_v<T, U>(a, best_g, best_v);
}

// The unit by K: 16 elements (16 code bytes a store) where K allows it,
// else 8, 4 or one; one element where x is not aligned for the unit's
// accesses. The codes rows (Kp a multiple of 32) are always aligned.
template <typename T>
int launch(const Args& a) {
  int u = a.K % 16 == 0 ? 16 : a.K % 8 == 0 ? 8 : a.K % 4 == 0 ? 4 : 1;
  const size_t need = u * sizeof(T) < 16 ? u * sizeof(T) : 16;
  if (reinterpret_cast<uintptr_t>(a.x) % need != 0 ||
      reinterpret_cast<uintptr_t>(a.codes) % 16 != 0)
    u = 1;
  switch (u) {
    case 16: return launch_u<T, 16>(a);
    case 8: return launch_u<T, 8>(a);
    case 4: return launch_u<T, 4>(a);
    default: return launch_u<T, 1>(a);
  }
}

}  // namespace quant

// ---------------------------------------------------------------------------
// int8_matmul: codes[M, Kp] x w[N, Kp] -> out[M, N], f32 or bf16
// ---------------------------------------------------------------------------

namespace mm {

constexpr int BM = 128;       // output rows of a tile: two m64 halves
constexpr int BN = 128;       // output columns of a tile
constexpr int BK = 128;       // codes of K a stage: one 128-byte swizzle row
constexpr int STAGES = 6;
constexpr int CONSUMERS = 2;  // wgmma warpgroups; then the producer's
constexpr int THREADS = (CONSUMERS + 1) * 128;
constexpr int CHUNKS = 4;     // epilogue pieces of a half, 32 columns each
constexpr uint32_t A_BYTES = BM * BK, B_BYTES = BN * BK;
constexpr uint32_t STAGE_BYTES = A_BYTES + B_BYTES;
// an epilogue chunk of one warpgroup, staged for its TMA store: 64 rows x
// 32 columns (128-byte rows in f32, 64-byte rows in bf16); two a
// warpgroup, so that one fills while the other's store reads it
constexpr uint32_t CHUNK_BYTES = 64 * 32 * 4;
// the ring, the staging buffers, then the full and empty barriers of the
// ring and the two warpgroups' turn barriers; 1,024 bytes of slack to
// align the ring to the swizzle's 1,024-byte atoms
constexpr int SMEM = STAGES * STAGE_BYTES + CONSUMERS * 2 * CHUNK_BYTES +
                     (2 * STAGES + CONSUMERS) * 8 + 1024;

#define I8_R8(i)                                                        \
  "+r"(d[i]), "+r"(d[i + 1]), "+r"(d[i + 2]), "+r"(d[i + 3]),           \
      "+r"(d[i + 4]), "+r"(d[i + 5]), "+r"(d[i + 6]), "+r"(d[i + 7])

// d (+)= a @ b^T over one k32 step on the int8 tensor cores: A 64 x 32
// codes and B 128 x 32 codes, K-major in shared memory (descriptors), s32
// accumulators, 64 a thread; scale_d = 0 overwrites d (a tile's first
// step).
__device__ __forceinline__ void wgmma_s8(int (&d)[BN / 2], uint64_t a,
                                         uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : I8_R8(0), I8_R8(8), I8_R8(16), I8_R8(24), I8_R8(32), I8_R8(40),
        I8_R8(48), I8_R8(56)
      : "l"(a), "l"(b), "r"(scale_d));
}

#undef I8_R8

// What the epilogue of one tile needs besides its accumulators: the
// tile's first row and column, this thread's row m in the upper half
// (rows m, m + 8 of each half are its), sx of its four rows, and sw and the
// bias of columns n0 + 32 c + lane (the other lanes' are fetched by
// shuffles).
struct Epi {
  int row0, n0, m;
  float sx[4], wv[CHUNKS], bv[CHUNKS];  // sx: rows m, m + 8, m + 64, m + 72
};

__device__ __forceinline__ float bias_at(const float* b, int n) {
  return b[n];
}
__device__ __forceinline__ float bias_at(const __nv_bfloat16* b, int n) {
  return __bfloat162float(b[n]);
}

// This thread's row within a 64-row half: 16 w + t / 4 (and + 8).
__device__ __forceinline__ int half_row() {
  return ((threadIdx.x >> 5) & 3) * 16 + ((threadIdx.x & 31) >> 2);
}

// Issued before a tile's products, so that the loads' latency hides
// behind them.
template <typename Tout>
__device__ __forceinline__ Epi gather(int row0, int n0, int M, int N,
                                      const float* __restrict__ sx,
                                      const float* __restrict__ sw,
                                      const Tout* __restrict__ bias) {
  Epi e;
  e.row0 = row0;
  e.n0 = n0;
  e.m = row0 + half_row();
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = e.m + (i & 1) * 8 + (i >> 1) * 64;
    e.sx[i] = m < M ? sx[m] : 0.f;
  }
#pragma unroll
  for (int c = 0; c < CHUNKS; ++c) {
    const int n = n0 + 32 * c + (threadIdx.x & 31);
    e.wv[c] = n < N ? sw[n] : 0.f;
    e.bv[c] = bias != nullptr && n < N ? bias_at(bias, n) : 0.f;
  }
  return e;
}

__device__ __forceinline__ float scaled(int acc, float a, float b) {
  return __fmul_rn(__fmul_rn(__int2float_rn(acc), a), b);
}

// Form (b) on a pair of outputs: r(r(p) + b), r rounding to the output
// type, b the bias as stored (in the output type, so exact as a float);
// for f32 r is the identity and the add one f32 rounding. Without a
// bias, r(p). Branch-free, so that a chunk's pairs interleave.
__device__ __forceinline__ float2 finish(float p0, float p1, float b0,
                                         float b1, bool has_b, const float*) {
  return make_float2(has_b ? __fadd_rn(p0, b0) : p0,
                     has_b ? __fadd_rn(p1, b1) : p1);
}
__device__ __forceinline__ __nv_bfloat162 finish(float p0, float p1,
                                                 float b0, float b1,
                                                 bool has_b,
                                                 const __nv_bfloat16*) {
  const __nv_bfloat162 r = __floats2bfloat162_rn(p0, p1);
  const float2 f = __bfloat1622float2(r);
  const __nv_bfloat162 rb =
      __floats2bfloat162_rn(__fadd_rn(f.x, b0), __fadd_rn(f.y, b1));
  return has_b ? rb : r;
}

// Form (c)'s activation, as PyTorch's CUDA F.gelu computes it (ATen's
// GeluCUDAKernelImpl, in f32 for bf16 and f32 alike), so that the result
// is F.gelu's bit for bit: the exact form x * 0.5 * (1 + erf(x / sqrt 2)),
// or with approximate="tanh" 0.5 * x * (1 + tanh(sqrt(2 / pi) * (x +
// 0.044715 x^3))). The constants are ATen's: double expressions narrowed
// to f32 once.
constexpr int GELU_ERF = 1, GELU_TANH = 2;  // ACT; 0: no activation

template <int ACT>
__device__ __forceinline__ float gelu(float x) {
  if constexpr (ACT == GELU_ERF) {
    constexpr float kAlpha = 0.70710678118654752440;  // M_SQRT1_2
    return __fmul_rn(__fmul_rn(x, 0.5f),
                     __fadd_rn(1.f, erff(__fmul_rn(x, kAlpha))));
  } else {
    // M_SQRT2 * M_2_SQRTPI * 0.5
    constexpr float kBeta =
        1.41421356237309504880 * 1.12837916709551257390 * 0.5;
    constexpr float kKappa = 0.044715;
    const float x_cube = x * x * x;
    const float inner = kBeta * (x + kKappa * x_cube);
    return 0.5f * x * (1.f + tanhf(inner));
  }
}

// GELU of a finished pair, rounded to the output type as F.gelu rounds it
// (bf16: its input is the stored bf16 value)
template <int ACT>
__device__ __forceinline__ float2 activate(float2 v) {
  return make_float2(gelu<ACT>(v.x), gelu<ACT>(v.y));
}
template <int ACT>
__device__ __forceinline__ __nv_bfloat162 activate(__nv_bfloat162 v) {
  const float2 f = __bfloat1622float2(v);
  return __floats2bfloat162_rn(gelu<ACT>(f.x), gelu<ACT>(f.y));
}

// out[m, n] and out[m, n + 1] (n even, n < N), masked at the M and N
// edges: one store of the pair when N is even (n + 1 < N then).
__device__ __forceinline__ void store2(float* __restrict__ out, int M, int N,
                                       int m, int n, float2 v) {
  if (m >= M) return;
  float* o = out + (size_t)m * N + n;
  if ((N & 1) == 0) {
    *reinterpret_cast<float2*>(o) = v;
  } else {
    o[0] = v.x;
    if (n + 1 < N) o[1] = v.y;
  }
}
__device__ __forceinline__ void store2(__nv_bfloat16* __restrict__ out,
                                       int M, int N, int m, int n,
                                       __nv_bfloat162 v) {
  if (m >= M) return;
  __nv_bfloat16* o = out + (size_t)m * N + n;
  if ((N & 1) == 0) {
    *reinterpret_cast<__nv_bfloat162*>(o) = v;
  } else {
    o[0] = v.x;
    if (n + 1 < N) o[1] = v.y;
  }
}

// Where the epilogue goes. With a tensor map (the output's row stride a
// multiple of 16 bytes) each warpgroup stages a chunk in shared memory, in
// the map's swizzle, and one thread stores it by TMA; otherwise every
// thread stores its pairs.
template <typename Tout>
struct Sink {
  Tout* out;
  const Tout* bias;
  int M, N;
  const CUtensorMap* map;  // null: direct stores
  uint8_t* stage;          // this warpgroup's two staging buffers
  int bar;                 // this warpgroup's named barrier
  uint32_t q;              // chunks staged so far
};

// Byte offset of (row r, column c) in a staging buffer: 128-byte rows
// under the 128-byte swizzle (f32) or 64-byte rows under the 64-byte one
// (bf16), as TMA reads them; both keep the pair stores free of bank
// conflicts.
template <typename Tout>
__device__ __forceinline__ uint32_t staged(int r, int c) {
  const uint32_t b = c * sizeof(Tout);
  if (sizeof(Tout) == 4)
    return r * 128 + (((b >> 4) ^ (r & 7)) << 4) + (b & 15);
  return r * 64 + (((b >> 4) ^ ((r >> 1) & 3)) << 4) + (b & 15);
}

// Columns 32 C .. 32 C + 31 of half H of a finished tile: thread t of
// warp w holds (rows 16 w + t / 4 and + 8 of the half, columns 8 j + 2 (t
// % 4) and + 1) in acc[4 j .. 4 j + 3], the f32 layout of the bf16
// m64nNk16.
template <int H, int C, int ACT, typename Tout>
__device__ __forceinline__ void store_chunk(const int (&acc)[BN / 2],
                                            const Epi& e, Sink<Tout>& o) {
  using Pair = decltype(finish(0.f, 0.f, 0.f, 0.f, false, o.out));
  const int lane = threadIdx.x & 31;
  const bool has_b = o.bias != nullptr;
  Pair lo[4], hi[4];  // rows m and m + 8, columns 8 j + 2 (t % 4) and + 1
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int j = 4 * C + jj;
    const int src = 8 * jj + 2 * (lane & 3);  // the lanes holding them
    const float w0 = __shfl_sync(~0u, e.wv[C], src);
    const float w1 = __shfl_sync(~0u, e.wv[C], src + 1);
    const float b0 = __shfl_sync(~0u, e.bv[C], src);
    const float b1 = __shfl_sync(~0u, e.bv[C], src + 1);
    const float sa = e.sx[2 * H], sb = e.sx[2 * H + 1];
    lo[jj] = finish(scaled(acc[4 * j], sa, w0), scaled(acc[4 * j + 1], sa, w1),
                    b0, b1, has_b, o.out);
    hi[jj] = finish(scaled(acc[4 * j + 2], sb, w0),
                    scaled(acc[4 * j + 3], sb, w1), b0, b1, has_b, o.out);
    if constexpr (ACT != 0) {
      lo[jj] = activate<ACT>(lo[jj]);
      hi[jj] = activate<ACT>(hi[jj]);
    }
  }
  if (o.map == nullptr) {
#pragma unroll
    for (int jj = 0; jj < 4; ++jj) {
      const int n = e.n0 + 32 * C + 8 * jj + 2 * (lane & 3);
      if (n < o.N) {
        store2(o.out, o.M, o.N, e.m + 64 * H, n, lo[jj]);
        store2(o.out, o.M, o.N, e.m + 64 * H + 8, n, hi[jj]);
      }
    }
    return;
  }
  const bool lead = (threadIdx.x & 127) == 0;
  const int r = half_row();
  uint8_t* buf = o.stage + (o.q & 1) * CHUNK_BYTES;
  // the store that last read this buffer (two chunks ago) is done
  if (lead) hopper::bulk_wait_read<1>();
  hopper::named_bar_sync(o.bar, 128);
#pragma unroll
  for (int jj = 0; jj < 4; ++jj) {
    const int c = 8 * jj + 2 * (lane & 3);
    *reinterpret_cast<Pair*>(buf + staged<Tout>(r, c)) = lo[jj];
    *reinterpret_cast<Pair*>(buf + staged<Tout>(r + 8, c)) = hi[jj];
  }
  hopper::fence_proxy_async();
  hopper::named_bar_sync(o.bar, 128);
  if (lead) {
    hopper::tma_store_2d(o.map, buf, e.n0 + 32 * C, e.row0 + 64 * H);
    hopper::bulk_commit();
  }
  ++o.q;
}

// The whole epilogue of a tile: both halves, chunk by chunk.
template <int ACT, typename Tout>
__device__ __forceinline__ void store_tile(const int (&acc)[2][BN / 2],
                                           const Epi& e, Sink<Tout>& o) {
  store_chunk<0, 0, ACT>(acc[0], e, o);
  store_chunk<0, 1, ACT>(acc[0], e, o);
  store_chunk<0, 2, ACT>(acc[0], e, o);
  store_chunk<0, 3, ACT>(acc[0], e, o);
  store_chunk<1, 0, ACT>(acc[1], e, o);
  store_chunk<1, 1, ACT>(acc[1], e, o);
  store_chunk<1, 2, ACT>(acc[1], e, o);
  store_chunk<1, 3, ACT>(acc[1], e, o);
}

// Tout = float: form (a) when bias is null, else form (b) in f32;
// Tout = __nv_bfloat16: form (b). ACT = GELU_ERF or GELU_TANH: form (c),
// GELU after form (b). The roles and the ring are the file header's.
template <typename Tout, int ACT>
__global__ void __launch_bounds__(THREADS, 1)
    int8_matmul_kernel(const __grid_constant__ CUtensorMap map_a,
                       const __grid_constant__ CUtensorMap map_b,
                       const __grid_constant__ CUtensorMap map_out,
                       bool tma_out, const float* __restrict__ sx,
                       const float* __restrict__ sw,
                       const Tout* __restrict__ bias, Tout* __restrict__ out,
                       int M, int Kp, int N) {
  extern __shared__ unsigned char smem_raw[];
  uint8_t* ring = reinterpret_cast<uint8_t*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  uint8_t* staging = ring + STAGES * STAGE_BYTES;
  uint64_t* full =
      reinterpret_cast<uint64_t*>(staging + CONSUMERS * 2 * CHUNK_BYTES);
  uint64_t* empty = full + STAGES;
  uint64_t* turn = empty + STAGES;  // turn[w]: warpgroup w issued a tile
  const int tiles_n = (N + BN - 1) / BN;
  const int tiles = (M + BM - 1) / BM * tiles_n;
  const int steps = (Kp + BK - 1) / BK;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      hopper::mbar_init<1>(&full[s]);
      hopper::mbar_init<128>(&empty[s]);
    }
    for (int w = 0; w < CONSUMERS; ++w) hopper::mbar_init<128>(&turn[w]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= CONSUMERS * 128) {
    // producer: one thread keeps the ring full
    hopper::setmaxnreg_dec<40>();
    if (threadIdx.x == CONSUMERS * 128) {
      int s = 0;
      uint32_t phase = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / tiles_n * BM, n0 = tile % tiles_n * BN;
        for (int k = 0; k < steps; ++k) {
          hopper::mbar_wait(&empty[s], phase ^ 1);  // the first pass: free
          hopper::mbar_expect(&full[s], STAGE_BYTES);
          uint8_t* st = ring + s * STAGE_BYTES;
          hopper::tma_2d(st, &map_a, k * BK, m0, &full[s]);
          hopper::tma_2d(st + A_BYTES, &map_b, k * BK, n0, &full[s]);
          if (++s == STAGES) {
            s = 0;
            phase ^= 1;
          }
        }
      }
    }
  } else {
    // consumers, in ping-pong: warpgroup wg takes the block's tiles i = wg,
    // wg + 2, ... whole (rows 0-63 and 64-127 as two accumulators), and
    // starts a tile's products only once the other warpgroup has issued
    // those of tile i - 1; so one warpgroup's epilogue runs beside the
    // other's products. That order also keeps a warpgroup's wait on a
    // stage's full barrier from matching an earlier phase: every use of
    // the ring before its own has been loaded and consumed by then.
    hopper::setmaxnreg_inc<232>();
    const int wg = threadIdx.x >> 7;
    Sink<Tout> o{out, bias, M, N, tma_out ? &map_out : nullptr,
                 staging + wg * 2 * CHUNK_BYTES, 1 + wg, 0};
    int acc[2][BN / 2];
    for (int i = wg;; i += CONSUMERS) {
      const int tile = blockIdx.x + i * gridDim.x;
      if (tile >= tiles) break;
      const Epi e = gather(tile / tiles_n * BM, tile % tiles_n * BN, M, N,
                           sx, sw, bias);
      if (i > 0) hopper::mbar_wait(&turn[wg ^ 1], ((i - 1) >> 1) & 1);
      int held = 0;
      for (int k = 0; k < steps; ++k) {
        const int g = i * steps + k;  // the block's K step: its stage
        const int s = g % STAGES;
        hopper::mbar_wait(&full[s], (g / STAGES) & 1);
        const uint8_t* st = ring + s * STAGE_BYTES;
        hopper::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < BK / 32; ++kk) {
          const uint64_t b = hopper::desc_sw128(st + A_BYTES + kk * 32);
#pragma unroll
          for (int h = 0; h < 2; ++h)
            wgmma_s8(acc[h], hopper::desc_sw128(st + h * 64 * BK + kk * 32),
                     b, k > 0 || kk > 0);
        }
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();  // the previous stage's group retired
        if (k > 0) hopper::mbar_arrive(&empty[held]);
        held = s;
      }
      hopper::mbar_arrive(&turn[wg]);  // the other warpgroup may go on
      hopper::wgmma_wait<0>();
      hopper::mbar_arrive(&empty[held]);
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) hopper::fence_operand(acc[h][j]);
      store_tile<ACT>(acc, e, o);
    }
    if (o.map != nullptr && (threadIdx.x & 127) == 0) hopper::bulk_wait<0>();
  }
}

// The ring and the staging buffers (224 KB) are above the 48 KB default:
// the limit is raised once per instance. Every tensor map goes through
// encode_map's cache: the weight's is encoded once, the activation codes'
// and the output's once per address the caching allocator hands out. The
// output is stored by TMA when its row stride is a multiple of 16 bytes.
template <typename Tout, int ACT>
int launch(const void* codes, const void* w, const void* sx, const void* sw,
           const void* bias, void* out, int M, int Kp, int N,
           cudaStream_t stream) {
  static const cudaError_t attr = cudaFuncSetAttribute(
      int8_matmul_kernel<Tout, ACT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (attr != cudaSuccess) return (int)attr;
  constexpr bool f32 = sizeof(Tout) == 4;
  const bool tma_out = (size_t)N * sizeof(Tout) % 16 == 0;
  CUtensorMap map_a, map_b, map_out;
  memset(&map_out, 0, sizeof(map_out));
  if (!hopper::encode_map(&map_a, CU_TENSOR_MAP_DATA_TYPE_UINT8, codes, Kp,
                          M, Kp, BK, BM, CU_TENSOR_MAP_SWIZZLE_128B) ||
      !hopper::encode_map(&map_b, CU_TENSOR_MAP_DATA_TYPE_UINT8, w, Kp, N,
                          Kp, BK, BN, CU_TENSOR_MAP_SWIZZLE_128B) ||
      (tma_out &&
       !hopper::encode_map(
           &map_out,
           f32 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
               : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
           out, N, M, (uint64_t)N * sizeof(Tout), 32, 64,
           f32 ? CU_TENSOR_MAP_SWIZZLE_128B : CU_TENSOR_MAP_SWIZZLE_64B)))
    return (int)cudaErrorInvalidValue;
  const long long tiles =
      (long long)((M + BM - 1) / BM) * ((N + BN - 1) / BN);
  const int grid = (int)(tiles < hopper::sm_count() ? tiles
                                                    : hopper::sm_count());
  int8_matmul_kernel<Tout, ACT><<<grid, THREADS, SMEM, stream>>>(
      map_a, map_b, map_out, tma_out, (const float*)sx, (const float*)sw,
      (const Tout*)bias, (Tout*)out, M, Kp, N);
  return (int)cudaGetLastError();
}

}  // namespace mm

}  // namespace

extern "C" int quantize_rows_i8_f32(const void* x, void* codes, void* sx,
                                    int M, int K, void* stream) {
  if (M <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  return quant::launch<float>(
      {x, (int8_t*)codes, (float*)sx, M, K, (cudaStream_t)stream});
}

extern "C" int quantize_rows_i8_bf16(const void* x, void* codes, void* sx,
                                     int M, int K, void* stream) {
  if (M <= 0 || K <= 0) return (int)cudaErrorInvalidValue;
  return quant::launch<__nv_bfloat16>(
      {x, (int8_t*)codes, (float*)sx, M, K, (cudaStream_t)stream});
}

extern "C" int int8_matmul(const void* codes, const void* w, const void* sx,
                           const void* sw, const void* bias, void* out, int M,
                           int Kp, int N, int bf16_out, void* stream) {
  if (M <= 0 || N <= 0 || Kp <= 0 || Kp % KP_ALIGN != 0)
    return (int)cudaErrorInvalidValue;
  return (bf16_out ? mm::launch<__nv_bfloat16, 0> : mm::launch<float, 0>)(
      codes, w, sx, sw, bias, out, M, Kp, N, (cudaStream_t)stream);
}

// Form (c): form (b), then GELU (tanh_approx: the tanh form), stored in
// the output type.
extern "C" int int8_matmul_gelu(const void* codes, const void* w,
                                const void* sx, const void* sw,
                                const void* bias, void* out, int M, int Kp,
                                int N, int bf16_out, int tanh_approx,
                                void* stream) {
  if (M <= 0 || N <= 0 || Kp <= 0 || Kp % KP_ALIGN != 0)
    return (int)cudaErrorInvalidValue;
  const cudaStream_t st = (cudaStream_t)stream;
  if (tanh_approx)
    return (bf16_out ? mm::launch<__nv_bfloat16, mm::GELU_TANH>
                     : mm::launch<float, mm::GELU_TANH>)(
        codes, w, sx, sw, bias, out, M, Kp, N, st);
  return (bf16_out ? mm::launch<__nv_bfloat16, mm::GELU_ERF>
                   : mm::launch<float, mm::GELU_ERF>)(
      codes, w, sx, sw, bias, out, M, Kp, N, st);
}
