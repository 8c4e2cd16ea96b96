// Fused Q4 dequantize + matmul for Hopper (sm_90a): out[M,N] (f32) =
// x[M,K] @ dequant(W)[K,N], with W in the group-local layout of
// bert_tpu_torch/quant.py: packed[K/2,N] uint8, where packed row 32g+r holds
// logical row 64g+r in its low nibble and row 64g+32+r in its high nibble;
// scales[K/32,N] f32 and, for Q4_1, mins[K/32,N] f32.
//
// Replaces: bert_tpu/ops/q4_matmul.py::_q4_matmul_kernel (launched by
// _q4_matmul_pallas, routed by q4_matmul). Same arithmetic: each weight is
// dequantized in f32 ((c-8)*s for Q4_0, c*s+m for Q4_1, with __fmul_rn /
// __fadd_rn so no FMA contraction changes the rounding) and multiplied
// with x accumulating in f32. A bf16 x meets the weight rounded once to
// bf16. An f32 x meets the f32 weight at the Pallas kernel's
// Precision.HIGHEST (bert_tpu/ops/common.py:14-25), which the TPU's matrix
// unit runs as six bf16 products; so does this kernel (below). W never
// reaches device memory in dense form.
//
// What bounds it on the H100: at the main path's shapes almost nothing.
// At M=1024, K=384, N=1152 (MiniLM QKV) it must move 5.8 MB (x 0.8 MB in
// bf16, packed W 0.2 MB, scales 0.06 MB, the f32 output 4.7 MB) and do
// 0.9 GFLOP: 1.7 us at 3.35 TB/s against 0.9 us at 989 TFLOP/s, so the
// bound is bytes, and mostly the f32 output the contract asks for. At
// 0.9 GFLOP a call is a few microseconds of work spread over 132 SMs, so
// latency (of the loads, of each K step) and how many SMs get a tile
// decide its time more than the tensor cores' peak rate does.
//
// The pipeline, both instances. Each 128-thread block (2x2 warps) owns a
// BM x 64 output tile, BM = 64 or 32, and walks K one 64-row group at a
// time through rings in shared memory: the x tile, and the group's band
// of 32 packed rows with its 2 scale (and 2 min) rows. The block
// dequantizes a band into a bf16 W tile in shared memory (each thread 4
// columns x 4 packed rows, so a scale is read once per 8 weights), and
// each warp runs mma.sync.m16n8k16 (bf16 -> f32) over the group's four
// 16-deep steps, with B from the W tile by ldmatrix.trans. bf16: 3-slot
// rings and two W tiles make it a software pipeline: while the warps
// multiply group g they dequantize group g+1 into the other tile, with
// the copies of x for g+2 and of the band for g+3 in flight, so there is
// one barrier per group. f32 (whose tiles are larger, below): 2-slot
// rings and one W tile, a second barrier before the tile is refilled,
// and three blocks on an SM to overlap one block's dequantizing with
// another's products.
// Copies: where N's row stride is a multiple of 16 bytes (every Q4 weight
// of a model, whose N is a multiple of 64), one thread issues each group's
// copies as TMA tile loads (cp.async.bulk.tensor) that complete on an
// mbarrier per ring slot; the hardware zero-fills the ragged M and N
// edges. Else every thread issues cp.async copies (the band's 4 or 1 byte
// wide, as N allows; the wrapper checks each pointer's alignment for it).
// In diagnostic builds on the H100 the per-thread cp.async copies had
// cost more time per group than the products; TMA takes most of it away
// (chip_smoke.py's times before and after are in PERF.md).
// mma.sync and not wgmma: a 64-row group gives a block only 4 k16 steps
// between copies, and at these sizes the grid and the per-group latency,
// not the issue rate of the tensor cores, set the time. BM is 64 when that
// gives at least one tile per SM, else 32, which doubles the blocks of the
// small shapes (M=512, N=384: 48 -> 96 blocks). No split-K: every output
// is summed by one thread in a fixed order, so a call is deterministic.
// Ragged M and N edges are masked on store; K must be a multiple of 64.
//
// The bf16 instance: the x tile is bf16 (no widening), A comes from it by
// ldmatrix, one product a step.
//
// The f32 instance: the six-product split on the same tensor cores (not
// TF32, which keeps 10 bits and stays off package-wide). Each operand is
// split into three bf16 parts, hi = bf16(v), mid = bf16(v - hi), lo =
// bf16(v - hi - mid), whose sum is v exactly; the six cross products whose
// order is at least 2^-16 of hi*hi (lo*hi, mid*mid, hi*lo, mid*hi, hi*mid,
// hi*hi, in that order, smallest first) are summed in f32. Each bf16
// product is exact in f32, but the tensor cores' f32 sums truncate (round
// toward zero), and a chain of 6*K/16 products into one accumulator loses
// up to an ulp of the running sum at each, in one direction: so each
// 64-row group's 24 products go into a fresh accumulator, added to the
// running sum in IEEE f32 (__fadd_rn), which keeps the result about as
// close to an f64 product as cuBLAS f32 (at most 2.3x its distance at the
// main path's shapes; chip_smoke.py logs both, PERF.md).
// The bound is max(bytes / 3.35 TB/s, 6*2*M*N*K / 989 TFLOP/s)
// (QKV at M=1024: 6.57 MB, 0.0055 ms), against 2*M*N*K / 67 TFLOP/s =
// 0.0135 ms for f32 on the CUDA cores. The x tile arrives in f32 as two
// 32-column halves in TMA's 128-byte swizzle (cp.async writes the same
// layout); each warp reads its A fragments as 16-byte float4s and splits
// them in registers. A float4 feeds mma slots 2t, 2t+1, 2t+8, 2t+9 of
// lane t, and step s of a half reads chunks 2t+s, so the k order inside a
// group is permuted: logical row 32h + 8t + 4s + 2u + j of the group sits
// in slot 8u + 2t + j of step 2h+s (slot_row), where the dequantize pass
// writes it, so A and B still meet on the same k, and each quarter-warp's
// loads hit 32 distinct banks. The weight is dequantized in f32 exactly as
// above and split into three bf16 W tiles (rows of 128 bytes, 16-byte
// chunks XOR-swizzled by the row, so ldmatrix.trans and the dequantize
// stores are conflict-free). A block takes 64 KB of shared memory at
// BM=64 and, capped by __launch_bounds__, 166 registers a thread, so
// three fit an SM: at M=1024 the QKV and FFN-up grids (288 and 384 tiles)
// then run in one wave, where two a SM (107 KB: 3-slot rings, two W
// tiles) took two, and longer, in a diagnostic build on the H100.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include <type_traits>

#include "hopper.cuh"
#include "hopper_tma.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int QK = 32;        // quantization block
constexpr int BK = 64;        // one group-local group of K rows
constexpr int BN = 64;        // output columns per block
constexpr int THREADS = 128;  // 2 x 2 warps
constexpr int WS = BN + 8;    // bf16 W tile row: 144 bytes

// T = float: the f32 instance (six products of split operands)
template <class T>
constexpr bool kF32 = std::is_same<T, float>::value;
template <class T>
constexpr int kParts = kF32<T> ? 3 : 1;  // bf16 W tiles per group
template <class T>
constexpr int kWRow = kF32<T> ? BN : WS;  // W tile row, elements
// Ring slots and W tiles: the f32 instance takes 2 and 1 (64 KB at
// BM = 64, so three blocks fit an SM), the bf16 instance 3 and 2.
template <class T>
constexpr int kStages = kF32<T> ? 2 : 3;
template <class T>
constexpr int kWBuf = kF32<T> ? 1 : 2;

// bf16 x tile rows: TMA writes them dense, 128 bytes, in its 128-byte
// swizzle (16-byte chunk j of row r at chunk j ^ (r % 8)); cp.async writes
// them padded to 144 bytes. Either way ldmatrix's eight row addresses hit
// distinct banks.
template <bool TMA>
__device__ __forceinline__ int x_col(int r, int chunk) {
  return TMA ? (chunk ^ (r & 7)) * 8 : chunk * 8;
}

// f32 x tile: float offset of 16-byte chunk c (0-7) of row r in a
// 32-column half, in TMA's 128-byte swizzle (both copy paths write it so)
__device__ __forceinline__ int xf_off(int r, int c) {
  return r * 32 + ((c ^ (r & 7)) << 2);
}

// W tile element (row, col): bf16 rows padded to 144 bytes; f32 instance's
// parts in 128-byte rows with 16-byte chunks XOR-swizzled by the row
template <class T>
__device__ __forceinline__ int w_idx(int row, int col) {
  if constexpr (kF32<T>)
    return row * BN + ((((col >> 3) ^ (row & 7))) << 3) + (col & 7);
  else
    return row * WS + col;
}

// f32 instance: the W tile row of logical row lr (0-63) of a group
// (32h + 8t + 4s + 2u + j -> slot 8u + 2t + j of k16 step 2h + s)
__device__ __forceinline__ int slot_row(int lr) {
  const int q = lr & 31;
  return ((lr >> 5) * 2 + ((q >> 2) & 1)) * 16 + ((q >> 1) & 1) * 8 +
         (q >> 3) * 2 + (q & 1);
}

template <class T, int MT, bool TMA>  // m16 tiles per warp; BM = 32 * MT
struct Smem {
  static constexpr int BM = 32 * MT;
  using XTile = std::conditional_t<kF32<T>, float[2][BM][32],
                                   bf16[BM][TMA ? BK : BK + 8]>;
  static constexpr int STAGES = kStages<T>;
  alignas(1024) XTile x[STAGES];
  alignas(128) uint8_t band[STAGES][QK][BN];
  alignas(128) float sc[STAGES][2][BN];
  alignas(128) float mn[STAGES][2][BN];
  alignas(128) bf16 w[kWBuf<T>][kParts<T>][BK * kWRow<T>];
  uint64_t bar[STAGES];
};

struct Maps {  // TMA descriptors of x, the packed band, scales and mins
  CUtensorMap x, band, sc, mn;
};

// Issue load group j: x of group j and the band of group j+1 (and, for
// j = 0, the band of group 0), into their ring slots; TMA completes on
// barrier j % STAGES, cp.async on the commit group.
template <class T, int MT, bool TMA>
__device__ __forceinline__ void load_group(
    Smem<T, MT, TMA>& s, const Maps& maps, int j, int groups,
    const T* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scales, const float* __restrict__ mins, int M,
    int K, int N, int m0, int n0) {
  constexpr int BM = 32 * MT, STAGES = kStages<T>;
  const int tid = threadIdx.x;
  const int b0 = j == 0 ? 0 : j + 1, b1 = j + 1;  // bands of this group
  if (TMA) {
    if (tid != 0 || j >= groups) return;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t band_bytes = QK * BN + (mins ? 4 : 2) * BN * 4;
    uint32_t bytes = BM * BK * sizeof(T);
    for (int b = b0; b <= b1; ++b)
      if (b < groups) bytes += band_bytes;
    uint64_t* bar = &s.bar[j % STAGES];
    hopper::mbar_expect(bar, bytes);
    if constexpr (kF32<T>) {  // two 32-column halves of 128-byte rows
      hopper::tma_2d(&s.x[j % STAGES][0][0][0], &maps.x, j * BK, m0, bar);
      hopper::tma_2d(&s.x[j % STAGES][1][0][0], &maps.x, j * BK + 32, m0,
                     bar);
    } else {
      hopper::tma_2d(&s.x[j % STAGES][0][0], &maps.x, j * BK, m0, bar);
    }
    for (int b = b0; b <= b1; ++b) {
      if (b >= groups) continue;
      const int st = b % STAGES;
      hopper::tma_2d(&s.band[st][0][0], &maps.band, n0, b * QK, bar);
      hopper::tma_2d(&s.sc[st][0][0], &maps.sc, n0, 2 * b, bar);
      if (mins) hopper::tma_2d(&s.mn[st][0][0], &maps.mn, n0, 2 * b, bar);
    }
    return;
  }
  if (j < groups) {
    const int st = j % STAGES;
    constexpr int CH = BK * sizeof(T) / 16;  // 16-byte chunks of a row
    for (int i = tid; i < BM * CH; i += THREADS) {
      const int r = i / CH, c = i % CH;
      const bool ok = m0 + r < M;
      const T* src = x + (size_t)(ok ? m0 + r : 0) * K + j * BK +
                     c * (16 / sizeof(T));
      if constexpr (kF32<T>)
        hopper::cp_async16(&s.x[st][c >> 3][0][0] + xf_off(r, c & 7), src,
                           ok);
      else
        hopper::cp_async16(&s.x[st][r][x_col<TMA>(r, c)], src, ok);
    }
  }
  for (int g = b0; g <= b1; ++g) {
    if (g >= groups) continue;
    const int st = g % STAGES;
    const uint8_t* band = packed + (size_t)g * QK * N;
    if ((N & 3) == 0) {  // N % 16 == 0 takes the TMA instance
      for (int i = tid; i < QK * (BN / 4); i += THREADS) {
        const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
        const bool ok = n0 + c < N;
        hopper::cp_async4(&s.band[st][r][c],
                          band + (size_t)r * N + (ok ? n0 + c : 0), ok);
      }
    } else {
      for (int i = tid; i < QK * BN; i += THREADS) {
        const int r = i / BN, c = i % BN;
        s.band[st][r][c] = n0 + c < N ? band[(size_t)r * N + n0 + c] : 0;
      }
    }
    const size_t srow = (size_t)2 * g * N;
    if ((N & 3) == 0) {
      for (int i = tid; i < 2 * (BN / 4); i += THREADS) {
        const int r = i / (BN / 4), c = (i % (BN / 4)) * 4;
        const bool ok = n0 + c < N;
        const size_t off = srow + (size_t)r * N + (ok ? n0 + c : 0);
        hopper::cp_async16(&s.sc[st][r][c], scales + off, ok);
        if (mins) hopper::cp_async16(&s.mn[st][r][c], mins + off, ok);
      }
    } else {
      for (int i = tid; i < 2 * BN; i += THREADS) {
        const int r = i / BN, c = i % BN;
        const bool ok = n0 + c < N;
        const size_t off = srow + (size_t)r * N + (ok ? n0 + c : 0);
        hopper::cp_async4(&s.sc[st][r][c], scales + off, ok);
        if (mins) hopper::cp_async4(&s.mn[st][r][c], mins + off, ok);
      }
    }
  }
  hopper::cp_async_commit();
}

// Wait until load group g has landed, for this thread (the caller's
// __syncthreads makes it so for all).
template <class T, int MT, bool TMA>
__device__ __forceinline__ void wait_group(Smem<T, MT, TMA>& s, int g) {
  constexpr int STAGES = kStages<T>;
  if (TMA)
    hopper::mbar_wait(&s.bar[g % STAGES], (g / STAGES) & 1);
  else
    hopper::cp_async_wait<STAGES - 2>();
}

// Four f32 weights (columns c..c+3 of logical row lr) into W tile wb: one
// bf16 rounding each (bf16), or three bf16 parts at row slot_row(lr)
// (f32).
template <class T, class S>
__device__ __forceinline__ void store_w(S& s, int wb, int lr, int c,
                                       const float (&v)[4]) {
  if constexpr (kF32<T>) {
    uint32_t p0[3], p1[3];
    hopper::split_bf16x3(v[0], v[1], p0);
    hopper::split_bf16x3(v[2], v[3], p1);
    const int at = w_idx<T>(slot_row(lr), c);
#pragma unroll
    for (int p = 0; p < 3; ++p)
      *reinterpret_cast<uint2*>(&s.w[wb][p][at]) = make_uint2(p0[p], p1[p]);
  } else {
    *reinterpret_cast<uint2*>(&s.w[wb][0][w_idx<T>(lr, c)]) =
        make_uint2(hopper::pack_bf16(v[0], v[1]),
                   hopper::pack_bf16(v[2], v[3]));
  }
}

// Band of slot st -> W tile wb: thread owns columns c..c+3 of packed rows
// r, r+8, r+16, r+24 (a warp reads two whole 64-byte rows per load,
// conflict-free); packed row r gives W rows r (low nibble) and r+32 (high).
template <class T, class S>
__device__ __forceinline__ void dequantize(S& s, int st, int wb, bool q4_1) {
  const int tid = threadIdx.x;
  const int c = (tid & 15) * 4;
  const float4 s0 = *reinterpret_cast<const float4*>(&s.sc[st][0][c]);
  const float4 s1 = *reinterpret_cast<const float4*>(&s.sc[st][1][c]);
  const float sl[4] = {s0.x, s0.y, s0.z, s0.w};
  const float sh[4] = {s1.x, s1.y, s1.z, s1.w};
  float ml[4] = {0.f, 0.f, 0.f, 0.f}, mh[4] = {0.f, 0.f, 0.f, 0.f};
  if (q4_1) {
    const float4 m0 = *reinterpret_cast<const float4*>(&s.mn[st][0][c]);
    const float4 m1 = *reinterpret_cast<const float4*>(&s.mn[st][1][c]);
    ml[0] = m0.x; ml[1] = m0.y; ml[2] = m0.z; ml[3] = m0.w;
    mh[0] = m1.x; mh[1] = m1.y; mh[2] = m1.z; mh[3] = m1.w;
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = (tid >> 4) + 8 * j;
    const uint32_t word =
        *reinterpret_cast<const uint32_t*>(&s.band[st][r][c]);
    float lo[4], hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = (word >> (8 * i)) & 0xFF;
      if (q4_1) {  // c*s+m, two roundings as in the Pallas kernel (no fma)
        lo[i] = __fadd_rn(__fmul_rn((float)(b & 0xF), sl[i]), ml[i]);
        hi[i] = __fadd_rn(__fmul_rn((float)(b >> 4), sh[i]), mh[i]);
      } else {
        lo[i] = __fmul_rn((float)((b & 0xF) - 8), sl[i]);
        hi[i] = __fmul_rn((float)((b >> 4) - 8), sh[i]);
      }
    }
    store_w<T>(s, wb, r, c, lo);
    store_w<T>(s, wb, r + QK, c, hi);
  }
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

// (min blocks per SM: 1, so that ptxas may take the registers the
// cp.async instances need instead of capping them at 128 and spilling;
// the f32 TMA instances 3, which caps them at 168 without a spill)
template <class T, int MT, bool TMA>
__global__ void __launch_bounds__(THREADS, kF32<T> && TMA ? 3 : 1)
    q4_matmul_kernel(const T* __restrict__ x,
                     const uint8_t* __restrict__ packed,
                     const float* __restrict__ scales,
                     const float* __restrict__ mins, float* __restrict__ out,
                     int M, int K, int N, const __grid_constant__ Maps maps) {
  extern __shared__ unsigned char smem_raw[];
  Smem<T, MT, TMA>& s = *reinterpret_cast<Smem<T, MT, TMA>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * 32 * MT, n0 = blockIdx.x * BN;
  const int groups = K / BK;
  const bool q4_1 = mins != nullptr;
  constexpr int STAGES = kStages<T>;

  if (TMA && threadIdx.x == 0) {
    for (int st = 0; st < STAGES; ++st) hopper::mbar_init(&s.bar[st]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  float acc[MT][4][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  // Load group j = {x of j, band of j+1} (group 0 also brings band 0).
  // Iteration g multiplies group g (x slot g%STAGES, W tile g%2, or the
  // one W tile) and dequantizes group g+1 into the other (or, after a
  // barrier, the same) W tile.
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j)
    load_group<T, MT, TMA>(s, maps, j, groups, x, packed, scales, mins, M,
                           K, N, m0, n0);
  wait_group<T, MT, TMA>(s, 0);
  __syncthreads();
  dequantize<T>(s, 0, 0, q4_1);

  // f32: the group's products, summed apart (see the note at the top)
  float part[MT][4][4];
  for (int g = 0; g < groups; ++g) {
    const int st = g % STAGES, wb = kWBuf<T> == 2 ? g & 1 : 0;
    wait_group<T, MT, TMA>(s, g);  // x of g and band of g+1 landed
    __syncthreads();  // ... for every thread; W of g is complete; slots
                      // g-1 (x) and g (band) and W of g-1 are free
    load_group<T, MT, TMA>(s, maps, g + STAGES - 1, groups, x, packed,
                           scales, mins, M, K, N, m0, n0);
    if constexpr (kF32<T>) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
    }

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      constexpr int P = kParts<T>;
      uint32_t a[P][MT][4];
      if constexpr (kF32<T>) {
        // float4 of lane t: logical k 32h + 8t + 4s + 0..3 of rows r, r+8
        const float* xt = &s.x[st][kk >> 1][0][0];
        const int c = 2 * (lane & 3) + (kk & 1);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int r = wm * 16 * MT + mt * 16 + (lane >> 2);
          const float4 u = *reinterpret_cast<const float4*>(xt + xf_off(r, c));
          const float4 v =
              *reinterpret_cast<const float4*>(xt + xf_off(r + 8, c));
          uint32_t p[4][3];
          hopper::split_bf16x3(u.x, u.y, p[0]);
          hopper::split_bf16x3(v.x, v.y, p[1]);
          hopper::split_bf16x3(u.z, u.w, p[2]);
          hopper::split_bf16x3(v.z, v.w, p[3]);
#pragma unroll
          for (int q = 0; q < 3; ++q)
#pragma unroll
            for (int i = 0; i < 4; ++i) a[q][mt][i] = p[i][q];
        }
      } else {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const int r = wm * 16 * MT + mt * 16 + (lane & 15);
          hopper::ldsm_x4(a[0][mt],
                          &s.x[st][r][x_col<TMA>(r, kk * 2 + (lane >> 4))]);
        }
      }
      uint32_t b[P][4][2];
#pragma unroll
      for (int q = 0; q < P; ++q)
#pragma unroll
        for (int np = 0; np < 2; ++np) {
          uint32_t r[4];
          hopper::ldsm_x4_trans(
              r, &s.w[wb][q][w_idx<T>(kk * 16 + (lane & 15),
                                      wn * 32 + np * 16 + (lane >> 4) * 8)]);
          b[q][2 * np][0] = r[0];
          b[q][2 * np][1] = r[1];
          b[q][2 * np + 1][0] = r[2];
          b[q][2 * np + 1][1] = r[3];
        }
      if constexpr (kF32<T>) {
#pragma unroll
        for (int p = 0; p < 6; ++p)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int nt = 0; nt < 4; ++nt)
              hopper::mma_bf16(part[mt][nt], a[hopper::x6_a(p)][mt],
                               b[hopper::x6_b(p)][nt][0],
                               b[hopper::x6_b(p)][nt][1]);
      } else {
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            hopper::mma_bf16(acc[mt][nt], a[0][mt], b[0][nt][0],
                             b[0][nt][1]);
      }
    }
    if constexpr (kF32<T>) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e], part[mt][nt][e]);
    }
    if (kWBuf<T> == 1) __syncthreads();  // every warp is done with W
    if (g + 1 < groups)
      dequantize<T>(s, (g + 1) % STAGES, kWBuf<T> == 2 ? wb ^ 1 : 0, q4_1);
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int m = m0 + wm * 16 * MT + mt * 16 + (lane >> 2);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int n = n0 + wn * 32 + nt * 8 + (lane & 3) * 2;
      store2(out, M, N, m, n, acc[mt][nt][0], acc[mt][nt][1]);
      store2(out, M, N, m + 8, n, acc[mt][nt][2], acc[mt][nt][3]);
    }
  }
}

// Launch the (T, MT, TMA) instance; its shared memory (above 48 KB at
// MT = 2, and for f32) needs the limit raised, once per instance. The f32
// instance also asks for the largest shared-memory carveout, so that
// three of its blocks fit an SM.
template <class T, int MT, bool TMA>
int launch(const void* x, const void* packed, const void* scales,
           const void* mins, void* out, int M, int K, int N,
           cudaStream_t stream) {
  constexpr int smem = sizeof(Smem<T, MT, TMA>) + 1024;
  const auto kernel = q4_matmul_kernel<T, MT, TMA>;
  static const cudaError_t attr = [&] {
    cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess && kF32<T>)
      e = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
    return e;
  }();
  if (attr != cudaSuccess) return (int)attr;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  if (TMA) {
    const bool ok =
        (kF32<T> ? hopper::encode_map(&maps.x,
                                      CU_TENSOR_MAP_DATA_TYPE_FLOAT32, x, K,
                                      M, (uint64_t)K * 4, 32, 32 * MT,
                                      CU_TENSOR_MAP_SWIZZLE_128B)
                 : hopper::encode_map(&maps.x,
                                      CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K,
                                      M, (uint64_t)K * 2, BK, 32 * MT,
                                      CU_TENSOR_MAP_SWIZZLE_128B)) &&
        hopper::encode_map(&maps.band, CU_TENSOR_MAP_DATA_TYPE_UINT8, packed,
                           N, K / 2, N, BN, QK, CU_TENSOR_MAP_SWIZZLE_NONE) &&
        hopper::encode_map(&maps.sc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scales,
                           N, K / QK, (uint64_t)N * 4, BN, 2,
                           CU_TENSOR_MAP_SWIZZLE_NONE) &&
        (mins == nullptr ||
         hopper::encode_map(&maps.mn, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, mins,
                            N, K / QK, (uint64_t)N * 4, BN, 2,
                            CU_TENSOR_MAP_SWIZZLE_NONE));
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((N + BN - 1) / BN, (M + 32 * MT - 1) / (32 * MT));
  kernel<<<grid, THREADS, smem, stream>>>(
      (const T*)x, (const uint8_t*)packed, (const float*)scales,
      (const float*)mins, (float*)out, M, K, N, maps);
  return (int)cudaGetLastError();
}

// BM = 64 when the grid still gives every SM a tile (f32: two, as three
// of its blocks share an SM; at M=512 BM=32 was the faster in a
// diagnostic build), else 32; TMA loads when N's row stride is a
// multiple of 16 bytes, else cp.async. The f32 cp.async instance (N % 16
// != 0: no model's weight) keeps BM = 32: at 64 its copies and the split
// take all 255 registers a thread has.
template <class T>
int launch_for(const void* x, const void* packed, const void* scales,
               const void* mins, void* out, int M, int K, int N,
               cudaStream_t stream) {
  const long long tiles64 = (long long)((N + BN - 1) / BN) * ((M + 63) / 64);
  const bool tma = N % 16 == 0;
  const bool big = tiles64 >= (kF32<T> ? 2 : 1) * hopper::sm_count();
  int (*fn)(const void*, const void*, const void*, const void*, void*, int,
            int, int, cudaStream_t);
  if constexpr (kF32<T>)
    fn = tma ? (big ? launch<T, 2, true> : launch<T, 1, true>)
             : launch<T, 1, false>;
  else
    fn = big ? (tma ? launch<T, 2, true> : launch<T, 2, false>)
             : (tma ? launch<T, 1, true> : launch<T, 1, false>);
  return fn(x, packed, scales, mins, out, M, K, N, stream);
}

bool valid(int M, int K, int N) {
  return M > 0 && N > 0 && K > 0 && K % BK == 0;
}

}  // namespace

extern "C" int q4_matmul_f32(const void* x, const void* packed,
                             const void* scales, const void* mins, void* out,
                             int M, int K, int N, void* stream) {
  if (!valid(M, K, N)) return (int)cudaErrorInvalidValue;
  return launch_for<float>(x, packed, scales, mins, out, M, K, N,
                           (cudaStream_t)stream);
}

extern "C" int q4_matmul_bf16(const void* x, const void* packed,
                              const void* scales, const void* mins, void* out,
                              int M, int K, int N, void* stream) {
  if (!valid(M, K, N)) return (int)cudaErrorInvalidValue;
  return launch_for<__nv_bfloat16>(x, packed, scales, mins, out, M, K, N,
                                   (cudaStream_t)stream);
}
