// Fused Q4 dequantize + matmul for Hopper (sm_90a): out[M,N] (f32) =
// x[M,K] @ dequant(W)[K,N] (the bulk-M instance also in a bf16 form with
// the bias in its epilogue, below), with W in the group-local layout of
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
// mma.sync and not wgmma below the router's crossover (WGMMA_MIN_M in
// ops/q4_matmul.py, measured by chip_smoke.py): a 64-row group gives a
// block only 4 k16 steps between copies, and at these sizes the grid and
// the per-group latency, not the issue rate of the tensor cores, set the
// time. BM is 64 when that gives at least one tile per SM, else 32, which
// doubles the blocks of the small shapes (M=512, N=384: 48 -> 96 blocks).
// No split-K: every output is summed by one thread in a fixed order, so a
// call is deterministic. Ragged M and N edges are masked on store; K must
// be a multiple of 64.
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
//
// The bulk-M bf16 instance (q4_matmul_bf16_wgmma; N % 16 == 0). What
// bounds it: at bert-base's shapes at M = 8,192 tokens the product is
// bound by operations (QKV: 29 GFLOP, 29 us at 989 TFLOP/s, against 15 us
// for x, W and a bf16-sized output at 3.35 TB/s), and only wgmma reaches
// the tensor cores' full rate; the mma.sync instance ran at a fifth of it.
// Two costs come on top of the products: dequantizing, about five
// instructions a weight, and the f32 output, 4 bytes an element written
// while every SM finishes its tiles at about the same time.
// Design: persistent blocks, one per SM, 384 threads, computing out^T =
// W^T x^T on tiles of 128 W columns x 256 tokens, token-block major.
//  - The producer warpgroup (one thread works; setmaxnreg 40) keeps a
//    4-stage ring of TMA loads on full/empty mbarriers: per K group the x
//    tile (256 tokens x 64 k in bf16, 128-byte swizzle), the band's 32
//    packed rows of 128 columns (128-byte swizzle) and its scale (and min)
//    rows. TMA zero-fills past M and N.
//  - Two consumer warpgroups (setmaxnreg 232) own 64 W columns each. Per
//    group each thread dequantizes its own wgmma A fragments (16 bytes of
//    the band, 32 weights, the mma.sync instances' arithmetic: (c-8)*s or
//    c*s+m in f32 with __fmul_rn / __fadd_rn, rounded once to bf16) into
//    registers, then issues four wgmma.m64n256k16 with A from registers
//    and B the x tile by descriptor, f32 accumulators (128 a thread). The
//    fragments are double-buffered: group g+1's are made while group g's
//    products run, and a stage is released once its products retired.
//    W never reaches shared memory as bf16, so the shared-memory traffic
//    is the x tile's (written once, read by each consumer) and the band's.
//  - The epilogue goes through shared memory: each consumer writes half a
//    tile (128 tokens x its 64 columns) into two boxes in the output map's
//    128-byte swizzle, and one thread stores them by TMA; the warps go on
//    while the copy engine drains, so the next tile's products overlap the
//    f32 output's write.
//  - The bf16 form (q4_matmul_bf16_wgmma_bf16): the epilogue rounds each
//    accumulator to bf16 and, given a bf16 bias [N], adds it in f32 and
//    rounds again, r(r(p) + b): bit for bit the f32 form, then the cast,
//    then the bias add, the three launches it replaces after the QKV and
//    FFN-up products. A thread's columns are two W^T rows, so it loads
//    two bias values a tile, before the tile's products. Tokens come in
//    pairs of a column, rounded by one cvt a pair; the half tile is one
//    box of 128-byte rows in the same swizzle, one TMA store, and the
//    consumer's two boxes alternate, so a box is written while the other
//    drains: half the staged bytes and half the stored ones. At bert-base's
//    QKV and FFN-up at M = 8,192 it took 0.054 and 0.067 ms against the f32
//    form's 0.063 and 0.079 (PERF.md). GELU does not go here: in this
//    epilogue (erff on every output, on the consumers' critical path) it
//    took 1.3-1.5x the bf16 form then F.gelu's launch.
//  - Tail: where the last round of tiles would fill at most half the SMs,
//    its tiles are cut into 128-token halves (wgmma.m64n128k16) so that
//    twice as many SMs share it.
// Each output is summed by one accumulator, k in order, 16 a step: no
// split-K, no atomics; at every shape chip_smoke.py checks, the result is
// the mma.sync instance's bit for bit. Rejected in diagnostic builds on the
// H100 (PERF.md): dequantizing warpgroups that write a swizzled bf16 W
// tile for the consumers' descriptors (SS operands), 128- or 256-row
// tiles, one or two such warpgroups; it read that W tile once per m64
// product from shared memory and ran at the same speed as this design
// without its staged epilogue, for which it had no shared memory left.

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

// ---------------------------------------------------------------------------
// The bulk-M bf16 instance: persistent warp-specialised blocks on wgmma,
// out^T = W^T x^T with W^T dequantized into registers (the header's last
// part says why)
// ---------------------------------------------------------------------------

namespace wg {

constexpr int WBN = 128;  // W columns (outputs' n) of a tile, 64 a consumer
constexpr int BT = 256;   // tokens (x rows, outputs' m) of a tile: wgmma's N
constexpr int STAGES = 4;
constexpr int THREADS = 3 * 128;  // two consumer warpgroups, the producer
// registers a thread after setmaxnreg: 168 each at launch (65,536 / 384);
// the producer's go to the consumers
constexpr int REG_P = 40, REG_C = 232;
// an epilogue box: 128 tokens x 32 columns of f32 or 64 of bf16, rows of
// 128 bytes in the 128-byte swizzle, as the output's tensor map stores it
constexpr int OUT_T = 128, OUT_N = 32, BOX_BYTES = OUT_T * 128;

struct Smem {
  // as TMA writes them: x tiles in 128-byte rows (one row a token) and the
  // bands, both in the 128-byte swizzle (16-byte chunk j of row r at chunk
  // j ^ (r % 8)); the x tile is what the wgmma's B descriptor reads
  alignas(1024) bf16 x[STAGES][BT][BK];
  alignas(1024) uint8_t band[STAGES][QK][WBN];
  // each consumer's two boxes: in f32 the two halves of its 64 columns of
  // half a tile; in bf16 a whole half tile each, used in turns
  alignas(1024) uint8_t out[2][2][BOX_BYTES];
  alignas(128) float sc[STAGES][2][WBN];
  alignas(128) float mn[STAGES][2][WBN];
  uint64_t full[STAGES], empty[STAGES];
};

#define WG_R8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// d (+)= a @ b over one k16 step: A 64 x 16 of W^T in registers (the
// mma.m16n8k16 A layout, a warp 16 rows), B 256 x 16 of x, K-major in
// shared memory (a descriptor), f32 accumulators, 128 a thread; scale_d =
// 0 overwrites d (a tile's first step).
__device__ __forceinline__ void wgmma_rs(float (&d)[BT / 2],
                                         const uint32_t (&a)[4], uint64_t b,
                                         int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %133, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63, %64, %65, %66, %67, %68, %69, "
      "%70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, "
      "%90, %91, %92, %93, %94, %95, %96, %97, %98, %99, "
      "%100, %101, %102, %103, %104, %105, %106, %107, %108, %109, "
      "%110, %111, %112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127"
      "}, {%128, %129, %130, %131}, %132, p, 1, 1, 0;\n}\n"
      : WG_R8(0), WG_R8(8), WG_R8(16), WG_R8(24), WG_R8(32), WG_R8(40),
        WG_R8(48), WG_R8(56), WG_R8(64), WG_R8(72), WG_R8(80), WG_R8(88),
        WG_R8(96), WG_R8(104), WG_R8(112), WG_R8(120)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

// The same over the first 128 tokens of the tile (a half tile, below).
__device__ __forceinline__ void wgmma_rs_half(float (&d)[BT / 4],
                                              const uint32_t (&a)[4],
                                              uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %69, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
      : WG_R8(0), WG_R8(8), WG_R8(16), WG_R8(24), WG_R8(32), WG_R8(40),
        WG_R8(48), WG_R8(56)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
}

#undef WG_R8

// One weight from its nibble n: (n-8)*s (Q4_0) or n*s+m (Q4_1), in f32
// with one rounding per operation, as the mma.sync instances compute it.
// The bits 0x4B00000n read as a float are 2^23 + n exactly.
template <bool Q41>
__device__ __forceinline__ float weight(uint32_t nibble, float s, float m) {
  const float v = __int_as_float(0x4B000000u | nibble);
  if (Q41) return __fadd_rn(__fmul_rn(__fsub_rn(v, 8388608.f), s), m);
  return __fmul_rn(__fsub_rn(v, 8388616.f), s);
}

// This thread's A fragments of one group, for its k16 steps kk = 0..3:
// a[kk] holds W^T rows n and n + 8 (W columns of the tile) at k = 16 kk +
// 2q, + 1 (a[kk][0], [1]) and + 8, + 9 ([2], [3]), q = lane % 4. Step kk
// reads the low nibbles (kk < 2) or high nibbles of packed rows 16 (kk % 2)
// + 2q + {0, 1, 8, 9}: eight rows, each read once as a byte per column.
// The band's swizzle puts the four q's rows in four 16-byte chunks, and
// the eight lanes of a q read neighbouring bytes: no bank conflicts.
template <bool Q41>
__device__ __forceinline__ void fragments(const Smem& s, int st, int n,
                                          uint32_t (&a)[4][4]) {
  const int q = threadIdx.x & 3;
  float sc[2][2], mn[2][2];  // [low/high nibbles][column n, n + 8]
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int c = 0; c < 2; ++c) {
      sc[h][c] = s.sc[st][h][n + 8 * c];
      mn[h][c] = Q41 ? s.mn[st][h][n + 8 * c] : 0.f;
    }
  uint32_t b[2][4][2];  // [kk % 2][row 2q + {0, 1, 8, 9}][column]
#pragma unroll
  for (int half = 0; half < 2; ++half)
#pragma unroll
    for (int rr = 0; rr < 4; ++rr) {
      const int r = 16 * half + 2 * q + (rr & 1) + 8 * (rr >> 1);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = n + 8 * c;
        b[half][rr][c] =
            s.band[st][r][(((col >> 4) ^ (r & 7)) << 4) | (col & 15)];
      }
    }
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const int half = kk & 1, h = kk >> 1;
#pragma unroll
    for (int i = 0; i < 4; ++i) {  // a[kk][i]: rows pair i / 2, column i % 2
      const int c = i & 1, rr = (i >> 1) * 2;
      a[kk][i] = hopper::pack_bf16(
          weight<Q41>((b[half][rr][c] >> (4 * h)) & 0xF, sc[h][c], mn[h][c]),
          weight<Q41>((b[half][rr + 1][c] >> (4 * h)) & 0xF, sc[h][c],
                      mn[h][c]));
    }
  }
}

// Keep the compiler from reusing a fragment's registers before the wgmma
// that reads them has retired (it reads them behind the compiler's back).
__device__ __forceinline__ void hold(uint32_t (&a)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// One K group of a consumer: its fragments into `cur`, four wgmma on the
// stage's x tile, then, once the previous group's products retired, that
// group's fragments (`prev`) and its stage are free.
template <bool Q41>
__device__ __forceinline__ void group(Smem& s, float (&acc)[BT / 2],
                                      uint32_t (&cur)[4][4],
                                      uint32_t (&prev)[4][4], int n, int g,
                                      bool half, int& q) {
  const int st = q % STAGES;
  hopper::mbar_wait(&s.full[st], (q / STAGES) & 1);
  fragments<Q41>(s, st, n, cur);
  hopper::wgmma_fence();
  // one branch around the group's four wgmma (not one each), so that
  // ptxas sees them back to back and fences only the first
  if (half) {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs_half(reinterpret_cast<float(&)[BT / 4]>(acc), cur[kk],
                    hopper::desc_sw128(&s.x[st][0][kk * 16]), g > 0 || kk > 0);
  } else {
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk)
      wgmma_rs(acc, cur[kk], hopper::desc_sw128(&s.x[st][0][kk * 16]),
               g > 0 || kk > 0);
  }
  hopper::wgmma_commit();
  hopper::wgmma_wait<1>();
  hold(prev);
  if (g > 0 && (threadIdx.x & 31) == 0)
    hopper::mbar_arrive(&s.empty[(q + STAGES - 1) % STAGES]);
  ++q;
}

// Tokens 128 H.. of the consumer's finished tile, out[t0 + 128 H.., n0 +
// 64 w..], through its staging boxes, stored by two TMA stores. The thread
// holds out^T rows n and n + 8 (acc[4j + {0, 1}] and [4j + {2, 3}]) at
// tokens 8j + 2q and + 1; lanes g and g ^ 1 (g = lane / 4) swap one value
// each, so that each writes a pair of neighbouring columns: (t, n, n + 1)
// from the even lane, (t + 1, n - 1, n) from the odd one. The box's
// swizzle spreads a warp's pairs over all banks.
template <int H>
__device__ __forceinline__ void store_half(Smem& s, const float (&acc)[BT / 2],
                                           const CUtensorMap* map, int t0,
                                           int n0) {
  const int w = threadIdx.x >> 7, lane = threadIdx.x & 31, q = lane & 3;
  const bool odd = (lane >> 2) & 1, lead = (threadIdx.x & 127) == 0;
  const int n = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);  // 0..63
  // the stores that last read the boxes are done with them
  if (lead) hopper::bulk_wait_read<0>();
  hopper::named_bar_sync(1 + w, 128);
#pragma unroll
  for (int j = 0; j < OUT_T / 8; ++j)
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int a = 4 * (j + H * OUT_T / 8) + 2 * r;
      const float v0 = acc[a], v1 = acc[a + 1];
      const float got = __shfl_xor_sync(~0u, odd ? v0 : v1, 4);
      const int t = 8 * j + 2 * q + odd, c = n + 8 * r - odd;
      float* box = reinterpret_cast<float*>(s.out[w][c >> 5]);
      *reinterpret_cast<float2*>(
          box + t * OUT_N + ((((c & 31) >> 2) ^ (t & 7)) << 2) + (c & 3)) =
          odd ? make_float2(got, v1) : make_float2(v0, got);
    }
  hopper::fence_proxy_async();
  hopper::named_bar_sync(1 + w, 128);
  if (lead) {
    hopper::tma_store_2d(map, s.out[w][0], n0 + 64 * w, t0 + H * OUT_T);
    hopper::tma_store_2d(map, s.out[w][1], n0 + 64 * w + OUT_N,
                         t0 + H * OUT_T);
    hopper::bulk_commit();
  }
}

// The bf16 form's outputs of one column at two tokens, as a bf16 pair
// (the first token in the low half): r(p), or with the bias r(r(p) + b),
// b a bf16 and so exact as a float; r rounds to nearest even, one
// instruction a pair. The cast and the bias add launched after the f32
// form compute the same.
template <bool HAS_B>
__device__ __forceinline__ uint32_t finish(float p0, float p1, float b) {
  const uint32_t r = hopper::pack_bf16(p0, p1);
  if constexpr (!HAS_B) return r;
  const float2 f = hopper::unpack_bf16(r);
  return hopper::pack_bf16(__fadd_rn(f.x, b), __fadd_rn(f.y, b));
}

// The bf16 form's store_half: tokens 128 H.. of the consumer's tile in one
// box of 128 tokens x its 64 columns (rows of 128 bytes), stored by one TMA
// store; the consumer's two boxes in turns (`stores` counts its stores),
// so that a box is written while the other's store drains. The thread
// finishes its own outputs of each 8 tokens (columns n and n + 8, bias
// bv[0] and bv[1]), a pair of tokens a column, then lanes g and g ^ 1 swap
// a word of two bf16, one a column, as store_half swaps its floats: each
// then writes pairs of neighbouring columns, a warp eight tokens x 16
// bytes, all banks.
template <int H, bool HAS_B>
__device__ __forceinline__ void store_half_bf16(
    Smem& s, const float (&acc)[BT / 2], const CUtensorMap* map, int t0,
    int n0, const float (&bv)[2], uint32_t& stores) {
  const int w = threadIdx.x >> 7, lane = threadIdx.x & 31, q = lane & 3;
  const bool odd = (lane >> 2) & 1, lead = (threadIdx.x & 127) == 0;
  const int n = 16 * ((threadIdx.x >> 5) & 3) + (lane >> 2);  // 0..63
  uint8_t* box = s.out[w][stores & 1];
  // the store that last read this box (two stores ago) is done with it
  if (lead) hopper::bulk_wait_read<1>();
  hopper::named_bar_sync(1 + w, 128);
#pragma unroll
  for (int j = 0; j < OUT_T / 8; ++j) {
    const int a = 4 * (j + H * OUT_T / 8);
    // columns n and n + 8 at tokens 8j + 2q (low halves) and + 1 (high)
    const uint32_t y0 = finish<HAS_B>(acc[a], acc[a + 1], bv[0]);
    const uint32_t y1 = finish<HAS_B>(acc[a + 2], acc[a + 3], bv[1]);
    // the even lane keeps token 8j + 2q and sends the high halves; the odd
    // one keeps 8j + 2q + 1 and sends the low halves
    const uint32_t got = __shfl_xor_sync(
        ~0u, odd ? __byte_perm(y0, y1, 0x5410) : __byte_perm(y0, y1, 0x7632),
        4);
    const uint32_t word[2] = {
        odd ? __byte_perm(got, y0, 0x7610) : __byte_perm(y0, got, 0x5410),
        odd ? __byte_perm(got, y1, 0x7632) : __byte_perm(y1, got, 0x7610)};
    const int t = 8 * j + 2 * q + odd;
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int c = n + 8 * r - odd;  // the pair's first column, even
      *reinterpret_cast<uint32_t*>(
          box + t * 128 + (((c >> 3) ^ (t & 7)) << 4) + ((c & 7) << 1)) =
          word[r];
    }
  }
  hopper::fence_proxy_async();
  hopper::named_bar_sync(1 + w, 128);
  if (lead) {
    hopper::tma_store_2d(map, box, n0 + 64 * w, t0 + H * OUT_T);
    hopper::bulk_commit();
  }
  ++stores;
}

// The block's tiles, the same order for every role: t = blockIdx.x, +
// gridDim.x, ..., token-block major, 256 tokens x 128 columns. Where the
// last round would leave at least half the SMs idle, its tiles (index
// `split` on) are cut in two halves of 128 tokens, twice as many tiles
// that each take about half the time: the SMs fill better, and every output
// is still summed in the same order.
struct Tiles {
  int tiles_n, split, count;  // count: tiles after any cut
  __device__ __forceinline__ void at(int v, int& t0, int& n0,
                                     bool& half) const {
    int tile = v;
    half = v >= split;
    if (half) tile = split + (v - split) / 2;
    t0 = tile / tiles_n * BT + (half ? ((v - split) & 1) * OUT_T : 0);
    n0 = tile % tiles_n * WBN;
  }
};

template <bool Q41, bool BF16>
__device__ __forceinline__ void consumer(Smem& s, const CUtensorMap* map,
                                         const Tiles& tl, int groups,
                                         const bf16* __restrict__ bias,
                                         int N) {
  // this thread's W^T rows: 64 a consumer warpgroup, 16 a warp
  const int n_in = 64 * (threadIdx.x >> 7) + 16 * ((threadIdx.x >> 5) & 3) +
                   ((threadIdx.x & 31) >> 2);
  const bool has_b = bias != nullptr;
  float acc[BT / 2];
  uint32_t fa[4][4], fb[4][4];
  int q = 0;
  uint32_t stores = 0;
  for (int v = blockIdx.x; v < tl.count; v += gridDim.x) {
    int t0, n0;
    bool half;
    tl.at(v, t0, n0, half);
    // the bias of this thread's two columns, loaded before the products
    // so that its latency hides behind them
    float bv[2] = {0.f, 0.f};
    if (BF16 && has_b) {
      for (int r = 0; r < 2; ++r) {
        const int n = n0 + n_in + 8 * r;
        bv[r] = n < N ? __bfloat162float(bias[n]) : 0.f;
      }
    }
    for (int g = 0; g < groups; g += 2) {
      group<Q41>(s, acc, fa, fb, n_in, g, half, q);
      if (g + 1 < groups) group<Q41>(s, acc, fb, fa, n_in, g + 1, half, q);
    }
    hopper::wgmma_wait<0>();
    hold(fa);
    hold(fb);
    if ((threadIdx.x & 31) == 0)
      hopper::mbar_arrive(&s.empty[(q + STAGES - 1) % STAGES]);
#pragma unroll
    for (int j = 0; j < BT / 2; ++j) hopper::fence_operand(acc[j]);
    if constexpr (!BF16) {
      store_half<0>(s, acc, map, t0, n0);
      if (!half) store_half<1>(s, acc, map, t0, n0);
    } else if (has_b) {
      store_half_bf16<0, true>(s, acc, map, t0, n0, bv, stores);
      if (!half) store_half_bf16<1, true>(s, acc, map, t0, n0, bv, stores);
    } else {
      store_half_bf16<0, false>(s, acc, map, t0, n0, bv, stores);
      if (!half) store_half_bf16<1, false>(s, acc, map, t0, n0, bv, stores);
    }
  }
  if ((threadIdx.x & 127) == 0) hopper::bulk_wait<0>();
}

struct Maps {  // TMA descriptors: Q4 operands as above, and the output
  CUtensorMap x, band, sc, mn, out;
};

// Roles (threads): consumers 0-255, then the producer's warpgroup, of which
// one thread works. Tiles t = blockIdx.x, + gridDim.x, ..., token-block
// major; q counts the block's K groups over its tiles, and group q uses
// ring stage q % STAGES. BF16: the output's form (below); bias (bf16
// form; null: none) is the output columns' [N].
template <bool BF16>
__global__ void __launch_bounds__(THREADS, 1)
    q4_matmul_wgmma_kernel(const __grid_constant__ Maps maps, Tiles tl, int K,
                           int N, int q4_1, const bf16* __restrict__ bias) {
  extern __shared__ unsigned char smem_raw[];
  // aligned by an offset from smem_raw, not through an integer, so that
  // the compiler still knows it for shared memory (LDS, not generic loads)
  Smem& s = *reinterpret_cast<Smem*>(
      smem_raw + (-hopper::smem_addr(smem_raw) & 1023u));
  const int groups = K / BK;

  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbar_init<1>(&s.full[i]);
      hopper::mbar_init<8>(&s.empty[i]);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 256) {
    // producer: one thread keeps the ring full
    hopper::setmaxnreg_dec<REG_P>();
    if (threadIdx.x == 256) {
      // a half tile's x box brings 256 tokens too, the second 128 unused
      const uint32_t bytes =
          BT * BK * 2 + QK * WBN + (q4_1 ? 4 : 2) * WBN * 4;
      int q = 0;
      for (int v = blockIdx.x; v < tl.count; v += gridDim.x) {
        int t0, n0;
        bool half;
        tl.at(v, t0, n0, half);
        for (int g = 0; g < groups; ++g, ++q) {
          const int st = q % STAGES;
          hopper::mbar_wait(&s.empty[st], ((q / STAGES) & 1) ^ 1);
          uint64_t* bar = &s.full[st];
          hopper::mbar_expect(bar, bytes);
          hopper::tma_2d(&s.x[st][0][0], &maps.x, g * BK, t0, bar);
          hopper::tma_2d(&s.band[st][0][0], &maps.band, n0, g * QK, bar);
          hopper::tma_2d(&s.sc[st][0][0], &maps.sc, n0, 2 * g, bar);
          if (q4_1) hopper::tma_2d(&s.mn[st][0][0], &maps.mn, n0, 2 * g, bar);
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<REG_C>();
    if (q4_1)
      consumer<true, BF16>(s, &maps.out, tl, groups, bias, N);
    else
      consumer<false, BF16>(s, &maps.out, tl, groups, bias, N);
  }
}

// The output's forms: the f32 product (BF16 false); or the product rounded
// to bf16, plus a bf16 bias rounded again, r(r(p) + b): what the cast and
// the bias add after the f32 form compute, bit for bit.
template <bool BF16>
int launch(const void* x, const void* packed, const void* scales,
           const void* mins, const void* bias, void* out, int M, int K,
           int N, cudaStream_t stream) {
  constexpr int smem = sizeof(Smem) + 1024;
  const auto kernel = q4_matmul_wgmma_kernel<BF16>;
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  Maps maps;
  memset(&maps, 0, sizeof(maps));
  const bool ok =
      hopper::encode_map(&maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K, M,
                         (uint64_t)K * 2, BK, BT,
                         CU_TENSOR_MAP_SWIZZLE_128B) &&
      hopper::encode_map(&maps.band, CU_TENSOR_MAP_DATA_TYPE_UINT8, packed, N,
                         K / 2, N, WBN, QK, CU_TENSOR_MAP_SWIZZLE_128B) &&
      hopper::encode_map(&maps.sc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scales, N,
                         K / QK, (uint64_t)N * 4, WBN, 2,
                         CU_TENSOR_MAP_SWIZZLE_NONE) &&
      (mins == nullptr ||
       hopper::encode_map(&maps.mn, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, mins, N,
                          K / QK, (uint64_t)N * 4, WBN, 2,
                          CU_TENSOR_MAP_SWIZZLE_NONE)) &&
      (!BF16
           ? hopper::encode_map(&maps.out, CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                out, N, M, (uint64_t)N * 4, OUT_N, OUT_T,
                                CU_TENSOR_MAP_SWIZZLE_128B)
           : hopper::encode_map(&maps.out, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
                                out, N, M, (uint64_t)N * 2, 2 * OUT_N, OUT_T,
                                CU_TENSOR_MAP_SWIZZLE_128B));
  if (!ok) return (int)cudaErrorInvalidValue;
  // the last round's tiles are cut in halves where that round would fill
  // at most half the SMs
  const int sms = hopper::sm_count();
  Tiles tl;
  tl.tiles_n = (N + WBN - 1) / WBN;
  const int tiles = (M + BT - 1) / BT * tl.tiles_n;
  const int last = tiles - (tiles - 1) / sms * sms;  // tiles in the last round
  tl.split = 2 * last <= sms ? tiles - last : tiles;
  tl.count = tl.split + 2 * (tiles - tl.split);
  const int grid = tl.count < sms ? tl.count : sms;
  kernel<<<grid, THREADS, smem, stream>>>(maps, tl, K, N, mins != nullptr,
                                          (const bf16*)bias);
  return (int)cudaGetLastError();
}

}  // namespace wg

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

// The bulk-M bf16 instance: N % 16 == 0 (its loads are TMA tiles).
extern "C" int q4_matmul_bf16_wgmma(const void* x, const void* packed,
                                    const void* scales, const void* mins,
                                    void* out, int M, int K, int N,
                                    void* stream) {
  if (!valid(M, K, N) || N % 16 != 0) return (int)cudaErrorInvalidValue;
  return wg::launch<false>(x, packed, scales, mins, nullptr, out, M, K, N,
                           (cudaStream_t)stream);
}

// The same instance writing bf16 out[M, N] with the bias (bf16 [N],
// nullable) in its epilogue: r(r(p) + b), or r(p) without one.
extern "C" int q4_matmul_bf16_wgmma_bf16(const void* x, const void* packed,
                                         const void* scales, const void* mins,
                                         const void* bias, void* out, int M,
                                         int K, int N, void* stream) {
  if (!valid(M, K, N) || N % 16 != 0) return (int)cudaErrorInvalidValue;
  return wg::launch<true>(x, packed, scales, mins, bias, out, M, K, N,
                          (cudaStream_t)stream);
}
