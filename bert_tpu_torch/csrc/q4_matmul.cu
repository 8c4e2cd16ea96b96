// Fused Q4 dequantize + matmul for Hopper (sm_90a): out[M,N] (f32) =
// x[M,K] @ dequant(W)[K,N], with W in the group-local layout of
// bert_tpu_torch/quant.py: packed[K/2,N] uint8, where packed row 32g+r holds
// logical row 64g+r in its low nibble and row 64g+32+r in its high nibble;
// scales[K/32,N] f32 and, for Q4_1, mins[K/32,N] f32.
//
// Replaces: bert_tpu/ops/q4_matmul.py::_q4_matmul_kernel (launched by
// _q4_matmul_pallas, routed by q4_matmul). Same arithmetic: each weight is
// dequantized in f32 ((c-8)*s for Q4_0, c*s+m for Q4_1, with __fmul_rn /
// __fadd_rn so no FMA contraction changes the rounding), rounded once to
// x's type, and multiplied with x accumulating in f32. W never reaches
// device memory in dense form.
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
// The bf16 instance (tensor cores). Each 128-thread block (2x2 warps) owns
// a BM x 64 output tile, BM = 64 or 32, and walks K one 64-row group at a
// time through 3-slot rings in shared memory: the x tile (bf16, no
// widening), and the group's band of 32 packed rows with its 2 scale (and
// 2 min) rows. The block dequantizes a band into a 64x64 bf16 W tile in
// shared memory (each thread 4 columns x 4 packed rows, so a scale is read
// once per 8 weights), and each warp runs mma.sync.m16n8k16 (bf16 -> f32)
// over the group's four 16-deep steps, with A from the x tile by ldmatrix
// and B from the W tile by ldmatrix.trans. Two W tiles make it a software
// pipeline: while the warps multiply group g they dequantize group g+1
// into the other tile, with the copies of x for g+2 and of the band for
// g+3 in flight, so there is one barrier per group.
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
// The f32 instance keeps the CUDA-core design (f32 must stay f32: TF32 is
// off package-wide): each 256-thread block owns a 64x64 tile, stages x
// (f32) and the dequantized W tile in shared memory, and each thread
// accumulates a 4x4 register tile with fmaf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>
#include <string.h>

#include "hopper.cuh"
#include "hopper_tma.cuh"

namespace {

constexpr int QK = 32;  // quantization block
constexpr int BK = 64;  // one group-local group of K rows

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

namespace simt {

constexpr int BM = 64;       // output rows per block
constexpr int BN = 64;       // output columns per block
constexpr int THREADS = 256; // 16 x 16 threads, 4 x 4 outputs each

__global__ void __launch_bounds__(THREADS)
    q4_matmul_f32_kernel(const float* __restrict__ x,
                         const uint8_t* __restrict__ packed,
                         const float* __restrict__ scales,
                         const float* __restrict__ mins,
                         float* __restrict__ out, int M, int K, int N) {
  __shared__ float xs[BK][BM + 4];  // x tile, transposed: xs[k][m]
  __shared__ float ws[BK][BN];      // dequantized W tile
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
      xs[c][r] = (m < M) ? x[(size_t)m * K + k0 + c] : 0.f;
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
      if (q4_1) {  // c*s+m, two roundings as in the Pallas kernel (no fma)
        ws[r][c] = __fadd_rn(__fmul_rn((float)lo, ss[0][c]), ms[0][c]);
        ws[QK + r][c] = __fadd_rn(__fmul_rn((float)hi, ss[1][c]), ms[1][c]);
      } else {
        ws[r][c] = __fmul_rn((float)(lo - 8), ss[0][c]);
        ws[QK + r][c] = __fmul_rn((float)(hi - 8), ss[1][c]);
      }
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

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync) fed by TMA or cp.async rings
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int BN = 64;
constexpr int THREADS = 128;  // 2 x 2 warps
constexpr int STAGES = 3;
constexpr int WS = BN + 8;    // W tile row: 144 bytes

// x tile rows: TMA writes them dense, 128 bytes, in its 128-byte swizzle
// (16-byte chunk j of row r at chunk j ^ (r % 8)); cp.async writes them
// padded to 144 bytes. Either way ldmatrix's eight row addresses hit
// distinct banks.
template <bool TMA>
__device__ __forceinline__ int x_col(int r, int chunk) {
  return TMA ? (chunk ^ (r & 7)) * 8 : chunk * 8;
}

template <int MT, bool TMA>  // m16 tiles per warp; BM = 32 * MT
struct Smem {
  alignas(1024) bf16 x[STAGES][32 * MT][TMA ? BK : BK + 8];
  alignas(128) uint8_t band[STAGES][QK][BN];
  alignas(128) float sc[STAGES][2][BN];
  alignas(128) float mn[STAGES][2][BN];
  alignas(128) bf16 w[2][BK][WS];
  uint64_t bar[STAGES];
};

struct Maps {  // TMA descriptors of x, the packed band, scales and mins
  CUtensorMap x, band, sc, mn;
};

// Issue load group j: x of group j and the band of group j+1 (and, for
// j = 0, the band of group 0), into their ring slots; TMA completes on
// barrier j % STAGES, cp.async on the commit group.
template <int MT, bool TMA>
__device__ __forceinline__ void load_group(
    Smem<MT, TMA>& s, const Maps& maps, int j, int groups,
    const bf16* __restrict__ x, const uint8_t* __restrict__ packed,
    const float* __restrict__ scales, const float* __restrict__ mins, int M,
    int K, int N, int m0, int n0) {
  constexpr int BM = 32 * MT;
  const int tid = threadIdx.x;
  const int b0 = j == 0 ? 0 : j + 1, b1 = j + 1;  // bands of this group
  if (TMA) {
    if (tid != 0 || j >= groups) return;
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    const uint32_t band_bytes = QK * BN + (mins ? 4 : 2) * BN * 4;
    uint32_t bytes = BM * BK * 2;
    for (int b = b0; b <= b1; ++b)
      if (b < groups) bytes += band_bytes;
    uint64_t* bar = &s.bar[j % STAGES];
    hopper::mbar_expect(bar, bytes);
    hopper::tma_2d(&s.x[j % STAGES][0][0], &maps.x, j * BK, m0, bar);
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
    for (int i = tid; i < BM * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), c = i % (BK / 8);
      const bool ok = m0 + r < M;
      hopper::cp_async16(&s.x[st][r][x_col<TMA>(r, c)],
                         x + (size_t)(ok ? m0 + r : 0) * K + j * BK + c * 8,
                         ok);
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
template <int MT, bool TMA>
__device__ __forceinline__ void wait_group(Smem<MT, TMA>& s, int g) {
  if (TMA)
    hopper::mbar_wait(&s.bar[g % STAGES], (g / STAGES) & 1);
  else
    hopper::cp_async_wait<STAGES - 2>();
}

// Band of slot st -> bf16 W tile wb: thread owns columns c..c+3 of packed
// rows r, r+8, r+16, r+24 (a warp reads two whole 64-byte rows per load,
// conflict-free); packed row r gives W rows r (low nibble) and r+32 (high).
template <class S>
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
    *reinterpret_cast<uint2*>(&s.w[wb][r][c]) =
        make_uint2(hopper::pack_bf16(lo[0], lo[1]),
                   hopper::pack_bf16(lo[2], lo[3]));
    *reinterpret_cast<uint2*>(&s.w[wb][r + QK][c]) =
        make_uint2(hopper::pack_bf16(hi[0], hi[1]),
                   hopper::pack_bf16(hi[2], hi[3]));
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

// (min 1 block per SM: ptxas may then take the registers the cp.async
// instance needs instead of capping it at 128 and spilling)
template <int MT, bool TMA>
__global__ void __launch_bounds__(THREADS, 1)
    q4_matmul_bf16_kernel(const bf16* __restrict__ x,
                          const uint8_t* __restrict__ packed,
                          const float* __restrict__ scales,
                          const float* __restrict__ mins,
                          float* __restrict__ out, int M, int K, int N,
                          const __grid_constant__ Maps maps) {
  extern __shared__ unsigned char smem_raw[];
  Smem<MT, TMA>& s = *reinterpret_cast<Smem<MT, TMA>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int m0 = blockIdx.y * 32 * MT, n0 = blockIdx.x * BN;
  const int groups = K / BK;
  const bool q4_1 = mins != nullptr;

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
  // Iteration g multiplies group g (x slot g%STAGES, W tile g%2) and
  // dequantizes group g+1 into the other W tile.
#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j)
    load_group<MT, TMA>(s, maps, j, groups, x, packed, scales, mins, M, K, N,
                        m0, n0);
  wait_group<MT, TMA>(s, 0);
  __syncthreads();
  dequantize(s, 0, 0, q4_1);

  for (int g = 0; g < groups; ++g) {
    const int st = g % STAGES, wb = g & 1;
    wait_group<MT, TMA>(s, g);  // x of g and band of g+1 landed
    __syncthreads();  // ... for every thread; W of g is complete; slots
                      // g-1 (x) and g (band) and W of g-1 are free
    load_group<MT, TMA>(s, maps, g + STAGES - 1, groups, x, packed, scales,
                        mins, M, K, N, m0, n0);

#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int r = wm * 16 * MT + mt * 16 + (lane & 15);
        hopper::ldsm_x4(a[mt],
                        &s.x[st][r][x_col<TMA>(r, kk * 2 + (lane >> 4))]);
      }
      uint32_t b[4][2];
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        hopper::ldsm_x4_trans(r, &s.w[wb][kk * 16 + (lane & 15)]
                                     [wn * 32 + np * 16 + (lane >> 4) * 8]);
        b[2 * np][0] = r[0];
        b[2 * np][1] = r[1];
        b[2 * np + 1][0] = r[2];
        b[2 * np + 1][1] = r[3];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < 4; ++nt)
          hopper::mma_bf16(acc[mt][nt], a[mt], b[nt][0], b[nt][1]);
    }
    if (g + 1 < groups) dequantize(s, (g + 1) % STAGES, wb ^ 1, q4_1);
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

}  // namespace tc

int launch_f32(const void* x, const void* packed, const void* scales,
               const void* mins, void* out, int M, int K, int N,
               cudaStream_t stream) {
  const dim3 grid((N + simt::BN - 1) / simt::BN,
                  (M + simt::BM - 1) / simt::BM);
  simt::q4_matmul_f32_kernel<<<grid, simt::THREADS, 0, stream>>>(
      (const float*)x, (const uint8_t*)packed, (const float*)scales,
      (const float*)mins, (float*)out, M, K, N);
  return (int)cudaGetLastError();
}

// Launch the (MT, TMA) instance; its shared memory (above 48 KB at MT = 2)
// needs the limit raised, once per instance.
template <int MT, bool TMA>
int launch_tc(const void* x, const void* packed, const void* scales,
              const void* mins, void* out, int M, int K, int N,
              cudaStream_t stream) {
  constexpr int smem = sizeof(tc::Smem<MT, TMA>) + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      tc::q4_matmul_bf16_kernel<MT, TMA>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  tc::Maps maps;
  memset(&maps, 0, sizeof(maps));
  if (TMA) {
    const bool ok =
        hopper::encode_map(&maps.x, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, x, K,
                           M, (uint64_t)K * 2, BK, 32 * MT,
                           CU_TENSOR_MAP_SWIZZLE_128B) &&
        hopper::encode_map(&maps.band, CU_TENSOR_MAP_DATA_TYPE_UINT8, packed,
                           N, K / 2, N, tc::BN, QK,
                           CU_TENSOR_MAP_SWIZZLE_NONE) &&
        hopper::encode_map(&maps.sc, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, scales,
                           N, K / QK, (uint64_t)N * 4, tc::BN, 2,
                           CU_TENSOR_MAP_SWIZZLE_NONE) &&
        (mins == nullptr ||
         hopper::encode_map(&maps.mn, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, mins,
                            N, K / QK, (uint64_t)N * 4, tc::BN, 2,
                            CU_TENSOR_MAP_SWIZZLE_NONE));
    if (!ok) return (int)cudaErrorInvalidValue;
  }
  const dim3 grid((N + tc::BN - 1) / tc::BN, (M + 32 * MT - 1) / (32 * MT));
  tc::q4_matmul_bf16_kernel<MT, TMA><<<grid, tc::THREADS, smem, stream>>>(
      (const __nv_bfloat16*)x, (const uint8_t*)packed, (const float*)scales,
      (const float*)mins, (float*)out, M, K, N, maps);
  return (int)cudaGetLastError();
}

// BM = 64 when the grid still gives every SM a tile, else 32; TMA loads
// when N's row stride is a multiple of 16 bytes, else cp.async.
int launch_bf16(const void* x, const void* packed, const void* scales,
                const void* mins, void* out, int M, int K, int N,
                cudaStream_t stream) {
  const long long tiles64 =
      (long long)((N + tc::BN - 1) / tc::BN) * ((M + 63) / 64);
  const bool big = tiles64 >= hopper::sm_count(), tma = N % 16 == 0;
  const auto launch = big ? (tma ? launch_tc<2, true> : launch_tc<2, false>)
                          : (tma ? launch_tc<1, true> : launch_tc<1, false>);
  return launch(x, packed, scales, mins, out, M, K, N, stream);
}

bool valid(int M, int K, int N) {
  return M > 0 && N > 0 && K > 0 && K % BK == 0;
}

}  // namespace

extern "C" int q4_matmul_f32(const void* x, const void* packed,
                             const void* scales, const void* mins, void* out,
                             int M, int K, int N, void* stream) {
  if (!valid(M, K, N)) return (int)cudaErrorInvalidValue;
  return launch_f32(x, packed, scales, mins, out, M, K, N,
                    (cudaStream_t)stream);
}

extern "C" int q4_matmul_bf16(const void* x, const void* packed,
                              const void* scales, const void* mins, void* out,
                              int M, int K, int N, void* stream) {
  if (!valid(M, K, N)) return (int)cudaErrorInvalidValue;
  return launch_bf16(x, packed, scales, mins, out, M, K, N,
                     (cudaStream_t)stream);
}
