// Mixture-of-experts layer of DeepSeek-V2 for Hopper (sm_90a): the
// routing (softmax over the router's f32 logits, greedy top-k, a stable
// counting sort of the (token, choice) pairs by expert, the tile table of
// the sorted rows), the grouped Q4_0 product over the experts, and the
// fixed-order combine of each token's weighted expert outputs.
//
// Replaces no TPU kernel: the JAX package has no mixture of experts. The
// layer runs inside one CUDA graph a batch shape: the per-expert counts,
// offsets and tiles live on the device and no kernel returns anything to
// the host, so the grid of the grouped product is the most tiles any
// routing can make (ceil(R / 64) + E for R = M * k sorted rows) and a
// block past the routing's tile count returns at once.
//
// Routing (moe_topk, moe_sort). moe_topk: one warp a token, two experts a
// lane (E <= 64): the softmax in f32 (expf), then k rounds of a warp
// argmax, ties to the lower expert; the weights are the probabilities
// times the routed scale, not renormalised (DeepSeek-V2-Lite's greedy
// method). moe_sort: one block an expert; each counts the whole routing
// (a shared-memory histogram), so each knows its offset and its first
// tile, and then walks the pairs in (token, choice) order and places its
// own by a block-wide scan: stable, so the rows of an expert are its
// tokens in order and the placement is the same on every run. Block e
// writes its tiles (expert, first row, end row) and adds its count to the
// layer's token counter (BertTorch.stats()["experts"]). Both are bound by
// latency at these sizes (R = 6 * M int32s, at most 1.2 MB, read from L2
// twice by each of the E blocks).
//
// The grouped product (expert_q4_matmul_*). What bounds it: operations.
// At M = 32,768 tokens the routed experts' gate and up product is 2 * 6M
// * 2,048 * 2,816 = 2.27 TFLOP (2.3 ms at 989 TFLOP/s) against 2.4 GB of
// all 64 experts' Q4_0 weights, the gathered rows and the output (0.7 ms
// at 3.35 TB/s). Design: q4_matmul.cu's mma.sync bf16 instance, made
// grouped. A block of 4 warps owns a tile of 64 sorted rows of one expert
// and 64 columns; it reads its (expert, rows) from the tile table and
// gathers its rows by cp.async (the gate and up product reads token rows
// through the sorted order, the down product the sorted rows in place;
// rows past the expert's end are zero-filled and never stored), walks K a
// 64-row group at a time through 3-slot rings of x and of the Q4 band of
// the expert's weight (the group-local layout of quant.py, E weights
// stacked), dequantizes a band into a bf16 W tile in shared memory ((c -
// 8) * s in f32, rounded once, as q4_matmul does) while the warps multiply
// the previous one, and runs mma.sync.m16n8k16 with f32 accumulation. Each
// output is summed by one accumulator, k in order: no split-K, no atomics.
// The gate and up form (SWIGLU) takes a weight whose columns interleave
// gate and up in runs of 8 (deepseek_v2.py lays them so at load), so that
// a thread holds each gate value beside its up value, and writes
// silu(gate) * up in f32, rounded once to bf16: [R, N / 2].
//
// The combine (moe_combine): out[t] = shared[t] + sum over j of w[t, j] *
// y[pos(t, j)], in f32, the shared experts' product first and the choices
// in order: the same sum on every run (no float atomics). One block a
// token, 8 elements a thread; bound by bytes (13 KB a token at D = 2,048).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int BM = 64;   // sorted rows a tile
constexpr int BN = 64;   // output columns a block
constexpr int BK = 64;   // one group-local group of K rows
constexpr int QK = 32;   // quantization block
constexpr int THREADS = 128;
constexpr int STAGES = 3;
constexpr int XS = BK + 8;  // x tile row: 144 bytes
constexpr int WS = BN + 8;  // W tile row: 144 bytes
constexpr int SORT_THREADS = 1024;
constexpr int ITEMS = 8;  // pairs a thread per step of the sort

// ---------------------------------------------------------------- routing

__global__ void topk_kernel(const float* __restrict__ logits, int M, int E,
                            int K, float scaling, int* __restrict__ topi,
                            float* __restrict__ topw) {
  const int t = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (t >= M) return;
  const float* l = logits + (size_t)t * E;
  const float v0 = lane < E ? l[lane] : -CUDART_INF_F;
  const float v1 = lane + 32 < E ? l[lane + 32] : -CUDART_INF_F;
  float mx = fmaxf(v0, v1);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
  float e0 = lane < E ? expf(v0 - mx) : 0.f;
  float e1 = lane + 32 < E ? expf(v1 - mx) : 0.f;
  float sum = e0 + e1;
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    sum += __shfl_xor_sync(0xffffffffu, sum, o);
  float p0 = lane < E ? e0 / sum : -1.f;
  float p1 = lane + 32 < E ? e1 / sum : -1.f;
  for (int k = 0; k < K; ++k) {
    // the lane's best (ties: the lower expert), then the warp's
    float bv = p0;
    int bi = lane;
    if (p1 > p0) {
      bv = p1;
      bi = lane + 32;
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) {
      const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
      if (ov > bv || (ov == bv && oi < bi)) {
        bv = ov;
        bi = oi;
      }
    }
    if (lane == 0) {
      topi[(size_t)t * K + k] = bi;
      topw[(size_t)t * K + k] = bv * scaling;
    }
    if (bi == lane) p0 = -1.f;
    if (bi == lane + 32) p1 = -1.f;
  }
}

// inclusive scan of v over the block (SORT_THREADS threads); *total gets
// the block's sum
__device__ __forceinline__ int block_scan(int v, int* warp_tot, int* total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int u = __shfl_up_sync(0xffffffffu, v, o);
    if (lane >= o) v += u;
  }
  if (lane == 31) warp_tot[warp] = v;
  __syncthreads();
  if (warp == 0) {
    int w = warp_tot[lane];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int u = __shfl_up_sync(0xffffffffu, w, o);
      if (lane >= o) w += u;
    }
    warp_tot[lane] = w;  // inclusive over warps
    if (lane == 31) *total = w;
  }
  __syncthreads();
  return v + (warp > 0 ? warp_tot[warp - 1] : 0);
}

__global__ void __launch_bounds__(SORT_THREADS)
    sort_kernel(const int* __restrict__ topi, int R, int K, int E,
                int* __restrict__ sorted_tok, int* __restrict__ slot_pos,
                int* __restrict__ counts, int* __restrict__ tile_e,
                int* __restrict__ tile_r0, int* __restrict__ tile_r1,
                int* __restrict__ n_tiles, long long* __restrict__ acc) {
  __shared__ int hist[64];
  __shared__ int warp_tot[32];
  __shared__ int total;
  __shared__ int off_s, tile0_s;
  const int e = blockIdx.x, tid = threadIdx.x;
  if (tid < 64) hist[tid] = 0;
  __syncthreads();
  for (int i = tid; i < R; i += SORT_THREADS) atomicAdd(&hist[topi[i]], 1);
  __syncthreads();
  if (tid == 0) {
    int off = 0, tiles = 0, all_tiles = 0;
    for (int x = 0; x < E; ++x) {
      const int nt = (hist[x] + BM - 1) / BM;
      if (x < e) {
        off += hist[x];
        tiles += nt;
      }
      all_tiles += nt;
    }
    off_s = off;
    tile0_s = tiles;
    counts[e] = hist[e];
    if (e == 0) *n_tiles = all_tiles;
    if (acc != nullptr) acc[e] += hist[e];
  }
  __syncthreads();
  const int c = hist[e], off = off_s, tile0 = tile0_s;
  for (int i = tid; i < (c + BM - 1) / BM; i += SORT_THREADS) {
    tile_e[tile0 + i] = e;
    tile_r0[tile0 + i] = off + i * BM;
    tile_r1[tile0 + i] = off + c;
  }
  int running = 0;
  for (int start = 0; start < R; start += SORT_THREADS * ITEMS) {
    const int first = start + tid * ITEMS;
    int mine = 0;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      mine += (first + j < R && topi[first + j] == e) ? 1 : 0;
    const int incl = block_scan(mine, warp_tot, &total);
    int pos = off + running + incl - mine;
#pragma unroll
    for (int j = 0; j < ITEMS; ++j)
      if (first + j < R && topi[first + j] == e) {
        sorted_tok[pos] = (first + j) / K;
        slot_pos[first + j] = pos;
        ++pos;
      }
    running += total;
    __syncthreads();  // total and warp_tot are rewritten by the next step
  }
}

// ------------------------------------------------------ grouped product

struct Smem {
  alignas(128) bf16 x[STAGES][BM][XS];
  alignas(128) uint8_t band[STAGES][QK][BN];
  alignas(128) float sc[STAGES][2][BN];
  alignas(128) bf16 w[2][BK][WS];
  int src[BM];
};

// load group j: x of group j and the band of group j+1 (group 0 also
// brings band 0)
__device__ __forceinline__ void load_group(
    Smem& s, int j, int groups, const bf16* __restrict__ x, int ldx,
    const uint8_t* __restrict__ pk, const float* __restrict__ sc, int N,
    int n0, int rows) {
  const int tid = threadIdx.x;
  if (j < groups) {
    const int st = j % STAGES;
    for (int i = tid; i < BM * (BK / 8); i += THREADS) {
      const int r = i / (BK / 8), c = i % (BK / 8);
      const bool ok = r < rows;
      const bf16* src = x + (size_t)(ok ? s.src[r] : 0) * ldx + j * BK + c * 8;
      hopper::cp_async16(&s.x[st][r][c * 8], src, ok);
    }
  }
  const int b0 = j == 0 ? 0 : j + 1, b1 = j + 1;
  for (int g = b0; g <= b1; ++g) {
    if (g >= groups) continue;
    const int st = g % STAGES;
    {  // 32 rows x 64 bytes: one 16-byte chunk a thread
      const int r = tid >> 2, c = (tid & 3) * 16;
      hopper::cp_async16(&s.band[st][r][c],
                         pk + (size_t)(g * QK + r) * N + n0 + c, true);
    }
    if (tid < 32) {  // 2 rows x 64 f32
      const int r = tid >> 4, c = (tid & 15) * 4;
      hopper::cp_async16(&s.sc[st][r][c],
                         sc + (size_t)(2 * g + r) * N + n0 + c, true);
    }
  }
  hopper::cp_async_commit();
}

// band of slot st -> W tile wb (q4_matmul.cu's dequantize, Q4_0)
__device__ __forceinline__ void dequantize(Smem& s, int st, int wb) {
  const int tid = threadIdx.x;
  const int c = (tid & 15) * 4;
  const float4 s0 = *reinterpret_cast<const float4*>(&s.sc[st][0][c]);
  const float4 s1 = *reinterpret_cast<const float4*>(&s.sc[st][1][c]);
  const float sl[4] = {s0.x, s0.y, s0.z, s0.w};
  const float sh[4] = {s1.x, s1.y, s1.z, s1.w};
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int r = (tid >> 4) + 8 * j;
    const uint32_t word =
        *reinterpret_cast<const uint32_t*>(&s.band[st][r][c]);
    float lo[4], hi[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int b = (word >> (8 * i)) & 0xFF;
      lo[i] = __fmul_rn((float)((b & 0xF) - 8), sl[i]);
      hi[i] = __fmul_rn((float)((b >> 4) - 8), sh[i]);
    }
    *reinterpret_cast<uint2*>(&s.w[wb][r][c]) = make_uint2(
        hopper::pack_bf16(lo[0], lo[1]), hopper::pack_bf16(lo[2], lo[3]));
    *reinterpret_cast<uint2*>(&s.w[wb][r + QK][c]) = make_uint2(
        hopper::pack_bf16(hi[0], hi[1]), hopper::pack_bf16(hi[2], hi[3]));
  }
}

__device__ __forceinline__ float silu(float v) {
  return v / (1.f + expf(-v));
}

template <bool SWIGLU>
__global__ void __launch_bounds__(THREADS)
    expert_matmul_kernel(const bf16* __restrict__ x, int ldx,
                  const int* __restrict__ gather,
                  const uint8_t* __restrict__ packed,
                  const float* __restrict__ scales,
                  const int* __restrict__ tile_e,
                  const int* __restrict__ tile_r0,
                  const int* __restrict__ tile_r1,
                  const int* __restrict__ n_tiles, bf16* __restrict__ out,
                  int ldo, int K, int N) {
  const int tile = blockIdx.y;
  if (tile >= *n_tiles) return;
  extern __shared__ unsigned char smem_raw[];
  Smem& s = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 127) & ~uintptr_t(127));
  const int e = tile_e[tile], r0 = tile_r0[tile];
  const int rows = min(BM, tile_r1[tile] - r0);
  const int n0 = blockIdx.x * BN;
  const uint8_t* pk = packed + (size_t)e * (K / 2) * N;
  const float* sc = scales + (size_t)e * (K / QK) * N;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int groups = K / BK;
  if (tid < BM)
    s.src[tid] = tid < rows ? (gather != nullptr ? gather[r0 + tid] : r0 + tid)
                            : 0;
  __syncthreads();

  float acc[2][4][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[i][j][q] = 0.f;

#pragma unroll
  for (int j = 0; j < STAGES - 1; ++j)
    load_group(s, j, groups, x, ldx, pk, sc, N, n0, rows);
  hopper::cp_async_wait<STAGES - 2>();
  __syncthreads();
  dequantize(s, 0, 0);

  for (int g = 0; g < groups; ++g) {
    const int st = g % STAGES, wb = g & 1;
    hopper::cp_async_wait<STAGES - 2>();  // x of g and band of g+1
    __syncthreads();  // ... for every thread; W of g is complete
    load_group(s, g + STAGES - 1, groups, x, ldx, pk, sc, N, n0, rows);
#pragma unroll
    for (int kk = 0; kk < BK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
        hopper::ldsm_x4(a[mt], &s.x[st][wm * 32 + mt * 16 + (lane & 15)]
                                   [kk * 16 + (lane >> 4) * 8]);
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t r[4];
        hopper::ldsm_x4_trans(r, &s.w[wb][kk * 16 + (lane & 15)]
                                     [wn * 32 + np * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          hopper::mma_bf16(acc[mt][2 * np], a[mt], r[0], r[1]);
          hopper::mma_bf16(acc[mt][2 * np + 1], a[mt], r[2], r[3]);
        }
      }
    }
    if (g + 1 < groups) dequantize(s, (g + 1) % STAGES, wb ^ 1);
  }

  const int gq = lane >> 2, t4 = lane & 3;
#pragma unroll
  for (int mt = 0; mt < 2; ++mt)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = wm * 32 + mt * 16 + gq + half * 8;
      if (m >= rows) continue;
      bf16* o = out + (size_t)(r0 + m) * ldo;
      if constexpr (SWIGLU) {
#pragma unroll
        for (int p = 0; p < 2; ++p) {  // n8 tiles 2p (gate), 2p+1 (up)
          const int col = n0 / 2 + wn * 16 + p * 8 + 2 * t4;
          const float h0 = silu(acc[mt][2 * p][2 * half]) *
                           acc[mt][2 * p + 1][2 * half];
          const float h1 = silu(acc[mt][2 * p][2 * half + 1]) *
                           acc[mt][2 * p + 1][2 * half + 1];
          *reinterpret_cast<uint32_t*>(o + col) = hopper::pack_bf16(h0, h1);
        }
      } else {
#pragma unroll
        for (int nt = 0; nt < 4; ++nt) {
          const int col = n0 + wn * 32 + nt * 8 + 2 * t4;
          *reinterpret_cast<uint32_t*>(o + col) = hopper::pack_bf16(
              acc[mt][nt][2 * half], acc[mt][nt][2 * half + 1]);
        }
      }
    }
}

// ---------------------------------------------------------------- combine

__global__ void combine_kernel(const float* __restrict__ shared,
                               const bf16* __restrict__ y,
                               const float* __restrict__ w,
                               const int* __restrict__ pos, float* __restrict__ out,
                               int K, int D) {
  const int t = blockIdx.x;
  for (int c = threadIdx.x * 8; c < D; c += blockDim.x * 8) {
    float a[8];
    const float4 s0 = *reinterpret_cast<const float4*>(shared + (size_t)t * D + c);
    const float4 s1 =
        *reinterpret_cast<const float4*>(shared + (size_t)t * D + c + 4);
    a[0] = s0.x; a[1] = s0.y; a[2] = s0.z; a[3] = s0.w;
    a[4] = s1.x; a[5] = s1.y; a[6] = s1.z; a[7] = s1.w;
    for (int j = 0; j < K; ++j) {
      const float wj = w[(size_t)t * K + j];
      const uint4 u =
          *reinterpret_cast<const uint4*>(y + (size_t)pos[(size_t)t * K + j] * D + c);
      const uint32_t v[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float2 f = hopper::unpack_bf16(v[i]);
        a[2 * i] = __fadd_rn(a[2 * i], __fmul_rn(wj, f.x));
        a[2 * i + 1] = __fadd_rn(a[2 * i + 1], __fmul_rn(wj, f.y));
      }
    }
    *reinterpret_cast<float4*>(out + (size_t)t * D + c) =
        make_float4(a[0], a[1], a[2], a[3]);
    *reinterpret_cast<float4*>(out + (size_t)t * D + c + 4) =
        make_float4(a[4], a[5], a[6], a[7]);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// topi, topw [M, K]: the K largest of softmax(logits [M, E]) in
// descending order, the weights times `scaling`
extern "C" int moe_topk(const void* logits, int M, int E, int K,
                        float scaling, void* topi, void* topw, void* stream) {
  if (M <= 0 || E <= 0 || E > 64 || K <= 0 || K > E)
    return (int)cudaErrorInvalidValue;
  const int warps = 8;
  topk_kernel<<<(M + warps - 1) / warps, warps * 32, 0,
                (cudaStream_t)stream>>>((const float*)logits, M, E, K, scaling,
                                        (int*)topi, (float*)topw);
  return (int)cudaGetLastError();
}

// The stable counting sort of the R = M * K pairs of topi by expert:
// sorted_tok [R] (the token of each sorted row), slot_pos [R] (the sorted
// row of each pair), counts [E], the tile table (tile_e, tile_r0, tile_r1
// [ceil(R / 64) + E]) and n_tiles [1]; acc [E] int64 (nullable) += counts
extern "C" int moe_sort(const void* topi, int R, int K, int E,
                        void* sorted_tok, void* slot_pos, void* counts,
                        void* tile_e, void* tile_r0, void* tile_r1,
                        void* n_tiles, void* acc, void* stream) {
  if (R <= 0 || K <= 0 || E <= 0 || E > 64) return (int)cudaErrorInvalidValue;
  sort_kernel<<<E, SORT_THREADS, 0, (cudaStream_t)stream>>>(
      (const int*)topi, R, K, E, (int*)sorted_tok, (int*)slot_pos,
      (int*)counts, (int*)tile_e, (int*)tile_r0, (int*)tile_r1,
      (int*)n_tiles, (long long*)acc);
  return (int)cudaGetLastError();
}

// out [R, N] (or [R, N / 2] with swiglu) bf16 = the sorted rows' products
// with their experts' Q4_0 weights (packed [E, K/2, N], scales [E, K/32,
// N]); the A rows are x[gather[r]] (gather null: x[r]), x [*, ldx] bf16
extern "C" int expert_q4_matmul_bf16(const void* x, int ldx,
                                     const void* gather, const void* packed,
                                     const void* scales, const void* tile_e,
                                     const void* tile_r0, const void* tile_r1,
                                     const void* n_tiles, int max_tiles,
                                     void* out, int ldo, int K, int N,
                                     int swiglu, void* stream) {
  if (K <= 0 || K % BK || N <= 0 || N % BN || ldx % 8 || ldo % 2 ||
      max_tiles <= 0 || max_tiles > 65535)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(x) || !aligned16(packed) || !aligned16(scales) ||
      !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  const int smem = (int)sizeof(Smem) + 128;
  static bool attr[2] = {false, false};
  if (!attr[swiglu ? 1 : 0]) {
    cudaFuncSetAttribute(swiglu ? expert_matmul_kernel<true> : expert_matmul_kernel<false>,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    attr[swiglu ? 1 : 0] = true;
  }
  const dim3 grid(N / BN, max_tiles);
  auto kernel = swiglu ? expert_matmul_kernel<true> : expert_matmul_kernel<false>;
  kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      (const bf16*)x, ldx, (const int*)gather, (const uint8_t*)packed,
      (const float*)scales, (const int*)tile_e, (const int*)tile_r0,
      (const int*)tile_r1, (const int*)n_tiles, (bf16*)out, ldo, K, N);
  return (int)cudaGetLastError();
}

// out [M, D] f32 = shared [M, D] f32 + sum_j w[t, j] * y[pos[t, j]] (y
// [R, D] bf16), in that order
extern "C" int moe_combine(const void* shared, const void* y, const void* w,
                           const void* pos, void* out, int M, int K, int D,
                           void* stream) {
  if (M <= 0 || K <= 0 || D <= 0 || D % 8) return (int)cudaErrorInvalidValue;
  if (!aligned16(shared) || !aligned16(y) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  combine_kernel<<<M, 256, 0, (cudaStream_t)stream>>>(
      (const float*)shared, (const bf16*)y, (const float*)w, (const int*)pos,
      (float*)out, K, D);
  return (int)cudaGetLastError();
}
