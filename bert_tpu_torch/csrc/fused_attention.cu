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
// 128x128 MXU and Mosaic's VMEM and are not carried over. The softmax runs
// from a finite running max (-FLT_MAX) and takes expf (no fast math).
//
// What bounds it on the H100: at the main path's shapes, bytes. Packed
// MiniLM rows (B=16, T=64, H=12, dh=32, bf16, pairwise bias) must read
// qkv (2.4 MB) and the bias (0.26 MB) and write the context (0.8 MB):
// 1.0 us at 3.35 TB/s, against 0.1 us for its 101 MFLOP on the tensor
// cores. At T=512 the flops grow with T^2 and lead. Either way a call is a
// few microseconds, so the latency of each key tile and the number of
// blocks in flight set its time.
//
// The bf16 instance (tensor cores, flash-attention-2 style). A block of 4
// warps owns 64 query rows of one (batch row, head); each warp owns 16
// rows. q comes straight from global memory into mma A fragments,
// scaled in registers. Key/value tiles of 64 rows stream through a
// double-buffered cp.async ring (rows padded to dh+8 bf16, so ldmatrix's
// eight row addresses hit distinct banks) while the warp's slice of the
// tile's bias is read from global memory into registers. S = q k^T runs
// as mma.sync.m16n8k16 (bf16 -> f32) with k^T's fragments from ldmatrix;
// the online softmax stays in registers (row max and sum over the 4 lanes
// of a quad by shuffles); p is rounded to bf16 in the S accumulator's own
// registers, which are then the A fragments of p v, with v's fragments from
// ldmatrix.trans, so p never touches shared memory. mma.sync plus cp.async
// and not wgmma plus TMA: a warp's share of a key tile is 16-32 mma.sync,
// so the time goes to the tile's loads and the softmax between the two
// products, not to the tensor cores' issue rate that wgmma raises; and
// mma.sync's fragments are registers the softmax can work on in place.
// Blocks of 2 warps (32 rows) would double the grid of the 1x512 bucket
// (96 -> 192 blocks) but measured slower there, as at every main-path
// shape (PERF.md): each block then loads every key tile for fewer rows.
// Keys past T are masked out of the max and the sum; rows past T are not
// stored. The wrapper checks that qkv is 16-byte aligned (both
// instances).
//
// The f32 instance: the same flash-attention-2 shape on the same tensor
// cores, with the Pallas kernel's Precision.HIGHEST in f32 (both dots,
// bert_tpu/ops/fused_attention.py:80-96), which the TPU's matrix unit runs
// as six bf16 products; so does this kernel. Each f32 operand is split
// into three bf16 parts (hi + mid + lo, exactly; hopper.cuh) and the six
// cross products down to 2^-16 of hi*hi are summed in f32, smallest first
// (not TF32, which keeps 10 bits and stays off package-wide). The tensor
// cores' f32 sums truncate, so no accumulator takes more than one key
// tile's products: S starts from zero each tile, and e v goes into a
// fresh accumulator that one IEEE FMA adds to the rescaled context
// (o = o * corr + e v). q is scaled by 1/sqrt(dh) in f32 (q's type) and split
// once into three sets of A fragments in registers. The key/value rows of
// a tile arrive by cp.async in f32 (16 or 32 KB); each thread splits the
// chunks it copied itself (so no barrier stands between copy and split)
// into three bf16 k and three bf16 v tiles, double buffered, from which
// ldmatrix and ldmatrix.trans feed the products as in the bf16 instance:
// after tile i's products a thread splits its part of tile i+1 and starts
// the copy of tile i+2, which then runs under tile i+1's products, and one
// barrier a tile hands the split tiles over (77 KB of shared memory at dh
// 32, 143 KB at dh 64). e = exp(s - m) stays f32 (the Pallas kernel's
// astype to q's type is a no-op in f32) and is split in the S
// accumulator's registers into three sets of A fragments for e v, six
// products again. The bound in f32 is max(bytes / 3.35 TB/s, 6 x the
// bf16 FLOPs / 989 TFLOP/s), beside 4*B*H*T^2*dh / 67 TFLOP/s on the CUDA
// cores.

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
constexpr int WARPS = 4;        // 16 query rows each
constexpr int BQ = 16 * WARPS;  // query rows per block
constexpr int BKV = 64;         // keys per tile
constexpr int NT = BKV / 8;     // n8 score tiles per key tile

// The bias of this lane's score entries in key tile k0: entry e of n8 tile
// nt is (row g + 8*(e/2), key k0 + 8*nt + 2*t + e%2). Keys past T read 0
// (they are masked later); so do rows past T.
__device__ __forceinline__ void load_bias(float (&bv)[NT][4],
                                          const float* __restrict__ bias,
                                          int b, int seq, int pairwise,
                                          int row0, int k0, int lane) {
  const bool even = (seq & 1) == 0;  // then a float2 at an even key is aligned
#pragma unroll
  for (int nt = 0; nt < NT; ++nt) {
    const int key = k0 + nt * 8 + (lane & 3) * 2;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const int qr = row0 + (lane >> 2) + 8 * hf;
      const float* p =
          pairwise ? bias + ((size_t)b * seq + qr) * seq + key
                   : bias + (size_t)b * seq + key;
      float v0 = 0.f, v1 = 0.f;
      if (qr < seq || !pairwise) {
        if (even) {
          if (key < seq) {
            const float2 v = *reinterpret_cast<const float2*>(p);
            v0 = v.x;
            v1 = v.y;
          }
        } else {
          if (key < seq) v0 = p[0];
          if (key + 1 < seq) v1 = p[1];
        }
      }
      bv[nt][2 * hf] = v0;
      bv[nt][2 * hf + 1] = v1;
    }
  }
}

// S's tile into scores: add the bias, drop keys past T to -FLT_MAX (in
// place), and move the running max m of rows g and g + 8 past the tile's;
// the sum l is rescaled by corr = exp(m_old - m_new), which the caller
// applies to the context.
__device__ __forceinline__ void online_max(float (&sa)[NT][4],
                                           const float (&sv)[NT][4],
                                           float (&m)[2], float (&l)[2],
                                           float (&corr)[2], int k0, int seq,
                                           int t) {
  float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + nt * 8 + 2 * t + (e & 1);
      const float v = key < seq ? sa[nt][e] + sv[nt][e] : -FLT_MAX;
      sa[nt][e] = v;
      mx[e >> 1] = fmaxf(mx[e >> 1], v);
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m[i], mx[i]);
    corr[i] = expf(m[i] - m_new);
    l[i] *= corr[i];
    m[i] = m_new;
  }
}

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync) fed by a cp.async ring
// ---------------------------------------------------------------------------

namespace tc {

template <int DH>
struct Smem {
  bf16 k[2][BKV][DH + 8];
  bf16 v[2][BKV][DH + 8];
};

// Issue the copies of key tile k0 (its k and v rows) into ring slot st;
// rows past T are zero-filled.
template <int DH>
__device__ __forceinline__ void load_tile(Smem<DH>& s, int st, int k0,
                                          const bf16* __restrict__ base,
                                          size_t row_stride, int seq) {
  constexpr int CH = DH / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < BKV * CH; i += 32 * WARPS) {
    const int j = i / CH, c = (i % CH) * 8;
    const bool ok = k0 + j < seq;
    const bf16* r = base + (size_t)(ok ? k0 + j : 0) * row_stride;
    hopper::cp_async16(&s.k[st][j][c], r + DH + c, ok);
    hopper::cp_async16(&s.v[st][j][c], r + 2 * DH + c, ok);
  }
}

template <int DH>
__global__ void __launch_bounds__(32 * WARPS)
    fused_attention_bf16_kernel(const bf16* __restrict__ qkv,
                                const float* __restrict__ bias,
                                bf16* __restrict__ out, int seq, int H,
                                int pairwise, float scale) {
  constexpr int KS = DH / 16;  // k16 steps over dh
  constexpr int OT = DH / 8;   // n8 tiles of the context
  __shared__ __align__(16) Smem<DH> s;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = blockIdx.x * BQ + warp * 16;  // this warp's first row
  const int D = H * DH;
  const size_t row_stride = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * seq * row_stride + (size_t)h * 3 * DH;
  const int n_tiles = (seq + BKV - 1) / BKV;
  const int g = lane >> 2, t = lane & 3;

  load_tile(s, 0, 0, base, row_stride, seq);
  hopper::cp_async_commit();

  // q's A fragments, pre-scaled in bf16 as the Pallas kernel does:
  // round(q * round(scale))
  const float scale_t = __bfloat162float(__float2bfloat16(scale));
  uint32_t qa[KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + g + 8 * (i & 1);
      const int d = kk * 16 + 2 * t + 8 * (i >> 1);
      uint32_t v = 0;
      if (r < seq) {
        const bf16* src = base + (size_t)r * row_stride + d;
        const float2 f =
            hopper::unpack_bf16(*reinterpret_cast<const uint32_t*>(src));
        v = hopper::pack_bf16(f.x * scale_t, f.y * scale_t);
      }
      qa[kk][i] = v;
    }

  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  // running max (finite, so m - m_new never yields NaN) and this lane's
  // part of the running sum, for rows g and g + 8
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1, k0 = it * BKV;
    if (it + 1 < n_tiles) {
      load_tile(s, st ^ 1, k0 + BKV, base, row_stride, seq);
      hopper::cp_async_commit();
    }
    float sv[NT][4];
    load_bias(sv, bias, b, seq, pairwise, row0, k0, lane);
    if (it + 1 < n_tiles)
      hopper::cp_async_wait<1>();
    else
      hopper::cp_async_wait<0>();
    __syncthreads();

    // S = q k^T, plus the bias; keys past T drop out at -FLT_MAX
    float sa[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[4];
        hopper::ldsm_x4(r, &s.k[st][np * 16 + (lane & 7) + ((lane >> 4) << 3)]
                               [kk * 16 + ((lane >> 3) & 1) * 8]);
        hopper::mma_bf16(sa[2 * np], qa[kk], r[0], r[1]);
        hopper::mma_bf16(sa[2 * np + 1], qa[kk], r[2], r[3]);
      }
    float corr[2];
    online_max(sa, sv, m, l, corr, k0, seq, t);
#pragma unroll
    for (int j = 0; j < OT; ++j) {
      o[j][0] *= corr[0];
      o[j][1] *= corr[0];
      o[j][2] *= corr[1];
      o[j][3] *= corr[1];
    }
    // p = round(exp(s - m)) in place: S's C fragments of n8 tiles 2u and
    // 2u+1 are the A fragment of k16 step u of p v
    uint32_t pa[NT / 2][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float p[4];
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[e] = __bfloat162float(__float2bfloat16(expf(sa[nt][e] - m[e >> 1])));
      l[0] += p[0] + p[1];
      l[1] += p[2] + p[3];
      pa[nt >> 1][2 * (nt & 1)] = hopper::pack_bf16(p[0], p[1]);
      pa[nt >> 1][2 * (nt & 1) + 1] = hopper::pack_bf16(p[2], p[3]);
    }
    // o += p v
#pragma unroll
    for (int u = 0; u < NT / 2; ++u)
#pragma unroll
      for (int dp = 0; dp < OT / 2; ++dp) {
        uint32_t r[4];
        hopper::ldsm_x4_trans(
            r, &s.v[st][u * 16 + (lane & 15)][dp * 16 + (lane >> 4) * 8]);
        hopper::mma_bf16(o[2 * dp], pa[u], r[0], r[1]);
        hopper::mma_bf16(o[2 * dp + 1], pa[u], r[2], r[3]);
      }
    __syncthreads();  // slot st is refilled by the next iteration's copy
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row0 + g + 8 * hf;
    if (r >= seq) continue;
    bf16* dst = out + ((size_t)b * seq + r) * D + (size_t)h * DH + 2 * t;
#pragma unroll
    for (int j = 0; j < OT; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j) = hopper::pack_bf16(
          o[j][2 * hf] / l[hf], o[j][2 * hf + 1] / l[hf]);
  }
}

}  // namespace tc

// ---------------------------------------------------------------------------
// f32: the same tensor cores, six products of split operands
// ---------------------------------------------------------------------------

namespace x6 {

template <int DH>
struct Smem {
  float kv[2][BKV][DH];         // the next tile's k and v rows, as copied
  bf16 k[2][3][BKV][DH + 8];    // [buffer][part]: hi, mid, lo
  bf16 v[2][3][BKV][DH + 8];
};

// Issue the copies of key tile k0's k and v rows into kv; rows past T are
// zero-filled. Thread i copies chunks i, i + 128, ... (split_tile's).
template <int DH>
__device__ __forceinline__ void load_tile(Smem<DH>& s, int k0,
                                          const float* __restrict__ base,
                                          size_t row_stride, int seq) {
  constexpr int CH = DH / 4;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < BKV * CH; i += 32 * WARPS) {
    const int j = i / CH, c = (i % CH) * 4;
    const bool ok = k0 + j < seq;
    const float* r = base + (size_t)(ok ? k0 + j : 0) * row_stride;
    hopper::cp_async16(&s.kv[0][j][c], r + DH + c, ok);
    hopper::cp_async16(&s.kv[1][j][c], r + 2 * DH + c, ok);
  }
  hopper::cp_async_commit();
}

// Wait for this thread's copies, then split them into buffer bf: the
// chunks are the ones this thread copied, so no block barrier is needed
// between copy and split; the compiler barrier keeps the reads of kv
// ahead of the next load_tile's copies into it.
template <int DH>
__device__ __forceinline__ void split_tile(Smem<DH>& s, int bf) {
  constexpr int CH = DH / 4;
  hopper::cp_async_wait<0>();
  for (int i = threadIdx.x; i < BKV * CH; i += 32 * WARPS) {
    const int j = i / CH, c = (i % CH) * 4;
#pragma unroll
    for (int w = 0; w < 2; ++w) {
      const float4 f = *reinterpret_cast<const float4*>(&s.kv[w][j][c]);
      uint32_t p0[3], p1[3];
      hopper::split_bf16x3(f.x, f.y, p0);
      hopper::split_bf16x3(f.z, f.w, p1);
      bf16(*dst)[BKV][DH + 8] = w ? s.v[bf] : s.k[bf];
#pragma unroll
      for (int p = 0; p < 3; ++p)
        *reinterpret_cast<uint2*>(&dst[p][j][c]) = make_uint2(p0[p], p1[p]);
    }
  }
  asm volatile("" ::: "memory");
}

template <int DH>
__global__ void __launch_bounds__(32 * WARPS)
    fused_attention_f32_kernel(const float* __restrict__ qkv,
                               const float* __restrict__ bias,
                               float* __restrict__ out, int seq, int H,
                               int pairwise, float scale) {
  constexpr int KS = DH / 16;  // k16 steps over dh
  constexpr int OT = DH / 8;   // n8 tiles of the context
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<DH>& s = *reinterpret_cast<Smem<DH>*>(smem_raw);

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = blockIdx.x * BQ + warp * 16;  // this warp's first row
  const int D = H * DH;
  const size_t row_stride = 3 * (size_t)D;
  const float* base =
      qkv + (size_t)b * seq * row_stride + (size_t)h * 3 * DH;
  const int n_tiles = (seq + BKV - 1) / BKV;
  const int g = lane >> 2, t = lane & 3;

  load_tile(s, 0, base, row_stride, seq);

  // q's A fragments: q * scale in f32, as the Pallas kernel scales q in
  // q's type, split three ways
  uint32_t qa[3][KS][4];
#pragma unroll
  for (int kk = 0; kk < KS; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = row0 + g + 8 * (i & 1);
      const int d = kk * 16 + 2 * t + 8 * (i >> 1);
      float2 f = make_float2(0.f, 0.f);
      if (r < seq)
        f = *reinterpret_cast<const float2*>(base + (size_t)r * row_stride +
                                             d);
      uint32_t p[3];
      hopper::split_bf16x3(__fmul_rn(f.x, scale), __fmul_rn(f.y, scale),
                           p);
#pragma unroll
      for (int q = 0; q < 3; ++q) qa[q][kk][i] = p[q];
    }

  float o[OT][4];
#pragma unroll
  for (int j = 0; j < OT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[j][e] = 0.f;
  float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f};

  split_tile(s, 0);
  if (n_tiles > 1) load_tile(s, BKV, base, row_stride, seq);

  for (int it = 0; it < n_tiles; ++it) {
    const int bf = it & 1, k0 = it * BKV;
    float sv[NT][4];
    load_bias(sv, bias, b, seq, pairwise, row0, k0, lane);
    __syncthreads();  // buffer bf is split; buffer bf^1 (tile it-1) is free

    // S = q k^T in six products, plus the bias
    float sa[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[nt][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t r[3][4];
#pragma unroll
        for (int q = 0; q < 3; ++q)
          hopper::ldsm_x4(
              r[q], &s.k[bf][q][np * 16 + (lane & 7) + ((lane >> 4) << 3)]
                               [kk * 16 + ((lane >> 3) & 1) * 8]);
#pragma unroll
        for (int p = 0; p < 6; ++p) {
          const int pa = hopper::x6_a(p), pb = hopper::x6_b(p);
          hopper::mma_bf16(sa[2 * np], qa[pa][kk], r[pb][0], r[pb][1]);
          hopper::mma_bf16(sa[2 * np + 1], qa[pa][kk], r[pb][2], r[pb][3]);
        }
      }
    float corr[2];
    online_max(sa, sv, m, l, corr, k0, seq, t);
    // e = exp(s - m) in f32, in place
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) sa[nt][e] = expf(sa[nt][e] - m[e >> 1]);
      l[0] += sa[nt][0] + sa[nt][1];
      l[1] += sa[nt][2] + sa[nt][3];
    }
    // o = o * corr + e v, e v in six products into a fresh accumulator
    // (the tensor cores' f32 sums truncate, so each tile's sum is taken
    // apart and added in IEEE f32); S's C fragments of n8 tiles 2u and
    // 2u+1, split three ways, are the A fragments of k16 step u
    float ot[OT][4];
#pragma unroll
    for (int j = 0; j < OT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) ot[j][e] = 0.f;
#pragma unroll
    for (int u = 0; u < NT / 2; ++u) {
      uint32_t ea[3][4], p[3];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int nt = 2 * u + (i >> 1), e = 2 * (i & 1);
        hopper::split_bf16x3(sa[nt][e], sa[nt][e + 1], p);
#pragma unroll
        for (int q = 0; q < 3; ++q) ea[q][i] = p[q];
      }
#pragma unroll
      for (int dp = 0; dp < OT / 2; ++dp) {
        uint32_t r[3][4];
#pragma unroll
        for (int q = 0; q < 3; ++q)
          hopper::ldsm_x4_trans(
              r[q], &s.v[bf][q][u * 16 + (lane & 15)]
                               [dp * 16 + (lane >> 4) * 8]);
#pragma unroll
        for (int p6 = 0; p6 < 6; ++p6) {
          const int pa = hopper::x6_a(p6), pb = hopper::x6_b(p6);
          hopper::mma_bf16(ot[2 * dp], ea[pa], r[pb][0], r[pb][1]);
          hopper::mma_bf16(ot[2 * dp + 1], ea[pa], r[pb][2], r[pb][3]);
        }
      }
    }
#pragma unroll
    for (int j = 0; j < OT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        o[j][e] = __fmaf_rn(o[j][e], corr[e >> 1], ot[j][e]);
    // the next tile: split it (every thread finished tile it-1 with
    // buffer bf^1 at the barrier above) and start the copy after it
    if (it + 1 < n_tiles) {
      split_tile(s, bf ^ 1);
      if (it + 2 < n_tiles)
        load_tile(s, k0 + 2 * BKV, base, row_stride, seq);
    }
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int hf = 0; hf < 2; ++hf) {
    const int r = row0 + g + 8 * hf;
    if (r >= seq) continue;
    float* dst = out + ((size_t)b * seq + r) * D + (size_t)h * DH + 2 * t;
#pragma unroll
    for (int j = 0; j < OT; ++j)
      *reinterpret_cast<float2*>(dst + 8 * j) =
          make_float2(o[j][2 * hf] / l[hf], o[j][2 * hf + 1] / l[hf]);
  }
}

// Launch the DH instance; its shared memory (above 48 KB) needs the limit
// raised, once per instance.
template <int DH>
int launch(const float* qkv, const float* bias, float* out, dim3 grid,
           int seq, int H, int pairwise, float scale, cudaStream_t st) {
  constexpr int smem = sizeof(Smem<DH>);
  static const cudaError_t attr = cudaFuncSetAttribute(
      fused_attention_f32_kernel<DH>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  fused_attention_f32_kernel<DH><<<grid, 32 * WARPS, smem, st>>>(
      qkv, bias, out, seq, H, pairwise, scale);
  return (int)cudaGetLastError();
}

}  // namespace x6

int launch_f32(const void* qkv, const void* bias, void* out, int B, int seq,
               int H, int dh, int pairwise, float scale, cudaStream_t st) {
  const dim3 grid((seq + BQ - 1) / BQ, H, B);
  const auto* q = (const float*)qkv;
  const auto* bp = (const float*)bias;
  if (dh == 32)
    return x6::launch<32>(q, bp, (float*)out, grid, seq, H, pairwise, scale,
                          st);
  if (dh == 64)
    return x6::launch<64>(q, bp, (float*)out, grid, seq, H, pairwise, scale,
                          st);
  return (int)cudaErrorInvalidValue;
}

int launch_bf16(const void* qkv, const void* bias, void* out, int B, int seq,
                int H, int dh, int pairwise, float scale, cudaStream_t st) {
  const dim3 grid((seq + BQ - 1) / BQ, H, B);
  const auto* q = (const __nv_bfloat16*)qkv;
  const auto* bp = (const float*)bias;
  auto* o = (__nv_bfloat16*)out;
  if (dh == 32) {
    tc::fused_attention_bf16_kernel<32><<<grid, 32 * WARPS, 0, st>>>(
        q, bp, o, seq, H, pairwise, scale);
  } else if (dh == 64) {
    tc::fused_attention_bf16_kernel<64><<<grid, 32 * WARPS, 0, st>>>(
        q, bp, o, seq, H, pairwise, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int fused_attention_f32(const void* qkv, const void* bias,
                                   void* out, int B, int seq, int H, int dh,
                                   int pairwise, float scale, void* stream) {
  if (B <= 0 || seq <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  return launch_f32(qkv, bias, out, B, seq, H, dh, pairwise, scale,
                    (cudaStream_t)stream);
}

extern "C" int fused_attention_bf16(const void* qkv, const void* bias,
                                    void* out, int B, int seq, int H, int dh,
                                    int pairwise, float scale, void* stream) {
  if (B <= 0 || seq <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  return launch_bf16(qkv, bias, out, B, seq, H, dh, pairwise, scale,
                     (cudaStream_t)stream);
}
