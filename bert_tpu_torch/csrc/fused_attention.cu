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
//
// The band form (ModernBERT's local layers; bert_tpu_torch/modernbert.py),
// a kernel of its own (fused_attention_band_*) so that BERT's instances
// above compile as they did and a trace tells it apart: it attends over the
// keys within `window` positions of the query, inclusive (|i - j| <=
// window). A band block visits only the key tiles that meet [q0 - window,
// q1 + window] of its rows q0..q1 (at BQ = BKV = 64 and window 64: 3 of
// the 128 tiles of T = 8,192) and drops the keys past the window inside
// them to -FLT_MAX, as it drops keys past T; a nullable counter adds up the
// tiles the blocks visit. ModernBERT's global layers run the instances
// above, and in bf16 at T >= 1,024 the long-T form below.
//
// RoPE (rope_qkv_*): one pass that rotates q and k of every head in place
// in qkv before the attention reads it (rotate-half: x'[d] = x[d] cos -
// x[d + dh/2] sin and x'[d + dh/2] = x[d + dh/2] cos + x[d] sin for d <
// dh/2, in f32, products and sum each rounded, then rounded to qkv's
// type), from f32 tables cos, sin [P, dh/2] and an optional int32 position
// array [B, T] (null: the row's index). A thread takes 16 bytes of lanes d
// and the matching 16 bytes of lanes d + dh/2 of one head's q or k. It
// reads and writes 2/3 of qkv once (0.4 GB at 8 x 8,192 in bf16); rotating
// inside the attention instead would rotate each k tile again for every
// query block that visits it (128 times a tile at T = 8,192).

// The long-T form (fused_attention_wgmma_bf16_kernel; ModernBERT's global
// layers: bf16, dh 64, key-side bias, T >= 1,024, ops/fused_attention.py's
// wgmma_route), a kernel of its own so that BERT's instances above compile
// as they did. It replaces the same Pallas _fused_attn_kernel, at long T,
// with the arithmetic above but for one step: exp(s - m) is the SFU's
// 2^((s - m) log2 e) (ex2.approx, results below 2^-126 flushed to 0), not
// expf, whose range reduction (seven more FMA-pipe instructions an
// exponential) set the pace here: 5.24 against 3.92 ms at 8 x 8,192 on the
// H100, all else equal. What bounds it: operations. At 8 x 8,192 (12
// heads) the two products are 1.65 TFLOP, 1.668 ms at 989 TFLOP/s, against
// 0.16 GB of qkv and context (0.05 ms at 3.35 TB/s); and its 6.4 G
// exponentials, on the SFU's 16 lanes an SM a cycle, take about as long,
// so the products, the exponentials and the softmax's other arithmetic
// have to run under each other. At these T a query block streams 8-64 key
// tiles, and the mma.sync instance's premise (few products a tile, the time
// in the loads and the softmax) no longer holds. Design (FA-3's shape):
//  - persistent blocks, one an SM, of 512 threads walking (query block of
//    192 rows, head, batch row) items, query blocks fastest; producer and
//    consumers walk the same items, so the ring runs on across them;
//  - a producer warp (setmaxnreg 24) keeps a 4-stage ring of key and value
//    tiles of 128 keys x 64 lanes (16 KB each) full by TMA on mbarriers:
//    one 2-D map over qkv's rows [B*T, 3D] in place (no relayout), 128-byte
//    swizzle, passed as a __grid_constant__ (CUDA graphs replay it); its 32
//    lanes stage the tile's key-side bias beside it (-inf for keys past T:
//    an exact 0 after exp, and never a row's max, since key 0 of every row
//    is real; the keys of the next batch row that a tile reaches are read
//    and masked so);
//  - three consumer warpgroups (setmaxnreg 160) of 64 query rows each. A
//    warpgroup scales its q rows once an item (in registers, as above) into
//    shared memory in the same swizzle. Per key tile: S = q k^T by four
//    wgmma.m64n128k16 (both operands by descriptor), f32; the online
//    softmax in registers (a row's max and sum over the 4 lanes of a quad);
//    p rounded to bf16 in place into the A fragments of o += p v, eight
//    wgmma.m64n64k16 with v as the transposed (MN-major) B operand. A
//    warpgroup issues the next tile's S and this tile's p v together, in
//    its turn on named barriers (0, 1, 2, 0, ...), and hands the turn on
//    once they retired: while one multiplies, the other two are in their
//    softmax (issued at once, the warpgroups fell into step: all
//    multiplying, then all in the softmax);
//  - the context is divided by the sum once, staged in shared memory and
//    written by 16-byte stores (rows past T are not stored).
// Rejected on the H100 (PERF.md, same call each): two consumer warpgroups
// of 128-row items (q in registers, two sets of p fragments), 4.28 against
// 3.92-3.97 ms at 8 x 8,192 (but 0.091 against 0.104 at 8 x 1,024, where
// 192-row blocks pad T); handing the turn over at issue (4.10 against
// 3.97); with two warpgroups, the row sums as eight columns of ones beside
// v (8% slower: the products, not the softmax's arithmetic, lead) and an
// FMA-folded exponent with skipped all-zero bias adds and unit rescales
// (20% slower: the exponentials then came back to back on the SFU).

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include "hopper.cuh"
#include "hopper_tma.cuh"

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

// S's tile into scores: add the bias, drop keys past T (and, in the band
// form, keys more than `window` from the lane's rows qg and qg + 8) to
// -FLT_MAX (in place), and move the running max m of rows g and g + 8 past
// the tile's; the sum l is rescaled by corr = exp(m_old - m_new), which the
// caller applies to the context.
template <bool BAND = false>
__device__ __forceinline__ void online_max(float (&sa)[NT][4],
                                           const float (&sv)[NT][4],
                                           float (&m)[2], float (&l)[2],
                                           float (&corr)[2], int k0, int seq,
                                           int t, int qg = 0,
                                           int window = 0) {
  float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
  for (int nt = 0; nt < NT; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int key = k0 + nt * 8 + 2 * t + (e & 1);
      bool in = key < seq;
      if constexpr (BAND) {
        const int dist = key - (qg + 8 * (e >> 1));
        in = in && dist <= window && dist >= -window;
      }
      const float v = in ? sa[nt][e] + sv[nt][e] : -FLT_MAX;
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

// The key tiles a block visits: every tile, or in the band form those
// that meet [q0 - window, q1 + window] for its rows q0..q1; the visits are
// added to `tiles` where it is given.
template <bool BAND>
__device__ __forceinline__ void tile_range(int seq, int window, int* tiles,
                                           int& lo, int& hi) {
  lo = 0;
  hi = (seq + BKV - 1) / BKV - 1;
  if constexpr (BAND) {
    const int q0 = blockIdx.x * BQ;
    const int q1 = min(seq, q0 + BQ) - 1;
    lo = max(0, q0 - window) / BKV;
    hi = min(seq - 1, q1 + window) / BKV;
    if (tiles != nullptr && threadIdx.x == 0) atomicAdd(tiles, hi - lo + 1);
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

template <int DH, bool BAND>
__device__ __forceinline__ void attend(const bf16* __restrict__ qkv,
                                       const float* __restrict__ bias,
                                       bf16* __restrict__ out, int seq, int H,
                                       int pairwise, float scale, int window,
                                       int* tiles) {
  constexpr int KS = DH / 16;  // k16 steps over dh
  constexpr int OT = DH / 8;   // n8 tiles of the context
  __shared__ __align__(16) Smem<DH> s;

  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.y, b = blockIdx.z;
  const int row0 = blockIdx.x * BQ + warp * 16;  // this warp's first row
  const int D = H * DH;
  const size_t row_stride = 3 * (size_t)D;
  const bf16* base = qkv + (size_t)b * seq * row_stride + (size_t)h * 3 * DH;
  int t_lo, t_hi;
  tile_range<BAND>(seq, window, tiles, t_lo, t_hi);
  const int g = lane >> 2, t = lane & 3;

  load_tile(s, 0, t_lo * BKV, base, row_stride, seq);
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

  for (int it = t_lo; it <= t_hi; ++it) {
    const int st = (it - t_lo) & 1, k0 = it * BKV;
    if (it < t_hi) {
      load_tile(s, st ^ 1, k0 + BKV, base, row_stride, seq);
      hopper::cp_async_commit();
    }
    float sv[NT][4];
    load_bias(sv, bias, b, seq, pairwise, row0, k0, lane);
    if (it < t_hi)
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
    online_max<BAND>(sa, sv, m, l, corr, k0, seq, t, row0 + g, window);
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

template <int DH>
__global__ void __launch_bounds__(32 * WARPS)
    fused_attention_bf16_kernel(const bf16* __restrict__ qkv,
                                const float* __restrict__ bias,
                                bf16* __restrict__ out, int seq, int H,
                                int pairwise, float scale) {
  attend<DH, false>(qkv, bias, out, seq, H, pairwise, scale, 0, nullptr);
}

template <int DH>
__global__ void __launch_bounds__(32 * WARPS)
    fused_attention_band_bf16_kernel(const bf16* __restrict__ qkv,
                                     const float* __restrict__ bias,
                                     bf16* __restrict__ out, int seq, int H,
                                     int pairwise, float scale, int window,
                                     int* tiles) {
  attend<DH, true>(qkv, bias, out, seq, H, pairwise, scale, window, tiles);
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

template <int DH, bool BAND>
__device__ __forceinline__ void attend(const float* __restrict__ qkv,
                                       const float* __restrict__ bias,
                                       float* __restrict__ out, int seq,
                                       int H, int pairwise, float scale,
                                       int window, int* tiles) {
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
  int t_lo, t_hi;
  tile_range<BAND>(seq, window, tiles, t_lo, t_hi);
  const int g = lane >> 2, t = lane & 3;

  load_tile(s, t_lo * BKV, base, row_stride, seq);

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
  if (t_lo < t_hi) load_tile(s, (t_lo + 1) * BKV, base, row_stride, seq);

  for (int it = t_lo; it <= t_hi; ++it) {
    const int bf = (it - t_lo) & 1, k0 = it * BKV;
    // the band instance reads the bias after the products: its 32
    // registers would otherwise be live across them, and it spilled
    float sv[NT][4];
    if constexpr (!BAND)
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
    if constexpr (BAND)
      load_bias(sv, bias, b, seq, pairwise, row0, k0, lane);
    float corr[2];
    online_max<BAND>(sa, sv, m, l, corr, k0, seq, t, row0 + g, window);
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
    if (it < t_hi) {
      split_tile(s, bf ^ 1);
      if (it + 1 < t_hi)
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

template <int DH>
__global__ void __launch_bounds__(32 * WARPS)
    fused_attention_f32_kernel(const float* __restrict__ qkv,
                               const float* __restrict__ bias,
                               float* __restrict__ out, int seq, int H,
                               int pairwise, float scale) {
  attend<DH, false>(qkv, bias, out, seq, H, pairwise, scale, 0, nullptr);
}

template <int DH>
__global__ void __launch_bounds__(32 * WARPS)
    fused_attention_band_f32_kernel(const float* __restrict__ qkv,
                                    const float* __restrict__ bias,
                                    float* __restrict__ out, int seq, int H,
                                    int pairwise, float scale, int window,
                                    int* tiles) {
  attend<DH, true>(qkv, bias, out, seq, H, pairwise, scale, window, tiles);
}

// Launch a kernel of the DH instance; its shared memory (above 48 KB)
// needs the limit raised, once per kernel.
template <int DH, typename K, typename... A>
int launch(K kernel, dim3 grid, cudaStream_t st, A... args) {
  constexpr int smem = sizeof(Smem<DH>);
  static const cudaError_t attr = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  kernel<<<grid, 32 * WARPS, smem, st>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace x6

int launch_f32(const void* qkv, const void* bias, void* out, int B, int seq,
               int H, int dh, int pairwise, float scale, cudaStream_t st) {
  const dim3 grid((seq + BQ - 1) / BQ, H, B);
  const auto* q = (const float*)qkv;
  const auto* bp = (const float*)bias;
  if (dh == 32)
    return x6::launch<32>(x6::fused_attention_f32_kernel<32>, grid, st, q,
                          bp, (float*)out, seq, H, pairwise, scale);
  if (dh == 64)
    return x6::launch<64>(x6::fused_attention_f32_kernel<64>, grid, st, q,
                          bp, (float*)out, seq, H, pairwise, scale);
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

// The band form (dh 64, ModernBERT's local layers)
int launch_band_f32(const void* qkv, const void* bias, void* out, int B,
                    int seq, int H, int dh, int pairwise, int window,
                    float scale, int* tiles, cudaStream_t st) {
  const dim3 grid((seq + BQ - 1) / BQ, H, B);
  if (dh != 64) return (int)cudaErrorInvalidValue;
  return x6::launch<64>(x6::fused_attention_band_f32_kernel<64>, grid, st,
                        (const float*)qkv, (const float*)bias, (float*)out,
                        seq, H, pairwise, scale, window, tiles);
}

int launch_band_bf16(const void* qkv, const void* bias, void* out, int B,
                     int seq, int H, int dh, int pairwise, int window,
                     float scale, int* tiles, cudaStream_t st) {
  const dim3 grid((seq + BQ - 1) / BQ, H, B);
  if (dh != 64) return (int)cudaErrorInvalidValue;
  tc::fused_attention_band_bf16_kernel<64><<<grid, 32 * WARPS, 0, st>>>(
      (const __nv_bfloat16*)qkv, (const float*)bias, (__nv_bfloat16*)out,
      seq, H, pairwise, scale, window, tiles);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// bf16 at long T: warp-specialised, wgmma on TMA-fed key/value tiles (the
// header's last form)
// ---------------------------------------------------------------------------

namespace wg {

constexpr int DH = 64;
constexpr int NC = 3;        // consumer warpgroups, 64 query rows each
constexpr int BM = 64 * NC;  // query rows of an item
constexpr int BN = 128;      // keys a tile
constexpr int SN = BN / 8;   // n8 column tiles of S
constexpr int STAGES = 4;
constexpr int THREADS = (NC + 1) * 128;  // the consumers, the producer's
// registers a thread after setmaxnreg: 128 each at launch (65,536 / 512);
// the producer's go to the consumers
constexpr int REG_P = 24, REG_C = 160;
// named barriers: a consumer's own (its q and context staging) and its turn
constexpr int BAR_STAGE = 1, BAR_TURN = 1 + NC;

struct Smem {
  // as TMA writes them: one key a 128-byte row, in the 128-byte swizzle
  alignas(1024) bf16 k[STAGES][BN][DH];
  alignas(1024) bf16 v[STAGES][BN][DH];
  // each consumer's 64 query rows, scaled, in the same swizzle
  alignas(1024) bf16 q[NC][64][DH];
  alignas(16) float bias[STAGES][BN];
  // each consumer's context, staged for 16-byte stores (rows of 144 bytes:
  // a quad's words land in distinct banks)
  alignas(16) bf16 o[NC][64][DH + 8];
  uint64_t full[STAGES], empty[STAGES];
};

#define WG_R8(i)                                                        \
  "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3]),           \
      "+f"(d[i + 4]), "+f"(d[i + 5]), "+f"(d[i + 6]), "+f"(d[i + 7])

// S (+)= q k^T over one k16 step of dh: A 64 x 16 of q and B 128 keys x
// 16, both K-major in shared memory (descriptors); scale_d = 0 overwrites
// S.
__device__ __forceinline__ void wgmma_s(float (&d)[4 * SN], uint64_t a,
                                        uint64_t b, int scale_d) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %66, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31, %32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, %48, %49, "
      "%50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : WG_R8(0), WG_R8(8), WG_R8(16), WG_R8(24), WG_R8(32), WG_R8(40),
        WG_R8(48), WG_R8(56)
      : "l"(a), "l"(b), "r"(scale_d));
}

// o += p v over one k16 step of keys: A 64 x 16 of p in registers (the
// mma.m16n8k16 A layout, a warp 16 rows), B 16 keys x 64 lanes of v, lanes
// contiguous in shared memory (MN-major: the transposed B operand,
// imm-trans-b 1).
__device__ __forceinline__ void wgmma_pv(float (&d)[DH / 2],
                                         const uint32_t (&a)[4], uint64_t b) {
  asm volatile(
      "{\n .reg .pred p;\n setp.ne.b32 p, %37, 0;\n"
      " wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, "
      "%10, %11, %12, %13, %14, %15, %16, %17, %18, %19, "
      "%20, %21, %22, %23, %24, %25, %26, %27, %28, %29, "
      "%30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : WG_R8(0), WG_R8(8), WG_R8(16), WG_R8(24)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(1));
}

#undef WG_R8

template <int N>
__device__ __forceinline__ void fence_all(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) hopper::fence_operand(r[i]);
}

// Keep the compiler from reusing a fragment's registers before the wgmma
// that reads them has retired (it reads them behind the compiler's back).
__device__ __forceinline__ void hold(uint32_t (&a)[BN / 16][4]) {
#pragma unroll
  for (int i = 0; i < BN / 16; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// exp(x) for x <= 0 as the SFU's 2^(x log2 e), results below 2^-126
// flushed to 0 (they round to 0 or to a bf16 subnormal after it): the
// header's exponential. x = s - m is formed first, as for expf, so that a
// row whose keys are all masked (scores near the mask's -1e9, m as large)
// still gets the plain version's exponents.
__device__ __forceinline__ float exp_sfu(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n"
      : "=f"(y)
      : "f"(__fmul_rn(x, 1.4426950408889634f)));
  return y;
}

// Two f32 values rounded to bf16 (nearest even) in one word, `lo` in the
// low half: one cvt (pack_bf16 goes through a bfloat162 and its halves).
__device__ __forceinline__ uint32_t bf16x2(float lo, float hi) {
  uint32_t r;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;\n" : "=r"(r) : "f"(hi), "f"(lo));
  return r;
}

// The online softmax of one tile's S (the wgmma accumulator: s[4j + e] is
// row g + 8 (e / 2) of the warp's 16, key 8j + 2t + e % 2 of the tile) with
// its staged bias: the running max m and sum l of rows g and g + 8 move
// past the tile's (corr = exp(m_old - m_new) rescales l here and the
// context at the caller), and p = round(exp(s - m)), summed as rounded,
// goes into the A fragments of p v: S's n8 tiles 2u and 2u + 1 are k16
// step u.
__device__ __forceinline__ void softmax(float (&s)[4 * SN],
                                        const float* __restrict__ bias,
                                        float (&m)[2], float (&l)[2],
                                        float (&corr)[2],
                                        uint32_t (&p)[BN / 16][4], int t) {
  float mx[2] = {-FLT_MAX, -FLT_MAX};
#pragma unroll
  for (int j = 0; j < SN; ++j) {
    const float2 bv = *reinterpret_cast<const float2*>(bias + 8 * j + 2 * t);
    s[4 * j] += bv.x;
    s[4 * j + 1] += bv.y;
    s[4 * j + 2] += bv.x;
    s[4 * j + 3] += bv.y;
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
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
#pragma unroll
  for (int j = 0; j < SN; ++j) {
#pragma unroll
    for (int hf = 0; hf < 2; ++hf) {
      const uint32_t w = bf16x2(exp_sfu(s[4 * j + 2 * hf] - m[hf]),
                                exp_sfu(s[4 * j + 2 * hf + 1] - m[hf]));
      l[hf] += __uint_as_float(w << 16) + __uint_as_float(w & 0xffff0000u);
      p[j >> 1][2 * (j & 1) + hf] = w;
    }
  }
}

// The item's query block, head and batch row: query blocks fastest, so the
// blocks in flight share their (batch row, head)'s keys in L2.
__device__ __forceinline__ void item(int v, int seq, int H, int& q0, int& h,
                                     int& b) {
  const int qb = (seq + BM - 1) / BM;
  q0 = v % qb * BM;
  h = v / qb % H;
  b = v / qb / H;
}

// The tensor cores in turns (the header's last design point): a consumer
// issues its products only in its turn and passes the turn to the next
// once they retired.
__device__ __forceinline__ void my_turn(int wgi) {
  hopper::named_bar_sync(BAR_TURN + wgi, 256);
}
__device__ __forceinline__ void your_turn(int wgi) {
  hopper::named_bar_arrive(BAR_TURN + (wgi + 1) % NC, 256);
}

// A consumer warpgroup's pass over key tile `it` of the item (ring slot
// (q + it) % STAGES, `q` the block's tiles before the item), in its turn:
// the next tile's S (where NEXT) and o += p v of this tile. Once both
// retired the turn passes and the slot is freed, and the next tile's
// softmax leaves its p in `p` and rescales o by its corr.
template <bool NEXT>
__device__ __forceinline__ void step(Smem& s, int q, int it, int wgi,
                                     float (&sacc)[4 * SN],
                                     float (&o)[DH / 2], float (&m)[2],
                                     float (&l)[2], uint32_t (&p)[BN / 16][4],
                                     int t) {
  const int st = (q + it) % STAGES, sn = (q + it + 1) % STAGES;
  if (NEXT) hopper::mbar_wait(&s.full[sn], ((q + it + 1) / STAGES) & 1);
  my_turn(wgi);
  fence_all(o);
  fence_all(sacc);
  hopper::wgmma_fence();
  if (NEXT) {
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_s(sacc, hopper::desc_sw128(&s.q[wgi][0][kk * 16]),
              hopper::desc_sw128(&s.k[sn][0][kk * 16]), kk > 0);
  }
#pragma unroll
  for (int u = 0; u < BN / 16; ++u)
    wgmma_pv(o, p[u], hopper::desc_sw128(&s.v[st][u * 16][0]));
  hopper::wgmma_commit();
  hopper::wgmma_wait<0>();
  your_turn(wgi);
  fence_all(o);
  fence_all(sacc);
  hold(p);
  __syncwarp();
  if ((threadIdx.x & 31) == 0) hopper::mbar_arrive(&s.empty[st]);
  if (NEXT) {
    float corr[2];
    softmax(sacc, s.bias[sn], m, l, corr, p, t);
#pragma unroll
    for (int j = 0; j < DH / 8; ++j) {
      o[4 * j] *= corr[0];
      o[4 * j + 1] *= corr[0];
      o[4 * j + 2] *= corr[1];
      o[4 * j + 3] *= corr[1];
    }
  }
}

__device__ __forceinline__ void consumer(Smem& s, const bf16* __restrict__ qkv,
                                         bf16* __restrict__ out, int seq,
                                         int H, int items, float scale) {
  const int wgi = threadIdx.x >> 7, warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int D = H * DH;
  const size_t row_stride = 3 * (size_t)D;
  const int tiles = (seq + BN - 1) / BN;
  const float scale_t = __bfloat162float(__float2bfloat16(scale));
  if (wgi == NC - 1) your_turn(wgi);  // the first turn is warpgroup 0's
  int q = 0;  // the block's key tiles before this item
  for (int v = blockIdx.x; v < items; v += gridDim.x, q += tiles) {
    int q0, h, b;
    item(v, seq, H, q0, h, b);
    const bf16* base = qkv + (size_t)b * seq * row_stride + (size_t)h * 3 * DH;
    // this warpgroup's 64 query rows, pre-scaled in bf16 (round(q *
    // round(scale))), into shared memory in the 128-byte swizzle: 16-byte
    // chunk c of row r at chunk c ^ (r % 8); rows past T are zero
#pragma unroll
    for (int i = 0; i < 64 * DH / 8 / 128; ++i) {
      const int c = (threadIdx.x & 127) + 128 * i, r = c >> 3, ch = c & 7;
      const int row = q0 + 64 * wgi + r;
      uint4 w = make_uint4(0, 0, 0, 0);
      if (row < seq) {
        w = *reinterpret_cast<const uint4*>(base + (size_t)row * row_stride +
                                            8 * ch);
        uint32_t* x = reinterpret_cast<uint32_t*>(&w);
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const float2 f = hopper::unpack_bf16(x[k]);
          x[k] = bf16x2(f.x * scale_t, f.y * scale_t);
        }
      }
      *reinterpret_cast<uint4*>(&s.q[wgi][r][8 * (ch ^ (r & 7))]) = w;
    }
    hopper::fence_proxy_async();  // the wgmma (async proxy) reads them
    hopper::named_bar_sync(BAR_STAGE + wgi, 128);
    float o[DH / 2], sacc[4 * SN];
#pragma unroll
    for (int i = 0; i < DH / 2; ++i) o[i] = 0.f;
    float m[2] = {-FLT_MAX, -FLT_MAX}, l[2] = {0.f, 0.f}, corr[2];
    uint32_t p[BN / 16][4];

    // the first tile's S and softmax (o is 0: its corr is moot)
    const int s0 = q % STAGES;
    hopper::mbar_wait(&s.full[s0], (q / STAGES) & 1);
    my_turn(wgi);
    fence_all(sacc);
    hopper::wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < DH / 16; ++kk)
      wgmma_s(sacc, hopper::desc_sw128(&s.q[wgi][0][kk * 16]),
              hopper::desc_sw128(&s.k[s0][0][kk * 16]), kk > 0);
    hopper::wgmma_commit();
    hopper::wgmma_wait<0>();
    your_turn(wgi);
    fence_all(sacc);
    softmax(sacc, s.bias[s0], m, l, corr, p, t);
    for (int it = 0; it + 1 < tiles; ++it)
      step<true>(s, q, it, wgi, sacc, o, m, l, p, t);
    step<false>(s, q, tiles - 1, wgi, sacc, o, m, l, p, t);

    // the context: o / l, staged, then 16-byte stores of rows below T
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    }
#pragma unroll
    for (int j = 0; j < DH / 8; ++j)
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        *reinterpret_cast<uint32_t*>(
            &s.o[wgi][16 * warp + g + 8 * hf][8 * j + 2 * t]) =
            bf16x2(o[4 * j + 2 * hf] / l[hf], o[4 * j + 2 * hf + 1] / l[hf]);
    hopper::named_bar_sync(BAR_STAGE + wgi, 128);
#pragma unroll
    for (int i = 0; i < 64 * DH / 8 / 128; ++i) {
      const int c = (threadIdx.x & 127) + 128 * i, r = c >> 3;
      const int row = q0 + 64 * wgi + r;
      if (row < seq)
        *reinterpret_cast<uint4*>(out + ((size_t)b * seq + row) * D +
                                  (size_t)h * DH + 8 * (c & 7)) =
            *reinterpret_cast<const uint4*>(&s.o[wgi][r][8 * (c & 7)]);
    }
    hopper::named_bar_sync(BAR_STAGE + wgi, 128);  // the staging is free
  }
  // the last warpgroup's last your_turn, met (every named barrier completes)
  if (wgi == 0) my_turn(wgi);
}

// Roles (threads): consumers 0-383, then the producer's warpgroup, of which
// one warp works. Items v = blockIdx.x, + gridDim.x, ...; q counts the
// block's key tiles over its items, and tile q uses ring stage q % STAGES.
__global__ void __launch_bounds__(THREADS, 1)
    fused_attention_wgmma_bf16_kernel(const __grid_constant__ CUtensorMap map,
                                      const bf16* __restrict__ qkv,
                                      const float* __restrict__ bias,
                                      bf16* __restrict__ out, int seq, int H,
                                      int items, float scale) {
  extern __shared__ unsigned char smem_raw[];
  // aligned by an offset from smem_raw, not through an integer, so that
  // the compiler still knows it for shared memory
  Smem& s = *reinterpret_cast<Smem*>(
      smem_raw + (-hopper::smem_addr(smem_raw) & 1023u));
  if (threadIdx.x == 0) {
    for (int i = 0; i < STAGES; ++i) {
      hopper::mbar_init<33>(&s.full[i]);  // the TMA's thread + 32 bias lanes
      hopper::mbar_init<4 * NC>(&s.empty[i]);  // the consumer warps
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x >= 128 * NC) {
    hopper::setmaxnreg_dec<REG_P>();
    if (threadIdx.x < 128 * NC + 32) {
      // producer: lane 0 issues the tiles' loads, every lane stages four
      // keys' bias (read before the slot is free, so the latency hides)
      const int lane = threadIdx.x & 31;
      const int tiles = (seq + BN - 1) / BN;
      int q = 0;
      for (int v = blockIdx.x; v < items; v += gridDim.x) {
        int q0, h, b;
        item(v, seq, H, q0, h, b);
        const float* brow = bias + (size_t)b * seq;
        for (int it = 0; it < tiles; ++it, ++q) {
          const int st = q % STAGES, k0 = it * BN;
          float bv[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const int key = k0 + 4 * lane + i;
            bv[i] = key < seq ? brow[key] : -CUDART_INF_F;
          }
          hopper::mbar_wait(&s.empty[st], ((q / STAGES) & 1) ^ 1);
          if (lane == 0) {
            uint64_t* bar = &s.full[st];
            hopper::mbar_expect(bar, 2 * BN * DH * 2);
            const int c = h * 3 * DH, r = b * seq + k0;
            hopper::tma_2d(&s.k[st][0][0], &map, c + DH, r, bar);
            hopper::tma_2d(&s.v[st][0][0], &map, c + 2 * DH, r, bar);
          }
          *reinterpret_cast<float4*>(&s.bias[st][4 * lane]) =
              make_float4(bv[0], bv[1], bv[2], bv[3]);
          hopper::mbar_arrive(&s.full[st]);
        }
      }
    }
  } else {
    hopper::setmaxnreg_inc<REG_C>();
    consumer(s, qkv, out, seq, H, items, scale);
  }
}

int launch(const void* qkv, const void* bias, void* out, int B, int seq,
           int H, float scale, cudaStream_t st) {
  constexpr int smem = sizeof(Smem) + 1024;
  static const cudaError_t attr = cudaFuncSetAttribute(
      fused_attention_wgmma_bf16_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (attr != cudaSuccess) return (int)attr;
  CUtensorMap map;
  memset(&map, 0, sizeof(map));
  const uint64_t cols = 3 * (uint64_t)H * DH;
  if (!hopper::encode_map(&map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, qkv, cols,
                          (uint64_t)B * seq, cols * 2, DH, BN,
                          CU_TENSOR_MAP_SWIZZLE_128B))
    return (int)cudaErrorInvalidValue;
  const int items = (seq + BM - 1) / BM * H * B;
  const int sms = hopper::sm_count();
  fused_attention_wgmma_bf16_kernel<<<items < sms ? items : sms, THREADS,
                                      smem, st>>>(
      map, (const bf16*)qkv, (const float*)bias, (bf16*)out, seq, H, items,
      scale);
  return (int)cudaGetLastError();
}

}  // namespace wg

// ---------------------------------------------------------------------------
// RoPE on q and k, in place
// ---------------------------------------------------------------------------

// The rotation of a pair of values (lane d and lane d + dh/2 of a head) by
// (c, s): (x c - y s, y c + x s), each product and the sum rounded (no
// fused multiply-add), as the plain version computes it
__device__ __forceinline__ void rotate(float& x, float& y, float c,
                                       float s) {
  const float x2 = __fsub_rn(__fmul_rn(x, c), __fmul_rn(y, s));
  y = __fadd_rn(__fmul_rn(y, c), __fmul_rn(x, s));
  x = x2;
}

// Eight values of either type as f32: a 16-byte chunk of bf16, or two of
// f32
template <typename T>
struct Lanes;

template <>
struct Lanes<bf16> {
  static __device__ __forceinline__ void load(const bf16* p, float (&v)[8]) {
    uint32_t w[4];
    *reinterpret_cast<uint4*>(w) = *reinterpret_cast<const uint4*>(p);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const float2 f = hopper::unpack_bf16(w[i]);
      v[2 * i] = f.x;
      v[2 * i + 1] = f.y;
    }
  }
  static __device__ __forceinline__ void store(bf16* p, const float (&v)[8]) {
    uint32_t w[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      w[i] = hopper::pack_bf16(v[2 * i], v[2 * i + 1]);
    *reinterpret_cast<uint4*>(p) = *reinterpret_cast<const uint4*>(w);
  }
};

template <>
struct Lanes<float> {
  static __device__ __forceinline__ void load(const float* p, float (&v)[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = p[i];
  }
  static __device__ __forceinline__ void store(float* p, const float (&v)[8]) {
#pragma unroll
    for (int i = 0; i < 8; ++i) p[i] = v[i];
  }
};

// One item: eight lanes d..d+7 (d < dh/2) of q or k of one head of one
// row, with their partners d + dh/2..; items run over (row, head, q/k,
// chunk), chunk fastest, so neighbouring threads touch neighbouring bytes
template <typename T>
__global__ void __launch_bounds__(256)
    rope_qkv_kernel(T* __restrict__ qkv, const float* __restrict__ cos,
                    const float* __restrict__ sin,
                    const int* __restrict__ pos, long long items, int seq,
                    int H, int dh) {
  const int chunks = dh / 16;  // eight-lane chunks of a half head
  for (long long it = blockIdx.x * (long long)blockDim.x + threadIdx.x;
       it < items; it += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(it % chunks) * 8;
    const long long hq = it / chunks;  // (row, head, q/k)
    const int which = (int)(hq % 2), h = (int)(hq / 2 % H);
    const long long row = hq / (2 * H);  // b * seq + i
    const int p = pos != nullptr ? pos[row] : (int)(row % seq);
    T* x = qkv + row * 3 * H * dh + (size_t)h * 3 * dh + which * dh + c;
    float lo[8], hi[8];
    Lanes<T>::load(x, lo);
    Lanes<T>::load(x + dh / 2, hi);
    const float* cs = cos + (size_t)p * (dh / 2) + c;
    const float* sn = sin + (size_t)p * (dh / 2) + c;
#pragma unroll
    for (int i = 0; i < 8; ++i) rotate(lo[i], hi[i], cs[i], sn[i]);
    Lanes<T>::store(x, lo);
    Lanes<T>::store(x + dh / 2, hi);
  }
}

template <typename T>
int launch_rope(void* qkv, const void* cos, const void* sin, const void* pos,
                int B, int seq, int H, int dh, cudaStream_t st) {
  if (dh % 16) return (int)cudaErrorInvalidValue;
  const long long items = (long long)B * seq * H * 2 * (dh / 16);
  const int threads = 256;
  const long long want = (items + threads - 1) / threads;
  const int blocks = (int)(want < (1 << 20) ? want : (1 << 20));
  rope_qkv_kernel<T><<<blocks, threads, 0, st>>>(
      (T*)qkv, (const float*)cos, (const float*)sin, (const int*)pos, items,
      seq, H, dh);
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

// The long-T form: bf16, dh 64, key-side bias [B, T] (the wrapper's
// wgmma_route)
extern "C" int fused_attention_wgmma_bf16(const void* qkv, const void* bias,
                                          void* out, int B, int seq, int H,
                                          int dh, float scale, void* stream) {
  if (B <= 0 || seq <= 0 || H <= 0 || dh != wg::DH)
    return (int)cudaErrorInvalidValue;
  return wg::launch(qkv, bias, out, B, seq, H, scale, (cudaStream_t)stream);
}

// The band |i - j| <= window (window > 0); tiles (nullable): the key tiles
// the blocks visit are added to it
extern "C" int fused_attention_band_f32(const void* qkv, const void* bias,
                                        void* out, int B, int seq, int H,
                                        int dh, int pairwise, int window,
                                        float scale, void* tiles,
                                        void* stream) {
  if (B <= 0 || seq <= 0 || H <= 0 || window <= 0)
    return (int)cudaErrorInvalidValue;
  return launch_band_f32(qkv, bias, out, B, seq, H, dh, pairwise, window,
                         scale, (int*)tiles, (cudaStream_t)stream);
}

extern "C" int fused_attention_band_bf16(const void* qkv, const void* bias,
                                         void* out, int B, int seq, int H,
                                         int dh, int pairwise, int window,
                                         float scale, void* tiles,
                                         void* stream) {
  if (B <= 0 || seq <= 0 || H <= 0 || window <= 0)
    return (int)cudaErrorInvalidValue;
  return launch_band_bf16(qkv, bias, out, B, seq, H, dh, pairwise, window,
                          scale, (int*)tiles, (cudaStream_t)stream);
}

// RoPE on q and k of qkv [B, T, 3D], in place, from cos, sin [P, dh/2] f32
// and positions [B, T] int32 (nullable: the index)
extern "C" int rope_qkv_f32(void* qkv, const void* cos, const void* sin,
                            const void* pos, int B, int seq, int H, int dh,
                            void* stream) {
  if (B <= 0 || seq <= 0 || H <= 0 || cos == nullptr || sin == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_rope<float>(qkv, cos, sin, pos, B, seq, H, dh,
                            (cudaStream_t)stream);
}

extern "C" int rope_qkv_bf16(void* qkv, const void* cos, const void* sin,
                             const void* pos, int B, int seq, int H, int dh,
                             void* stream) {
  if (B <= 0 || seq <= 0 || H <= 0 || cos == nullptr || sin == nullptr)
    return (int)cudaErrorInvalidValue;
  return launch_rope<__nv_bfloat16>(qkv, cos, sin, pos, B, seq, H, dh,
                                    (cudaStream_t)stream);
}
