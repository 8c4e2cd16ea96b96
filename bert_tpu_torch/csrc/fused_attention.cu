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
// stored. The wrapper checks that qkv is 16-byte aligned.
//
// The f32 instance keeps the CUDA-core design (f32 must stay f32: TF32 is
// off package-wide): one 64-thread block per (64 query rows, head, batch
// row), each thread owning one query row, with key/value tiles of 32 rows
// staged in shared memory and the online softmax in f32.

#include <cfloat>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace {

// ---------------------------------------------------------------------------
// f32: CUDA cores
// ---------------------------------------------------------------------------

namespace simt {

constexpr int BQ = 64;   // queries per block, one per thread
constexpr int BKV = 32;  // keys per shared-memory tile

template <int DH>
__global__ void __launch_bounds__(BQ)
    fused_attention_f32_kernel(const float* __restrict__ qkv,
                               const float* __restrict__ bias,
                               float* __restrict__ out, int seq, int H,
                               int pairwise, float scale) {
  __shared__ float ks[BKV][DH];
  __shared__ float vs[BKV][DH];
  __shared__ float bs[BQ][BKV + 1];  // pairwise bias tile (+1: no conflicts)
  __shared__ float kb[BKV];          // key-side bias tile
  __shared__ float sc[BKV][BQ];      // the tile's scores, a column per thread

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int D = H * DH;
  const size_t row_stride = 3 * (size_t)D;
  const float* base = qkv + (size_t)b * seq * row_stride + (size_t)h * 3 * DH;
  const int qi = q0 + tid;
  const bool active = qi < seq;

  // q, pre-scaled as the Pallas kernel does
  float q[DH], acc[DH];
#pragma unroll
  for (int d = 0; d < DH; ++d) {
    q[d] = active ? base[(size_t)qi * row_stride + d] * scale : 0.f;
    acc[d] = 0.f;
  }
  float m = -FLT_MAX;  // running max; finite, so m - m_new never yields NaN
  float l = 0.f;       // running sum of the probabilities

  for (int k0 = 0; k0 < seq; k0 += BKV) {
    const int nk = min(BKV, seq - k0);
    __syncthreads();  // the previous tile has been consumed
    for (int i = tid; i < BKV * DH; i += BQ) {
      const int j = i / DH, d = i % DH;
      float kv = 0.f, vv = 0.f;
      if (j < nk) {
        const float* r = base + (size_t)(k0 + j) * row_stride;
        kv = r[DH + d];
        vv = r[2 * DH + d];
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
      const float p = expf(sc[j][tid] - m_new);
      l += p;
#pragma unroll
      for (int d = 0; d < DH; ++d) acc[d] = fmaf(p, vs[j][d], acc[d]);
    }
    m = m_new;
  }

  if (active) {
    float* o = out + ((size_t)b * seq + qi) * D + (size_t)h * DH;
#pragma unroll
    for (int d = 0; d < DH; ++d) o[d] = acc[d] / l;
  }
}

}  // namespace simt

// ---------------------------------------------------------------------------
// bf16: tensor cores (mma.sync) fed by a cp.async ring
// ---------------------------------------------------------------------------

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int WARPS = 4;     // 16 query rows each
constexpr int BQ = 16 * WARPS;  // query rows per block
constexpr int BKV = 64;      // keys per tile
constexpr int NT = BKV / 8;  // n8 score tiles per key tile

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
    float corr[2], m_new[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
      mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
      m_new[i] = fmaxf(m[i], mx[i]);
      corr[i] = expf(m[i] - m_new[i]);
      l[i] *= corr[i];
      m[i] = m_new[i];
    }
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
        p[e] = __bfloat162float(
            __float2bfloat16(expf(sa[nt][e] - m_new[e >> 1])));
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

int launch_f32(const void* qkv, const void* bias, void* out, int B, int seq,
               int H, int dh, int pairwise, float scale, cudaStream_t st) {
  const dim3 grid((seq + simt::BQ - 1) / simt::BQ, H, B);
  const auto* q = (const float*)qkv;
  const auto* bp = (const float*)bias;
  if (dh == 32) {
    simt::fused_attention_f32_kernel<32><<<grid, simt::BQ, 0, st>>>(
        q, bp, (float*)out, seq, H, pairwise, scale);
  } else if (dh == 64) {
    simt::fused_attention_f32_kernel<64><<<grid, simt::BQ, 0, st>>>(
        q, bp, (float*)out, seq, H, pairwise, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

int launch_bf16(const void* qkv, const void* bias, void* out, int B, int seq,
                int H, int dh, int pairwise, float scale, cudaStream_t st) {
  const dim3 grid((seq + tc::BQ - 1) / tc::BQ, H, B);
  const auto* q = (const __nv_bfloat16*)qkv;
  const auto* bp = (const float*)bias;
  auto* o = (__nv_bfloat16*)out;
  if (dh == 32) {
    tc::fused_attention_bf16_kernel<32><<<grid, 32 * tc::WARPS, 0, st>>>(
        q, bp, o, seq, H, pairwise, scale);
  } else if (dh == 64) {
    tc::fused_attention_bf16_kernel<64><<<grid, 32 * tc::WARPS, 0, st>>>(
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
