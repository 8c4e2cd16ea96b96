// DeepSeek-V2's latent attention (MLA) in its expanded prefill form, for
// Hopper (sm_90a): the RoPE pass over the rope lanes of q and the one
// shared rope key a token, and a causal attention whose q.k width (192:
// 128 "nope" lanes and 64 rope lanes) differs from its v width (128).
//
// Replaces no TPU kernel: the JAX package has no causal attention and no
// latent attention. Its kernels are the nearest kin (fused_attention.cu's
// RoPE pass and flash-style attention), whose instances take one head dim
// for q, k and v and a key-side or pairwise mask; these take none.
//
// Operands, as the model's products leave them (no copy to a head-major
// layout, no expansion of the shared rope key):
//   q   [B*T, ldq]  bf16: head h's 192 lanes at h*192, nope then rope
//   kva [B*T, ldkv] bf16: the latent c at 0..rank-1, the rope key kr at
//                         rank..rank+63 (one for all heads)
//   kvb [B*T, ldkvb] bf16: head h's k_nope at h*256, its v at h*256+128
//   out [B*T, H*128] bf16: head h's context at h*128
// The rope lanes were de-interleaved at load (deepseek_v2.py), so the
// RoPE pass is rotate-half: lane i pairs with lane i+32 at frequency i.
//
// The RoPE pass (rope_mla_bf16): one thread a pair, in place, in f32 from
// the bf16 lanes, rounded back. Bytes bound: 2 * 64 lanes a head and 128
// bytes of kr a token read and written, under 1% of a layer's time.
//
// The attention (causal_mla_attention_bf16). What bounds it: operations.
// At T = 512 a row of 512 tokens costs 2 * 16 * (192 + 128) * 131,328
// causal pairs = 1.35 GFLOP against 8 MB of operands; at the bulk cell's
// T of 64-512 it is under 1% of the model's FLOPs. Right padding needs no
// mask: a real query's keys (j <= i) are all real, and a padding query's
// output is never read. Design: flash attention on mma.sync.m16n8k16
// (bf16 in, f32 accumulation). A block of 4 warps owns 64 queries of one
// (row, head); each warp 16 of them, whose q fragments (12 k16 steps of
// the 192 lanes) stay in registers. The block walks the key tiles of 64
// up to the diagonal (causal: the tiles past it are never loaded), each
// tile's k (192 lanes: k_nope from kvb, kr from kva) and v (128 lanes)
// copied into shared memory by cp.async (rows padded by 16 bytes, so
// ldmatrix's rows hit distinct banks); the scores go through an online
// softmax in f32 (exp2 of log2-scaled scores), the probabilities are
// rounded to bf16 into A fragments in registers, and v's B fragments come
// by ldmatrix.trans. Each output is summed in one accumulator in a fixed
// order: no split over keys, no atomics, so a call is deterministic. The
// query tiles nearest the end of a row (the most key tiles) launch first.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int DQK = 192, DV = 128, NOPE = 128, ROPE = 64;
constexpr int BQ = 64, BKV = 64, THREADS = 128;
constexpr int QS = DQK + 8;  // smem row of q and k: 400 bytes
constexpr int VS = DV + 8;   // smem row of v: 272 bytes
constexpr int SMEM = (BQ * QS + BKV * QS + BKV * VS) * 2;

// one thread a rotated pair: slot h < H is head h's rope lanes of q, slot
// H the token's kr; token t of each row at position t
__global__ void rope_mla_kernel(bf16* __restrict__ q, bf16* __restrict__ kva,
                                const float* __restrict__ cosv,
                                const float* __restrict__ sinv, int BT, int T,
                                int H, int ldq, int ldkv, int rank) {
  constexpr int HALF = ROPE / 2;
  const long long idx = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long per_tok = (long long)(H + 1) * HALF;
  if (idx >= (long long)BT * per_tok) return;
  const int tok = (int)(idx / per_tok);
  const int rem = (int)(idx % per_tok);
  const int slot = rem / HALF, i = rem % HALF;
  const int p = tok % T;
  const float c = cosv[(size_t)p * HALF + i], s = sinv[(size_t)p * HALF + i];
  bf16* base = slot < H ? q + (size_t)tok * ldq + slot * DQK + NOPE
                        : kva + (size_t)tok * ldkv + rank;
  const float x1 = __bfloat162float(base[i]);
  const float x2 = __bfloat162float(base[i + HALF]);
  base[i] = __float2bfloat16(x1 * c - x2 * s);
  base[i + HALF] = __float2bfloat16(x2 * c + x1 * s);
}

__global__ void __launch_bounds__(THREADS)
    causal_mla_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kva,
                      const bf16* __restrict__ kvb, bf16* __restrict__ out,
                      int T, int H, int ldq, int ldkv, int ldkvb, int rank,
                      float scale_log2) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Qs = reinterpret_cast<bf16*>(smem_raw);
  bf16* Ks = Qs + BQ * QS;
  bf16* Vs = Ks + BKV * QS;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int qt = gridDim.x - 1 - blockIdx.x;  // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * BQ;
  const size_t row0 = (size_t)b * T;

  // q tile: 64 rows x 24 chunks of 16 bytes
  for (int i = tid; i < BQ * (DQK / 8); i += THREADS) {
    const int r = i / (DQK / 8), c = i % (DQK / 8);
    const bool ok = q0 + r < T;
    const bf16* src = q + (row0 + (ok ? q0 + r : 0)) * ldq + h * DQK + c * 8;
    hopper::cp_async16(&Qs[r * QS + c * 8], src, ok);
  }
  hopper::cp_async_commit();

  const int g = lane >> 2, t4 = lane & 3;
  uint32_t qa[DQK / 16][4];
  float o[DV / 8][4];
#pragma unroll
  for (int i = 0; i < DV / 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[i][e] = 0.f;
  float m_r[2] = {-CUDART_INF_F, -CUDART_INF_F}, l_r[2] = {0.f, 0.f};
  const int qi0 = q0 + warp * 16 + g;  // this thread's rows: qi0, qi0 + 8

  for (int j = 0; j <= qt; ++j) {
    const int k0 = j * BKV;
    for (int i = tid; i < BKV * (DQK / 8); i += THREADS) {
      const int r = i / (DQK / 8), c = i % (DQK / 8);
      const bool ok = k0 + r < T;
      const size_t tok = row0 + (ok ? k0 + r : 0);
      const bf16* src =
          c < NOPE / 8 ? kvb + tok * ldkvb + h * (NOPE + DV) + c * 8
                       : kva + tok * ldkv + rank + (c - NOPE / 8) * 8;
      hopper::cp_async16(&Ks[r * QS + c * 8], src, ok);
    }
    for (int i = tid; i < BKV * (DV / 8); i += THREADS) {
      const int r = i / (DV / 8), c = i % (DV / 8);
      const bool ok = k0 + r < T;
      const size_t tok = row0 + (ok ? k0 + r : 0);
      hopper::cp_async16(&Vs[r * VS + c * 8],
                         kvb + tok * ldkvb + h * (NOPE + DV) + NOPE + c * 8,
                         ok);
    }
    hopper::cp_async_commit();
    hopper::cp_async_wait<0>();
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < DQK / 16; ++kk)
        hopper::ldsm_x4(qa[kk], &Qs[(warp * 16 + (lane & 15)) * QS +
                                    kk * 16 + (lane >> 4) * 8]);
    }

    // scores of the warp's 16 queries against the tile's 64 keys
    float s[BKV / 8][4];
#pragma unroll
    for (int i = 0; i < BKV / 8; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[i][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DQK / 16; ++kk) {
#pragma unroll
      for (int np = 0; np < BKV / 16; ++np) {
        uint32_t r[4];
        const int mi = lane >> 3;
        hopper::ldsm_x4(r, &Ks[(np * 16 + (mi >> 1) * 8 + (lane & 7)) * QS +
                               kk * 16 + (mi & 1) * 8]);
        hopper::mma_bf16(s[2 * np], qa[kk], r[0], r[1]);
        hopper::mma_bf16(s[2 * np + 1], qa[kk], r[2], r[3]);
      }
    }
    // causal mask (the diagonal tile only), then the online softmax
    float mx[2] = {m_r[0], m_r[1]};
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * t4 + (e & 1);
        const int qi = qi0 + (e >> 1) * 8;
        float v = s[nt][e] * scale_log2;
        if (j == qt && key > qi) v = -CUDART_INF_F;
        s[nt][e] = v;
        mx[e >> 1] = fmaxf(mx[e >> 1], v);
      }
    float alpha[2], sum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      alpha[r] = exp2f(m_r[r] - mx[r]);  // 0 on the first tile
      m_r[r] = mx[r];
    }
    uint32_t pa[BKV / 16][4];
#pragma unroll
    for (int nt = 0; nt < BKV / 8; ++nt) {
      const float p0 = exp2f(s[nt][0] - mx[0]), p1 = exp2f(s[nt][1] - mx[0]);
      const float p2 = exp2f(s[nt][2] - mx[1]), p3 = exp2f(s[nt][3] - mx[1]);
      sum[0] += p0 + p1;
      sum[1] += p2 + p3;
      // C fragments of key tiles 2k, 2k+1 are the A fragment of k16 step k
      pa[nt >> 1][(nt & 1) * 2] = hopper::pack_bf16(p0, p1);
      pa[nt >> 1][(nt & 1) * 2 + 1] = hopper::pack_bf16(p2, p3);
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 1);
      sum[r] += __shfl_xor_sync(0xffffffffu, sum[r], 2);
      l_r[r] = l_r[r] * alpha[r] + sum[r];
    }
#pragma unroll
    for (int dt = 0; dt < DV / 8; ++dt) {
      o[dt][0] *= alpha[0];
      o[dt][1] *= alpha[0];
      o[dt][2] *= alpha[1];
      o[dt][3] *= alpha[1];
    }
#pragma unroll
    for (int kk = 0; kk < BKV / 16; ++kk) {
#pragma unroll
      for (int dp = 0; dp < DV / 16; ++dp) {
        uint32_t r[4];
        hopper::ldsm_x4_trans(
            r, &Vs[(kk * 16 + (lane & 15)) * VS + dp * 16 + (lane >> 4) * 8]);
        hopper::mma_bf16(o[2 * dp], pa[kk], r[0], r[1]);
        hopper::mma_bf16(o[2 * dp + 1], pa[kk], r[2], r[3]);
      }
    }
    __syncthreads();  // every warp is done with this tile's k and v
  }

  const float inv[2] = {1.f / l_r[0], 1.f / l_r[1]};
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = qi0 + r * 8;
    if (qi >= T) continue;
    bf16* dst = out + (row0 + qi) * (size_t)(H * DV) + h * DV;
#pragma unroll
    for (int dt = 0; dt < DV / 8; ++dt)
      *reinterpret_cast<uint32_t*>(dst + dt * 8 + 2 * t4) = hopper::pack_bf16(
          o[dt][2 * r] * inv[r], o[dt][2 * r + 1] * inv[r]);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// In place: the rope lanes of every head of q [B*T, ldq] and kr at
// kva[:, rank:rank+64], rotate-half at position t of each row, cos and sin
// [P >= T, 32] f32
extern "C" int rope_mla_bf16(void* q, void* kva, const void* cosv,
                             const void* sinv, int B, int T, int H, int ldq,
                             int ldkv, int rank, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const long long n = (long long)B * T * (H + 1) * (ROPE / 2);
  const int threads = 256;
  const long long blocks = (n + threads - 1) / threads;
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  rope_mla_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (bf16*)q, (bf16*)kva, (const float*)cosv, (const float*)sinv, B * T, T,
      H, ldq, ldkv, rank);
  return (int)cudaGetLastError();
}

// out [B*T, H*128] = causal softmax(scale * q.k) v per (row, head)
extern "C" int causal_mla_attention_bf16(const void* q, const void* kva,
                                         const void* kvb, void* out, int B,
                                         int T, int H, int ldq, int ldkv,
                                         int ldkvb, int rank, float scale,
                                         void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || B > 65535 || H > 65535 || ldq % 8 ||
      ldkv % 8 || ldkvb % 8 || rank % 8)
    return (int)cudaErrorInvalidValue;
  if (!aligned16(q) || !aligned16(kva) || !aligned16(kvb) || !aligned16(out))
    return (int)cudaErrorMisalignedAddress;
  static bool attr = false;
  if (!attr) {
    cudaFuncSetAttribute(causal_mla_kernel,
                         cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
    attr = true;
  }
  const dim3 grid((T + BQ - 1) / BQ, H, B);
  causal_mla_kernel<<<grid, THREADS, SMEM, (cudaStream_t)stream>>>(
      (const bf16*)q, (const bf16*)kva, (const bf16*)kvb, (bf16*)out, T, H,
      ldq, ldkv, ldkvb, rank, scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
