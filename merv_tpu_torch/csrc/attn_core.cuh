// Device code shared by the whole-sequence attention of packed_temporal.cu
// (B5) and the attention stage of fused_vit_block.cu (B6), head dim 64.
//
// One block owns one (batch, head) and stages the head's K ([Tp][kKS],
// row-major) and V^T ([kD][VS]) in dynamic shared memory; 8 warps walk the
// query rows 16 at a time through mma.sync. Padded row strides (72 and
// Tp + 8 elements) keep the warps' 32-bit fragment loads free of bank
// conflicts. Keys past T (zero-filled) and, in packed temporal attention,
// keys of another head take the mask value -0.7 * fp32 max, as the TPU
// kernels' key-side masks do: exp(mask - m) underflows to exactly 0.
//
// Two softmax orders, both exact (not online across the output):
// - divide after PV (K1, B3, B5, as their TPU kernels): pass 1 takes the fp32
//   row max, pass 2 forms p = exp(s - m), sums l in fp32, rounds p to bf16
//   for PV and divides the output by l;
// - normalise before PV (B6, as _fused_block_kernel): pass 1 takes the row max
//   and l (per thread online, combined across the quad at the end), pass 2
//   rounds p / l to bf16 for PV and writes the product as it is.
#pragma once

#include "common.cuh"

namespace attn_core {

constexpr int kD = 64;        // head dim
constexpr int kWarps = 8;     // each warp takes 16-row query tiles in turn
constexpr int kChunk = 64;    // keys per score chunk (8 MMA n-tiles)
constexpr int kKS = kD + 8;   // Ks row stride in elements (36 words: conflict-free)
constexpr int kMaxT = 512;    // K and V^T of one head: <= 140 KB of shared memory
constexpr float kMaskValue = -0.7f * 3.40282346638528859811704183484516925e+38f;

__host__ __device__ inline int padded_t(int T) { return (T + kChunk - 1) / kChunk * kChunk; }
__host__ __device__ inline int vt_stride(int Tp) { return Tp + 8; }  // VS/2 == 4 (mod 32) words
inline size_t smem_bytes(int T) {
  const int Tp = padded_t(T);
  return (static_cast<size_t>(Tp) * kKS + static_cast<size_t>(kD) * vt_stride(Tp)) * sizeof(bf16);
}

// ---- staging (whole block) ----------------------------------------------

// K from kt [kD][T] (transposed while staging: coalesced reads along keys)
__device__ __forceinline__ void stage_k_from_kt(const bf16* __restrict__ kth, bf16* __restrict__ Ks, int T, int Tp) {
  const bf16 zero = __float2bfloat16(0.f);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  for (int d = warp; d < kD; d += nwarps)
    for (int tt = lane; tt < Tp; tt += 32) Ks[tt * kKS + d] = tt < T ? kth[static_cast<size_t>(d) * T + tt] : zero;
}

// K from k [T][kD], 16-byte rows (a kKS row is 144 bytes: aligned)
__device__ __forceinline__ void stage_k_rows(const bf16* __restrict__ kh, bf16* __restrict__ Ks, int T, int Tp) {
  for (int i = threadIdx.x; i < Tp * (kD / 8); i += blockDim.x) {
    const int tt = i >> 3, c8 = i & 7;
    uint4 k4 = make_uint4(0u, 0u, 0u, 0u);
    if (tt < T) k4 = *reinterpret_cast<const uint4*>(kh + static_cast<size_t>(tt) * kD + c8 * 8);
    *reinterpret_cast<uint4*>(Ks + tt * kKS + c8 * 8) = k4;
  }
}

// V^T [kD][VS] from v [T][kD]
__device__ __forceinline__ void stage_vt(const bf16* __restrict__ vh, bf16* __restrict__ Vt, int T, int Tp, int VS) {
  for (int i = threadIdx.x; i < Tp * (kD / 8); i += blockDim.x) {
    const int tt = i >> 3, c8 = i & 7;
    uint4 v4 = make_uint4(0u, 0u, 0u, 0u);
    if (tt < T) v4 = *reinterpret_cast<const uint4*>(vh + static_cast<size_t>(tt) * kD + c8 * 8);
    const bf16* ve = reinterpret_cast<const bf16*>(&v4);
#pragma unroll
    for (int j = 0; j < 8; ++j) Vt[(c8 * 8 + j) * VS + tt] = ve[j];
  }
}

// ---- one warp's pieces ---------------------------------------------------

// A fragments of query rows ra = r0 + g and rb = r0 + g + 8 (zero past T)
__device__ __forceinline__ void load_q(const bf16* __restrict__ qh, int ra, int rb, int T, int t,
                                       uint32_t (&qa)[kD / 16][4]) {
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    const int c = ks * 16 + 2 * t;
    qa[ks][0] = ra < T ? ld32(qh + static_cast<size_t>(ra) * kD + c) : 0u;
    qa[ks][1] = rb < T ? ld32(qh + static_cast<size_t>(rb) * kD + c) : 0u;
    qa[ks][2] = ra < T ? ld32(qh + static_cast<size_t>(ra) * kD + c + 8) : 0u;
    qa[ks][3] = rb < T ? ld32(qh + static_cast<size_t>(rb) * kD + c + 8) : 0u;
  }
}

// raw scores of the warp's 16 rows against the 64 staged keys k0 .. k0+63
__device__ __forceinline__ void qk_chunk(const uint32_t (&qa)[kD / 16][4], const bf16* __restrict__ Ks, int k0,
                                         int g, int t, float (&s)[kChunk / 8][4]) {
#pragma unroll
  for (int nt = 0; nt < kChunk / 8; ++nt) {
    s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
    for (int ks = 0; ks < kD / 16; ++ks) {
      const bf16* kp = Ks + (k0 + nt * 8 + g) * kKS + ks * 16 + 2 * t;
      mma_bf16_16816(s[nt], qa[ks], ld32(kp), ld32(kp + 8));
    }
  }
}

// scale the scores; masked entries (key >= T, or another head when heads > 0:
// row r sees key c iff r % heads == c % heads) take kMaskValue. kbase is the
// global index of the chunk's first key.
__device__ __forceinline__ void mask_chunk(float (&s)[kChunk / 8][4], int kbase, int T, int ra, int rb, int heads,
                                           float scale, int t) {
#pragma unroll
  for (int nt = 0; nt < kChunk / 8; ++nt) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      const int key = kbase + nt * 8 + 2 * t + j;
      bool oka = key < T, okb = key < T;
      if (heads > 0) {
        oka = oka && (key % heads) == (ra % heads);
        okb = okb && (key % heads) == (rb % heads);
      }
      s[nt][j] = oka ? s[nt][j] * scale : kMaskValue;
      s[nt][2 + j] = okb ? s[nt][2 + j] * scale : kMaskValue;
    }
  }
}

// acc += round_bf16(p) @ V over the chunk's 64 keys, V^T staged at Vt + k0
__device__ __forceinline__ void pv_chunk(const float (&p)[kChunk / 8][4], const bf16* __restrict__ Vt, int VS, int k0,
                                         int g, int t, float (&acc)[kD / 8][4]) {
#pragma unroll
  for (int kk = 0; kk < kChunk / 16; ++kk) {
    const uint32_t pf[4] = {pack_bf16(p[2 * kk][0], p[2 * kk][1]), pack_bf16(p[2 * kk][2], p[2 * kk][3]),
                            pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]),
                            pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3])};
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn) {
      const bf16* vp = Vt + (dn * 8 + g) * VS + k0 + kk * 16 + 2 * t;
      mma_bf16_16816(acc[dn], pf, ld32(vp), ld32(vp + 8));
    }
  }
}

// per-thread online (max, sum) over a masked chunk, for the normalise-first order
__device__ __forceinline__ void online_stats(const float (&s)[kChunk / 8][4], float& ma, float& mb, float& la,
                                             float& lb) {
  float ca = neg_inf(), cb = neg_inf();
#pragma unroll
  for (int nt = 0; nt < kChunk / 8; ++nt) {
    ca = fmaxf(ca, fmaxf(s[nt][0], s[nt][1]));
    cb = fmaxf(cb, fmaxf(s[nt][2], s[nt][3]));
  }
  const float na = fmaxf(ma, ca), nb = fmaxf(mb, cb);  // finite: masked entries are kMaskValue
  la *= expf(ma - na);                                 // ma == -inf on the first chunk: 0 * 0
  lb *= expf(mb - nb);
#pragma unroll
  for (int nt = 0; nt < kChunk / 8; ++nt) {
    la += expf(s[nt][0] - na) + expf(s[nt][1] - na);
    lb += expf(s[nt][2] - nb) + expf(s[nt][3] - nb);
  }
  ma = na;
  mb = nb;
}

// combine the quad's per-thread (max, sum) pairs into the row's
__device__ __forceinline__ void quad_stats(float& m, float& l) {
  const float mq = quad_max(m);
  l = quad_sum(l * expf(m - mq));
  m = mq;
}

// write the warp's two rows of acc * inv (bf16) at o + row * ostride
__device__ __forceinline__ void store_rows(const float (&acc)[kD / 8][4], bf16* __restrict__ o, int ostride, int ra,
                                           int rb, int T, float ia, float ib, int t) {
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) {
    const int c = dn * 8 + 2 * t;
    if (ra < T)
      *reinterpret_cast<__nv_bfloat162*>(o + static_cast<size_t>(ra) * ostride + c) =
          __floats2bfloat162_rn(acc[dn][0] * ia, acc[dn][1] * ia);
    if (rb < T)
      *reinterpret_cast<__nv_bfloat162*>(o + static_cast<size_t>(rb) * ostride + c) =
          __floats2bfloat162_rn(acc[dn][2] * ib, acc[dn][3] * ib);
  }
}

// One warp: query rows r0 .. r0+15 of the head against all T staged keys;
// output row r at oh + r * ostride. kNormFirst selects the softmax order.
template <bool kNormFirst>
__device__ __forceinline__ void attend_rows(const bf16* __restrict__ qh, const bf16* __restrict__ Ks,
                                            const bf16* __restrict__ Vt, bf16* __restrict__ oh, int ostride, int r0,
                                            int T, int Tp, int VS, int heads, float scale, int g, int t) {
  const int ra = r0 + g, rb = r0 + g + 8;
  uint32_t qa[kD / 16][4];
  load_q(qh, ra, rb, T, t, qa);

  // pass 1: the fp32 row max (and, normalising first, the row sum)
  float ma = neg_inf(), mb = neg_inf(), la = 0.f, lb = 0.f;
  for (int k0 = 0; k0 < Tp; k0 += kChunk) {
    float s[kChunk / 8][4];
    qk_chunk(qa, Ks, k0, g, t, s);
    mask_chunk(s, k0, T, ra, rb, heads, scale, t);
    if (kNormFirst) {
      online_stats(s, ma, mb, la, lb);
    } else {
#pragma unroll
      for (int nt = 0; nt < kChunk / 8; ++nt) {
        ma = fmaxf(ma, fmaxf(s[nt][0], s[nt][1]));
        mb = fmaxf(mb, fmaxf(s[nt][2], s[nt][3]));
      }
    }
  }
  if (kNormFirst) {
    quad_stats(ma, la);
    quad_stats(mb, lb);
  } else {
    ma = quad_max(ma);
    mb = quad_max(mb);
    la = lb = 0.f;
  }

  // pass 2: p in fp32, PV with p (or p / l) rounded to bf16
  float acc[kD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  for (int k0 = 0; k0 < Tp; k0 += kChunk) {
    float s[kChunk / 8][4];
    qk_chunk(qa, Ks, k0, g, t, s);
    mask_chunk(s, k0, T, ra, rb, heads, scale, t);
#pragma unroll
    for (int nt = 0; nt < kChunk / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float pa = expf(s[nt][j] - ma), pb = expf(s[nt][2 + j] - mb);
        if (kNormFirst) {
          s[nt][j] = pa / la;
          s[nt][2 + j] = pb / lb;
        } else {
          s[nt][j] = pa;
          s[nt][2 + j] = pb;
          la += pa;
          lb += pb;
        }
      }
    }
    pv_chunk(s, Vt, VS, k0, g, t, acc);
  }
  if (kNormFirst) {
    store_rows(acc, oh, ostride, ra, rb, T, 1.f, 1.f, t);
  } else {
    la = quad_sum(la);
    lb = quad_sum(lb);
    // the TPU kernels divide: o / l (division, not a reciprocal product)
#pragma unroll
    for (int dn = 0; dn < kD / 8; ++dn) {
      acc[dn][0] /= la;
      acc[dn][1] /= la;
      acc[dn][2] /= lb;
      acc[dn][3] /= lb;
    }
    store_rows(acc, oh, ostride, ra, rb, T, 1.f, 1.f, t);
  }
}

// the whole block: every warp walks its 16-row query tiles
template <bool kNormFirst>
__device__ __forceinline__ void attend_head(const bf16* __restrict__ qh, const bf16* __restrict__ Ks,
                                            const bf16* __restrict__ Vt, bf16* __restrict__ oh, int ostride, int T,
                                            int Tp, int VS, int heads, float scale) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, nwarps = blockDim.x >> 5;
  const int g = lane >> 2, t = lane & 3;
  for (int r0 = warp * 16; r0 < T; r0 += nwarps * 16)
    attend_rows<kNormFirst>(qh, Ks, Vt, oh, ostride, r0, T, Tp, VS, heads, scale, g, t);
}

}  // namespace attn_core
