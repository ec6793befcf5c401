// small_attention_kt: whole-sequence, non-causal, unmasked attention for the
// towers' frame attention (DINOv2 T=261, LanguageBind spatial T=257, head
// dim 64), with K given pre-transposed: q, v [B, H, T, 64], kt [B, H, 64, T],
// all bf16, contiguous.
//
// Replaces merv_tpu/ops/attention.py::small_attention_kt
// (_small_attention_kt_fwd_impl / _small_attn_kernel_kt, pallas_call :540).
//
// Bound on the H100: bytes, narrowly. Per head the kernel reads 3*T*64 and
// writes T*64 bf16 values for 4*T*T*64 flops: ~T/2 = 130 flops per byte at
// T=261, below the card's ~295 flops per byte balance point in bf16, so the
// least time is the bytes over 3.35 TB/s. With mma.sync (not wgmma), scalar
// staging loads and a second QK^T pass, issue rate is what it meets first.
//
// Design. The TPU kernel ran one grid cell per batch item with all heads
// unrolled; here a block owns one (batch, head), grid (B*H), and its 8 warps
// walk the head's query rows 16 at a time. The block stages its head's K
// (transposed from kt into [T][64]) and V^T ([64][T]) in dynamic shared
// memory (<= 140 KB at T=512, hence cudaFuncSetAttribute), so each warp's
// B fragments are single 32-bit loads and the padded row strides (72 / T+8
// elements) keep those loads free of bank conflicts. Softmax is exact, as on
// the TPU: pass 1 takes the fp32 row max over all keys, pass 2 recomputes
// the scores, forms p = exp(s - m) in fp32, sums l in fp32, rounds p to bf16
// for the PV MMA, and the output is divided by l after PV. Keys past T are
// zero-filled and masked.
#include "common.cuh"

namespace {

constexpr int kD = 64;        // head dim
constexpr int kWarps = 8;     // each warp takes 16-row query tiles in turn
constexpr int kChunk = 64;    // keys per score chunk (8 MMA n-tiles)
constexpr int kKS = kD + 8;   // Ks row stride in elements (36 words: conflict-free)
constexpr int kMaxT = 512;

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

// One warp: query rows r0 .. r0+15 of the head against all T staged keys.
__device__ __forceinline__ void attend_rows(const bf16* __restrict__ qh, const bf16* __restrict__ Ks,
                                            const bf16* __restrict__ Vt, bf16* __restrict__ oh, int r0, int T,
                                            int Tp, int VS, float scale, int g, int t) {
  const int ra = r0 + g, rb = r0 + g + 8;

  uint32_t qa[kD / 16][4];
#pragma unroll
  for (int ks = 0; ks < kD / 16; ++ks) {
    const int c = ks * 16 + 2 * t;
    qa[ks][0] = ra < T ? ld32(qh + ra * kD + c) : 0u;
    qa[ks][1] = rb < T ? ld32(qh + rb * kD + c) : 0u;
    qa[ks][2] = ra < T ? ld32(qh + ra * kD + c + 8) : 0u;
    qa[ks][3] = rb < T ? ld32(qh + rb * kD + c + 8) : 0u;
  }

  // pass 1: exact fp32 row max over every valid key
  float ma = neg_inf(), mb = neg_inf();
  for (int k0 = 0; k0 < Tp; k0 += kChunk) {
    float s[kChunk / 8][4];
    qk_chunk(qa, Ks, k0, g, t, s);
#pragma unroll
    for (int nt = 0; nt < kChunk / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (k0 + nt * 8 + 2 * t + j < T) {
          ma = fmaxf(ma, s[nt][j] * scale);
          mb = fmaxf(mb, s[nt][2 + j] * scale);
        }
      }
    }
  }
  ma = quad_max(ma);
  mb = quad_max(mb);

  // pass 2: p = exp(s - m) in fp32, l in fp32, PV with p rounded to bf16
  float la = 0.f, lb = 0.f;
  float acc[kD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int k0 = 0; k0 < Tp; k0 += kChunk) {
    float s[kChunk / 8][4];
    qk_chunk(qa, Ks, k0, g, t, s);
#pragma unroll
    for (int nt = 0; nt < kChunk / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool valid = k0 + nt * 8 + 2 * t + j < T;
        const float pa = valid ? expf(s[nt][j] * scale - ma) : 0.f;
        const float pb = valid ? expf(s[nt][2 + j] * scale - mb) : 0.f;
        s[nt][j] = pa;
        s[nt][2 + j] = pb;
        la += pa;
        lb += pb;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kChunk / 16; ++kk) {
      const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < kD / 8; ++dn) {
        const bf16* vp = Vt + (dn * 8 + g) * VS + k0 + kk * 16 + 2 * t;
        mma_bf16_16816(acc[dn], pf, ld32(vp), ld32(vp + 8));
      }
    }
  }
  la = quad_sum(la);
  lb = quad_sum(lb);

#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) {
    const int c = dn * 8 + 2 * t;
    if (ra < T)
      *reinterpret_cast<__nv_bfloat162*>(oh + ra * kD + c) = __floats2bfloat162_rn(acc[dn][0] / la, acc[dn][1] / la);
    if (rb < T)
      *reinterpret_cast<__nv_bfloat162*>(oh + rb * kD + c) = __floats2bfloat162_rn(acc[dn][2] / lb, acc[dn][3] / lb);
  }
}

__global__ void __launch_bounds__(kWarps * 32) small_attn_kt_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kt,
                                                            const bf16* __restrict__ v, bf16* __restrict__ o, int T,
                                                            int Tp, int VS, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [Tp][kKS]
  bf16* Vt = Ks + Tp * kKS;                      // [kD][VS]

  const size_t head = static_cast<size_t>(blockIdx.x) * T * kD;
  const bf16* qh = q + head;
  const bf16* kth = kt + head;
  const bf16* vh = v + head;
  bf16* oh = o + head;
  const bf16 zero = __float2bfloat16(0.f);

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // K: kt rows are read coalesced (consecutive lanes, consecutive keys) and
  // written transposed; V: 16-byte rows (8 values) written transposed
  for (int d = warp; d < kD; d += kWarps)
    for (int tt = lane; tt < Tp; tt += 32) Ks[tt * kKS + d] = tt < T ? kth[static_cast<size_t>(d) * T + tt] : zero;
  for (int i = threadIdx.x; i < Tp * (kD / 8); i += kWarps * 32) {
    const int tt = i >> 3, c8 = i & 7;
    uint4 v4 = make_uint4(0u, 0u, 0u, 0u);
    if (tt < T) v4 = *reinterpret_cast<const uint4*>(vh + static_cast<size_t>(tt) * kD + c8 * 8);
    const bf16* ve = reinterpret_cast<const bf16*>(&v4);
#pragma unroll
    for (int j = 0; j < 8; ++j) Vt[(c8 * 8 + j) * VS + tt] = ve[j];
  }
  __syncthreads();

  const int g = lane >> 2, t = lane & 3;
  for (int r0 = warp * 16; r0 < T; r0 += kWarps * 16) attend_rows(qh, Ks, Vt, oh, r0, T, Tp, VS, scale, g, t);
}

}  // namespace

// q, kt, v, o: device pointers (bf16, contiguous); BH = batch * heads.
MERV_EXPORT int small_attention_kt_bf16(const void* q, const void* kt, const void* v, void* o, int BH, int T, int D,
                                        float scale, void* stream) {
  if (D != kD || T <= 0 || T > kMaxT || BH <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int Tp = (T + kChunk - 1) / kChunk * kChunk;
  const int VS = Tp + 8;  // VS/2 == 4 (mod 32) words: conflict-free PV B loads
  const size_t smem = (static_cast<size_t>(Tp) * kKS + static_cast<size_t>(kD) * VS) * sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(small_attn_kt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  small_attn_kt_kernel<<<BH, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kt), static_cast<const bf16*>(v), static_cast<bf16*>(o),
      T, Tp, VS, scale);
  return static_cast<int>(cudaGetLastError());
}
