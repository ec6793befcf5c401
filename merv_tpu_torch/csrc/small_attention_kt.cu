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
// zero-filled and masked. The device code is attn_core.cuh's, shared with
// B3 (small_attention.cu), B5 (packed_temporal.cu) and B6's attention stage.
#include "attn_core.cuh"

using namespace attn_core;

namespace {

__global__ void __launch_bounds__(kWarps * 32) small_attn_kt_kernel(const bf16* __restrict__ q, const bf16* __restrict__ kt,
                                                            const bf16* __restrict__ v, bf16* __restrict__ o, int T,
                                                            int Tp, int VS, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [Tp][kKS]
  bf16* Vt = Ks + Tp * kKS;                      // [kD][VS]
  const size_t head = static_cast<size_t>(blockIdx.x) * T * kD;
  stage_k_from_kt(kt + head, Ks, T, Tp);
  stage_vt(v + head, Vt, T, Tp, VS);
  __syncthreads();
  attend_head<false>(q + head, Ks, Vt, o + head, kD, T, Tp, VS, 0, scale);
}

}  // namespace

// q, kt, v, o: device pointers (bf16, contiguous); BH = batch * heads.
MERV_EXPORT int small_attention_kt_bf16(const void* q, const void* kt, const void* v, void* o, int BH, int T, int D,
                                        float scale, void* stream) {
  if (D != kD || T <= 0 || T > kMaxT || BH <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int Tp = padded_t(T);
  const size_t smem = smem_bytes(T);
  cudaError_t e = cudaFuncSetAttribute(small_attn_kt_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  small_attn_kt_kernel<<<BH, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kt), static_cast<const bf16*>(v), static_cast<bf16*>(o),
      T, Tp, vt_stride(Tp), scale);
  return static_cast<int>(cudaGetLastError());
}
