// small_attention: whole-sequence, non-causal, unmasked self-attention with
// K row-major: q [B, H, T, 64], k/v [B, Hk, T, 64] (H % Hk == 0, GQA by the
// kv-head index h / (H / Hk): nothing is repeated in device memory), all
// bf16, contiguous, T <= 512. The towers' frame attention takes it on the
// `MERV_TPU_TOWER_ATTN=xla` route (DINOv2 T=261, LanguageBind spatial T=257).
//
// Replaces merv_tpu/ops/attention.py::_small_attention
// (_small_attention_fwd_impl / _small_attn_kernel, pallas_call :473).
//
// Bound on the H100: bytes, as K1's (small_attention_kt.cu): ~T/2 flops per
// byte at T=261, under the card's ~295 flops per byte balance point in bf16.
//
// Design: K1's, with K staged as it is (16-byte row copies, no transpose).
// One block per (batch, head), grid (B*H); the block stages its kv head's K
// ([Tp][72]) and V^T ([64][Tp+8]) in dynamic shared memory (<= 140 KB at
// T = 512; 256 KB at D = 128 would exceed the 227 KB a block may use, hence
// D == 64), then 8 warps take 16 query rows at a time through mma.sync with
// the exact two-pass softmax of the TPU kernel: fp32 scores, keys past T
// masked, p rounded to bf16 for PV, output divided by l after PV
// (attn_core.cuh).
#include "attn_core.cuh"

using namespace attn_core;

namespace {

__global__ void __launch_bounds__(kWarps * 32) small_attn_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                                         const bf16* __restrict__ v, bf16* __restrict__ o, int H,
                                                         int Hk, int T, int Tp, int VS, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [Tp][kKS]
  bf16* Vt = Ks + Tp * kKS;                      // [kD][VS]
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const size_t head = static_cast<size_t>(bh) * T * kD;
  const size_t kv_head = static_cast<size_t>(b * Hk + h / (H / Hk)) * T * kD;
  stage_k_rows(k + kv_head, Ks, T, Tp);
  stage_vt(v + kv_head, Vt, T, Tp, VS);
  __syncthreads();
  attend_head<false>(q + head, Ks, Vt, o + head, kD, T, Tp, VS, 0, scale);
}

}  // namespace

// q, k, v, o: device pointers (bf16, contiguous).
MERV_EXPORT int small_attention_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int Hk, int T,
                                     int D, float scale, void* stream) {
  if (D != kD || T <= 0 || T > kMaxT || B <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int Tp = padded_t(T);
  const size_t smem = smem_bytes(T);
  cudaError_t e = cudaFuncSetAttribute(small_attn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  small_attn_kernel<<<B * H, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<bf16*>(o),
      H, Hk, T, Tp, vt_stride(Tp), scale);
  return static_cast<int>(cudaGetLastError());
}
