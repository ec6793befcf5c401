// small_attention: whole-sequence, non-causal, unmasked self-attention with
// K row-major: q [B, H, T, D], k/v [B, Hk, T, D], D = 64 or 72 (H % Hk == 0,
// GQA by the kv-head index h / (H / Hk): nothing is repeated in device
// memory), all bf16, contiguous, 16-byte aligned, 1 <= T <= 512. The towers'
// frame attention takes it on the `MERV_TPU_TOWER_ATTN=xla` route (DINOv2
// T=261, LanguageBind spatial T=257, SigLIP so400m T=256 at D=72).
//
// Replaces merv_tpu/ops/attention.py::_small_attention
// (_small_attention_fwd_impl / _small_attn_kernel, pallas_call :473).
//
// Bound on the H100: bytes, as K1's (small_attention_kt.cu): ~T/2 flops per
// byte at T=261, under the card's ~295 flops per byte balance point in bf16.
//
// Design: K1's (small_attn_hopper.cuh), with K loaded by TMA as it lies and
// read K-major by wgmma: a persistent grid of one block per SM, a producer
// warpgroup loading the kv head's K and V into a ring of two shared-memory
// stages, two consumer warpgroups on 64-row query tiles with a whole row of
// scores in registers (T <= 272) and the TPU kernel's exact softmax order.
#include "small_attn_hopper.cuh"

// q, k, v, o: device pointers (bf16, contiguous, 16-byte aligned); D = 64 or 72
// (any other head dim: cudaErrorInvalidValue).
MERV_EXPORT int small_attention_bf16(const void* q, const void* k, const void* v, void* o, int B, int H, int Hk, int T,
                                     int D, float scale, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return small_attn::launch<false, false, 64>(q, k, nullptr, v, o, B, H, Hk, T, scale, st);
  if (D == 72) return small_attn::launch<false, false, 72>(q, k, nullptr, v, o, B, H, Hk, T, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
