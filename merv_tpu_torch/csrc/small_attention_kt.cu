// small_attention_kt: whole-sequence, non-causal, unmasked attention for the
// towers' frame attention (DINOv2 T=261, LanguageBind spatial T=257, head
// dim 64; SigLIP so400m T=256, head dim 72), with K given pre-transposed:
// q, v [B, H, T, D], kt [B, H, D, T], D = 64 or 72, all bf16, contiguous,
// 16-byte aligned, 1 <= T <= 512.
//
// Replaces merv_tpu/ops/attention.py::small_attention_kt
// (_small_attention_kt_fwd_impl / _small_attn_kernel_kt, pallas_call :540).
//
// Bound on the H100: bytes, narrowly. Per head the kernel reads 3*T*64 and
// writes T*64 bf16 values for 4*T*T*64 flops: ~T/2 = 130 flops per byte at
// T=261, below the card's ~295 flops per byte balance point in bf16, so the
// least time is the bytes over 3.35 TB/s; the softmax's exponentials come
// close to it.
//
// Design (small_attn_hopper.cuh, shared with B3): a persistent grid of one
// block per SM walks the (batch, head) items; a producer warpgroup brings each
// head's kt in with one 1-D bulk copy (its row stride, 2T bytes, rules out a
// tensor map), rewrites it into 128-byte-swizzled slabs that wgmma reads
// MN-major through its transpose bit, and loads V by TMA, into a ring of two
// stages, while two consumer warpgroups run S = Q K^T and O += P V by wgmma on
// the previous head with a whole row of scores in registers (T <= 272) and
// the TPU kernel's exact softmax order.
#include "small_attn_hopper.cuh"

// q, kt, v, o: device pointers (bf16, contiguous, 16-byte aligned); BH = batch * heads;
// D = 64 or 72 (any other head dim: cudaErrorInvalidValue).
MERV_EXPORT int small_attention_kt_bf16(const void* q, const void* kt, const void* v, void* o, int BH, int T, int D,
                                        float scale, void* stream) {
  if (BH <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D == 64) return small_attn::launch<true, false, 64>(q, nullptr, kt, v, o, BH, 1, 1, T, scale, st);
  if (D == 72) return small_attn::launch<true, false, 72>(q, nullptr, kt, v, o, BH, 1, 1, T, scale, st);
  return static_cast<int>(cudaErrorInvalidValue);
}
