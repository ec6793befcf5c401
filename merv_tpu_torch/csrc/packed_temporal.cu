// packed_temporal_attention: LanguageBind's temporal attention with all heads
// packed into one sequence per window. q/v [Bn, R, 64], kt [Bn, 64, R], bf16,
// contiguous, R = frames * heads rows ordered (frame, head), R <= 512. Row r
// attends exactly the rows r' with r % heads == r' % heads; the kernel builds
// that mask itself (no [R, R] bias in device memory).
//
// Replaces merv_tpu/ops/attention.py::packed_temporal_attention
// (_packed_temporal_fwd_impl / _packed_temporal_kernel, pallas_call :622).
//
// Bound on the H100: bytes. At LanguageBind's [514, 128, 64] the kernel reads
// q, kt, v and writes o once (33.7 MB, 0.0101 ms at 3.35 TB/s); the full
// 128 x 128 scores it computes are 2.16e9 flops (0.0022 ms), and only 8 of
// each row's 128 keys are valid.
//
// Design: the TPU kernel's, one block per packed window (grid Bn), computing
// the full R x R scores and masking them (attn_core.cuh): K transposed out
// of kt while staging, V^T staged, 8 warps
// of 16 rows, fp32 scores, masked entries set to -0.7 * fp32 max (so their p
// is exactly 0), exact two-pass softmax, p rounded to bf16 for PV, output
// divided by l after PV. Skipping the masked tiles is left for later.
#include "attn_core.cuh"

using namespace attn_core;

namespace {

__global__ void __launch_bounds__(kWarps * 32) packed_temporal_kernel(const bf16* __restrict__ q,
                                                              const bf16* __restrict__ kt,
                                                              const bf16* __restrict__ v, bf16* __restrict__ o,
                                                              int R, int Rp, int VS, int heads, float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [Rp][kKS]
  bf16* Vt = Ks + Rp * kKS;                      // [kD][VS]
  const size_t win = static_cast<size_t>(blockIdx.x) * R * kD;
  stage_k_from_kt(kt + win, Ks, R, Rp);
  stage_vt(v + win, Vt, R, Rp, VS);
  __syncthreads();
  attend_head<false>(q + win, Ks, Vt, o + win, kD, R, Rp, VS, heads, scale);
}

}  // namespace

// q, kt, v, o: device pointers (bf16, contiguous).
MERV_EXPORT int packed_temporal_bf16(const void* q, const void* kt, const void* v, void* o, int Bn, int R, int D,
                                     int heads, float scale, void* stream) {
  if (D != kD || R <= 0 || R > kMaxT || Bn <= 0 || heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const int Rp = padded_t(R);
  const size_t smem = smem_bytes(R);
  cudaError_t e = cudaFuncSetAttribute(packed_temporal_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  packed_temporal_kernel<<<Bn, kWarps * 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(kt), static_cast<const bf16*>(v), static_cast<bf16*>(o),
      R, Rp, vt_stride(Rp), heads, scale);
  return static_cast<int>(cudaGetLastError());
}
