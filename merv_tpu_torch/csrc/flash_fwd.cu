// flash_attention_forward: blocked online-softmax attention forward.
// q [B, H, Tq, D], k/v [B, Hk, Tk, D] (H % Hk == 0, GQA by head index
// h / (H/Hk)), bf16, contiguous, D in {64, 128}; optional [B, Tk] key mask
// (1 byte per key, nonzero = valid); optional causal mask aligned to the
// right: query i sits at key position q_offset + i and sees keys <= that.
// Rows with no valid key write exactly 0. Optionally writes the per-row
// log-sum-exp lse [B, H, Tq] fp32 (m + log l, in scaled-score units) that the
// backward (flash_bwd.cu) recomputes P from; a row with no valid key gets
// +inf there, so every P of that row is exactly 0 in the backward.
//
// Replaces merv_tpu/ops/attention.py::_flash_forward (_flash_fwd_kernel,
// pallas_call :376) and the forward of the library kernel the TPU used at
// ViViT's shape (_library_flash_padded, :741-770).
//
// Bound on the H100: operations at ViViT's shape ([1, 12, 3137, 64]:
// 4*Tq*Tk*D flops per head against 4*T*D*2 bytes, ~1568 flops per byte, far
// above the card's ~295 flops per byte balance point in bf16); the Llama
// prefill ([1, 32, 1088, 128] over a 1120-key cache, causal half masked) sits
// near the balance point (~270 flops per byte), so both rates matter there.
//
// Design. Grid (B*H, ceil(Tq/64)), 4 warps x 16 query rows; the TPU's
// sequential kv grid axis becomes a loop inside the block. Each iteration
// stages a 64-key tile of K ([64][D+8]) and V^T ([D][72]) in shared memory,
// 16-byte vector loads from global, then each warp runs QK^T and PV with
// mma.sync m16n8k16 (bf16 in, fp32 accumulate), an fp32 online softmax with
// exact zeros at masked keys, and p rounded to bf16 before PV, as the Pallas
// kernel does. Ragged Tq/Tk edges are masked in the kernel (no padding copies
// in device memory). Under the causal mask, key tiles past the block's last
// visible key are never loaded.
#include "common.cuh"

namespace {

constexpr int kBK = 64;       // keys per tile
constexpr int kRows = 64;     // query rows per block
constexpr int kVS = kBK + 8;  // V^T row stride (36 words: conflict-free)

template <int D>
__global__ void __launch_bounds__(128) flash_fwd_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                                                        const bf16* __restrict__ v, const uint8_t* __restrict__ mask,
                                                        bf16* __restrict__ o, float* __restrict__ lse, int H, int Hk,
                                                        int Tq, int Tk,
                                                        int causal, int q_offset, float scale) {
  constexpr int KS = D + 8;  // (D+8)/2 == 4 (mod 32) words for D = 64, 128
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [kBK][KS]
  bf16* Vt = Ks + kBK * KS;                      // [D][kVS]
  __shared__ uint8_t key_ok[kBK];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hk);
  const bf16* qh = q + static_cast<size_t>(bh) * Tq * D;
  const bf16* kh = k + static_cast<size_t>(b * Hk + hk) * Tk * D;
  const bf16* vh = v + static_cast<size_t>(b * Hk + hk) * Tk * D;
  bf16* oh = o + static_cast<size_t>(bh) * Tq * D;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * kRows + warp * 16;
  const int ra = r0 + g, rb = r0 + g + 8;
  const int pos_a = q_offset + ra, pos_b = q_offset + rb;  // causal: last visible key

  uint32_t qa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + 2 * t;
    qa[ks][0] = ra < Tq ? ld32(qh + static_cast<size_t>(ra) * D + c) : 0u;
    qa[ks][1] = rb < Tq ? ld32(qh + static_cast<size_t>(rb) * D + c) : 0u;
    qa[ks][2] = ra < Tq ? ld32(qh + static_cast<size_t>(ra) * D + c + 8) : 0u;
    qa[ks][3] = rb < Tq ? ld32(qh + static_cast<size_t>(rb) * D + c + 8) : 0u;
  }

  int n_tiles = (Tk + kBK - 1) / kBK;
  if (causal) {
    const int last_row = min(static_cast<int>(blockIdx.y) * kRows + kRows - 1, Tq - 1);
    const int kend = q_offset + last_row + 1;  // keys [0, kend) can be visible to this block
    n_tiles = min(n_tiles, kend <= 0 ? 0 : (kend + kBK - 1) / kBK);
  }

  float ma = neg_inf(), mb = neg_inf(), la = 0.f, lb = 0.f;
  float acc[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kbase = tile * kBK;
    __syncthreads();  // every warp is done with the previous tile
    for (int i = threadIdx.x; i < kBK * D / 8; i += blockDim.x) {
      const int r = i / (D / 8), c8 = i - r * (D / 8);
      const int key = kbase + r;
      uint4 kv4 = make_uint4(0u, 0u, 0u, 0u), vv4 = make_uint4(0u, 0u, 0u, 0u);
      if (key < Tk) {
        kv4 = *reinterpret_cast<const uint4*>(kh + static_cast<size_t>(key) * D + c8 * 8);
        vv4 = *reinterpret_cast<const uint4*>(vh + static_cast<size_t>(key) * D + c8 * 8);
      }
      *reinterpret_cast<uint4*>(Ks + r * KS + c8 * 8) = kv4;
      const bf16* ve = reinterpret_cast<const bf16*>(&vv4);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c8 * 8 + j) * kVS + r] = ve[j];
    }
    if (threadIdx.x < kBK) {
      const int key = kbase + threadIdx.x;
      key_ok[threadIdx.x] = key < Tk && (mask == nullptr || mask[static_cast<size_t>(b) * Tk + key] != 0);
    }
    __syncthreads();

    float s[kBK / 8][4];
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const bf16* kp = Ks + (nt * 8 + g) * KS + ks * 16 + 2 * t;
        mma_bf16_16816(s[nt], qa[ks], ld32(kp), ld32(kp + 8));
      }
    }

    float ca = neg_inf(), cb = neg_inf();
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const int c = nt * 8 + 2 * t + j;
        const int key = kbase + c;
        const bool ok = key_ok[c] != 0;
        const bool va = ok && (!causal || key <= pos_a);
        const bool vb = ok && (!causal || key <= pos_b);
        s[nt][j] = va ? s[nt][j] * scale : neg_inf();
        s[nt][2 + j] = vb ? s[nt][2 + j] * scale : neg_inf();
        ca = fmaxf(ca, s[nt][j]);
        cb = fmaxf(cb, s[nt][2 + j]);
      }
    }
    ca = quad_max(ca);
    cb = quad_max(cb);
    const float na = fmaxf(ma, ca), nb = fmaxf(mb, cb);
    // no valid key yet: acc and l are still 0, any finite factor works
    const float alpha_a = ma == neg_inf() ? 0.f : expf(ma - na);
    const float alpha_b = mb == neg_inf() ? 0.f : expf(mb - nb);
    ma = na;
    mb = nb;
    la *= alpha_a;
    lb *= alpha_b;
#pragma unroll
    for (int dn = 0; dn < D / 8; ++dn) {
      acc[dn][0] *= alpha_a;
      acc[dn][1] *= alpha_a;
      acc[dn][2] *= alpha_b;
      acc[dn][3] *= alpha_b;
    }
#pragma unroll
    for (int nt = 0; nt < kBK / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        // masked keys hold -inf: their p is exactly 0 (so is every p of a row with no valid key)
        const float pa = s[nt][j] == neg_inf() ? 0.f : expf(s[nt][j] - ma);
        const float pb = s[nt][2 + j] == neg_inf() ? 0.f : expf(s[nt][2 + j] - mb);
        s[nt][j] = pa;
        s[nt][2 + j] = pb;
        la += pa;
        lb += pb;
      }
    }
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint32_t pf[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]), pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const bf16* vp = Vt + (dn * 8 + g) * kVS + kk * 16 + 2 * t;
        mma_bf16_16816(acc[dn], pf, ld32(vp), ld32(vp + 8));
      }
    }
  }

  la = quad_sum(la);
  lb = quad_sum(lb);
  const float ia = la == 0.f ? 0.f : 1.f / la;  // rows with no valid key write 0
  const float ib = lb == 0.f ? 0.f : 1.f / lb;
  if (lse != nullptr && t == 0) {
    float* lh = lse + static_cast<size_t>(bh) * Tq;
    if (ra < Tq) lh[ra] = la == 0.f ? __int_as_float(0x7f800000) : ma + logf(la);
    if (rb < Tq) lh[rb] = lb == 0.f ? __int_as_float(0x7f800000) : mb + logf(lb);
  }
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = dn * 8 + 2 * t;
    if (ra < Tq)
      *reinterpret_cast<__nv_bfloat162*>(oh + static_cast<size_t>(ra) * D + c) =
          __floats2bfloat162_rn(acc[dn][0] * ia, acc[dn][1] * ia);
    if (rb < Tq)
      *reinterpret_cast<__nv_bfloat162*>(oh + static_cast<size_t>(rb) * D + c) =
          __floats2bfloat162_rn(acc[dn][2] * ib, acc[dn][3] * ib);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* mask, void* o, void* lse, int B, int H, int Hk,
           int Tq, int Tk, int causal, int q_offset, float scale, cudaStream_t stream) {
  const size_t smem = (static_cast<size_t>(kBK) * (D + 8) + static_cast<size_t>(D) * kVS) * sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (Tq + kRows - 1) / kRows);
  flash_fwd_kernel<D><<<grid, 128, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k), static_cast<const bf16*>(v),
      static_cast<const uint8_t*>(mask), static_cast<bf16*>(o), static_cast<float*>(lse), H, Hk, Tq, Tk, causal,
      q_offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: device pointers (bf16, contiguous); mask: [B, Tk] bytes or null;
// lse: [B, H, Tq] fp32 or null.
MERV_EXPORT int flash_fwd_bf16(const void* q, const void* k, const void* v, const void* mask, void* o, void* lse,
                               int B, int H, int Hk, int Tq, int Tk, int D, int causal, int q_offset, float scale,
                               void* stream) {
  if (B <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 || Tq <= 0 || Tk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(q, k, v, mask, o, lse, B, H, Hk, Tq, Tk, causal, q_offset, scale, s);
  if (D == 128) return launch<128>(q, k, v, mask, o, lse, B, H, Hk, Tq, Tk, causal, q_offset, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
