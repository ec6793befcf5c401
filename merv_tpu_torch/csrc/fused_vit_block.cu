// fused_vit_attn_block: a ViT layer's attention half,
//   out = x + gamma * (o_proj(attention(q, k, v)) + bo),  q/k/v = LN1(x) W + b,
// for x [B, S, D] bf16 with D = 64 * heads. Weights in Linear's (out, in)
// layout, bf16 [D, D]; the LN affine, the four biases and gamma in one fp32
// [7, D] block (ns, nb, bq, bk, bv, bo, gamma).
//
// Replaces merv_tpu/ops/fused_vit_block.py::fused_vit_attn_block
// (_fused_block_fwd_impl / _fused_block_kernel, pallas_call :135).
//
// Bound on the H100: operations. flops = 2*B*S*D*4D (the four projections)
// + 4*B*S*S*D (scores and PV), e.g. 3.95e10 at DINOv2's [16, 261, 1024]
// (0.040 ms at 989 TFLOP/s) against 25.5 MB of x, out and weights (0.0076 ms).
//
// Design. The TPU program holds one image's [S, D] rows and all four weights
// in VMEM; one DINOv2 image alone (534 KB) exceeds an SM's shared memory, so
// here one C entry point launches four kernels on the caller's stream and
// passes the intermediates through scratch buffers the caller allocates:
//  (a) row_stats: one warp per row, the LN's fp32 mean and 1/sqrt(var + eps);
//  (b) gemm<QKV>: 64 x 64 output tiles of [B*S, 3D] over 64-wide k steps,
//      x normalised in fp32 and rounded to bf16 while it is staged (the LN
//      never goes to device memory), mma.sync bf16 with fp32 accumulate,
//      fp32 bias added, rounded to bf16 and scattered to q/k/v [B, H, S, 64];
//  (c) attention per (image, head), softmax normalised before PV as the TPU
//      kernel does ((p / l) rounded to bf16, then PV; o_h rounded to bf16):
//      for S <= 512 the whole head staged (attn_core.cuh, as in B5), else a
//      key-tiled stage per 64 query rows (two passes over 64-key tiles);
//      it writes o as [B*S, D], the layout the o-projection reads;
//  (d) gemm<OPROJ>: o @ Wo^T accumulated in fp32 over all heads, + bo, then
//      x + gamma * y in fp32 and one rounding to bf16.
// The GEMMs stage each 64 x 64 tile with plain 16-byte loads and no
// pipelining: right and simple first. All products are this file's mma.sync.
#include "attn_core.cuh"

using namespace attn_core;

namespace {

constexpr int kBM = 64, kBN = 64, kBK = 64;
constexpr int kAS = kBK + 8;  // tile row stride in elements (36 words: conflict-free fragment loads)
constexpr int kGemmThreads = 128;
constexpr int kTileVS = kChunk + 8;

__global__ void __launch_bounds__(256) row_stats_kernel(const bf16* __restrict__ x, float* __restrict__ mu,
                                                        float* __restrict__ rstd, int M, int D, float eps) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* xr = x + static_cast<size_t>(row) * D;
  float s = 0.f;
  for (int c = lane * 8; c < D; c += 256) {
    const uint4 v4 = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v4);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += __bfloat162float(e[j]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float m = s / D;
  float ss = 0.f;
  for (int c = lane * 8; c < D; c += 256) {
    const uint4 v4 = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&v4);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = __bfloat162float(e[j]) - m;
      ss += d * d;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  if (lane == 0) {
    mu[row] = m;
    rstd[row] = rsqrtf(ss / D + eps);
  }
}

struct GemmArgs {
  const bf16* a;         // [M, K]: x (QKV, normalised while staged) or the attention output (OPROJ)
  const bf16* w[3];      // (out, in) weights, [n_per, K] each: wq, wk, wv (QKV) or wo (OPROJ)
  const float* bias[3];  // fp32 [n_per] each
  int M, K, n_per;
  const float* mu;       // QKV: LN statistics [M] and affine [K]
  const float* rstd;
  const float* ns;
  const float* nb;
  bf16* qkv;             // QKV: [3, B, H, S, 64]
  int S, H;
  const bf16* x;         // OPROJ: residual [M, n_per], gamma [n_per], out [M, n_per]
  const float* gamma;
  bf16* out;
};

template <bool kQKV>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(const GemmArgs p) {
  __shared__ __align__(16) unsigned char smem_raw[(kBM + kBN) * kAS * sizeof(bf16)];
  bf16* As = reinterpret_cast<bf16*>(smem_raw);  // [kBM][kAS]
  bf16* Bs = As + kBM * kAS;                     // [kBN][kAS]
  const int m0 = blockIdx.x * kBM;
  const int n0g = blockIdx.y * kBN;
  const int which = n0g / p.n_per, n0 = n0g - which * p.n_per;  // a tile never straddles two weights
  const bf16* __restrict__ w = p.w[which];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  float acc[kBN / 8][4];
#pragma unroll
  for (int nt = 0; nt < kBN / 8; ++nt) acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;

  for (int k0 = 0; k0 < p.K; k0 += kBK) {
    for (int i = threadIdx.x; i < kBM * (kBK / 8); i += kGemmThreads) {
      const int r = i >> 3, c8 = i & 7;
      const int m = m0 + r, kc = k0 + c8 * 8;
      uint4 a4 = make_uint4(0u, 0u, 0u, 0u);
      if (m < p.M) {
        a4 = *reinterpret_cast<const uint4*>(p.a + static_cast<size_t>(m) * p.K + kc);
        if (kQKV) {  // LN: ((x - mu) * rstd) * ns + nb in fp32, rounded to bf16
          bf16* e = reinterpret_cast<bf16*>(&a4);
          const float mu = p.mu[m], rs = p.rstd[m];
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            const float xn = __fmul_rn(__fsub_rn(__bfloat162float(e[j]), mu), rs);
            e[j] = __float2bfloat16(__fadd_rn(__fmul_rn(xn, p.ns[kc + j]), p.nb[kc + j]));
          }
        }
      }
      *reinterpret_cast<uint4*>(As + r * kAS + c8 * 8) = a4;
      *reinterpret_cast<uint4*>(Bs + r * kAS + c8 * 8) =
          *reinterpret_cast<const uint4*>(w + static_cast<size_t>(n0 + r) * p.K + kc);
    }
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < kBK / 16; ++ks) {
      const bf16* ap = As + (warp * 16 + g) * kAS + ks * 16 + 2 * t;
      const uint32_t af[4] = {ld32(ap), ld32(ap + 8 * kAS), ld32(ap + 8), ld32(ap + 8 * kAS + 8)};
#pragma unroll
      for (int nt = 0; nt < kBN / 8; ++nt) {
        const bf16* bp = Bs + (nt * 8 + g) * kAS + ks * 16 + 2 * t;
        mma_bf16_16816(acc[nt], af, ld32(bp), ld32(bp + 8));
      }
    }
    __syncthreads();
  }

  const int ra = m0 + warp * 16 + g, rb = ra + 8;
  const float* __restrict__ bias = p.bias[which];
#pragma unroll
  for (int nt = 0; nt < kBN / 8; ++nt) {
    const int n = n0 + nt * 8 + 2 * t;
    const float b0 = bias[n], b1 = bias[n + 1];
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int m = half ? rb : ra;
      if (m >= p.M) continue;
      const float y0 = __fadd_rn(acc[nt][2 * half], b0), y1 = __fadd_rn(acc[nt][2 * half + 1], b1);
      if (kQKV) {
        const int b = m / p.S, s = m - b * p.S, h = n / kD, j = n - h * kD;
        bf16* dst = p.qkv + static_cast<size_t>(which) * p.M * p.n_per +
                    (static_cast<size_t>(b * p.H + h) * p.S + s) * kD + j;
        *reinterpret_cast<__nv_bfloat162*>(dst) = __floats2bfloat162_rn(y0, y1);
      } else {
        const size_t at = static_cast<size_t>(m) * p.n_per + n;
        const __nv_bfloat162 x2 = *reinterpret_cast<const __nv_bfloat162*>(p.x + at);
        const float o0 = __fadd_rn(__bfloat162float(x2.x), __fmul_rn(p.gamma[n], y0));
        const float o1 = __fadd_rn(__bfloat162float(x2.y), __fmul_rn(p.gamma[n + 1], y1));
        *reinterpret_cast<__nv_bfloat162*>(p.out + at) = __floats2bfloat162_rn(o0, o1);
      }
    }
  }
}

// (c), S <= 512: one block per (image, head), the whole head staged
__global__ void __launch_bounds__(kWarps * 32) attn_small_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ o,
                                                         int H, int S, int Sp, int VS, size_t plane, int D,
                                                         float scale) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [Sp][kKS]
  bf16* Vt = Ks + Sp * kKS;                      // [kD][VS]
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const bf16* qh = qkv + static_cast<size_t>(bh) * S * kD;
  stage_k_rows(qh + plane, Ks, S, Sp);
  stage_vt(qh + 2 * plane, Vt, S, Sp, VS);
  __syncthreads();
  attend_head<true>(qh, Ks, Vt, o + static_cast<size_t>(b) * S * D + h * kD, D, S, Sp, VS, 0, scale);
}

// (c), S > 512: one block per (image, head, 64 query rows), 4 warps; pass 1
// takes each row's max and sum over 64-key tiles, pass 2 restages K and V^T
// tile by tile for (p / l) V
__global__ void __launch_bounds__(128) attn_tiled_kernel(const bf16* __restrict__ qkv, bf16* __restrict__ o, int H,
                                                         int S, size_t plane, int D, float scale) {
  __shared__ __align__(16) unsigned char smem_raw[(kChunk * kKS + kD * kTileVS) * sizeof(bf16)];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [kChunk][kKS]
  bf16* Vt = Ks + kChunk * kKS;                  // [kD][kTileVS]
  const int bh = blockIdx.x, b = bh / H, h = bh - b * H;
  const bf16* qh = qkv + static_cast<size_t>(bh) * S * kD;
  const bf16* kh = qh + plane;
  const bf16* vh = qh + 2 * plane;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int ra = blockIdx.y * 64 + warp * 16 + g, rb = ra + 8;
  uint32_t qa[kD / 16][4];
  load_q(qh, ra, rb, S, t, qa);

  float ma = neg_inf(), mb = neg_inf(), la = 0.f, lb = 0.f;
  for (int kbase = 0; kbase < S; kbase += kChunk) {
    __syncthreads();
    stage_k_rows(kh + static_cast<size_t>(kbase) * kD, Ks, S - kbase, kChunk);
    __syncthreads();
    float s[kChunk / 8][4];
    qk_chunk(qa, Ks, 0, g, t, s);
    mask_chunk(s, kbase, S, ra, rb, 0, scale, t);
    online_stats(s, ma, mb, la, lb);
  }
  quad_stats(ma, la);
  quad_stats(mb, lb);

  float acc[kD / 8][4];
#pragma unroll
  for (int dn = 0; dn < kD / 8; ++dn) acc[dn][0] = acc[dn][1] = acc[dn][2] = acc[dn][3] = 0.f;
  for (int kbase = 0; kbase < S; kbase += kChunk) {
    __syncthreads();
    stage_k_rows(kh + static_cast<size_t>(kbase) * kD, Ks, S - kbase, kChunk);
    stage_vt(vh + static_cast<size_t>(kbase) * kD, Vt, S - kbase, kChunk, kTileVS);
    __syncthreads();
    float s[kChunk / 8][4];
    qk_chunk(qa, Ks, 0, g, t, s);
    mask_chunk(s, kbase, S, ra, rb, 0, scale, t);
#pragma unroll
    for (int nt = 0; nt < kChunk / 8; ++nt) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[nt][j] = expf(s[nt][j] - ma) / la;
        s[nt][2 + j] = expf(s[nt][2 + j] - mb) / lb;
      }
    }
    pv_chunk(s, Vt, kTileVS, 0, g, t, acc);
  }
  store_rows(acc, o + static_cast<size_t>(b) * S * D + h * kD, D, ra, rb, S, 1.f, 1.f, t);
}

}  // namespace

// x, out: [B, S, D] bf16; vecs: fp32 [7, D] (ns, nb, bq, bk, bv, bo, gamma);
// wq, wk, wv, wo: bf16 [D, D] (out, in). Scratch from the caller: stats fp32
// [2, B*S], qkv bf16 [3, B, H, S, 64], attn bf16 [B*S, D]. key_tiled != 0
// takes the key-tiled attention stage at any S. One call.
MERV_EXPORT int fused_vit_attn_block_bf16(const void* x, const void* vecs, const void* wq, const void* wk,
                                          const void* wv, const void* wo, void* stats, void* qkv, void* attn,
                                          void* out, int B, int S, int D, int H, int key_tiled, float eps,
                                          float scale, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || D != H * kD) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int M = B * S;
  const float* v = static_cast<const float*>(vecs);
  float* mu = static_cast<float*>(stats);
  float* rstd = mu + M;
  bf16* qkv_b = static_cast<bf16*>(qkv);
  bf16* attn_b = static_cast<bf16*>(attn);
  const size_t plane = static_cast<size_t>(M) * D;
  cudaError_t e;

  row_stats_kernel<<<(M + 7) / 8, 256, 0, st>>>(static_cast<const bf16*>(x), mu, rstd, M, D, eps);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  GemmArgs a{};
  a.a = static_cast<const bf16*>(x);
  a.w[0] = static_cast<const bf16*>(wq);
  a.w[1] = static_cast<const bf16*>(wk);
  a.w[2] = static_cast<const bf16*>(wv);
  a.bias[0] = v + 2 * D;
  a.bias[1] = v + 3 * D;
  a.bias[2] = v + 4 * D;
  a.M = M;
  a.K = D;
  a.n_per = D;
  a.mu = mu;
  a.rstd = rstd;
  a.ns = v;
  a.nb = v + D;
  a.qkv = qkv_b;
  a.S = S;
  a.H = H;
  gemm_kernel<true><<<dim3((M + kBM - 1) / kBM, 3 * D / kBN), kGemmThreads, 0, st>>>(a);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  if (S <= kMaxT && !key_tiled) {
    const int Sp = padded_t(S);
    const size_t smem = smem_bytes(S);
    e = cudaFuncSetAttribute(attn_small_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    attn_small_kernel<<<B * H, kWarps * 32, smem, st>>>(qkv_b, attn_b, H, S, Sp, vt_stride(Sp), plane, D, scale);
  } else {
    attn_tiled_kernel<<<dim3(B * H, (S + 63) / 64), 128, 0, st>>>(qkv_b, attn_b, H, S, plane, D, scale);
  }
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  GemmArgs o{};
  o.a = attn_b;
  o.w[0] = o.w[1] = o.w[2] = static_cast<const bf16*>(wo);
  o.bias[0] = o.bias[1] = o.bias[2] = v + 5 * D;
  o.M = M;
  o.K = D;
  o.n_per = D;
  o.x = static_cast<const bf16*>(x);
  o.gamma = v + 6 * D;
  o.out = static_cast<bf16*>(out);
  gemm_kernel<false><<<dim3((M + kBM - 1) / kBM, D / kBN), kGemmThreads, 0, st>>>(o);
  return static_cast<int>(cudaGetLastError());
}
