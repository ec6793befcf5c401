// int8_linear (K4): the weight-only int8 product at decode row counts,
//   y[m, n] = bf16(bf16(bf16(sum_k x[m, k] q[n, k]) * bf16(scale[n])) + bf16(bias[n]))
// x bf16 [M, K] (1 <= M <= 64), q int8 [N, K] (the Linear's (out, in) layout),
// scale fp32 [N], bias bf16 [N] or none, y bf16 [M, N]; all contiguous and
// 16-byte aligned, K a multiple of 64. The sum is taken in fp32; the two (or
// three) roundings are merv_tpu's: `x @ q.astype(x.dtype)` rounds to the
// compute dtype, `* scale.astype(x.dtype)` rounds again, then the bias.
//
// Replaces no Pallas kernel: merv_tpu/nn/core.py::Linear (:126-133) with
// merv_tpu/nn/quantization.py's layout computes it as XLA, which fuses the
// int8 upcast into the matmul's read of the weights. A plain torch form
// (`x @ q.to(bf16).T`) would write and reread a bf16 copy of every weight.
//
// Bound on the H100: bytes. The weights are read once, N*K bytes, against
// 2*M*N*K operations: at M <= 64 that is at most 128 operations a byte, under
// the card's ~295 bf16 balance point.
//
// Design: each block owns 16 output columns n and runs 8 warps over K
// (split-K, the warps' sums added through shared memory at the end), so that
// a 4096-wide output already gives 2,048 warps streaming weights. A lane reads
// 16 contiguous weight bytes of two rows per 64-wide K chunk (16-byte loads
// that bypass L1), four chunks ahead. The product is the m16n8k16 bf16 tensor-
// core instruction with the weights as A (16 output columns x 16 k) and x as B
// (16 k x 8 rows of x), one instruction per 8 rows of x: the int8 values
// convert to bf16 exactly (|q| <= 127). Since the sum runs over k in any order,
// each lane's 16 contiguous bytes are spread over the four k16 steps of its
// chunk (step s takes bytes 4s..4s+3) and x is read in the same order: lane
// (g, t) of step s holds physical k = 16 t + 4 s + {0, 1, 2, 3} for the
// logical slots {2t, 2t+1, 2t+8, 2t+9} of the fragment layout (common.cuh),
// for A and B alike. x stays in L1 and L2 (at most 64 x 11008 x 2 bytes).
#include "common.cuh"

namespace {

constexpr int kWarps = 8;   // split-K warps per block
constexpr int kCols = 16;   // output columns per block: the mma's 16 A rows
constexpr int kChunk = 64;  // k per lane-quad per iteration: 4 lanes x 16 bytes
constexpr int kAhead = 4;   // chunks each warp loads before it multiplies

__device__ __forceinline__ int4 ld_stream(const int8_t* p) {
  int4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.s32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p));
  return v;
}

// byte i of w (a signed int8) as an exact float: 2^23 + (byte ^ 0x80) - (2^23 + 128)
__device__ __forceinline__ float i8_to_float(uint32_t w_biased, int i) {
  return __uint_as_float(__byte_perm(w_biased, 0x4B000000u, 0x7540u + i)) - 8388736.0f;
}

// bytes (lo, lo + 1) of a weight word as a bf16 pair (exact)
__device__ __forceinline__ uint32_t i8_pair(uint32_t w, int lo) {
  const uint32_t u = w ^ 0x80808080u;
  return pack_bf16(i8_to_float(u, lo), i8_to_float(u, lo + 1));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// MT: tiles of 8 rows of x (M <= 8 * MT)
template <int MT>
__global__ void __launch_bounds__(kWarps * 32) int8_linear_kernel(const bf16* __restrict__ x,
                                                                  const int8_t* __restrict__ q,
                                                                  const float* __restrict__ scale,
                                                                  const bf16* __restrict__ bias, bf16* __restrict__ y,
                                                                  int M, int N, int K) {
  __shared__ float red[kWarps][MT][32][4];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * kCols;
  // rows past N read row N - 1 (their sums are never stored)
  const int8_t* qa = q + static_cast<size_t>(min(n0 + g, N - 1)) * K + 16 * t;
  const int8_t* qb = q + static_cast<size_t>(min(n0 + g + 8, N - 1)) * K + 16 * t;
  const int chunks = K / kChunk;

  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;

  for (int c0 = warp; c0 < chunks; c0 += kWarps * kAhead) {
    int4 wa[kAhead], wb[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int c = c0 + u * kWarps;
      if (c < chunks) {
        wa[u] = ld_stream(qa + c * kChunk);
        wb[u] = ld_stream(qb + c * kChunk);
      } else {
        wa[u] = wb[u] = make_int4(0, 0, 0, 0);
      }
    }
#pragma unroll
    for (int u = 0; u < kAhead; ++u) {
      const int c = c0 + u * kWarps;
      if (c >= chunks) break;
      const uint32_t ra[4] = {static_cast<uint32_t>(wa[u].x), static_cast<uint32_t>(wa[u].y),
                              static_cast<uint32_t>(wa[u].z), static_cast<uint32_t>(wa[u].w)};
      const uint32_t rb[4] = {static_cast<uint32_t>(wb[u].x), static_cast<uint32_t>(wb[u].y),
                              static_cast<uint32_t>(wb[u].z), static_cast<uint32_t>(wb[u].w)};
      uint32_t a[4][4];
#pragma unroll
      for (int s = 0; s < 4; ++s) {
        a[s][0] = i8_pair(ra[s], 0);  // row g,     k 16t+4s+{0,1}
        a[s][1] = i8_pair(rb[s], 0);  // row g + 8, the same k
        a[s][2] = i8_pair(ra[s], 2);  // row g,     k 16t+4s+{2,3}
        a[s][3] = i8_pair(rb[s], 2);  // row g + 8
      }
      const int k0 = c * kChunk + 16 * t;
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        const int m = mt * 8 + g;
        uint32_t xw[8];
        if (m < M) {
          const int4* xp = reinterpret_cast<const int4*>(x + static_cast<size_t>(m) * K + k0);
          const int4 x0 = __ldg(xp), x1 = __ldg(xp + 1);
          xw[0] = x0.x, xw[1] = x0.y, xw[2] = x0.z, xw[3] = x0.w;
          xw[4] = x1.x, xw[5] = x1.y, xw[6] = x1.z, xw[7] = x1.w;
        } else {
#pragma unroll
          for (int i = 0; i < 8; ++i) xw[i] = 0u;
        }
#pragma unroll
        for (int s = 0; s < 4; ++s) mma_bf16(acc[mt], a[s], xw[2 * s], xw[2 * s + 1]);
      }
    }
  }

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int r = 0; r < 4; ++r) red[warp][mt][lane][r] = acc[mt][r];
  __syncthreads();
  for (int e = threadIdx.x; e < MT * 128; e += kWarps * 32) {
    const int mt = e >> 7, ln = (e >> 2) & 31, r = e & 3;
    float sum = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) sum += red[w][mt][ln][r];
    // accumulator element r of lane ln: output column g' (+8 for r >= 2), row of x 2t' (+1 for odd r)
    const int n = n0 + (ln >> 2) + (r >= 2 ? 8 : 0), m = mt * 8 + 2 * (ln & 3) + (r & 1);
    if (n < N && m < M) {
      const float s = __bfloat162float(__float2bfloat16(scale[n]));
      bf16 out = __float2bfloat16(__bfloat162float(__float2bfloat16(sum)) * s);
      if (bias != nullptr) out = __float2bfloat16(__bfloat162float(out) + __bfloat162float(bias[n]));
      y[static_cast<size_t>(m) * N + n] = out;
    }
  }
}

template <int MT>
cudaError_t launch(const void* x, const void* q, const void* scale, const void* bias, void* y, int M, int N, int K,
                   cudaStream_t stream) {
  int8_linear_kernel<MT><<<(N + kCols - 1) / kCols, kWarps * 32, 0, stream>>>(
      static_cast<const bf16*>(x), static_cast<const int8_t*>(q), static_cast<const float*>(scale),
      static_cast<const bf16*>(bias), static_cast<bf16*>(y), M, N, K);
  return cudaGetLastError();
}

}  // namespace

// x, q, scale, bias (or null), y: device pointers as above.
MERV_EXPORT int int8_linear_bf16(const void* x, const void* q, const void* scale, const void* bias, void* y, int M,
                                 int N, int K, void* stream) {
  if (M < 1 || M > 64 || N < 1 || K < kChunk || K % kChunk) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  switch ((M + 7) / 8) {
    case 1: e = launch<1>(x, q, scale, bias, y, M, N, K, s); break;
    case 2: e = launch<2>(x, q, scale, bias, y, M, N, K, s); break;
    case 3: e = launch<3>(x, q, scale, bias, y, M, N, K, s); break;
    case 4: e = launch<4>(x, q, scale, bias, y, M, N, K, s); break;
    case 5: e = launch<5>(x, q, scale, bias, y, M, N, K, s); break;
    case 6: e = launch<6>(x, q, scale, bias, y, M, N, K, s); break;
    case 7: e = launch<7>(x, q, scale, bias, y, M, N, K, s); break;
    default: e = launch<8>(x, q, scale, bias, y, M, N, K, s); break;
  }
  return static_cast<int>(e);
}
