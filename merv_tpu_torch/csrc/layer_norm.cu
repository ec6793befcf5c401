// layer_norm (K6): LayerNorm over the last dimension in one pass,
//   y[r, :] = bf16((x[r, :] - mean) * rsqrt(var + eps) * w + b)
// x bf16 [rows, D] and y bf16 [rows, D] contiguous and 16-byte aligned, D in
// {768, 1024, 1152}; w and b [D], both fp32 (the towers' param_dtype) or both
// bf16. The arithmetic is the plain version's
// (ops/layer_norm.py::layer_norm_plain) in fp32: the mean as the row's sum
// times 1/D, the biased variance in a second pass over the row,
// (x - mean) * rsqrt(var + eps), times w, plus b, each rounded on its own,
// then one rounding to bf16. Two things differ: the sums' order, and the
// variance's sum of squares, which adds each (x - mean)^2 by a fused
// multiply-add (one rounding where the plain version rounds twice).
//
// Replaces no Pallas kernel: merv_tpu/nn/core.py::LayerNorm (:168-178) is
// left to XLA, which fuses the statistics and the affine map into the
// neighbouring work. The port's plain form runs ~10 eager kernels, each of
// which writes a full-size fp32 intermediate (~52 bytes moved an element).
//
// Bound on the H100: bytes. One read of x and one write of y, 4 bytes an
// element, against ~8 operations an element.
//
// Design: one warp a row, the row in registers. Lane l owns the 16-byte
// vectors l, l + 32, ... of every row (8 columns each; D = 1152's 144 vectors
// leave lanes 16-31 idle on their fifth), so a warp's loads and stores are
// 512 contiguous bytes, and a lane reads its columns of w and b once, into
// registers, for every row it takes. The sums go by warp shuffles: no shared
// memory and no barrier. The grid is persistent: warps stride over the rows,
// and each issues the loads of the row kAhead strides on before the current
// row's reductions, so kAhead + 1 rows a warp are in flight (2 ahead beat 1
// by 1-13 % at the towers' shapes, 3 ahead gained nothing more). The host
// sizes the grid from the kernel's residency (layer_norm_residency).
#include "common.cuh"

namespace {

constexpr int kThreads = 128;  // 4 warps, one row each at a time
constexpr int kWarps = kThreads / 32;
constexpr int kAhead = 2;  // rows a warp has loaded beyond the one it reduces

template <int D>
struct Row {
  static_assert(D % 8 == 0, "rows of whole 16-byte vectors");
  static constexpr int kVecs = D / 8;
  static constexpr int kIters = (kVecs + 31) / 32;  // vectors a lane holds
  static constexpr bool kRagged = kVecs % 32 != 0;
  __device__ static bool owns(int i, int lane) { return !kRagged || i * 32 + lane < kVecs; }
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float lo_bf16(uint32_t u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_bf16(uint32_t u) { return __uint_as_float(u & 0xffff0000u); }

template <int D>
__device__ __forceinline__ void load_row(const uint4* __restrict__ row, int lane, uint4 (&v)[Row<D>::kIters]) {
#pragma unroll
  for (int i = 0; i < Row<D>::kIters; ++i)
    if (Row<D>::owns(i, lane)) v[i] = __ldg(row + i * 32 + lane);
}

// the 8 values of a vector, in column order
__device__ __forceinline__ void unpack(const uint4& v, float (&f)[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    f[2 * k] = lo_bf16(u[k]);
    f[2 * k + 1] = hi_bf16(u[k]);
  }
}

template <int D, typename W>
__global__ void __launch_bounds__(kThreads) layer_norm_kernel(const uint4* __restrict__ x, const W* __restrict__ w,
                                                              const W* __restrict__ b, uint4* __restrict__ y, int rows,
                                                              float eps) {
  using R = Row<D>;
  const int lane = threadIdx.x & 31;
  const int stride = gridDim.x * kWarps;
  int row = blockIdx.x * kWarps + static_cast<int>(threadIdx.x >> 5);
  if (row >= rows) return;  // the whole warp

  float g[R::kIters][8], be[R::kIters][8];
#pragma unroll
  for (int i = 0; i < R::kIters; ++i) {
    const int c0 = 8 * (i * 32 + lane);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      g[i][j] = R::owns(i, lane) ? to_float(w[c0 + j]) : 0.f;
      be[i][j] = R::owns(i, lane) ? to_float(b[c0 + j]) : 0.f;
    }
  }

  // rows row, row + stride, ..., row + kAhead stride of this warp: the current one and those loaded ahead
  uint4 ring[kAhead + 1][R::kIters];
#pragma unroll
  for (int a = 0; a < kAhead; ++a)
    if (row + a * stride < rows) load_row<D>(x + static_cast<size_t>(row + a * stride) * R::kVecs, lane, ring[a]);
  for (; row < rows; row += stride) {
    const int next = row + kAhead * stride;
    if (next < rows) load_row<D>(x + static_cast<size_t>(next) * R::kVecs, lane, ring[kAhead]);
    const uint4(&cur)[R::kIters] = ring[0];

    float sum = 0.f;
#pragma unroll
    for (int i = 0; i < R::kIters; ++i) {
      if (!R::owns(i, lane)) continue;
      float f[8];
      unpack(cur[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) sum += f[j];
    }
    const float mean = __fmul_rn(warp_sum(sum), 1.0f / D);
    float sq = 0.f;
#pragma unroll
    for (int i = 0; i < R::kIters; ++i) {
      if (!R::owns(i, lane)) continue;
      float f[8];
      unpack(cur[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float d = __fsub_rn(f[j], mean);
        sq = __fmaf_rn(d, d, sq);
      }
    }
    const float rstd = rsqrtf(__fadd_rn(__fdiv_rn(warp_sum(sq), static_cast<float>(D)), eps));

    uint4* out = y + static_cast<size_t>(row) * R::kVecs;
#pragma unroll
    for (int i = 0; i < R::kIters; ++i) {
      if (!R::owns(i, lane)) continue;
      float f[8];
      unpack(cur[i], f);
#pragma unroll
      for (int j = 0; j < 8; ++j)
        f[j] = __fadd_rn(__fmul_rn(__fmul_rn(__fsub_rn(f[j], mean), rstd), g[i][j]), be[i][j]);
      out[i * 32 + lane] = make_uint4(pack_bf16(f[0], f[1]), pack_bf16(f[2], f[3]), pack_bf16(f[4], f[5]),
                                      pack_bf16(f[6], f[7]));
    }
#pragma unroll
    for (int a = 0; a < kAhead; ++a)
#pragma unroll
      for (int i = 0; i < R::kIters; ++i) ring[a][i] = ring[a + 1][i];
  }
}

template <int D, typename W>
cudaError_t launch(const void* x, const void* w, const void* b, void* y, int rows, float eps, int blocks,
                   cudaStream_t s) {
  layer_norm_kernel<D, W><<<blocks, kThreads, 0, s>>>(static_cast<const uint4*>(x), static_cast<const W*>(w),
                                                      static_cast<const W*>(b), static_cast<uint4*>(y), rows, eps);
  return cudaGetLastError();
}

template <int D, typename W>
cudaError_t residency(int* blocks_per_sm) {
  return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, layer_norm_kernel<D, W>, kThreads, 0);
}

}  // namespace

// y = LayerNorm(x) over rows of D (see above); w_bf16: w and b are bf16, else
// fp32. blocks: the grid, at most one block a kWarps rows.
MERV_EXPORT int layer_norm_bf16(const void* x, const void* w, const void* b, void* y, int rows, int D, float eps,
                                int w_bf16, int blocks, void* stream) {
  if (rows < 1 || blocks < 1 || blocks > (rows + kWarps - 1) / kWarps) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (D) {
    case 768: return static_cast<int>(w_bf16 ? launch<768, bf16>(x, w, b, y, rows, eps, blocks, s)
                                             : launch<768, float>(x, w, b, y, rows, eps, blocks, s));
    case 1024: return static_cast<int>(w_bf16 ? launch<1024, bf16>(x, w, b, y, rows, eps, blocks, s)
                                              : launch<1024, float>(x, w, b, y, rows, eps, blocks, s));
    case 1152: return static_cast<int>(w_bf16 ? launch<1152, bf16>(x, w, b, y, rows, eps, blocks, s)
                                              : launch<1152, float>(x, w, b, y, rows, eps, blocks, s));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// How many blocks of the kernel for width D an SM holds at once.
MERV_EXPORT int layer_norm_residency(int D, int w_bf16, int* blocks_per_sm) {
  switch (D) {
    case 768: return static_cast<int>(w_bf16 ? residency<768, bf16>(blocks_per_sm) : residency<768, float>(blocks_per_sm));
    case 1024:
      return static_cast<int>(w_bf16 ? residency<1024, bf16>(blocks_per_sm) : residency<1024, float>(blocks_per_sm));
    case 1152:
      return static_cast<int>(w_bf16 ? residency<1152, bf16>(blocks_per_sm) : residency<1152, float>(blocks_per_sm));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
