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
// Design. A block owns 128 output columns (weight rows) and one split of K;
// the splits of a column tile form one thread block cluster (at most 8, the
// portable size) and add their partial sums through distributed shared
// memory, in split order, so a call is one launch, needs no workspace and no
// counter, and gives the same bits every time. The host's plan
// (ops/int8_linear.py::int8_linear_plan) picks the splits from the kernel's
// real residency: as many as one wave holds, so that each SM runs as many
// warps as it can (with one block of four consumer warps an SM, the loop's
// conversions and loads are latency-bound).
//   - A producer warp streams the block's K range by TMA into a ring of 4
//     stages on mbarriers: per 128-wide k step one 16 KB box of weights
//     ([128 columns, 128 k] int8, 128-byte swizzle) and two boxes of x
//     ([8*MT rows, 64 k] bf16, the same swizzle; rows past M read as 0). The
//     ring keeps 64 KB a block in flight, more than Little's law asks of an
//     SM at 3.35 TB/s; x is read from L2 once a block of 128 columns.
//   - Eight consumer warps own 16 columns each and run the m16n8k16 bf16
//     tensor-core product (mma.sync: A from registers, as the int8 weights
//     must be converted before any product; x's rows, 1..64, are the product's
//     8-wide n, so the x tile of every width is one instruction shape; wgmma
//     would need x re-laid in shared memory in the weights' k order). The
//     weights are A: a lane reads 16 contiguous weight bytes of a row, which
//     convert exactly to bf16 (through fp32, the 2^23 trick; an all-bf16
//     form with fewer instructions measured slower) and fill its
//     fragment slots of four k16 steps (step s takes bytes 4s..4s+3: lane
//     (g, t) of step s holds physical k = 16 t + 4 s + {0, 1, 2, 3} for the
//     logical slots {2t, 2t+1, 2t+8, 2t+9}); x, B, is read in the same k
//     order. Fragment row g reads tile row frag_row(g), so that the two rows a
//     quarter-warp reads sit 4 chunks apart under the swizzle: no bank
//     conflicts for the weights or for x.
//   - Programmatic dependent launch: each block lets the next kernel on the
//     stream start at once, and the producer streams its first stages'
//     weights before it waits for the kernel before it (griddepcontrol), so
//     in a run of int8 Linears (q, k, v; gate, up) one's weight loads overlap
//     the tail of the one before; x is loaded, and y written, only after the
//     wait. Kernels not launched so (all of PyTorch's) wait as usual.
//   - The partial sums go to shared memory (the ring, once drained), the
//     cluster syncs, and each block adds a share of the tile's outputs over
//     the splits in split order, then applies the scale, the roundings and
//     the bias.
#include "hopper.cuh"

namespace {

constexpr int kCols = 128;       // output columns (weight rows) per block
constexpr int kStepK = 128;      // k per ring stage: one 128-byte swizzled row of weights per column
constexpr int kStages = 4;
constexpr int kConsumers = 8;    // warps of 16 columns
constexpr int kThreads = (kConsumers + 1) * 32;
constexpr int kMaxSplits = 8;    // a portable cluster
constexpr int kPitch = kCols + 4;  // floats per row of the partial sums (conflict-free writes)

template <int MT>
struct Layout {
  static constexpr int kRows = 8 * MT;             // rows of x staged: M rounded up to the mma's 8
  static constexpr int kW = kCols * kStepK;        // weights of one stage
  static constexpr int kXBox = kRows * 128;        // one 64-k box of x
  static constexpr int kStage = kW + 2 * kXBox;    // a multiple of 1024: every box is swizzle-atom aligned
  static constexpr int kRing = kStages * kStage;
  static constexpr int kPartial = kRows * kPitch * 4;
  static_assert(kPartial <= kRing, "the partial sums reuse the ring");
  static constexpr int kSmem = kRing + 2 * kStages * 8 + 1024;  // + the barriers, + alignment slack
};

// Tile row that fragment row g (0..7) reads: rows g and g + 1 of a quarter-warp
// differ in bit 2 of (row % 8), which the 128-byte swizzle XORs into the chunk.
__device__ __forceinline__ int frag_row(int g) { return ((g & 1) << 2) | (g >> 1); }

struct Args {
  const float* scale;
  const bf16* bias;
  bf16* y;
  int M, N, steps, splits;  // steps: ceil(K / 128)
};

template <int MT>
__global__ void __launch_bounds__(kThreads) int8_linear_kernel(const __grid_constant__ CUtensorMap wmap,
                                                               const __grid_constant__ CUtensorMap xmap,
                                                               const Args a) {
  using L = Layout<MT>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kRing);
  uint64_t* empty = full + kStages;
  const int split = blockIdx.x, n0 = blockIdx.y * kCols;
  const int s_begin = split * a.steps / a.splits, s_end = (split + 1) * a.steps / a.splits;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers);
    }
    mbar_fence_init();
  }
  __syncthreads();

  float* part = reinterpret_cast<float*>(smem);  // [kRows][kPitch], after the ring has drained
  // the next int8 Linear on the stream may start now: its weights do not depend on this one
  griddep_launch_dependents();
  if (warp == kConsumers) {
    if (lane == 0) {
      auto load_x = [&](int s, int stage) {
        unsigned char* st = smem + stage * L::kStage;
        tma_load_2d(st + L::kW, &xmap, &full[stage], s * kStepK, 0);
        tma_load_2d(st + L::kW + L::kXBox, &xmap, &full[stage], s * kStepK + 64, 0);
      };
      // the first stages' weights stream before x may be read (x comes from the kernel before this one)
      const int early = min(kStages, s_end - s_begin);
      RingPos pos;
      for (int s = s_begin; s < s_end; ++s, pos.next(kStages)) {
        mbar_wait_or_trap(&empty[pos.stage], pos.phase ^ 1);
        unsigned char* st = smem + pos.stage * L::kStage;
        mbar_arrive_expect_tx(&full[pos.stage], L::kStage);
        tma_load_2d(st, &wmap, &full[pos.stage], s * kStepK, n0);
        if (s - s_begin >= early) load_x(s, pos.stage);
        if (s - s_begin == early - 1) {
          griddep_wait();
          for (int i = 0; i < early; ++i) load_x(s_begin + i, i);
        }
      }
    }
  } else {
    const int g = lane >> 2, t = lane & 3;
    const int r = 16 * warp + frag_row(g);  // the mma's row g; r + 8 its row g + 8 (both r % 8 == frag_row(g))
    float acc[MT][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) acc[mt][0] = acc[mt][1] = acc[mt][2] = acc[mt][3] = 0.f;

    RingPos pos;
    for (int s = s_begin; s < s_end; ++s, pos.next(kStages)) {
      mbar_wait_or_trap(&full[pos.stage], pos.phase);
      const unsigned char* w = smem + pos.stage * L::kStage;
#pragma unroll
      for (int c = 0; c < 2; ++c) {  // the stage's two 64-k chunks
        uint32_t af[4][4];
        {
          const int off = (((4 * c + t) ^ (r & 7)) << 4);
          const uint4 wa = lds128(w + r * 128 + off), wb = lds128(w + (r + 8) * 128 + off);
          const uint32_t ra[4] = {wa.x, wa.y, wa.z, wa.w}, rb[4] = {wb.x, wb.y, wb.z, wb.w};
#pragma unroll
          for (int st = 0; st < 4; ++st) {
            af[st][0] = i8_pair(ra[st], 0);  // row g,     k 16t+4st+{0,1}
            af[st][1] = i8_pair(rb[st], 0);  // row g + 8, the same k
            af[st][2] = i8_pair(ra[st], 2);  // row g,     k 16t+4st+{2,3}
            af[st][3] = i8_pair(rb[st], 2);  // row g + 8
          }
        }
        const unsigned char* xb = w + L::kW + c * L::kXBox;
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          const unsigned char* xr = xb + (8 * mt + g) * 128;  // x row 8 mt + g: its row % 8 is g
          const uint4 x0 = lds128(xr + (((2 * t) ^ g) << 4)), x1 = lds128(xr + (((2 * t + 1) ^ g) << 4));
          const uint32_t xw[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int st = 0; st < 4; ++st) mma_bf16(acc[mt], af[st], xw[2 * st], xw[2 * st + 1]);
        }
      }
      __syncwarp();
      if (lane == 0) mbar_arrive(&empty[pos.stage]);
    }
    // every consumer is past its last stage before any partial overwrites the ring
    named_barrier_sync(1, kConsumers * 32);
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // accumulator i of lane (g, t): column r (+8 for i >= 2), row of x 8mt + 2t (+1 for odd i)
      const int m = 8 * mt + 2 * t;
      part[m * kPitch + r] = acc[mt][0];
      part[(m + 1) * kPitch + r] = acc[mt][1];
      part[m * kPitch + r + 8] = acc[mt][2];
      part[(m + 1) * kPitch + r + 8] = acc[mt][3];
    }
  }
  __syncwarp();
  cluster_sync();
  griddep_wait();  // y may be read by the kernel before this one until it has finished

  // this block's share of the tile's outputs, summed over the splits in split order
  for (int e = split * kThreads + threadIdx.x; e < a.M * kCols; e += a.splits * kThreads) {
    const int m = e / kCols, col = e % kCols, n = n0 + col;
    if (n >= a.N) continue;
    const float* mine = part + m * kPitch + col;
    float p[kMaxSplits];
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q) p[q] = q < a.splits ? ld_cluster(cluster_addr(mine, q)) : 0.f;
    float sum = 0.f;
#pragma unroll
    for (int q = 0; q < kMaxSplits; ++q) sum += p[q];  // split order; the absent splits add 0
    const float sc = __bfloat162float(__float2bfloat16(a.scale[n]));
    bf16 out = __float2bfloat16(__bfloat162float(__float2bfloat16(sum)) * sc);
    if (a.bias != nullptr) out = __float2bfloat16(__bfloat162float(out) + __bfloat162float(a.bias[n]));
    a.y[static_cast<size_t>(m) * a.N + n] = out;
  }
  cluster_sync();  // no block leaves while another still reads its partial sums
}

template <int MT>
cudaError_t launch(const void* x, const void* q, const Args& a, int K, cudaStream_t stream) {
  using L = Layout<MT>;
  CUtensorMap wmap, xmap;
  const cuuint64_t wdims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(a.N)};
  const cuuint64_t wstride[1] = {static_cast<cuuint64_t>(K)};
  const cuuint32_t wbox[2] = {kStepK, kCols};
  cudaError_t e = make_map(&wmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, q, wdims, wstride, wbox,
                           CU_TENSOR_MAP_SWIZZLE_128B);
  const cuuint64_t xdims[2] = {static_cast<cuuint64_t>(K), static_cast<cuuint64_t>(a.M)};
  const cuuint64_t xstride[1] = {static_cast<cuuint64_t>(K) * 2};
  const cuuint32_t xbox[2] = {64, static_cast<cuuint32_t>(L::kRows)};
  if (e == cudaSuccess)
    e = make_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, x, xdims, xstride, xbox, CU_TENSOR_MAP_SWIZZLE_128B);
  if (e != cudaSuccess) return e;
  const dim3 grid(a.splits, (a.N + kCols - 1) / kCols, 1);
  return launch_clustered(int8_linear_kernel<MT>, grid, kThreads, L::kSmem, a.splits, stream, true, wmap, xmap, a);
}

// Once per device: every instantiation may take the whole shared memory. The
// record is a static of this non-inline function: one per library.
cudaError_t setup() {
  static int done[64] = {0};
  int sms = 0;
  return device_setup(done, &sms, int8_linear_kernel<1>, int8_linear_kernel<2>, int8_linear_kernel<3>,
                     int8_linear_kernel<4>, int8_linear_kernel<5>, int8_linear_kernel<6>, int8_linear_kernel<7>,
                     int8_linear_kernel<8>);
}

template <int MT>
cudaError_t residency(int* clusters) {
  return cluster_residency(int8_linear_kernel<MT>, kThreads, Layout<MT>::kSmem, kMaxSplits, clusters);
}

}  // namespace

// x, q, scale, bias (or null), y: device pointers as above; splits: the K
// splits of a column tile (one cluster), 1..8 and at most ceil(K / 128).
MERV_EXPORT int int8_linear_bf16(const void* x, const void* q, const void* scale, const void* bias, void* y, int M,
                                 int N, int K, int splits, void* stream) {
  const int steps = (K + kStepK - 1) / kStepK;
  if (M < 1 || M > 64 || N < 1 || K < 64 || K % 64 || splits < 1 || splits > kMaxSplits || splits > steps)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = setup();
  if (e != cudaSuccess) return static_cast<int>(e);
  const Args a{static_cast<const float*>(scale), static_cast<const bf16*>(bias), static_cast<bf16*>(y), M, N, steps,
               splits};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch ((M + 7) / 8) {
    case 1: e = launch<1>(x, q, a, K, s); break;
    case 2: e = launch<2>(x, q, a, K, s); break;
    case 3: e = launch<3>(x, q, a, K, s); break;
    case 4: e = launch<4>(x, q, a, K, s); break;
    case 5: e = launch<5>(x, q, a, K, s); break;
    case 6: e = launch<6>(x, q, a, K, s); break;
    case 7: e = launch<7>(x, q, a, K, s); break;
    default: e = launch<8>(x, q, a, K, s); break;
  }
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

// The kernel's residency for M rows of x: clusters[c - 1] = how many clusters
// of c blocks (c = 1..8) the device holds at once.
MERV_EXPORT int int8_linear_residency(int M, int* clusters) {
  if (M < 1 || M > 64) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = setup();
  if (e != cudaSuccess) return static_cast<int>(e);
  switch ((M + 7) / 8) {
    case 1: e = residency<1>(clusters); break;
    case 2: e = residency<2>(clusters); break;
    case 3: e = residency<3>(clusters); break;
    case 4: e = residency<4>(clusters); break;
    case 5: e = residency<5>(clusters); break;
    case 6: e = residency<6>(clusters); break;
    case 7: e = residency<7>(clusters); break;
    default: e = residency<8>(clusters); break;
  }
  return static_cast<int>(e);
}
