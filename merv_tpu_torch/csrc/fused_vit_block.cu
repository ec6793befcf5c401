// fused_vit_attn_block: a ViT layer's attention half,
//   out = x + gamma * (o_proj(attention(q, k, v)) + bo),  q/k/v = LN1(x) W + b,
// for x [B, S, D] bf16 with D = 64 * heads, or D = 72 * heads with D % 64 == 0
// (SigLIP so400m: 1152 = 16 x 72). Weights in Linear's (out, in)
// layout, bf16 [D, D]; the LN affine, the four biases and gamma in one fp32
// [7, D] block (ns, nb, bq, bk, bv, bo, gamma).
//
// Replaces merv_tpu/ops/fused_vit_block.py::fused_vit_attn_block
// (_fused_block_fwd_impl / _fused_block_kernel, pallas_call :135).
//
// Bound on the H100: operations. flops = 2*B*S*D*4D (the four projections)
// + 4*B*S*S*D (scores and PV), e.g. 3.95e10 at DINOv2's [16, 261, 1024]
// (0.040 ms at 989 TFLOP/s) against 25.5 MB of x, out and weights (0.0076 ms).
// The projections are 89 % of the flops there, so they have to run near the
// tensor cores' rate.
//
// Design. The TPU program holds one image's [S, D] rows and all four weights
// in VMEM; one DINOv2 image alone (534 KB) exceeds an SM's shared memory, so
// here one C entry point launches four kernels on the caller's stream and
// passes the intermediates through scratch buffers the caller allocates:
//  (a) ln_kernel: one warp per row, held in registers (D <= 2048), LN1's
//      fp32 mean and 1/sqrt(var + eps)
//      (kept for the stage checks) and xn = ((x - mu) * rstd) * ns + nb in
//      fp32, rounded once to bf16, into the attention output's scratch
//      (which nothing reads until (c) overwrites it), so that the GEMM's A
//      operand arrives by TMA as it lies;
//  (b) gemm_kernel<QKV>: [B*S, 3D] = xn W^T, the plain TN product: A [M, K]
//      and W [N, K] both K-major, loaded by 2-D TMA boxes of 128 (A) and 256
//      (W) rows x 64 columns (128-byte swizzle, zero fill past M and past a
//      weight's rows) into a ring of 3 stages guarded by full / empty
//      mbarriers. One producer thread issues the loads; two consumer
//      warpgroups each own 64 rows of a 128 x 256 output tile (two wgmma
//      m64n128k16 from shared memory a k step, one k slice in flight while
//      the next is issued). A persistent grid
//      walks the tiles, so one tile's epilogue runs while the producer loads
//      the next tile's slices. Epilogue, through shared memory in 16-byte
//      stores: + the fp32 bias, rounded to bf16, into q/k/v [3, B, H, S, 64];
//  (c) attention per (image, head) in the TPU kernel's order: m and l first,
//      then (p / l) rounded to bf16, then PV, o_h rounded to bf16; written as
//      [B*S, D] at column 64 h, the layout the o-projection reads. For
//      256 < S <= 512 B3's whole-head kernel in its kFused mode
//      (small_attn_hopper.cuh: persistent grid, K and V of a head by TMA, a
//      whole row of scores in registers up to S = 272). Otherwise
//      attn_tiled_kernel: 128 query rows per block on
//      two consumer warpgroups, 128-key K and V tiles by TMA through a ring
//      of 3 stages, two passes because l is needed before PV: pass 1 takes
//      QK^T and each row's max and sum (the sum rescaled as the max grows),
//      pass 2 takes QK^T again and p / l = 2^(s c - (m c + log2 l)) on one
//      FFMA and one ex2.approx.ftz, then PV. The two warpgroups take turns
//      on QK^T, so one's exponentials run beside the other's products.
//      By graph replay on an H100, B6 takes 12 % less time with the
//      whole-head stage at 257 and 261 tokens (a third 128-key tile, mostly
//      empty, costs the key-tiled stage two passes), and 7 % more at 196,
//      two full tiles (PERF.md §6): hence the split at 256;
//  (d) gemm_kernel<OPROJ>: o W_o^T in fp32, + bo, then x + gamma * y in fp32
//      and one rounding to bf16.
// Every product is wgmma; nothing here is a library call.
//
// Head dim 72 (HD = 72, a second instance of (b)'s q/k/v epilogue and of (c)'s
// key-tiled stage; the D = 64 instances compile as before, every step for 72
// behind `if constexpr`). The GEMMs need no new shape: K = 1152 is 18 k slices
// of 64, and N = 1152 a weight is 4.5 tiles of 256, the last tile's rows past
// the weight zero-filled by TMA and its columns past D not stored. The q/k/v
// epilogue writes head c / 72, dim c % 72 into [3, B, H, S, 72] (72 % 8 == 0:
// a 16-byte store never crosses a head); no padding, since the attention
// stage's TMA boxes read past column 72 as 0. The key-tiled stage keeps Q's,
// K's and V's first 64 columns in the 128-byte-swizzled tiles above and takes
// columns 64..79 as a 32-byte-wide slab each (hopper.cuh's make_tail_map: box
// {16, rows}, 32-byte swizzle, loaded at column 64; 72..79 lie past the tensor
// and read as 0), as small_attn_hopper.cuh does for K1 / B3: QK^T takes a fifth
// k step (m64n128k16 on the 32-byte slabs), P V an m64n16 product beside the
// m64n64 (columns 72..79 come out 0 and are not stored), and the output goes at
// column 72 h. The whole-head stage (kFused) is built for 64 only: at 72 the
// key-tiled stage takes every S.
#include <algorithm>

#include "small_attn_hopper.cuh"

namespace fused_block {
namespace {

constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups

// ---------------------------------------------------------------------------
// (a) LN1
// ---------------------------------------------------------------------------

constexpr int kMaxD = 2048;  // LN1 holds a row in registers: kMaxD / 256 16-byte chunks a lane

__global__ void __launch_bounds__(256) ln_kernel(const bf16* __restrict__ x, const float* __restrict__ ns,
                                                 const float* __restrict__ nb, float* __restrict__ mu,
                                                 float* __restrict__ rstd, bf16* __restrict__ xn, int M, int D,
                                                 float eps) {
  constexpr int kChunks = kMaxD / 256;
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5), lane = threadIdx.x & 31;
  if (row >= M) return;
  const bf16* xr = x + static_cast<size_t>(row) * D;
  uint4 held[kChunks];
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = lane * 8 + i * 256;
    if (c >= D) break;
    held[i] = *reinterpret_cast<const uint4*>(xr + c);
    const bf16* e = reinterpret_cast<const bf16*>(&held[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) s += __bfloat162float(e[j]);
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const float m = s / D;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    if (lane * 8 + i * 256 >= D) break;
    const bf16* e = reinterpret_cast<const bf16*>(&held[i]);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const float d = __bfloat162float(e[j]) - m;
      ss += d * d;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) ss += __shfl_xor_sync(0xffffffffu, ss, o);
  const float rs = rsqrtf(ss / D + eps);
  if (lane == 0) {
    mu[row] = m;
    rstd[row] = rs;
  }
  bf16* xo = xn + static_cast<size_t>(row) * D;
#pragma unroll
  for (int i = 0; i < kChunks; ++i) {
    const int c = lane * 8 + i * 256;
    if (c >= D) break;
    bf16* e = reinterpret_cast<bf16*>(&held[i]);
    const float4 s0 = *reinterpret_cast<const float4*>(ns + c), s1 = *reinterpret_cast<const float4*>(ns + c + 4);
    const float4 b0 = *reinterpret_cast<const float4*>(nb + c), b1 = *reinterpret_cast<const float4*>(nb + c + 4);
    const float sc[8] = {s0.x, s0.y, s0.z, s0.w, s1.x, s1.y, s1.z, s1.w};
    const float bi[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
    for (int j = 0; j < 8; ++j) {  // ((x - mu) * rstd) * ns + nb in fp32, rounded once
      const float n = __fmul_rn(__fsub_rn(__bfloat162float(e[j]), m), rs);
      e[j] = __float2bfloat16(__fadd_rn(__fmul_rn(n, sc[j]), bi[j]));
    }
    *reinterpret_cast<uint4*>(xo + c) = held[i];
  }
}

// ---------------------------------------------------------------------------
// (b), (d) the GEMM
// ---------------------------------------------------------------------------

// A 128 x 256 output tile a k slice of 64: 2 * 128 * 256 * 64 flops over
// 48 KB of operands, 87 flops a byte. 128 x 128 tiles (64 flops a byte) ran
// the QKV product at ~340 TFLOP/s, bound by the L2's bandwidth to the SMs.
constexpr int kTileM = 128;   // output rows of a tile (64 a consumer warpgroup)
constexpr int kTileN = 256;   // output columns of a tile (two m64n128 products a warpgroup)
constexpr int kGemmStages = 3;
constexpr uint32_t kABytes = kTileM * 128, kBBytes = kTileN * 128;  // rows x 64 bf16
constexpr int kCStride = 128 + 4;  // fp32 epilogue row: 128 columns, padded against bank conflicts

struct GemmSmem {
  bf16 a[kGemmStages][kTileM * 64];
  bf16 b[kGemmStages][kTileN * 64];
  float c[kTileM * kCStride];  // the epilogue's half tile
  uint64_t full[kGemmStages], empty[kGemmStages];
};

struct GemmArgs {
  int M, K, n_per, n_weights;  // A [M, K]; n_weights weights of [n_per, K]
  const float* bias;           // fp32, n_weights * n_per (QKV: bq | bk | bv; OPROJ: bo)
  bf16* qkv;                   // QKV: [3, B, H, S, HD]
  int S, H;
  const bf16* x;               // OPROJ: residual [M, n_per], gamma [n_per], out [M, n_per]
  const float* gamma;
  bf16* out;
};

// HD: the head dim the QKV epilogue writes (the OPROJ instance takes 64 and does not read it)
template <bool kQKV, int HD>
__global__ void __launch_bounds__(kThreads, 1)
    gemm_kernel(const __grid_constant__ CUtensorMap amap, const __grid_constant__ CUtensorMap w0,
                const __grid_constant__ CUtensorMap w1, const __grid_constant__ CUtensorMap w2, const GemmArgs p) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  GemmSmem& sm = *reinterpret_cast<GemmSmem*>(align_1024(smem_raw));
  const int tiles_m = (p.M + kTileM - 1) / kTileM;
  const int tiles_per_w = (p.n_per + kTileN - 1) / kTileN;  // a tile never straddles two weights
  const int n_tiles = tiles_m * tiles_per_w * p.n_weights;
  const int k_steps = p.K / 64;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < kGemmStages; ++s) {
      mbar_init(&sm.full[s], 1);
      mbar_init(&sm.empty[s], 8);  // the consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer: one thread issues every load ----------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      RingPos pos;
      for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
        const int tn = tile % (tiles_per_w * p.n_weights), tm = tile / (tiles_per_w * p.n_weights);
        const int which = tn / tiles_per_w, n0 = (tn - which * tiles_per_w) * kTileN;
        const CUtensorMap* wmap = which == 0 ? &w0 : (which == 1 ? &w1 : &w2);
        for (int kb = 0; kb < k_steps; ++kb, pos.next(kGemmStages)) {
          mbar_wait(&sm.empty[pos.stage], pos.phase ^ 1u);
          mbar_arrive_expect_tx(&sm.full[pos.stage], kABytes + kBBytes);
          tma_load_3d(sm.a[pos.stage], &amap, &sm.full[pos.stage], kb * 64, tm * kTileM, 0);
          tma_load_3d(sm.b[pos.stage], wmap, &sm.full[pos.stage], kb * 64, n0, 0);
        }
      }
    }
    return;
  }

  // ---------------- consumers: 64 rows of each tile a warpgroup ----------------
  setmaxnreg_inc<240>();
  const int cw = wg - 1;
  const int tid = threadIdx.x - wg * 128;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  RingPos pos;
  for (int tile = blockIdx.x; tile < n_tiles; tile += gridDim.x) {
    const int tn = tile % (tiles_per_w * p.n_weights), tm = tile / (tiles_per_w * p.n_weights);
    const int which = tn / tiles_per_w, n0 = (tn - which * tiles_per_w) * kTileN;
    float acc[2][64];  // columns 0-127 and 128-255 of the tile
    int prev = 0;
    for (int kb = 0; kb < k_steps; ++kb, pos.next(kGemmStages)) {
      mbar_wait(&sm.full[pos.stage], pos.phase);
      wgmma_fence();
      pin(acc[0]);
      pin(acc[1]);
#pragma unroll
      for (int ks = 0; ks < 4; ++ks) {
        const uint64_t da = kmajor_desc(sm.a[pos.stage], cw * 64, ks * 16);
        wgmma_ss_n128(acc[0], da, kmajor_desc(sm.b[pos.stage], 0, ks * 16), kb > 0 || ks > 0);
        wgmma_ss_n128(acc[1], da, kmajor_desc(sm.b[pos.stage], 128, ks * 16), kb > 0 || ks > 0);
      }
      wgmma_commit();
      wgmma_wait<1>();  // the previous slice's products are done: its stage may be refilled
      pin(acc[0]);
      pin(acc[1]);
      if (kb > 0 && lane == 0) mbar_arrive(&sm.empty[prev]);
      prev = pos.stage;
    }
    wgmma_wait<0>();
    pin(acc[0]);
    pin(acc[1]);
    if (lane == 0) mbar_arrive(&sm.empty[prev]);

    // Epilogue, 128 columns at a time through shared memory: each thread
    // writes its fragment (acc[h][4n + 2i + j] is row 16 warp + g + 8i,
    // column 128 h + 8n + 2t + j of the warpgroup's 64 x 256) as fp32, then
    // the warpgroup reads its 64 rows back 8 columns a thread and stores 16
    // bytes at a time: 8 threads write a head's 128-byte row. (The fragment's
    // own 4-byte scattered stores took longer than the product.)
    float* cw_rows = sm.c + cw * 64 * kCStride;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c0 = n0 + 128 * h;  // the half's first column in the weight's n_per
#pragma unroll
      for (int n = 0; n < 16; ++n)
#pragma unroll
        for (int i = 0; i < 2; ++i)
          *reinterpret_cast<float2*>(cw_rows + (warp * 16 + g + 8 * i) * kCStride + n * 8 + 2 * t) =
              make_float2(acc[h][4 * n + 2 * i], acc[h][4 * n + 2 * i + 1]);
      named_barrier_sync(1 + cw, 128);
#pragma unroll 2
      for (int q = tid; q < 64 * 16; q += 128) {
        const int r = q >> 4, col = c0 + (q & 15) * 8, m = tm * kTileM + cw * 64 + r;
        if (m < p.M && col < p.n_per) {
          const float4 y0 = *reinterpret_cast<const float4*>(cw_rows + r * kCStride + (q & 15) * 8);
          const float4 y1 = *reinterpret_cast<const float4*>(cw_rows + r * kCStride + (q & 15) * 8 + 4);
          const float* bias = p.bias + which * p.n_per + col;
          const float4 b0 = *reinterpret_cast<const float4*>(bias), b1 = *reinterpret_cast<const float4*>(bias + 4);
          float y[8] = {__fadd_rn(y0.x, b0.x), __fadd_rn(y0.y, b0.y), __fadd_rn(y0.z, b0.z), __fadd_rn(y0.w, b0.w),
                        __fadd_rn(y1.x, b1.x), __fadd_rn(y1.y, b1.y), __fadd_rn(y1.z, b1.z), __fadd_rn(y1.w, b1.w)};
          uint4 o;
          if constexpr (kQKV) {
            const int b = m / p.S, s = m - b * p.S, hh = col / HD, j = col - hh * HD;
            o = make_uint4(pack_bf16(y[0], y[1]), pack_bf16(y[2], y[3]), pack_bf16(y[4], y[5]), pack_bf16(y[6], y[7]));
            *reinterpret_cast<uint4*>(p.qkv + static_cast<size_t>(which) * p.M * p.n_per +
                                      (static_cast<size_t>(b * p.H + hh) * p.S + s) * HD + j) = o;
          } else {
            const size_t at = static_cast<size_t>(m) * p.n_per + col;
            const uint4 x4 = *reinterpret_cast<const uint4*>(p.x + at);
            const bf16* xe = reinterpret_cast<const bf16*>(&x4);
            const float4 g0 = *reinterpret_cast<const float4*>(p.gamma + col);
            const float4 g1 = *reinterpret_cast<const float4*>(p.gamma + col + 4);
            const float ga[8] = {g0.x, g0.y, g0.z, g0.w, g1.x, g1.y, g1.z, g1.w};
            float r8[8];
#pragma unroll
            for (int e = 0; e < 8; ++e) r8[e] = __fadd_rn(__bfloat162float(xe[e]), __fmul_rn(ga[e], y[e]));
            o = make_uint4(pack_bf16(r8[0], r8[1]), pack_bf16(r8[2], r8[3]), pack_bf16(r8[4], r8[5]),
                           pack_bf16(r8[6], r8[7]));
            *reinterpret_cast<uint4*>(p.out + at) = o;
          }
        }
      }
      named_barrier_sync(1 + cw, 128);  // the rows are read before the next half overwrites them
    }
  }
}

// ---------------------------------------------------------------------------
// (c), S <= 256 and S > 512: the key-tiled stage
// ---------------------------------------------------------------------------

constexpr int kRows = 128;  // query rows per block, 64 per consumer warpgroup
constexpr int kKeys = 128;  // keys per tile
constexpr int kKvStages = 3;
constexpr int kWholeHeadMinS = 2 * kKeys;  // the whole-head stage takes kWholeHeadMinS < S <= small_attn::kMaxT

template <int HD>
struct TiledSmem {
  bf16 q[kRows * 64];
  bf16 k[kKvStages][kKeys * 64];
  bf16 v[kKvStages][kKeys * 64];
  uint64_t q_full, k_full[kKvStages], v_full[kKvStages], empty[kKvStages];
};

// Head dim 72: columns 64..79 of Q, K and V in 32-byte rows (make_tail_map's
// boxes; 72..79 read as 0), after the 64-column tiles. Every array starts on a
// 1024-byte boundary.
template <>
struct TiledSmem<72> {
  bf16 q[kRows * 64];
  bf16 k[kKvStages][kKeys * 64];
  bf16 v[kKvStages][kKeys * 64];
  bf16 q32[kRows * 16];
  bf16 k32[kKvStages][kKeys * 16];
  bf16 v32[kKvStages][kKeys * 16];
  uint64_t q_full, k_full[kKvStages], v_full[kKvStages], empty[kKvStages];
};

// keys >= S of the tile at kbase -> -inf
__device__ __forceinline__ void mask_tile(float (&sc)[64], int kbase, int S, int t) {
  if (kbase + kKeys <= S) return;
#pragma unroll
  for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      if (kbase + 8 * n + 2 * t + j >= S) sc[4 * n + j] = sc[4 * n + 2 + j] = neg_inf();
    }
  }
}

// HD: the head dim, 64 or 72. qmap32 / kmap32 / vmap32 map columns 64..79 at
// 72 (unused copies at 64).
template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    attn_tiled_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap qmap32,
                      const __grid_constant__ CUtensorMap kmap32, const __grid_constant__ CUtensorMap vmap32,
                      bf16* __restrict__ o, int H, int S, float scale_log2) {
  static_assert(HD == 64 || HD == 72, "fused_vit_block: head dim 64 or 72");
  constexpr bool kWide = HD > 64;
  constexpr uint32_t kQBytes = kRows * 128 + (kWide ? kRows * 32 : 0);     // TMA bytes of Q
  constexpr uint32_t kTileBytes = kKeys * 128 + (kWide ? kKeys * 32 : 0);  // of a K or a V tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  TiledSmem<HD>& sm = *reinterpret_cast<TiledSmem<HD>*>(align_1024(smem_raw));
  const int bh = blockIdx.x, row0 = blockIdx.y * kRows;
  const int n_tiles = (S + kKeys - 1) / kKeys;

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < kKvStages; ++s) {
      mbar_init(&sm.k_full[s], 1);
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], 8);  // the consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer: Q once, then K tiles (pass 1), then K and V tiles (pass 2) ----------------
    setmaxnreg_dec<24>();
    if (threadIdx.x == 0) {
      mbar_arrive_expect_tx(&sm.q_full, kQBytes);
      tma_load_3d(sm.q, &qmap, &sm.q_full, 0, row0, bh);
      if constexpr (kWide) tma_load_3d(sm.q32, &qmap32, &sm.q_full, 64, row0, bh);
      RingPos pos;
      for (int j = 0; j < 2 * n_tiles; ++j, pos.next(kKvStages)) {
        const int second = j >= n_tiles, kbase = (j - second * n_tiles) * kKeys;
        mbar_wait(&sm.empty[pos.stage], pos.phase ^ 1u);
        mbar_arrive_expect_tx(&sm.k_full[pos.stage], kTileBytes);
        tma_load_3d(sm.k[pos.stage], &kmap, &sm.k_full[pos.stage], 0, kbase, bh);
        if constexpr (kWide) tma_load_3d(sm.k32[pos.stage], &kmap32, &sm.k_full[pos.stage], 64, kbase, bh);
        if (second) {
          mbar_arrive_expect_tx(&sm.v_full[pos.stage], kTileBytes);
          tma_load_3d(sm.v[pos.stage], &vmap, &sm.v_full[pos.stage], 0, kbase, bh);
          if constexpr (kWide) tma_load_3d(sm.v32[pos.stage], &vmap32, &sm.v_full[pos.stage], 64, kbase, bh);
        }
      }
    }
    return;
  }

  // ---------------- consumers: 64 query rows each ----------------
  setmaxnreg_inc<240>();
  const int cw = wg - 1;
  const int tid = threadIdx.x - wg * 128;
  const int warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  const bf16* qw = sm.q + cw * 64 * 64;  // this warpgroup's 64 rows (8 KB into the 128-row box)

  // The two warpgroups take turns on the tensor cores, as small_attn_hopper.cuh's
  // do: a warpgroup computes a tile's scores only after the other's are done
  // (barrier 4 + cw, 256 threads) and lets the other go once its own are
  // (barrier 5 - cw), so one's QK^T runs while the other's exponentials do.
  // Warpgroup 0 goes first.
  if (cw == 1) named_barrier_arrive(4, 256);
  float sc[64];
  auto tile_scores = [&](int stage) {  // S = Q K^T over one 128-key tile (m64n128, both K-major)
    named_barrier_sync(4 + cw, 256);
    wgmma_fence();
    pin(sc);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n128(sc, kmajor_desc(qw, 0, ks * 16), kmajor_desc(sm.k[stage], 0, ks * 16), ks > 0);
    if constexpr (kWide)  // the fifth k step: head dims 64..79, Q's (this warpgroup's rows, 2 KB in) and K's slabs
      wgmma_ss_n128(sc, sw32_desc(reinterpret_cast<const unsigned char*>(sm.q32) + cw * 64 * 32, 16, 256),
                    sw32_desc(sm.k32[stage], 16, 256), 1);
    wgmma_commit();
    wgmma_wait<0>();
    pin(sc);
    named_barrier_arrive(5 - cw, 256);
  };

  // pass 1: each row's max and sum in log2 units of the scaled scores; the
  // quad shares the max, each thread keeps its share of the sum
  float ma = neg_inf(), mb = neg_inf(), la = 0.f, lb = 0.f;
  mbar_wait(&sm.q_full, 0);
  RingPos pos;
  for (int j = 0; j < n_tiles; ++j, pos.next(kKvStages)) {
    mbar_wait(&sm.k_full[pos.stage], pos.phase);
    tile_scores(pos.stage);
    if (lane == 0) mbar_arrive(&sm.empty[pos.stage]);  // the scores are in registers
    mask_tile(sc, j * kKeys, S, t);
    float ca = neg_inf(), cb = neg_inf();
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
      ca = fmaxf(ca, fmaxf(sc[4 * n], sc[4 * n + 1]));
      cb = fmaxf(cb, fmaxf(sc[4 * n + 2], sc[4 * n + 3]));
    }
    // every tile holds a valid key of every row, so the max is finite from tile 0 on
    const float na = fmaxf(ma, quad_max(ca) * scale_log2), nb = fmaxf(mb, quad_max(cb) * scale_log2);
    la *= ex2_ftz(ma - na);  // 0 on the first tile (ma = -inf)
    lb *= ex2_ftz(mb - nb);
    ma = na;
    mb = nb;
#pragma unroll
    for (int n = 0; n < kKeys / 8; ++n) {
#pragma unroll
      for (int jj = 0; jj < 2; ++jj) {
        la += ex2_ftz(fmaf(sc[4 * n + jj], scale_log2, -ma));
        lb += ex2_ftz(fmaf(sc[4 * n + 2 + jj], scale_log2, -mb));
      }
    }
  }
  // p / l = 2^(s c - (m c + log2 l))
  const float ba = ma + __log2f(quad_sum(la)), bb = mb + __log2f(quad_sum(lb));

  // pass 2: (p / l) rounded to bf16, then PV. A stage's V barrier completes
  // only on its pass-2 uses: its phase is kept apart (bit s of v_phases).
  float acc[32];
  float acc32[8];  // HD = 72: columns 64..79 (72..79 are 0)
  uint32_t v_phases = 0;
  for (int j = 0; j < n_tiles; ++j, pos.next(kKvStages)) {
    mbar_wait(&sm.k_full[pos.stage], pos.phase);
    tile_scores(pos.stage);
    mask_tile(sc, j * kKeys, S, t);
    auto p = [&](int i, float bias) { return ex2_ftz(fmaf(sc[i], scale_log2, -bias)); };
    uint32_t pf[kKeys / 16][4];
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      const int i = 8 * kk;
      pf[kk][0] = pack_bf16(p(i, ba), p(i + 1, ba));
      pf[kk][1] = pack_bf16(p(i + 2, bb), p(i + 3, bb));
      pf[kk][2] = pack_bf16(p(i + 4, ba), p(i + 5, ba));
      pf[kk][3] = pack_bf16(p(i + 6, bb), p(i + 7, bb));
    }
    mbar_wait(&sm.v_full[pos.stage], (v_phases >> pos.stage) & 1u);
    v_phases ^= 1u << pos.stage;
    wgmma_fence();
    pin(acc);
    if constexpr (kWide) pin(acc32);
    pin(pf);
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      wgmma_rs_n64_tb(acc, pf[kk], mnmajor_desc(sm.v[pos.stage], kk * 16, kKeys * 128), j > 0 || kk > 0);
      if constexpr (kWide)  // V's 32-byte slab, MN-major: keys 16 kk .. 16 kk + 15 at 512 kk bytes
        wgmma_rs_n16_tb(acc32, pf[kk],
                        sw32_desc(reinterpret_cast<const unsigned char*>(sm.v32[pos.stage]) + kk * 512, kKeys * 32,
                                  256),
                        j > 0 || kk > 0);
    }
    wgmma_commit();
    wgmma_wait<0>();
    pin(acc);
    if constexpr (kWide) pin(acc32);
    pin(pf);
    if (lane == 0) mbar_arrive(&sm.empty[pos.stage]);
  }
  // Settle the turns: each warpgroup took 2 n_tiles, warpgroup 1 after its
  // opening arrival on barrier 4, which no turn of warpgroup 0 consumed.
  if (cw == 0) named_barrier_sync(4, 256);

  // o_h rounded to bf16 at [b, row, HD h]
  const int b = bh / H, h = bh - b * H, D = H * HD;
  const int ra = row0 + cw * 64 + warp * 16 + g, rb = ra + 8;
  bf16* oh = o + static_cast<size_t>(b) * S * D + h * HD;
#pragma unroll
  for (int n = 0; n < 8; ++n) {
    const int col = n * 8 + 2 * t;
    if (ra < S)
      *reinterpret_cast<__nv_bfloat162*>(oh + static_cast<size_t>(ra) * D + col) =
          __floats2bfloat162_rn(acc[4 * n], acc[4 * n + 1]);
    if (rb < S)
      *reinterpret_cast<__nv_bfloat162*>(oh + static_cast<size_t>(rb) * D + col) =
          __floats2bfloat162_rn(acc[4 * n + 2], acc[4 * n + 3]);
  }
  if constexpr (kWide) {  // columns 64..71 (acc32[4..7], columns 72..79, are 0)
    const int col = 64 + 2 * t;
    if (ra < S)
      *reinterpret_cast<__nv_bfloat162*>(oh + static_cast<size_t>(ra) * D + col) =
          __floats2bfloat162_rn(acc32[0], acc32[1]);
    if (rb < S)
      *reinterpret_cast<__nv_bfloat162*>(oh + static_cast<size_t>(rb) * D + col) =
          __floats2bfloat162_rn(acc32[2], acc32[3]);
  }
}

// ---------------------------------------------------------------------------
// host
// ---------------------------------------------------------------------------

// a: [M, K]; w[i]: [n_per, K], all bf16 row-major
template <bool kQKV, int HD>
cudaError_t gemm(const bf16* a, const bf16* const* w, int n_weights, const GemmArgs& p, int sms,
                        cudaStream_t st) {
  CUtensorMap amap, wmap[3];
  cudaError_t e = make_tile_map(&amap, a, 1, p.M, p.K, kTileM);
  for (int i = 0; i < 3 && e == cudaSuccess; ++i)
    e = make_tile_map(&wmap[i], w[std::min(i, n_weights - 1)], 1, p.n_per, p.K, kTileN);
  if (e != cudaSuccess) return e;
  const int tiles = (p.M + kTileM - 1) / kTileM * ((p.n_per + kTileN - 1) / kTileN) * n_weights;
  gemm_kernel<kQKV, HD><<<std::min(tiles, sms), kThreads, sizeof(GemmSmem) + 1024, st>>>(amap, wmap[0], wmap[1],
                                                                                         wmap[2], p);
  return cudaGetLastError();
}

// The four launches at head dim HD (64 or 72; at 72 the key-tiled stage takes every S).
template <int HD>
int run(const void* x, const void* vecs, const void* wq, const void* wk, const void* wv, const void* wo, void* stats,
        void* qkv, void* attn, void* out, int B, int S, int D, int H, int key_tiled, float eps, float scale, int sms,
        cudaStream_t st) {
  const int M = B * S;
  const float* v = static_cast<const float*>(vecs);
  float* mu = static_cast<float*>(stats);
  bf16* qkv_b = static_cast<bf16*>(qkv);
  bf16* attn_b = static_cast<bf16*>(attn);
  const size_t plane = static_cast<size_t>(M) * D;
  cudaError_t e;

  ln_kernel<<<(M + 7) / 8, 256, 0, st>>>(static_cast<const bf16*>(x), v, v + D, mu, mu + M, attn_b, M, D, eps);
  if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);

  GemmArgs a{};
  a.M = M;
  a.K = D;
  a.n_per = D;
  a.n_weights = 3;
  a.bias = v + 2 * D;  // bq | bk | bv
  a.qkv = qkv_b;
  a.S = S;
  a.H = H;
  const bf16* wqkv[3] = {static_cast<const bf16*>(wq), static_cast<const bf16*>(wk), static_cast<const bf16*>(wv)};
  if ((e = gemm<true, HD>(attn_b, wqkv, 3, a, sms, st)) != cudaSuccess) return static_cast<int>(e);

  const bool whole_head = HD == 64 && (key_tiled < 0 ? S > kWholeHeadMinS && S <= small_attn::kMaxT : key_tiled == 0);
  if (whole_head) {
    const int rc = small_attn::launch<false, true>(qkv_b, qkv_b + plane, nullptr, qkv_b + 2 * plane, attn_b, B, H, H,
                                                   S, scale, st);
    if (rc != 0) return rc;
  } else {
    CUtensorMap qmap, kmap, vmap;
    e = make_tile_map(&qmap, qkv_b, B * H, S, HD, kRows);
    if (e == cudaSuccess) e = make_tile_map(&kmap, qkv_b + plane, B * H, S, HD, kKeys);
    if (e == cudaSuccess) e = make_tile_map(&vmap, qkv_b + 2 * plane, B * H, S, HD, kKeys);
    if (e != cudaSuccess) return static_cast<int>(e);
    CUtensorMap qmap32 = qmap, kmap32 = kmap, vmap32 = vmap;  // HD = 64: unused copies
    if constexpr (HD > 64) {
      e = make_tail_map(&qmap32, qkv_b, B * H, S, HD, kRows);
      if (e == cudaSuccess) e = make_tail_map(&kmap32, qkv_b + plane, B * H, S, HD, kKeys);
      if (e == cudaSuccess) e = make_tail_map(&vmap32, qkv_b + 2 * plane, B * H, S, HD, kKeys);
      if (e != cudaSuccess) return static_cast<int>(e);
    }
    attn_tiled_kernel<HD><<<dim3(B * H, (S + kRows - 1) / kRows), kThreads, sizeof(TiledSmem<HD>) + 1024, st>>>(
        qmap, kmap, vmap, qmap32, kmap32, vmap32, attn_b, H, S, scale * kLog2e);
    if ((e = cudaGetLastError()) != cudaSuccess) return static_cast<int>(e);
  }

  GemmArgs o{};
  o.M = M;
  o.K = D;
  o.n_per = D;
  o.n_weights = 1;
  o.bias = v + 5 * D;
  o.x = static_cast<const bf16*>(x);
  o.gamma = v + 6 * D;
  o.out = static_cast<bf16*>(out);
  const bf16* wout[1] = {static_cast<const bf16*>(wo)};
  return static_cast<int>(gemm<false, 64>(attn_b, wout, 1, o, sms, st));
}

}  // namespace
}  // namespace fused_block

// x, out: [B, S, D] bf16; vecs: fp32 [7, D] (ns, nb, bq, bk, bv, bo, gamma);
// wq, wk, wv, wo: bf16 [D, D] (out, in). Head dim D / H: 64, or 72 with
// D % 64 == 0 (the GEMMs' k slices). Scratch from the caller: stats fp32
// [2, B*S], qkv bf16 [3, B, H, S, D / H], attn bf16 [B*S, D] (LN1's output,
// then the attention output). All 16-byte aligned. key_tiled < 0 picks the
// attention stage by S (head dim 72: the key-tiled stage at every S); 1 takes
// the key-tiled stage at any S, 0 the whole-head stage (head dim 64, S <= 512).
// scale: the softmax scale (the caller's 1 / sqrt(head dim)). One call.
MERV_EXPORT int fused_vit_attn_block_bf16(const void* x, const void* vecs, const void* wq, const void* wk,
                                          const void* wv, const void* wo, void* stats, void* qkv, void* attn,
                                          void* out, int B, int S, int D, int H, int key_tiled, float eps,
                                          float scale, void* stream) {
  using namespace fused_block;
  const int hd = H > 0 && D % H == 0 ? D / H : 0;
  if (B <= 0 || S <= 0 || H <= 0 || D > kMaxD || key_tiled > 1 || !(hd == 64 || (hd == 72 && D % 64 == 0)) ||
      (key_tiled == 0 && (hd != 64 || S > small_attn::kMaxT)))
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  static int done[64] = {0};  // a local of a function that is not inline: one per library
  int sms = 0;
  cudaError_t e = device_setup(done, &sms, gemm_kernel<true, 64>, gemm_kernel<false, 64>, attn_tiled_kernel<64>,
                               gemm_kernel<true, 72>, attn_tiled_kernel<72>);
  if (e != cudaSuccess) return static_cast<int>(e);
  return hd == 64 ? run<64>(x, vecs, wq, wk, wv, wo, stats, qkv, attn, out, B, S, D, H, key_tiled, eps, scale, sms, st)
                  : run<72>(x, vecs, wq, wk, wv, wo, stats, qkv, attn, out, B, S, D, H, key_tiled, eps, scale, sms, st);
}
