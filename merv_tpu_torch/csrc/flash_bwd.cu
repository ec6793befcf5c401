// flash_attention_backward: dq, dk, dv of flash_fwd.cu's function.
// q, o, do [B, H, Tq, D], k/v [B, Hk, Tk, D] (H % Hk == 0, GQA by head index
// h / (H/Hk)), bf16, contiguous, D in {64, 128}; lse [B, H, Tq] fp32 from the
// forward (m + log l in scaled-score units, +inf for a row with no valid
// key); optional [B, Tk] key mask (1 byte per key, nonzero = valid); optional
// causal mask aligned to the right (query i sees keys <= offset + i, offset =
// Tk - Tq). Writes dq, dk, dv in bf16; delta [B, H, Tq] fp32 is scratch.
//
// Replaces the backward of merv_tpu/ops/attention.py::_flash_attention (its
// custom VJP _flash_bwd_rule, :791-814, with the GQA fold at :803-806) and
// the Pallas backward kernels of the library flash attention the TPU ran on
// the LLM's training shape (_library_flash_call, :693-718).
//
// Math (standard flash backward): P = exp(S * scale - lse), dV = P^T dO,
// dP = dO V^T, delta = rowsum(dO o O), dS = P o (dP - delta),
// dK = scale * dS^T Q, dQ = scale * dS K. P and dS are rounded to bf16 before
// their products, as a bf16 TPU kernel feeds its matrix unit; S, dP and every
// accumulator stay fp32. A masked key, a ragged edge and a row with no valid
// key all give P = 0, so such a row has zero gradient (the gradient of
// flash_fwd.cu's function, which outputs 0 there).
//
// Bound on the H100: operations at the Llama training shape
// ([1, 32, 3072, 128] causal: 10 * D flops per visible (query, key) pair
// against ~8 * T * D * 2 bytes per head, ~1900 flops per byte).
//
// Design (simple and deterministic first; no atomics). Three launches on the
// caller's stream:
//   1. delta: one warp per query row.
//   2. dK/dV: grid (B * Hk, ceil(Tk / 64)); 4 warps x 16 keys hold their dK
//      and dV rows in fp32 registers while the block loops over the H / Hk
//      query heads of the group (the GQA fold happens in registers) and over
//      the 64-query tiles that can see its keys. K and V of the block sit in
//      shared memory; each query tile stages Q and dO row-major (for S^T and
//      dP^T) and transposed (for dK += dS^T Q and dV += P^T dO). Queries are
//      taken 16 at a time so S^T and dP^T cost 16 registers, not 64.
//   3. dQ: grid (B * H, ceil(Tq / 64)); 4 warps x 16 query rows keep Q and dO
//      as mma fragments in registers and loop over the 64-key tiles up to the
//      block's last visible key (K row-major and transposed, V row-major in
//      shared memory), 16 keys at a time.
// S and dP are computed in both 2 and 3 (14 * D flops per pair, not 10).
// Shared memory: 104 KiB (dK/dV) and 52 KiB (dQ) at D = 128, so neither
// stores K, V, Q, dO and the accumulators of a tile at once.
#include "common.cuh"

namespace {

constexpr int kTile = 64;        // keys per dK/dV block, query rows per dQ block, staged tile rows
constexpr int kTS = kTile + 8;   // row stride of a transposed tile (36 words: conflict-free fragments)

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

// delta[row] = sum_d dO[row, d] * O[row, d] in fp32; one warp per row.
template <int D>
__global__ void __launch_bounds__(256) bwd_delta_kernel(const bf16* __restrict__ o, const bf16* __restrict__ dout,
                                                        float* __restrict__ delta, int rows) {
  const int row = blockIdx.x * 8 + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (row >= rows) return;  // whole warps leave together
  const bf16* op = o + static_cast<size_t>(row) * D;
  const bf16* dp = dout + static_cast<size_t>(row) * D;
  float acc = 0.f;
#pragma unroll
  for (int c = lane * 2; c < D; c += 64) {
    const float2 a = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(op + c));
    const float2 b = __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(dp + c));
    acc += a.x * b.x + a.y * b.y;
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// Stage rows [base, base + 64) of a [T, D] matrix: row-major into rows
// ([64][D + 8]) and/or transposed into cols ([D][kTS]); rows past T are 0.
template <int D>
__device__ __forceinline__ void stage_tile(const bf16* __restrict__ src, int base, int T, bf16* rows, bf16* cols) {
  constexpr int RS = D + 8;
  for (int i = threadIdx.x; i < kTile * D / 8; i += blockDim.x) {
    const int r = i / (D / 8), c8 = i - r * (D / 8);
    uint4 v4 = make_uint4(0u, 0u, 0u, 0u);
    if (base + r < T) v4 = *reinterpret_cast<const uint4*>(src + static_cast<size_t>(base + r) * D + c8 * 8);
    if (rows != nullptr) *reinterpret_cast<uint4*>(rows + r * RS + c8 * 8) = v4;
    if (cols != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&v4);
#pragma unroll
      for (int j = 0; j < 8; ++j) cols[(c8 * 8 + j) * kTS + r] = e[j];
    }
  }
}

// A fragment (16 x 16, row-major) of rows r0.. r0+15, cols c0.. c0+15 of a [.][RS] tile.
template <int RS>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* tile, int r0, int c0, int g, int t) {
  const bf16* p = tile + (r0 + g) * RS + c0 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * RS);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * RS + 8);
}

// The 16 x 16 A fragment held by two m16n8 accumulators (cols 0-7 and 8-15), rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&x)[2][4]) {
  a[0] = pack_bf16(x[0][0], x[0][1]);
  a[1] = pack_bf16(x[0][2], x[0][3]);
  a[2] = pack_bf16(x[1][0], x[1][1]);
  a[3] = pack_bf16(x[1][2], x[1][3]);
}

template <int D>
__global__ void __launch_bounds__(128)
    bwd_dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                    const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                    const uint8_t* __restrict__ mask, bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Hk,
                    int Tq, int Tk, int causal, int offset, float scale) {
  constexpr int RS = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [64][RS] this block's keys
  bf16* Vs = Ks + kTile * RS;                    // [64][RS]
  bf16* Qs = Vs + kTile * RS;                    // [64][RS] current query tile
  bf16* dOs = Qs + kTile * RS;                   // [64][RS]
  bf16* Qt = dOs + kTile * RS;                   // [D][kTS]
  bf16* dOt = Qt + D * kTS;                      // [D][kTS]
  __shared__ float lse_s[kTile], delta_s[kTile];

  const int bhk = blockIdx.x;
  const int b = bhk / Hk, hk = bhk - b * Hk;
  const int group = H / Hk;
  const int kbase = blockIdx.y * kTile;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int kr = warp * 16;  // this warp's keys within the tile
  const int key_a = kbase + kr + g, key_b = key_a + 8;
  const bool ok_a = key_a < Tk && (mask == nullptr || mask[static_cast<size_t>(b) * Tk + key_a] != 0);
  const bool ok_b = key_b < Tk && (mask == nullptr || mask[static_cast<size_t>(b) * Tk + key_b] != 0);

  const size_t kv_off = static_cast<size_t>(bhk) * Tk * D;
  stage_tile<D>(k + kv_off, kbase, Tk, Ks, nullptr);
  stage_tile<D>(v + kv_off, kbase, Tk, Vs, nullptr);

  float dka[D / 8][4], dva[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn)
#pragma unroll
    for (int i = 0; i < 4; ++i) dka[dn][i] = dva[dn][i] = 0.f;

  // causal: the first query that sees a key of this tile has offset + i >= kbase
  const int q_first = causal ? max(0, kbase - offset) : 0;
  const int n_qt = (Tq + kTile - 1) / kTile;

  for (int hq = 0; hq < group; ++hq) {
    const size_t bh = static_cast<size_t>(b) * H + hk * group + hq;
    const bf16* qh = q + bh * Tq * D;
    const bf16* doh = dout + bh * Tq * D;
    for (int qt = q_first / kTile; qt < n_qt; ++qt) {
      const int qbase = qt * kTile;
      __syncthreads();  // every warp is done with the previous query tile
      stage_tile<D>(qh, qbase, Tq, Qs, Qt);
      stage_tile<D>(doh, qbase, Tq, dOs, dOt);
      if (threadIdx.x < kTile) {
        const int qi = qbase + threadIdx.x;
        lse_s[threadIdx.x] = qi < Tq ? lse[bh * Tq + qi] : pos_inf();
        delta_s[threadIdx.x] = qi < Tq ? delta[bh * Tq + qi] : 0.f;
      }
      __syncthreads();

#pragma unroll
      for (int qc = 0; qc < kTile / 16; ++qc) {
        float s[2][4], dp[2][4];
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
        // S^T = K Q^T and dP^T = V dO^T for this warp's 16 keys x 16 queries
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          uint32_t ka[4], va[4];
          load_a<RS>(ka, Ks, kr, ks * 16, g, t);
          load_a<RS>(va, Vs, kr, ks * 16, g, t);
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) {
            const int qrow = qc * 16 + nt * 8 + g;
            const bf16* qp = Qs + qrow * RS + ks * 16 + 2 * t;
            const bf16* op = dOs + qrow * RS + ks * 16 + 2 * t;
            mma_bf16_16816(s[nt], ka, ld32(qp), ld32(qp + 8));
            mma_bf16_16816(dp[nt], va, ld32(op), ld32(op + 8));
          }
        }
        // P^T and dS^T = P^T o (dP^T - delta), exact zeros where the pair is not visible
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const int ql = qc * 16 + nt * 8 + 2 * t + j;
            const int qi = qbase + ql;
            const float L = lse_s[ql], dl = delta_s[ql];
            const bool in = qi < Tq;
            const bool vis_a = ok_a && in && (!causal || key_a <= qi + offset);
            const bool vis_b = ok_b && in && (!causal || key_b <= qi + offset);
            const float pa = vis_a ? expf(s[nt][j] * scale - L) : 0.f;
            const float pb = vis_b ? expf(s[nt][2 + j] * scale - L) : 0.f;
            s[nt][j] = pa;
            s[nt][2 + j] = pb;
            dp[nt][j] = pa * (dp[nt][j] - dl);
            dp[nt][2 + j] = pb * (dp[nt][2 + j] - dl);
          }
        }
        uint32_t pa4[4], da4[4];
        acc_to_a(pa4, s);
        acc_to_a(da4, dp);
        // dV += P^T dO, dK += dS^T Q over these 16 queries
#pragma unroll
        for (int dn = 0; dn < D / 8; ++dn) {
          const bf16* op = dOt + (dn * 8 + g) * kTS + qc * 16 + 2 * t;
          const bf16* qp = Qt + (dn * 8 + g) * kTS + qc * 16 + 2 * t;
          mma_bf16_16816(dva[dn], pa4, ld32(op), ld32(op + 8));
          mma_bf16_16816(dka[dn], da4, ld32(qp), ld32(qp + 8));
        }
      }
    }
  }

  // keys no query sees (and masked keys) write exactly 0
  bf16* dkh = dk + kv_off;
  bf16* dvh = dv + kv_off;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = dn * 8 + 2 * t;
    if (key_a < Tk) {
      *reinterpret_cast<__nv_bfloat162*>(dkh + static_cast<size_t>(key_a) * D + c) =
          __floats2bfloat162_rn(dka[dn][0] * scale, dka[dn][1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvh + static_cast<size_t>(key_a) * D + c) =
          __floats2bfloat162_rn(dva[dn][0], dva[dn][1]);
    }
    if (key_b < Tk) {
      *reinterpret_cast<__nv_bfloat162*>(dkh + static_cast<size_t>(key_b) * D + c) =
          __floats2bfloat162_rn(dka[dn][2] * scale, dka[dn][3] * scale);
      *reinterpret_cast<__nv_bfloat162*>(dvh + static_cast<size_t>(key_b) * D + c) =
          __floats2bfloat162_rn(dva[dn][2], dva[dn][3]);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(128)
    bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                  const bf16* __restrict__ dout, const float* __restrict__ lse, const float* __restrict__ delta,
                  const uint8_t* __restrict__ mask, bf16* __restrict__ dq, int H, int Hk, int Tq, int Tk, int causal,
                  int offset, float scale) {
  constexpr int RS = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* Ks = reinterpret_cast<bf16*>(smem_raw);  // [64][RS]
  bf16* Vs = Ks + kTile * RS;                    // [64][RS]
  bf16* Kt = Vs + kTile * RS;                    // [D][kTS]
  __shared__ uint8_t key_ok[kTile];

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int hk = h / (H / Hk);
  const bf16* qh = q + static_cast<size_t>(bh) * Tq * D;
  const bf16* doh = dout + static_cast<size_t>(bh) * Tq * D;
  const bf16* kh = k + static_cast<size_t>(b * Hk + hk) * Tk * D;
  const bf16* vh = v + static_cast<size_t>(b * Hk + hk) * Tk * D;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int r0 = blockIdx.y * kTile + warp * 16;
  const int ra = r0 + g, rb = r0 + g + 8;
  const int pos_a = offset + ra, pos_b = offset + rb;  // causal: last visible key

  // Q and dO rows of this warp as A fragments (rows past Tq are 0)
  uint32_t qa[D / 16][4], oa[D / 16][4];
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const int c = ks * 16 + 2 * t;
    qa[ks][0] = ra < Tq ? ld32(qh + static_cast<size_t>(ra) * D + c) : 0u;
    qa[ks][1] = rb < Tq ? ld32(qh + static_cast<size_t>(rb) * D + c) : 0u;
    qa[ks][2] = ra < Tq ? ld32(qh + static_cast<size_t>(ra) * D + c + 8) : 0u;
    qa[ks][3] = rb < Tq ? ld32(qh + static_cast<size_t>(rb) * D + c + 8) : 0u;
    oa[ks][0] = ra < Tq ? ld32(doh + static_cast<size_t>(ra) * D + c) : 0u;
    oa[ks][1] = rb < Tq ? ld32(doh + static_cast<size_t>(rb) * D + c) : 0u;
    oa[ks][2] = ra < Tq ? ld32(doh + static_cast<size_t>(ra) * D + c + 8) : 0u;
    oa[ks][3] = rb < Tq ? ld32(doh + static_cast<size_t>(rb) * D + c + 8) : 0u;
  }
  const float La = ra < Tq ? lse[static_cast<size_t>(bh) * Tq + ra] : pos_inf();
  const float Lb = rb < Tq ? lse[static_cast<size_t>(bh) * Tq + rb] : pos_inf();
  const float Da = ra < Tq ? delta[static_cast<size_t>(bh) * Tq + ra] : 0.f;
  const float Db = rb < Tq ? delta[static_cast<size_t>(bh) * Tq + rb] : 0.f;

  int n_tiles = (Tk + kTile - 1) / kTile;
  if (causal) {
    const int last_row = min(static_cast<int>(blockIdx.y) * kTile + kTile - 1, Tq - 1);
    const int kend = offset + last_row + 1;  // keys [0, kend) can be visible to this block
    n_tiles = min(n_tiles, kend <= 0 ? 0 : (kend + kTile - 1) / kTile);
  }

  float dqa[D / 8][4];
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) dqa[dn][0] = dqa[dn][1] = dqa[dn][2] = dqa[dn][3] = 0.f;

  for (int tile = 0; tile < n_tiles; ++tile) {
    const int kbase = tile * kTile;
    __syncthreads();  // every warp is done with the previous key tile
    stage_tile<D>(kh, kbase, Tk, Ks, Kt);
    stage_tile<D>(vh, kbase, Tk, Vs, nullptr);
    if (threadIdx.x < kTile) {
      const int key = kbase + threadIdx.x;
      key_ok[threadIdx.x] = key < Tk && (mask == nullptr || mask[static_cast<size_t>(b) * Tk + key] != 0);
    }
    __syncthreads();

#pragma unroll
    for (int kc = 0; kc < kTile / 16; ++kc) {
      float s[2][4], dp[2][4];
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int i = 0; i < 4; ++i) s[nt][i] = dp[nt][i] = 0.f;
      // S = Q K^T and dP = dO V^T for this warp's 16 rows x 16 keys
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        const int krow = kc * 16 + nt * 8 + g;
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks) {
          const bf16* kp = Ks + krow * RS + ks * 16 + 2 * t;
          const bf16* vp = Vs + krow * RS + ks * 16 + 2 * t;
          mma_bf16_16816(s[nt], qa[ks], ld32(kp), ld32(kp + 8));
          mma_bf16_16816(dp[nt], oa[ks], ld32(vp), ld32(vp + 8));
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int j = 0; j < 2; ++j) {
          const int c = kc * 16 + nt * 8 + 2 * t + j;
          const int key = kbase + c;
          const bool ok = key_ok[c] != 0;
          const bool vis_a = ok && (!causal || key <= pos_a);
          const bool vis_b = ok && (!causal || key <= pos_b);
          const float pa = vis_a ? expf(s[nt][j] * scale - La) : 0.f;
          const float pb = vis_b ? expf(s[nt][2 + j] * scale - Lb) : 0.f;
          dp[nt][j] = pa * (dp[nt][j] - Da);
          dp[nt][2 + j] = pb * (dp[nt][2 + j] - Db);
        }
      }
      uint32_t da4[4];
      acc_to_a(da4, dp);
      // dQ += dS K over these 16 keys
#pragma unroll
      for (int dn = 0; dn < D / 8; ++dn) {
        const bf16* kp = Kt + (dn * 8 + g) * kTS + kc * 16 + 2 * t;
        mma_bf16_16816(dqa[dn], da4, ld32(kp), ld32(kp + 8));
      }
    }
  }

  bf16* dqh = dq + static_cast<size_t>(bh) * Tq * D;
#pragma unroll
  for (int dn = 0; dn < D / 8; ++dn) {
    const int c = dn * 8 + 2 * t;
    if (ra < Tq)
      *reinterpret_cast<__nv_bfloat162*>(dqh + static_cast<size_t>(ra) * D + c) =
          __floats2bfloat162_rn(dqa[dn][0] * scale, dqa[dn][1] * scale);
    if (rb < Tq)
      *reinterpret_cast<__nv_bfloat162*>(dqh + static_cast<size_t>(rb) * D + c) =
          __floats2bfloat162_rn(dqa[dn][2] * scale, dqa[dn][3] * scale);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
           const void* mask, void* delta, void* dq, void* dk, void* dv, int B, int H, int Hk, int Tq, int Tk,
           int causal, int offset, float scale, cudaStream_t stream) {
  constexpr size_t RS = D + 8;
  const size_t smem_kv = (4 * kTile * RS + 2 * static_cast<size_t>(D) * kTS) * sizeof(bf16);
  const size_t smem_q = (2 * kTile * RS + static_cast<size_t>(D) * kTS) * sizeof(bf16);
  cudaError_t e = cudaFuncSetAttribute(bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                       static_cast<int>(smem_kv));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_q));
  if (e != cudaSuccess) return static_cast<int>(e);

  const auto* qp = static_cast<const bf16*>(q);
  const auto* kp = static_cast<const bf16*>(k);
  const auto* vp = static_cast<const bf16*>(v);
  const auto* dop = static_cast<const bf16*>(dout);
  const auto* lp = static_cast<const float*>(lse);
  const auto* mp = static_cast<const uint8_t*>(mask);
  auto* dl = static_cast<float*>(delta);

  const int rows = B * H * Tq;
  bwd_delta_kernel<D><<<(rows + 7) / 8, 256, 0, stream>>>(static_cast<const bf16*>(o), dop, dl, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_dkdv_kernel<D><<<dim3(B * Hk, (Tk + kTile - 1) / kTile), 128, smem_kv, stream>>>(
      qp, kp, vp, dop, lp, dl, mp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Hk, Tq, Tk, causal, offset,
      scale);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_dq_kernel<D><<<dim3(B * H, (Tq + kTile - 1) / kTile), 128, smem_q, stream>>>(
      qp, kp, vp, dop, lp, dl, mp, static_cast<bf16*>(dq), H, Hk, Tq, Tk, causal, offset, scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: device pointers (bf16, contiguous); lse: [B, H, Tq] fp32;
// mask: [B, Tk] bytes or null; delta: [B, H, Tq] fp32 scratch.
MERV_EXPORT int flash_bwd_bf16(const void* q, const void* k, const void* v, const void* o, const void* dout,
                               const void* lse, const void* mask, void* delta, void* dq, void* dk, void* dv, int B,
                               int H, int Hk, int Tq, int Tk, int D, int causal, int offset, float scale,
                               void* stream) {
  if (B <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0 || Tq <= 0 || Tk <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64) return launch<64>(q, k, v, o, dout, lse, mask, delta, dq, dk, dv, B, H, Hk, Tq, Tk, causal, offset, scale, s);
  if (D == 128)
    return launch<128>(q, k, v, o, dout, lse, mask, delta, dq, dk, dv, B, H, Hk, Tq, Tk, causal, offset, scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
