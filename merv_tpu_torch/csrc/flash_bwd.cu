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
// Bound on the H100: operations at the Llama training shape ([1, 32, 3072,
// 128] causal: 10 * D flops per visible (query, key) pair against ~8 * T * D
// * 2 bytes per head, ~1900 flops per byte; 0.1955 ms at 989 TFLOP/s).
//
// Design: three launches on the caller's stream, deterministic (no atomics:
// two calls on the same inputs give the same bits). The dK/dV and dQ kernels
// are warp-specialised as flash_fwd.cu is (hopper.cuh): 384 threads, a
// producer warpgroup whose first warp issues every TMA load (setmaxnreg 24)
// and two consumer warpgroups (setmaxnreg 240) running wgmma on the tiles of
// a ring of full/empty mbarrier pairs.
//   1. delta: one warp per query row (bound by bytes, small).
//   2. dK/dV: grid (B * Hk, ceil(Tk / 128)), 64 keys per consumer
//      warpgroup. K and V are TMA-loaded once; Q and dO tiles of 64 queries,
//      with their lse and delta, stream through the ring over the H / Hk
//      heads of the group and the query tiles that can see these keys. S^T =
//      K Q^T and dP^T = V dO^T by wgmma with both operands K-major in shared
//      memory; P^T and dS^T in registers, rounded to bf16, are the register A
//      operands of dV += P^T dO and dK += dS^T Q, whose B operands are dO and
//      Q as they lie (MN-major): no transposed copy is staged. dK and dV stay
//      in fp32 registers over the whole GQA group.
//   3. dQ: grid (B * H, ceil(Tq / 128)), 64 queries per consumer warpgroup;
//      Q and dO resident, K and V tiles of 64 keys through the ring. S and dP
//      by wgmma (K-major); dS in registers is the A operand of dQ += dS K
//      with K as it lies (MN-major, no K^T).
// Masks are applied only on the tiles that need them (causal diagonal tiles,
// the ragged last key tile, every tile under a key mask in the dQ kernel);
// in the dK/dV kernel a masked key's rows are written as 0 and a query past
// Tq has lse +inf, so P = 0 there without a test. S and dP are computed in
// both 2 and 3 (14 * D flops per pair, not 10).
#include "hopper.cuh"

namespace {

constexpr int kThreads = 384;
constexpr int kKeysBlock = 128;  // dK/dV: keys per block, 64 per consumer warpgroup
constexpr int kRowsBlock = 128;  // dQ: query rows per block, 64 per consumer warpgroup
constexpr int kTile = 64;        // rows of a streamed tile (queries in dK/dV, keys in dQ)

template <int D>
struct BwdCfg {
  static constexpr int kSlabs = D / 64;
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr uint32_t kBigSlab = 128 * 64 * 2;   // slab of a resident 128-row tile
  static constexpr uint32_t kTileSlab = kTile * 64 * 2;  // slab of a streamed 64-row tile
};

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

// ---------------------------------------------------------------------------
// dK / dV
// ---------------------------------------------------------------------------

template <int D>
struct DkdvSmem {
  using C = BwdCfg<D>;
  bf16 k[C::kSlabs][kKeysBlock * 64];
  bf16 v[C::kSlabs][kKeysBlock * 64];
  bf16 q[C::kStages][C::kSlabs][kTile * 64];
  bf16 dout[C::kStages][C::kSlabs][kTile * 64];
  float lse2[C::kStages][kTile];  // lse * log2 e (+inf past Tq)
  float delta[C::kStages][kTile];
  uint64_t kv_full, full[C::kStages], empty[C::kStages];
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dkdv_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                    const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                    const float* __restrict__ lse, const float* __restrict__ delta, const uint8_t* __restrict__ mask,
                    bf16* __restrict__ dk, bf16* __restrict__ dv, int H, int Hk, int Tq, int Tk, int causal,
                    int offset, float scale, float scale_log2) {
  using C = BwdCfg<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  DkdvSmem<D>& sm = *reinterpret_cast<DkdvSmem<D>*>(align_1024(smem_raw));

  const int bhk = blockIdx.x;
  const int b = bhk / Hk, hk = bhk - b * Hk;
  const int group = H / Hk;
  const int kbase = blockIdx.y * kKeysBlock;
  // causal: the first query that sees a key of this block has offset + i >= kbase
  const int qt_first = causal ? max(0, kbase - offset) / kTile : 0;
  const int n_qt = (Tq + kTile - 1) / kTile;

  if (threadIdx.x == 0) {
    mbar_init(&sm.kv_full, 1);
#pragma unroll
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&sm.full[s], 32);  // the producer warp's lanes, after staging lse and delta
      mbar_init(&sm.empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.kv_full, 2 * C::kSlabs * C::kBigSlab);
#pragma unroll
        for (int c = 0; c < C::kSlabs; ++c) {
          tma_load_3d(sm.k[c], &kmap, &sm.kv_full, c * 64, kbase, bhk);
          tma_load_3d(sm.v[c], &vmap, &sm.kv_full, c * 64, kbase, bhk);
        }
      }
      RingPos pos;
      for (int hq = 0; hq < group; ++hq) {
        const int bh = b * H + hk * group + hq;
        for (int qt = qt_first; qt < n_qt; ++qt, pos.next(C::kStages)) {
          const int s = pos.stage, qbase = qt * kTile;
          mbar_wait(&sm.empty[s], pos.phase ^ 1u);
          if (lane == 0) {
            mbar_expect_tx(&sm.full[s], 2 * C::kSlabs * C::kTileSlab);
#pragma unroll
            for (int c = 0; c < C::kSlabs; ++c) {
              tma_load_3d(sm.q[s][c], &qmap, &sm.full[s], c * 64, qbase, bh);
              tma_load_3d(sm.dout[s][c], &domap, &sm.full[s], c * 64, qbase, bh);
            }
          }
#pragma unroll
          for (int i = lane; i < kTile; i += 32) {
            const int qi = qbase + i;
            const size_t at = static_cast<size_t>(bh) * Tq + qi;
            sm.lse2[s][i] = qi < Tq ? lse[at] * kLog2e : pos_inf();
            sm.delta[s][i] = qi < Tq ? delta[at] : 0.f;
          }
          mbar_arrive(&sm.full[s]);
        }
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int tid = threadIdx.x - wg * 128;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int kw = kbase + cw * 64;  // this warpgroup's first key
    const int key_a = kw + warp * 16 + g, key_b = key_a + 8;

    float dka[D / 2], dva[D / 2], st[kTile / 2], dpt[kTile / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dka[i] = dva[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) st[i] = dpt[i] = 0.f;

    mbar_wait(&sm.kv_full, 0);
    RingPos pos;
    for (int hq = 0; hq < group; ++hq) {
      for (int qt = qt_first; qt < n_qt; ++qt, pos.next(C::kStages)) {
        const int s = pos.stage, qbase = qt * kTile;
        mbar_wait(&sm.full[s], pos.phase);
        // S^T = K Q^T and dP^T = V dO^T for this warpgroup's 64 keys x 64 queries
        wgmma_fence();
        pin(st);
        pin(dpt);
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_ss_n64(st, kmajor_desc(sm.k[ks / 4], cw * 64, (ks % 4) * 16),
                       kmajor_desc(sm.q[s][ks / 4], 0, (ks % 4) * 16), ks > 0);
#pragma unroll
        for (int ks = 0; ks < D / 16; ++ks)
          wgmma_ss_n64(dpt, kmajor_desc(sm.v[ks / 4], cw * 64, (ks % 4) * 16),
                       kmajor_desc(sm.dout[s][ks / 4], 0, (ks % 4) * 16), ks > 0);
        wgmma_commit();
        wgmma_wait<0>();
        pin(st);
        pin(dpt);

        // P^T and dS^T = P^T o (dP^T - delta); the causal test only on diagonal tiles
        const bool need_mask = causal && kw + 63 > qbase + offset;
        const float* L2 = sm.lse2[s];
        const float* dl = sm.delta[s];
#pragma unroll
        for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int c = n * 8 + 2 * t + jj;
            const float Lc = L2[c], dc = dl[c];
            float pa = exp2f(st[4 * n + jj] * scale_log2 - Lc);
            float pb = exp2f(st[4 * n + 2 + jj] * scale_log2 - Lc);
            if (need_mask) {
              const int last = qbase + c + offset;  // the last key this query sees
              if (key_a > last) pa = 0.f;
              if (key_b > last) pb = 0.f;
            }
            st[4 * n + jj] = pa;
            st[4 * n + 2 + jj] = pb;
            dpt[4 * n + jj] = pa * (dpt[4 * n + jj] - dc);
            dpt[4 * n + 2 + jj] = pb * (dpt[4 * n + 2 + jj] - dc);
          }
        }
        uint32_t pf[kTile / 16][4], dsf[kTile / 16][4];
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk) {
          acc_to_a(pf[kk], st + 8 * kk);
          acc_to_a(dsf[kk], dpt + 8 * kk);
        }
        // dV += P^T dO and dK += dS^T Q over these 64 queries
        wgmma_fence();
        pin(dva);
        pin(dka);
        pin(pf);
        pin(dsf);
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
          wgmma_rs_tb<D>(dva, pf[kk], mnmajor_desc(sm.dout[s][0], kk * 16, C::kTileSlab), 1);
#pragma unroll
        for (int kk = 0; kk < kTile / 16; ++kk)
          wgmma_rs_tb<D>(dka, dsf[kk], mnmajor_desc(sm.q[s][0], kk * 16, C::kTileSlab), 1);
        wgmma_commit();
        wgmma_wait<0>();
        pin(dva);
        pin(dka);
        pin(pf);
        pin(dsf);
        if (lane == 0) mbar_arrive(&sm.empty[s]);
      }
    }

    // keys no query sees write 0 (their accumulators are 0); masked keys write exactly 0
    const size_t kv_off = static_cast<size_t>(bhk) * Tk * D;
    bf16* dkh = dk + kv_off;
    bf16* dvh = dv + kv_off;
    const bool ok_a = key_a < Tk && (mask == nullptr || mask[static_cast<size_t>(b) * Tk + key_a] != 0);
    const bool ok_b = key_b < Tk && (mask == nullptr || mask[static_cast<size_t>(b) * Tk + key_b] != 0);
    const float ka = ok_a ? scale : 0.f, kb = ok_b ? scale : 0.f;
    const float va = ok_a ? 1.f : 0.f, vb = ok_b ? 1.f : 0.f;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (key_a < Tk) {
        *reinterpret_cast<__nv_bfloat162*>(dkh + static_cast<size_t>(key_a) * D + c) =
            __floats2bfloat162_rn(dka[4 * n] * ka, dka[4 * n + 1] * ka);
        *reinterpret_cast<__nv_bfloat162*>(dvh + static_cast<size_t>(key_a) * D + c) =
            __floats2bfloat162_rn(dva[4 * n] * va, dva[4 * n + 1] * va);
      }
      if (key_b < Tk) {
        *reinterpret_cast<__nv_bfloat162*>(dkh + static_cast<size_t>(key_b) * D + c) =
            __floats2bfloat162_rn(dka[4 * n + 2] * kb, dka[4 * n + 3] * kb);
        *reinterpret_cast<__nv_bfloat162*>(dvh + static_cast<size_t>(key_b) * D + c) =
            __floats2bfloat162_rn(dva[4 * n + 2] * vb, dva[4 * n + 3] * vb);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// dQ
// ---------------------------------------------------------------------------

template <int D>
struct DqSmem {
  using C = BwdCfg<D>;
  bf16 q[C::kSlabs][kRowsBlock * 64];
  bf16 dout[C::kSlabs][kRowsBlock * 64];
  bf16 k[C::kStages][C::kSlabs][kTile * 64];
  bf16 v[C::kStages][C::kSlabs][kTile * 64];
  uint8_t key_ok[C::kStages][kTile];
  uint64_t qd_full, full[C::kStages], empty[C::kStages];
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    bwd_dq_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                  const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap domap,
                  const float* __restrict__ lse, const float* __restrict__ delta, const uint8_t* __restrict__ mask,
                  bf16* __restrict__ dq, int H, int Hk, int Tq, int Tk, int causal, int offset, float scale,
                  float scale_log2) {
  using C = BwdCfg<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  DqSmem<D>& sm = *reinterpret_cast<DqSmem<D>*>(align_1024(smem_raw));

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int bhk = b * Hk + h / (H / Hk);
  // under the causal mask the last row tiles carry the most keys: launch them first
  const int tile_m = causal ? static_cast<int>(gridDim.y - 1 - blockIdx.y) : static_cast<int>(blockIdx.y);
  const int row0 = tile_m * kRowsBlock;
  int n_tiles = (Tk + kTile - 1) / kTile;
  if (causal) {
    const int kend = offset + min(row0 + kRowsBlock, Tq);  // keys [0, kend) can be visible to this block
    n_tiles = min(n_tiles, kend <= 0 ? 0 : (kend + kTile - 1) / kTile);
  }

  if (threadIdx.x == 0) {
    mbar_init(&sm.qd_full, 1);
#pragma unroll
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&sm.full[s], 32);  // the producer warp's lanes, after staging key_ok
      mbar_init(&sm.empty[s], 8);
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.qd_full, 2 * C::kSlabs * C::kBigSlab);
#pragma unroll
        for (int c = 0; c < C::kSlabs; ++c) {
          tma_load_3d(sm.q[c], &qmap, &sm.qd_full, c * 64, row0, bh);
          tma_load_3d(sm.dout[c], &domap, &sm.qd_full, c * 64, row0, bh);
        }
      }
      RingPos pos;
      for (int j = 0; j < n_tiles; ++j, pos.next(C::kStages)) {
        const int s = pos.stage, kbase = j * kTile;
        mbar_wait(&sm.empty[s], pos.phase ^ 1u);
        if (lane == 0) {
          mbar_expect_tx(&sm.full[s], 2 * C::kSlabs * C::kTileSlab);
#pragma unroll
          for (int c = 0; c < C::kSlabs; ++c) {
            tma_load_3d(sm.k[s][c], &kmap, &sm.full[s], c * 64, kbase, bhk);
            tma_load_3d(sm.v[s][c], &vmap, &sm.full[s], c * 64, kbase, bhk);
          }
        }
#pragma unroll
        for (int i = lane; i < kTile; i += 32) {
          const int key = kbase + i;
          sm.key_ok[s][i] = key < Tk && (mask == nullptr || mask[static_cast<size_t>(b) * Tk + key] != 0);
        }
        mbar_arrive(&sm.full[s]);
      }
    }
  } else {
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int tid = threadIdx.x - wg * 128;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r_wg = row0 + cw * 64;
    const int ra = r_wg + warp * 16 + g, rb = ra + 8;
    const int last_a = offset + ra, last_b = offset + rb;  // causal: last visible key
    const size_t rows = static_cast<size_t>(bh) * Tq;
    const float La = ra < Tq ? lse[rows + ra] * kLog2e : pos_inf();
    const float Lb = rb < Tq ? lse[rows + rb] * kLog2e : pos_inf();
    const float Da = ra < Tq ? delta[rows + ra] : 0.f;
    const float Db = rb < Tq ? delta[rows + rb] : 0.f;
    const bool masked_keys = mask != nullptr;

    float dqa[D / 2], sc[kTile / 2], dp[kTile / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dqa[i] = 0.f;
#pragma unroll
    for (int i = 0; i < kTile / 2; ++i) sc[i] = dp[i] = 0.f;

    mbar_wait(&sm.qd_full, 0);
    RingPos pos;
    for (int j = 0; j < n_tiles; ++j, pos.next(C::kStages)) {
      const int s = pos.stage, kbase = j * kTile;
      mbar_wait(&sm.full[s], pos.phase);
      // S = Q K^T and dP = dO V^T for this warpgroup's 64 rows x 64 keys
      wgmma_fence();
      pin(sc);
      pin(dp);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n64(sc, kmajor_desc(sm.q[ks / 4], cw * 64, (ks % 4) * 16),
                     kmajor_desc(sm.k[s][ks / 4], 0, (ks % 4) * 16), ks > 0);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n64(dp, kmajor_desc(sm.dout[ks / 4], cw * 64, (ks % 4) * 16),
                     kmajor_desc(sm.v[s][ks / 4], 0, (ks % 4) * 16), ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      pin(sc);
      pin(dp);

      // keys past Tk are masked too: their zero-filled K gives a finite S, but exp(-lse) may overflow
      const bool need_mask = masked_keys || kbase + kTile > Tk || (causal && kbase + kTile - 1 > offset + r_wg);
      const uint8_t* ok = sm.key_ok[s];
#pragma unroll
      for (int n = 0; n < kTile / 8; ++n) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          float pa = exp2f(sc[4 * n + jj] * scale_log2 - La);
          float pb = exp2f(sc[4 * n + 2 + jj] * scale_log2 - Lb);
          if (need_mask) {
            const int c = n * 8 + 2 * t + jj;
            const int key = kbase + c;
            const bool valid = ok[c] != 0;
            if (!(valid && (!causal || key <= last_a))) pa = 0.f;
            if (!(valid && (!causal || key <= last_b))) pb = 0.f;
          }
          dp[4 * n + jj] = pa * (dp[4 * n + jj] - Da);
          dp[4 * n + 2 + jj] = pb * (dp[4 * n + 2 + jj] - Db);
        }
      }
      uint32_t dsf[kTile / 16][4];
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk) acc_to_a(dsf[kk], dp + 8 * kk);
      // dQ += dS K over these 64 keys
      wgmma_fence();
      pin(dqa);
      pin(dsf);
#pragma unroll
      for (int kk = 0; kk < kTile / 16; ++kk)
        wgmma_rs_tb<D>(dqa, dsf[kk], mnmajor_desc(sm.k[s][0], kk * 16, C::kTileSlab), 1);
      wgmma_commit();
      wgmma_wait<0>();
      pin(dqa);
      pin(dsf);
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    }

    bf16* dqh = dq + static_cast<size_t>(bh) * Tq * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (ra < Tq)
        *reinterpret_cast<__nv_bfloat162*>(dqh + static_cast<size_t>(ra) * D + c) =
            __floats2bfloat162_rn(dqa[4 * n] * scale, dqa[4 * n + 1] * scale);
      if (rb < Tq)
        *reinterpret_cast<__nv_bfloat162*>(dqh + static_cast<size_t>(rb) * D + c) =
            __floats2bfloat162_rn(dqa[4 * n + 2] * scale, dqa[4 * n + 3] * scale);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o, const void* dout, const void* lse,
           const void* mask, void* delta, void* dq, void* dk, void* dv, int B, int H, int Hk, int Tq, int Tk,
           int causal, int offset, float scale, cudaStream_t stream) {
  // the dK/dV kernel streams 64-row Q / dO tiles past 128-row K / V; the dQ kernel the other way round
  CUtensorMap q64, do64, k128, v128, q128, do128, k64, v64;
  cudaError_t e = cudaSuccess;
  const struct {
    CUtensorMap* map;
    const void* ptr;
    int bh, T, rows;
  } maps[] = {{&q64, q, B * H, Tq, kTile},          {&do64, dout, B * H, Tq, kTile},
              {&k128, k, B * Hk, Tk, kKeysBlock},   {&v128, v, B * Hk, Tk, kKeysBlock},
              {&q128, q, B * H, Tq, kRowsBlock},    {&do128, dout, B * H, Tq, kRowsBlock},
              {&k64, k, B * Hk, Tk, kTile},         {&v64, v, B * Hk, Tk, kTile}};
  for (const auto& m : maps) {
    e = make_tile_map(m.map, m.ptr, m.bh, m.T, D, m.rows);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const size_t smem_kv = sizeof(DkdvSmem<D>) + 1024, smem_q = sizeof(DqSmem<D>) + 1024;
  e = cudaFuncSetAttribute(bwd_dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_kv));
  if (e != cudaSuccess) return static_cast<int>(e);
  e = cudaFuncSetAttribute(bwd_dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem_q));
  if (e != cudaSuccess) return static_cast<int>(e);

  const auto* lp = static_cast<const float*>(lse);
  const auto* mp = static_cast<const uint8_t*>(mask);
  auto* dl = static_cast<float*>(delta);
  const float scale_log2 = scale * kLog2e;

  const int rows = B * H * Tq;
  bwd_delta_kernel<D><<<(rows + 7) / 8, 256, 0, stream>>>(static_cast<const bf16*>(o),
                                                           static_cast<const bf16*>(dout), dl, rows);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_dkdv_kernel<D><<<dim3(B * Hk, (Tk + kKeysBlock - 1) / kKeysBlock), kThreads, smem_kv, stream>>>(
      q64, k128, v128, do64, lp, dl, mp, static_cast<bf16*>(dk), static_cast<bf16*>(dv), H, Hk, Tq, Tk, causal,
      offset, scale, scale_log2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  bwd_dq_kernel<D><<<dim3(B * H, (Tq + kRowsBlock - 1) / kRowsBlock), kThreads, smem_q, stream>>>(
      q128, k64, v64, do128, lp, dl, mp, static_cast<bf16*>(dq), H, Hk, Tq, Tk, causal, offset, scale, scale_log2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o, dout, dq, dk, dv: device pointers (bf16, contiguous, 16-byte aligned); lse: [B, H, Tq] fp32;
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
