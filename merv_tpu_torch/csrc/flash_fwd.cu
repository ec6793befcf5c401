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
// Bound on the H100: operations at ViViT's shape ([1, 12, 3137, 64]: 4 * Tq *
// Tk * D flops per head, ~1568 flops per byte against the card's ~295 flops
// per byte balance point in bf16, 0.0306 ms at 989 TFLOP/s) and at the
// align step's causal [16, 32, 3072, 128]; the Llama prefill ([1, 32, 1088,
// 128] over a 1120-key cache, causal) sits near the balance point, so both
// rates matter there.
//
// Design (FlashAttention-3's shape, simplified; the machinery is hopper.cuh).
// Grid (B*H, ceil(Tq/128)); 384 threads: warpgroup 0 is the producer (one
// warp issues every load, setmaxnreg down to 24), warpgroups 1 and 2 consume
// 64 query rows each (setmaxnreg up to 240).
//   - The Q tile is loaded once by TMA. K and V tiles of 128 keys stream
//     through a ring of 2 (D = 128) or 3 (D = 64: half the work per tile for
//     the same load latency, and half the bytes per stage) stages, each
//     guarded by a full and an empty mbarrier; loads run ahead of the tensor
//     cores instead of each tile paying the memory latency in turn. The tensor maps are
//     3-D (D, T, B*H), so a box past a head's T is zero-filled by the
//     hardware. The producer warp also stages each tile's key validity
//     (ragged edge and key mask) beside it.
//   - S = Q K^T by wgmma m64n128k16 with both operands in shared memory,
//     K-major (no transpose staged). The fp32 online softmax runs on the
//     accumulator fragment with exp2 (scale * log2 e folded into the scores)
//     and quad shuffles for the row max and sum. P is rounded to bf16 in
//     registers and is the register A operand of O += P V, whose B operand is
//     V in shared memory as it lies ([keys][D], MN-major through wgmma's
//     transpose bit): no V^T is staged.
//   - Masks are applied only on tiles that need them: causal diagonal tiles
//     (per warpgroup), the ragged last tile and every tile under a key mask;
//     tiles wholly below the diagonal run mask-free, as the TPU kernel's
//     two-phase kv loop does. Tiles past a block's last visible key are never
//     loaded, and under the causal mask the blocks with the most tiles are
//     launched first.
//   - Epilogue: divide by the fp32 row sum; rows with no valid key write 0
//     and lse +inf; ragged rows are masked at Tq.
#include "hopper.cuh"

namespace {

constexpr int kBlockM = 128;  // query rows per block, 64 per consumer warpgroup
constexpr int kBlockN = 128;  // keys per tile
constexpr int kThreads = 384;

template <int D>
struct FwdCfg {
  static constexpr int kSlabs = D / 64;
  static constexpr int kStages = D == 64 ? 3 : 2;
  static constexpr uint32_t kSlabBytes = kBlockN * 64 * 2;  // a 128-row slab (Q, K and V tiles alike)
  static constexpr uint32_t kTileBytes = kSlabs * kSlabBytes;
};

template <int D>
struct FwdSmem {
  using C = FwdCfg<D>;
  bf16 q[C::kSlabs][kBlockM * 64];
  bf16 k[C::kStages][C::kSlabs][kBlockN * 64];
  bf16 v[C::kStages][C::kSlabs][kBlockN * 64];
  uint8_t key_ok[C::kStages][kBlockN];
  uint64_t q_full, k_full[C::kStages], v_full[C::kStages], empty[C::kStages];
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                     const __grid_constant__ CUtensorMap vmap, const uint8_t* __restrict__ mask,
                     bf16* __restrict__ o, float* __restrict__ lse, int H, int Hk, int Tq, int Tk, int causal,
                     int q_offset, float scale_log2) {
  using C = FwdCfg<D>;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  FwdSmem<D>& sm = *reinterpret_cast<FwdSmem<D>*>(align_1024(smem_raw));

  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - b * H;
  const int bhk = b * Hk + h / (H / Hk);
  // under the causal mask the last row tiles carry the most keys: launch them first
  const int tile_m = causal ? static_cast<int>(gridDim.y - 1 - blockIdx.y) : static_cast<int>(blockIdx.y);
  const int row0 = tile_m * kBlockM;
  int n_tiles = (Tk + kBlockN - 1) / kBlockN;
  if (causal) {
    const int kend = q_offset + min(row0 + kBlockM, Tq);  // keys [0, kend) can be visible to this block
    n_tiles = min(n_tiles, kend <= 0 ? 0 : (kend + kBlockN - 1) / kBlockN);
  }

  if (threadIdx.x == 0) {
    mbar_init(&sm.q_full, 1);
#pragma unroll
    for (int s = 0; s < C::kStages; ++s) {
      mbar_init(&sm.k_full[s], 32);  // the producer warp's lanes, after staging key_ok
      mbar_init(&sm.v_full[s], 1);
      mbar_init(&sm.empty[s], 8);  // the consumer warps
    }
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer ----------------
    setmaxnreg_dec<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        mbar_arrive_expect_tx(&sm.q_full, C::kTileBytes);
#pragma unroll
        for (int c = 0; c < C::kSlabs; ++c) tma_load_3d(sm.q[c], &qmap, &sm.q_full, c * 64, row0, bh);
      }
      RingPos pos;
      for (int j = 0; j < n_tiles; ++j, pos.next(C::kStages)) {
        const int s = pos.stage, kbase = j * kBlockN;
        mbar_wait(&sm.empty[s], pos.phase ^ 1u);
        if (lane == 0) {
          mbar_expect_tx(&sm.k_full[s], C::kTileBytes);
#pragma unroll
          for (int c = 0; c < C::kSlabs; ++c) tma_load_3d(sm.k[s][c], &kmap, &sm.k_full[s], c * 64, kbase, bhk);
          mbar_arrive_expect_tx(&sm.v_full[s], C::kTileBytes);
#pragma unroll
          for (int c = 0; c < C::kSlabs; ++c) tma_load_3d(sm.v[s][c], &vmap, &sm.v_full[s], c * 64, kbase, bhk);
        }
#pragma unroll
        for (int i = lane; i < kBlockN; i += 32) {
          const int key = kbase + i;
          sm.key_ok[s][i] = key < Tk && (mask == nullptr || mask[static_cast<size_t>(b) * Tk + key] != 0);
        }
        mbar_arrive(&sm.k_full[s]);
      }
    }
  } else {
    // ---------------- consumers: 64 query rows each ----------------
    setmaxnreg_inc<240>();
    const int cw = wg - 1;
    const int tid = threadIdx.x - wg * 128;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const int r_wg = row0 + cw * 64;  // this warpgroup's first row
    const int ra = r_wg + warp * 16 + g, rb = ra + 8;
    const int last_a = q_offset + ra, last_b = q_offset + rb;  // causal: last visible key
    const bool masked_keys = mask != nullptr;

    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sc[kBlockN / 2];
#pragma unroll
    for (int i = 0; i < kBlockN / 2; ++i) sc[i] = 0.f;
    // running max in log2 units of the scaled scores, and each thread's share of the row sum
    float ma = neg_inf(), mb = neg_inf(), la = 0.f, lb = 0.f;

    mbar_wait(&sm.q_full, 0);
    RingPos pos;
    for (int j = 0; j < n_tiles; ++j, pos.next(C::kStages)) {
      const int s = pos.stage, kbase = j * kBlockN;
      mbar_wait(&sm.k_full[s], pos.phase);
      wgmma_fence();
      pin(sc);
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks)
        wgmma_ss_n128(sc, kmajor_desc(sm.q[ks / 4], cw * 64, (ks % 4) * 16),
                      kmajor_desc(sm.k[s][ks / 4], 0, (ks % 4) * 16), ks > 0);
      wgmma_commit();
      wgmma_wait<0>();
      pin(sc);

#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) sc[i] *= scale_log2;
      const bool need_mask = masked_keys || kbase + kBlockN > Tk || (causal && kbase + kBlockN - 1 > q_offset + r_wg);
      if (need_mask) {
        const uint8_t* ok = sm.key_ok[s];
#pragma unroll
        for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
          for (int jj = 0; jj < 2; ++jj) {
            const int c = n * 8 + 2 * t + jj;
            const int key = kbase + c;
            const bool valid = ok[c] != 0;
            if (!(valid && (!causal || key <= last_a))) sc[4 * n + jj] = neg_inf();
            if (!(valid && (!causal || key <= last_b))) sc[4 * n + 2 + jj] = neg_inf();
          }
        }
      }
      float ca = neg_inf(), cb = neg_inf();
#pragma unroll
      for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          ca = fmaxf(ca, sc[4 * n + jj]);
          cb = fmaxf(cb, sc[4 * n + 2 + jj]);
        }
      }
      ca = quad_max(ca);
      cb = quad_max(cb);
      const float na = fmaxf(ma, ca), nb = fmaxf(mb, cb);
      // a row with no valid key yet keeps max -inf: subtract 0 instead, so every exp2 of -inf is exactly 0
      const float ua = na == neg_inf() ? 0.f : na, ub = nb == neg_inf() ? 0.f : nb;
      const float alpha_a = exp2f(ma - ua), alpha_b = exp2f(mb - ub);
      ma = na;
      mb = nb;
      la *= alpha_a;
      lb *= alpha_b;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[4 * n] *= alpha_a;
        acc[4 * n + 1] *= alpha_a;
        acc[4 * n + 2] *= alpha_b;
        acc[4 * n + 3] *= alpha_b;
      }
#pragma unroll
      for (int n = 0; n < kBlockN / 8; ++n) {
#pragma unroll
        for (int jj = 0; jj < 2; ++jj) {
          sc[4 * n + jj] = exp2f(sc[4 * n + jj] - ua);
          sc[4 * n + 2 + jj] = exp2f(sc[4 * n + 2 + jj] - ub);
          la += sc[4 * n + jj];
          lb += sc[4 * n + 2 + jj];
        }
      }
      uint32_t pf[kBlockN / 16][4];
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) acc_to_a(pf[kk], sc + 8 * kk);

      mbar_wait(&sm.v_full[s], pos.phase);
      wgmma_fence();
      pin(acc);
      pin(pf);
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk)
        wgmma_rs_tb<D>(acc, pf[kk], mnmajor_desc(sm.v[s][0], kk * 16, C::kSlabBytes), 1);
      wgmma_commit();
      wgmma_wait<0>();
      pin(acc);
      pin(pf);
      if (lane == 0) mbar_arrive(&sm.empty[s]);
    }

    la = quad_sum(la);
    lb = quad_sum(lb);
    const float ia = la == 0.f ? 0.f : 1.f / la;  // rows with no valid key write 0
    const float ib = lb == 0.f ? 0.f : 1.f / lb;
    if (lse != nullptr && t == 0) {
      float* lh = lse + static_cast<size_t>(bh) * Tq;
      if (ra < Tq) lh[ra] = la == 0.f ? pos_inf() : ma * kLn2 + logf(la);
      if (rb < Tq) lh[rb] = lb == 0.f ? pos_inf() : mb * kLn2 + logf(lb);
    }
    bf16* oh = o + static_cast<size_t>(bh) * Tq * D;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const int c = n * 8 + 2 * t;
      if (ra < Tq)
        *reinterpret_cast<__nv_bfloat162*>(oh + static_cast<size_t>(ra) * D + c) =
            __floats2bfloat162_rn(acc[4 * n] * ia, acc[4 * n + 1] * ia);
      if (rb < Tq)
        *reinterpret_cast<__nv_bfloat162*>(oh + static_cast<size_t>(rb) * D + c) =
            __floats2bfloat162_rn(acc[4 * n + 2] * ib, acc[4 * n + 3] * ib);
    }
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* mask, void* o, void* lse, int B, int H, int Hk,
           int Tq, int Tk, int causal, int q_offset, float scale, cudaStream_t stream) {
  CUtensorMap qmap, kmap, vmap;
  cudaError_t e = make_tile_map(&qmap, q, B * H, Tq, D, kBlockM);
  if (e == cudaSuccess) e = make_tile_map(&kmap, k, B * Hk, Tk, D, kBlockN);
  if (e == cudaSuccess) e = make_tile_map(&vmap, v, B * Hk, Tk, D, kBlockN);
  if (e != cudaSuccess) return static_cast<int>(e);
  const size_t smem = sizeof(FwdSmem<D>) + 1024;
  e = cudaFuncSetAttribute(flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(B * H, (Tq + kBlockM - 1) / kBlockM);
  flash_fwd_kernel<D><<<grid, kThreads, smem, stream>>>(qmap, kmap, vmap, static_cast<const uint8_t*>(mask),
                                                        static_cast<bf16*>(o), static_cast<float*>(lse), H, Hk, Tq,
                                                        Tk, causal, q_offset, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// q, k, v, o: device pointers (bf16, contiguous, 16-byte aligned); mask: [B, Tk] bytes or null;
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
