// decode_attention (K5): attention of a few query rows over the KV cache, as
// decoding, speculative verification and short cached prefills ask for it.
//   q     bf16 [B, H, Tq, D], 1 <= Tq <= 16, D in {64, 128}, H a multiple of Hk
//   k, v  the cache [B, Hk, Tk, D]: bf16, or int8 with fp32 scales
//         k_scale / v_scale [B, Hk, Tk, 1] (one per (batch, kv head, position))
//   mask  bool [B, Tk] (valid keys) or none
//   causal: query t of row b sees key j iff j <= t + offset (offset a host int,
//         or offs[b] read on the device)
//   o     bf16 [B, H, Tq, D]
//   lse   fp32 [B, H, Tq] or none: each row's log-sum-exp of its scaled scores
// The function is merv_tpu's T = 1 / verify attention over its cache
// (merv_tpu/models/backbones/llm/transformer.py:396-405 dequantizes, then
// ops/attention.py::attention_reference): an int8 key or value is dequantized
// as bf16(float(q8) * scale), one rounding; scores are fp32 sums of the bf16
// products; masked keys get no weight; a row with no valid key gets what
// the reference's uniform softmax gives, the mean of V over the whole buffer
// (weights bf16(1/Tk)). p is rounded to bf16 before P.V; the division by the
// row sum comes after, as in the flash kernels.
// With an lse output (the sequence-sharded cache: one call a shard, merged
// by LSE across ranks) a row with no valid key writes 0 and LSE -inf, so that
// a shard holding none of a row's keys weighs nothing in the merge, as
// merv_tpu's sharded body (ops/ring_attention.py:462-483) has it.
//
// Replaces no Pallas kernel: merv_tpu leaves this attention to XLA, which
// fuses the dequantization into its read of the cache. The port's plain form
// (ops/decode_attention.py::decode_attention_plain) copies the layer's cache
// to the compute dtype and then to fp32 before two matmuls.
//
// Bound on the H100: bytes. Each valid cache row's K and V (and scales) are
// read once against 4 * H/Hk * Tq * D operations a row.
//
// Design: one launch a call. A unit of work is a (batch, kv head, group of
// <= 16 query rows: the kv head's H/Hk heads x Tq); its keys, in 16-key tiles,
// are split over the blocks of one thread block cluster (at most 8, the
// portable size) and, inside a block, over its 4 warps: warp w of cluster
// block j takes tiles j + c (w + 4 i), c the cluster size, so a ragged slot's
// live tiles spread evenly over all of them. The host's plan
// (ops/decode_attention.py::decode_plan) picks c from the kernel's real
// residency: the most blocks one wave holds while a block keeps enough tiles
// for its warps' two stages. Tiles of 16 keys (8 KB of bf16 K and V at D =
// 128) let a block keep 8 of them in flight in 64 KB, so three blocks fit an
// SM and most of the B = 1 decode's keys are in flight at once.
//   - Each warp works alone until the merge: no block-wide barrier. It first
//     reads the key mask of its candidate tiles, 32 at a time (one ballot a
//     half-warp gives a tile's valid keys: mask, key < Tk, the causal bound),
//     so dead tiles cost no load and a warp with none stops at once; its first
//     tile's copy is started before the scan, on the causal bound alone, to
//     overlap the two. Its lane 0
//     loads each live tile's K and V by TMA (3-D tensor maps over
//     [B Hk, Tk, D]: keys past Tk read as 0) into the warp's two stages on
//     mbarriers: the next tile's copy runs under the current tile's arithmetic.
//     The int8 scales come as plain loads a tile ahead (one a lane): their rows
//     need not be 16-byte aligned, which TMA and bulk copies need.
//   - Tensor cores (mma.sync m16n8k16) for both products at every row count:
//     the query rows, padded to 16, are A for S = Q K^T with K as B, straight
//     from shared memory (a lane's 16 bytes of a key row fill its slots of two
//     (bf16) or four (int8) k16 steps, and q is held in the same d order), so
//     an int8 key is dequantized once, in registers. At one query row 15 of
//     the 16 rows are wasted, which costs nothing against the bytes. S's
//     accumulator becomes P (rounded to bf16) in registers, A for P V, with V
//     as B by ldmatrix.trans from 128-byte-swizzled rows (bf16 V comes so by
//     TMA; an int8 tile is dequantized once into such a bf16 copy first).
//     The online softmax stays in the registers of the four lanes that share
//     a row.
//   - Merge: each warp leaves (max, sum, unnormalised output) in its shared
//     memory; the block combines its warps in warp order; the cluster syncs,
//     and each block combines a share of the unit's outputs over the
//     cluster's blocks in rank order, read through distributed shared memory
//     (all ranks' loads issued at once), so every call gives the same bits; a
//     row with no valid key takes the mean of V there.
#include "hopper.cuh"

namespace {

constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 16;      // keys per tile: the mma's k of P V, two of its n of Q K^T
constexpr int kRowsMax = 16;   // query rows per unit: the mma's 16
constexpr int kBufs = 2;       // stages per warp
constexpr int kMaxCluster = 8;

struct Args {
  const bf16* q;
  const void* v;  // for the mean of V on a row with no valid key
  const float* ks;
  const float* vs;
  const unsigned char* mask;
  const long long* offs;
  bf16* o;
  float* lse;  // null: no LSE, and the mean of V on a row with no valid key
  int B, H, Hk, Tq, Tk, causal, offset, cluster;
  float scale_log2;
};

template <int D, bool kInt8>
struct Layout {
  static constexpr int kTileBytes = kTile * D * (kInt8 ? 1 : 2);  // K or V of one tile
  static constexpr int kStage = 2 * kTileBytes;                   // K, then V
  static constexpr int kStaging = kInt8 ? kTile * D * 2 : 0;       // an int8 V tile dequantized (bf16, swizzled)
  static constexpr int kWarp = kBufs * kStage + kStaging;          // each warp's region, a multiple of 1024
  static constexpr int kPitch = D + 4;                             // floats per row of a partial output
  // a partial: max and sum (log2 domain) of the 16 rows, then their unnormalised output
  static constexpr int kPartial = (2 * kRowsMax + kRowsMax * kPitch) * 4;
  static_assert(kWarp % 1024 == 0 && kPartial <= kWarp, "layout");
  static constexpr int kBlockML = kWarps * kWarp;                  // the block's combined max and sum
  static constexpr int kBars = kBlockML + 2 * kRowsMax * 4;
  static constexpr int kSmem = kBars + kWarps * kBufs * 8 + 1024;
  // elements of a cached row a lane reads at once (16 bytes), and the k16 steps they feed
  static constexpr int kE = kInt8 ? 16 : 8;
  static constexpr int kSteps = kE / 4;
};

// Byte offset of 16-byte chunk `chunk` (D / 8 chunks a row) of row `row` in a
// stack of 128-byte-swizzled slabs of kTile rows (TMA's layout for a box
// {64, kTile} with CU_TENSOR_MAP_SWIZZLE_128B: chunk c of row r at c ^ (r % 8)).
__device__ __forceinline__ int swz(int row, int chunk) {
  return (chunk >> 3) * (kTile * 128) + row * 128 + (((chunk & 7) ^ (row & 7)) << 4);
}

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16(x)); }

template <bool kInt8>
__device__ __forceinline__ float cached(const void* base, const float* scales, size_t row, int D, int col) {
  if constexpr (kInt8) {
    return round_bf16(static_cast<float>(static_cast<const signed char*>(base)[row * D + col]) * scales[row]);
  } else {
    return __bfloat162float(static_cast<const bf16*>(base)[row * D + col]);
  }
}

template <int D, bool kInt8>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(const __grid_constant__ CUtensorMap kmap,
                                                                    const __grid_constant__ CUtensorMap vmap,
                                                                    const Args a) {
  using L = Layout<D, kInt8>;
  constexpr int kE = L::kE, kSteps = L::kSteps;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem = align_1024(smem_raw);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int rank = blockIdx.x, cs = a.cluster;
  const int hk = blockIdx.y % a.Hk, rg = blockIdx.y / a.Hk, b = blockIdx.z;
  const int G = a.H / a.Hk, r0 = rg * kRowsMax, R = min(kRowsMax, G * a.Tq - r0);
  const int bh = b * a.Hk + hk;
  const long long off = a.causal ? (a.offs != nullptr ? a.offs[b] : static_cast<long long>(a.offset)) : 0;
  const long long last_key = a.causal ? min(static_cast<long long>(a.Tk) - 1, off + a.Tq - 1) : a.Tk - 1;
  const size_t q_row0 = static_cast<size_t>(b * a.H + hk * G) * a.Tq + r0;  // the unit's first query row
  const size_t srow0 = static_cast<size_t>(bh) * a.Tk;                      // the unit's first cache row
  unsigned char* mine = smem + warp * L::kWarp;
  uint64_t* bar = reinterpret_cast<uint64_t*>(smem + L::kBars) + warp * kBufs;
  if (lane == 0) {
    for (int i = 0; i < kBufs; ++i) mbar_init(&bar[i], 1);
    mbar_fence_init();
  }
  __syncwarp();

  // candidate tiles of this warp: first + stride * i
  const int first = rank + cs * warp, stride = cs * kWarps;
  const int n_tiles = (a.Tk + kTile - 1) / kTile;
  auto issue = [&](int tile, int buf, float& sk, float& sv) {
    unsigned char* st = mine + buf * L::kStage;
    if (lane == 0) {
      mbar_arrive_expect_tx(&bar[buf], L::kStage);
#pragma unroll
      for (int sl = 0; sl < (kInt8 ? 1 : D / 64); ++sl) {
        tma_load_3d(st + sl * kTile * 128, &kmap, &bar[buf], 64 * sl, tile * kTile, bh);
        tma_load_3d(st + L::kTileBytes + sl * kTile * 128, &vmap, &bar[buf], 64 * sl, tile * kTile, bh);
      }
    }
    if constexpr (kInt8) {  // lane j < 16 holds key j's scales
      const int key = tile * kTile + (lane & (kTile - 1));
      sk = key < a.Tk ? a.ks[srow0 + key] : 0.f;
      sv = key < a.Tk ? a.vs[srow0 + key] : 0.f;
    }
  };
  // The first candidate's copy starts before its mask is read (the causal bound alone decides), so that the
  // copy and the mask scan overlap; a candidate the mask then finds dead is waited for and skipped.
  int cur = first;
  float sk_cur = 0.f, sv_cur = 0.f, sk_nxt = 0.f, sv_nxt = 0.f;
  bool have = first < n_tiles && static_cast<long long>(first) * kTile <= last_key;
  if (have) issue(cur, 0, sk_cur, sv_cur);

  // q rows g and g + 8 as A fragments, d in the order a lane reads a key row:
  // step s of load c holds d = c kE 4 + kE t + 4 s + {0, 1 | 2, 3} in slots {2t, 2t+1 | 2t+8, 2t+9}
  uint32_t qa[D / 16][4];
  {
    const bool lo = g < R, hi = g + 8 < R;
#pragma unroll
    for (int c = 0; c < D / (4 * kE); ++c) {
      uint32_t wl[kE / 2], wh[kE / 2];
#pragma unroll
      for (int i = 0; i < kE / 8; ++i) {
        const size_t col = c * 4 * kE + kE * t + 8 * i;
        const uint4 zl = lo ? *reinterpret_cast<const uint4*>(a.q + (q_row0 + g) * D + col) : make_uint4(0, 0, 0, 0);
        const uint4 zh = hi ? *reinterpret_cast<const uint4*>(a.q + (q_row0 + g + 8) * D + col) : make_uint4(0, 0, 0, 0);
        wl[4 * i] = zl.x, wl[4 * i + 1] = zl.y, wl[4 * i + 2] = zl.z, wl[4 * i + 3] = zl.w;
        wh[4 * i] = zh.x, wh[4 * i + 1] = zh.y, wh[4 * i + 2] = zh.z, wh[4 * i + 3] = zh.w;
      }
#pragma unroll
      for (int s = 0; s < kSteps; ++s) {
        uint32_t(&f)[4] = qa[c * kSteps + s];
        f[0] = wl[2 * s], f[1] = wh[2 * s], f[2] = wl[2 * s + 1], f[3] = wh[2 * s + 1];
      }
    }
  }
  // the last key rows g and g + 8 may see (their query index within Tq)
  const long long lim_lo = off + (r0 + g) % a.Tq, lim_hi = off + (r0 + g + 8) % a.Tq;

  // The valid keys of 32 candidates at a time: half-warp h of step c reads candidate 2c + h's 16 mask bytes, one
  // ballot gives both; lane j keeps candidate j's 16-bit word; bit j of `live` says it has any valid key.
  uint32_t live = 0, my_word = 0;
  int chunk0 = 0, pos = 0;
  auto scan = [&]() {
    live = 0;
#pragma unroll 4
    for (int c = 0; c < 16; ++c) {
      const int h = lane >> 4;
      const long long key = static_cast<long long>(first + stride * (chunk0 + 2 * c + h)) * kTile + (lane & 15);
      bool ok = key <= last_key;
      if (ok && a.mask != nullptr) ok = a.mask[static_cast<size_t>(b) * a.Tk + key] != 0;
      const uint32_t both = __ballot_sync(0xffffffffu, ok);
      const uint32_t w0 = both & 0xffffu, w1 = both >> 16;
      if (lane == 2 * c) my_word = w0;
      if (lane == 2 * c + 1) my_word = w1;
      live |= (w0 != 0u ? 1u : 0u) << (2 * c);
      live |= (w1 != 0u ? 1u : 0u) << (2 * c + 1);
    }
  };
  // the next live tile after candidate `pos` of the chunk: its index and valid-key word (warp-uniform)
  auto next_live = [&](int& tile, uint32_t& word) -> bool {
    while (true) {
      const uint32_t rest = pos >= 31 ? 0u : live & (0xffffffffu << (pos + 1));
      if (rest != 0u) {
        pos = __ffs(rest) - 1;
        tile = first + stride * (chunk0 + pos);
        word = __shfl_sync(0xffffffffu, my_word, pos);
        return true;
      }
      chunk0 += 32;
      pos = -1;
      const long long tile0 = first + static_cast<long long>(stride) * chunk0;
      if (tile0 >= n_tiles || tile0 * kTile > last_key) return false;
      scan();
    }
  };
  scan();
  uint32_t cur_word = __shfl_sync(0xffffffffu, my_word, 0), nxt_word = 0;

  float m_run[2] = {neg_inf(), neg_inf()}, l_run[2] = {0.f, 0.f};
  float acc[D / 8][4];
#pragma unroll
  for (int n = 0; n < D / 8; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  int nxt = 0, buf = 0;
  uint32_t phase = 0;  // bit i: the parity stage i waits for next
  while (have) {
    const bool more = next_live(nxt, nxt_word);
    if (more) issue(nxt, buf ^ 1, sk_nxt, sv_nxt);
    mbar_wait_or_trap(&bar[buf], (phase >> buf) & 1u);
    phase ^= 1u << buf;
    if (cur_word != 0u) {
      const unsigned char* kt = mine + buf * L::kStage;
      const unsigned char* vt = kt + L::kTileBytes;

      // S = Q K^T over the tile's 16 keys: n-tile j holds keys 8 j .. 8 j + 7
      float s[2][4];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
        const int key = 8 * j + g;
        const float kscale = kInt8 ? __shfl_sync(0xffffffffu, sk_cur, key) : 1.f;
#pragma unroll
        for (int c = 0; c < D / (4 * kE); ++c) {
          uint32_t kw[kE / 2];
          if constexpr (kInt8) {
            const uint4 raw = lds128(kt + key * D + c * 64 + 16 * t);
            const uint32_t r4[4] = {raw.x, raw.y, raw.z, raw.w};
#pragma unroll
            for (int st = 0; st < 4; ++st) {
              kw[2 * st] = i8_pair_scaled(r4[st], 0, kscale);
              kw[2 * st + 1] = i8_pair_scaled(r4[st], 2, kscale);
            }
          } else {
            const uint4 raw = lds128(kt + swz(key, 4 * c + t));
            kw[0] = raw.x, kw[1] = raw.y, kw[2] = raw.z, kw[3] = raw.w;
          }
#pragma unroll
          for (int st = 0; st < kSteps; ++st) mma_bf16(s[j], qa[c * kSteps + st], kw[2 * st], kw[2 * st + 1]);
        }
      }

      // online softmax: rows g (e = 0, 1) and g + 8 (e = 2, 3), keys 8 j + 2 t + (e & 1); a quad holds a row
      const long long key0 = static_cast<long long>(cur) * kTile;
      float mx[2] = {neg_inf(), neg_inf()};
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kl = 8 * j + 2 * t + (e & 1);
          bool ok = (cur_word >> kl) & 1u;
          if (a.causal) ok = ok && key0 + kl <= (e < 2 ? lim_lo : lim_hi);
          s[j][e] = ok ? s[j][e] * a.scale_log2 : neg_inf();
          mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
        }
      float alpha[2], rsum[2] = {0.f, 0.f};
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const float m_new = fmaxf(m_run[h], quad_max(mx[h]));
        alpha[h] = m_run[h] == m_new ? 1.f : ex2_ftz(m_run[h] - m_new);
        m_run[h] = m_new;
      }
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = s[j][e] == neg_inf() ? 0.f : ex2_ftz(s[j][e] - m_run[e >> 1]);
          rsum[e >> 1] += s[j][e];
        }
#pragma unroll
      for (int h = 0; h < 2; ++h) l_run[h] = l_run[h] * alpha[h] + quad_sum(rsum[h]);
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        acc[n][0] *= alpha[0], acc[n][1] *= alpha[0];
        acc[n][2] *= alpha[1], acc[n][3] *= alpha[1];
      }

      // an int8 V tile, dequantized once into a bf16 copy in the swizzled layout
      const unsigned char* vb = vt;
      if constexpr (kInt8) {
        unsigned char* stg = mine + kBufs * L::kStage;
        constexpr int kSegs = kTile * D / 16;  // 16-byte segments of the int8 tile
#pragma unroll
        for (int i = lane; i < kSegs; i += 32) {
          const int key = i / (D / 16), d0 = (i % (D / 16)) * 16;
          const uint4 raw = lds128(vt + key * D + d0);
          const float vscale = __shfl_sync(0xffffffffu, sv_cur, key);
          const uint32_t r4[4] = {raw.x, raw.y, raw.z, raw.w};
          uint32_t w[8];
#pragma unroll
          for (int st = 0; st < 4; ++st) {
            w[2 * st] = i8_pair_scaled(r4[st], 0, vscale);
            w[2 * st + 1] = i8_pair_scaled(r4[st], 2, vscale);
          }
          sts128(stg + swz(key, d0 / 8), w[0], w[1], w[2], w[3]);
          sts128(stg + swz(key, d0 / 8 + 1), w[4], w[5], w[6], w[7]);
        }
        __syncwarp();
        vb = stg;
      }

      // O += P V: P (bf16) from S's accumulator, V by ldmatrix.trans (lane i names key (i / 8 % 2) 8 + i % 8)
      const uint32_t pa[4] = {pack_bf16(s[0][0], s[0][1]), pack_bf16(s[0][2], s[0][3]), pack_bf16(s[1][0], s[1][1]),
                              pack_bf16(s[1][2], s[1][3])};
      const int vrow = ((lane >> 3) & 1) * 8 + (lane & 7);
#pragma unroll
      for (int np = 0; np < D / 16; ++np) {
        uint32_t vf[4];
        ldmatrix_x4_trans(vf, vb + swz(vrow, 2 * np + (lane >> 4)));
        mma_bf16(acc[2 * np], pa, vf[0], vf[1]);
        mma_bf16(acc[2 * np + 1], pa, vf[2], vf[3]);
      }
    }
    __syncwarp();  // the stage (and the staging copy) are read before they are written again
    have = more;
    cur = nxt, cur_word = nxt_word, sk_cur = sk_nxt, sv_cur = sv_nxt;
    buf ^= 1;
  }

  // the warp's partial in its own region: rows' max and sum, unnormalised output
  float* pm = reinterpret_cast<float*>(mine);
  if (t == 0) {
    pm[g] = m_run[0], pm[g + 8] = m_run[1];
    pm[kRowsMax + g] = l_run[0], pm[kRowsMax + g + 8] = l_run[1];
  }
  float* po = pm + 2 * kRowsMax;
#pragma unroll
  for (int n = 0; n < D / 8; ++n) {
    *reinterpret_cast<float2*>(po + g * L::kPitch + 8 * n + 2 * t) = make_float2(acc[n][0], acc[n][1]);
    *reinterpret_cast<float2*>(po + (g + 8) * L::kPitch + 8 * n + 2 * t) = make_float2(acc[n][2], acc[n][3]);
  }
  __syncthreads();

  // the block's partial: its warps combined (in warp order) into warp 0's output rows and the block's max and sum
  auto warp_part = [&](int w) { return reinterpret_cast<const float*>(smem + w * L::kWarp); };
  float* bml = reinterpret_cast<float*>(smem + L::kBlockML);  // max [16], sum [16]
  float* out0 = reinterpret_cast<float*>(smem) + 2 * kRowsMax;  // warp 0's output rows, then the block's
  for (int e = threadIdx.x; e < R * (D / 2); e += kThreads) {
    const int r = e / (D / 2), col = 2 * (e % (D / 2));
    float mw[kWarps], m = neg_inf();
#pragma unroll
    for (int w = 0; w < kWarps; ++w) m = fmaxf(m, mw[w] = warp_part(w)[r]);
    float l = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      if (mw[w] == neg_inf()) continue;
      const float wt = ex2_ftz(mw[w] - m);
      const float2 op = *reinterpret_cast<const float2*>(warp_part(w) + 2 * kRowsMax + r * L::kPitch + col);
      l += wt * warp_part(w)[kRowsMax + r], o0 += wt * op.x, o1 += wt * op.y;
    }
    if (col == 0) bml[r] = m, bml[kRowsMax + r] = l;
    // into warp 0's output rows, where only this thread reads (r, col)
    *reinterpret_cast<float2*>(out0 + r * L::kPitch + col) = make_float2(o0, o1);
  }
  cluster_sync();

  // this block's share of the unit's outputs, combined over the cluster's blocks in rank order
  for (int e = rank * kThreads + threadIdx.x; e < R * (D / 2); e += cs * kThreads) {
    const int r = e / (D / 2), col = 2 * (e % (D / 2));
    float mq[kMaxCluster], m = neg_inf();
#pragma unroll
    for (int q = 0; q < kMaxCluster; ++q) {
      mq[q] = q < cs ? ld_cluster(cluster_addr(bml + r, q)) : neg_inf();
      m = fmaxf(m, mq[q]);
    }
    float2 out;
    float row_lse = neg_inf();
    if (m == neg_inf() && a.lse != nullptr) {  // no valid key in this shard: 0, weight 0
      out = make_float2(0.f, 0.f);
    } else if (m == neg_inf()) {  // no valid key: the mean of V over the whole buffer
      float s0 = 0.f, s1 = 0.f;
      for (int j = 0; j < a.Tk; ++j) {
        s0 += cached<kInt8>(a.v, a.vs, srow0 + j, D, col);
        s1 += cached<kInt8>(a.v, a.vs, srow0 + j, D, col + 1);
      }
      const float w = round_bf16(1.f / static_cast<float>(a.Tk));
      out = make_float2(s0 * w, s1 * w);
    } else {
      float lq[kMaxCluster];
      float2 oq[kMaxCluster];
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) {
        const bool use = q < cs && mq[q] != neg_inf();
        lq[q] = use ? ld_cluster(cluster_addr(bml + kRowsMax + r, q)) : 0.f;
        oq[q] = use ? ld_cluster2(cluster_addr(out0 + r * L::kPitch + col, q)) : make_float2(0.f, 0.f);
      }
      float l = 0.f, o0 = 0.f, o1 = 0.f;
#pragma unroll
      for (int q = 0; q < kMaxCluster; ++q) {
        if (mq[q] == neg_inf()) continue;
        const float wt = ex2_ftz(mq[q] - m);
        l += wt * lq[q], o0 += wt * oq[q].x, o1 += wt * oq[q].y;
      }
      out = make_float2(o0 / l, o1 / l);
      row_lse = m * kLn2 + logf(l);  // m is in the log2 domain (scores times scale * log2 e)
    }
    if (a.lse != nullptr && col == 0) a.lse[q_row0 + r] = row_lse;
    *reinterpret_cast<__nv_bfloat162*>(a.o + (q_row0 + r) * D + col) = __floats2bfloat162_rn(out.x, out.y);
  }
  cluster_sync();  // no block leaves while another still reads its partial
}

template <int D, bool kInt8>
cudaError_t launch(const Args& a, const void* k, const void* v, cudaStream_t stream) {
  using L = Layout<D, kInt8>;
  CUtensorMap kmap, vmap;
  const cuuint64_t BHk = static_cast<cuuint64_t>(a.B) * a.Hk, Tk = static_cast<cuuint64_t>(a.Tk);
  cudaError_t e;
  if constexpr (kInt8) {
    const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), Tk, BHk};
    const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D), Tk * D};
    const cuuint32_t box[3] = {static_cast<cuuint32_t>(D), kTile, 1};
    e = make_map(&kmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, k, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
    if (e == cudaSuccess)
      e = make_map(&vmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, v, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_NONE);
  } else {
    e = make_tile_map(&kmap, k, a.B * a.Hk, a.Tk, D, kTile);
    if (e == cudaSuccess) e = make_tile_map(&vmap, v, a.B * a.Hk, a.Tk, D, kTile);
  }
  if (e != cudaSuccess) return e;
  const int groups = (a.H / a.Hk * a.Tq + kRowsMax - 1) / kRowsMax;
  const dim3 grid(a.cluster, a.Hk * groups, a.B);
  return launch_clustered(decode_attention_kernel<D, kInt8>, grid, kThreads, L::kSmem, a.cluster, stream, false, kmap,
                          vmap, a);
}

// Once per device (see int8_linear.cu's setup).
cudaError_t setup() {
  static int done[64] = {0};
  int sms = 0;
  return device_setup(done, &sms, decode_attention_kernel<64, false>, decode_attention_kernel<64, true>,
                     decode_attention_kernel<128, false>, decode_attention_kernel<128, true>);
}

}  // namespace

// q, k, v, o: device pointers as above; k_scale / v_scale: fp32 scales (int8 != 0) or null; mask: bool [B, Tk]
// or null; offs: int64 [B] causal offsets or null (then `offset`); lse: fp32 [B, H, Tq] or null (see Args);
// cluster: the blocks that split a unit's keys (1..8).
MERV_EXPORT int decode_attention_bf16(const void* q, const void* k, const void* v, const void* k_scale,
                                      const void* v_scale, const void* mask, const void* offs, void* o, void* lse,
                                      int B, int H,
                                      int Hk, int Tq, int Tk, int D, int int8, int causal, int offset, int cluster,
                                      float scale, void* stream) {
  if (B < 1 || Hk < 1 || H % Hk || Tq < 1 || Tq > kRowsMax || Tk < 1 || (D != 64 && D != 128) || cluster < 1 ||
      cluster > kMaxCluster || (int8 && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = setup();
  if (e != cudaSuccess) return static_cast<int>(e);
  const Args a{static_cast<const bf16*>(q), v, static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
               static_cast<const unsigned char*>(mask), static_cast<const long long*>(offs), static_cast<bf16*>(o),
               static_cast<float*>(lse), B, H, Hk, Tq, Tk, causal, offset, cluster, scale * kLog2e};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 128)
    e = int8 ? launch<128, true>(a, k, v, s) : launch<128, false>(a, k, v, s);
  else
    e = int8 ? launch<64, true>(a, k, v, s) : launch<64, false>(a, k, v, s);
  if (e == cudaSuccess) e = cudaGetLastError();
  return static_cast<int>(e);
}

// clusters[c - 1] = how many clusters of c blocks (c = 1..8) of the kernel for (D, int8) the device holds at once.
MERV_EXPORT int decode_attention_residency(int D, int int8, int* clusters) {
  if (D != 64 && D != 128) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t e = setup();
  if (e != cudaSuccess) return static_cast<int>(e);
  if (D == 128)
    e = int8 ? cluster_residency(decode_attention_kernel<128, true>, kThreads, Layout<128, true>::kSmem, kMaxCluster,
                                 clusters)
             : cluster_residency(decode_attention_kernel<128, false>, kThreads, Layout<128, false>::kSmem, kMaxCluster,
                                 clusters);
  else
    e = int8 ? cluster_residency(decode_attention_kernel<64, true>, kThreads, Layout<64, true>::kSmem, kMaxCluster,
                                 clusters)
             : cluster_residency(decode_attention_kernel<64, false>, kThreads, Layout<64, false>::kSmem, kMaxCluster,
                                 clusters);
  return static_cast<int>(e);
}
