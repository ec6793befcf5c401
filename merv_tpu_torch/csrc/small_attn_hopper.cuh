// Device and host code of the whole-sequence attention kernels K1
// (small_attention_kt.cu: K given as kt [B, H, 64, T]) and B3
// (small_attention.cu: K given as k [B, Hk, T, 64], GQA through the kv-head
// index), and of B6's whole-head attention stage (fused_vit_block.cu: B3's
// operands, kFused). Head dim 64 or 72 (a template parameter D; SigLIP so400m's
// 1152 / 16 is 72; B6 takes 64 only), 1 <= T <= 512, bf16, contiguous; no mask
// but the ragged edge at T. Built on hopper.cuh.
//
// What is computed, in the TPU kernels' order (merv_tpu/ops/attention.py
// _small_attn_kernel / _small_attn_kernel_kt): s = (q k^T) * scale in fp32,
// keys past T masked; m = the row max over all keys; p = exp(s - m) in fp32
// (as exp2 with log2 e folded into the scale, as flash_fwd.cu does); l = sum p
// in fp32; O = round_bf16(p) V accumulated in fp32, divided by l after the
// product, written as bf16. No online rescaling across key chunks.
//
// kFused (B6, merv_tpu/ops/fused_vit_block.py _fused_block_kernel) takes the
// other order: l first, then round_bf16(p / l) V, written as it is, and the
// output as [B, T, H * 64] (head h at column 64 h: the rows the o-projection
// reads). For T <= 272 the whole row of p is in registers when l is known;
// for T > 272 the first chunk's sum is taken in the pass that finds its max
// and rescaled to the row's max, so l is known while the second chunk's
// scores are still held.
//
// Bound on the H100: bytes (at [16, 16, 261, 64]: 34.2 MB of q, k, v and o,
// 0.0102 ms; ~T/2 = 130 flops per byte, under the bf16 balance point), with
// the softmax's exponentials (one MUFU result per score) of the same order.
// So the loads, the tensor cores and the exponentials have to overlap.
//
// Design.
// - A persistent grid: one block per SM (at most B * H blocks), 384 threads.
//   Block i takes the heads i, i + gridDim.x, ... in turn. Warpgroup 0 is
//   the producer (setmaxnreg down to 24); warpgroups 1 and 2 consume 64-row
//   query tiles (setmaxnreg up to 240), alternating over the block's whole
//   sequence of (head, tile) pairs, so that a head with an odd number of tiles
//   does not leave one warpgroup idle.
// - K and V of a head sit in shared memory whole, in 64-key slabs with the
//   128-byte swizzle, in a ring of 2 stages (1 where two do not fit: T > 320
//   for kt, T > 384 for k) guarded by full / empty mbarriers: the producer
//   loads the next head while the consumers work on this one. V, B3's K and
//   every Q tile come by TMA (3-D tensor maps (64, T, heads), zero fill past
//   T). K1's kt cannot take a tensor map (its row stride, 2T bytes, is not a
//   multiple of 16), but a head's kt is one contiguous block of 128 T bytes:
//   one 1-D bulk copy brings it in, and the producer's 128 threads rewrite it
//   into swizzled MN-major slabs (64 head-dim rows x 64 keys each), which
//   wgmma reads through its transpose bit; keys 256-271 also go to a 16-row
//   K-major tail (see below).
// - A consumer warpgroup loads its Q tile by TMA (the next tile's load is
//   issued as soon as the scores no longer need this one) and computes
//   S = Q K^T by wgmma from shared memory into registers. For T <= 272 (the
//   towers' 257 and 261) the whole row is held: four m64n64 blocks and one
//   m64n16 tail (keys 256-271), 136 fp32 registers a thread, and QK^T runs
//   once. For 272 < T <= 512 the keys go in two chunks of 256: the row max is
//   taken over both, the last chunk's scores are still in registers, and only
//   the first chunk is computed again.
// - The fp32 row max and sum are taken on the accumulator fragment with quad
//   shuffles; exponentials are skipped for 8-key groups wholly past T and for
//   warps whose 16 rows are all past T (their p is 0). p goes from the
//   accumulator to the register A operand of O += P V (acc_to_a), whose B
//   operand is V as it lies ([keys][64], MN-major). O is divided by l and
//   stored for rows < T only.
//
// Head dim 72 (D = 72). A 72-wide row is 144 bytes, more than a 128-byte
// swizzled slab row, and the reduction over D goes in k steps of 16. So the
// first 64 columns stay in the 64-column slabs above, and columns 64..79 go to
// a second, 32-byte-wide slab per operand (hopper.cuh's make_tail_map: a TMA
// box {16, rows} with the 32-byte swizzle, loaded at column 64; columns 72..79
// lie past the tensor and read as 0). QK^T takes a fifth k step from those
// slabs (Q's and B3's K's 32-byte slabs K-major; K1's kt slabs are 80 head-dim
// rows tall instead of 64, rows 72..79 zero, written once at the start); P V
// adds an m64n16 product over V's 32-byte slab (columns 64..79, MN-major), whose
// columns 72..79 are 0 and are not stored. K1's raw kt (72 T values a head)
// comes in two bulk copies of 32 and 40 head-dim rows, so that at T = 512 the
// raw buffer, one stage and the Q tiles fit in shared memory. The D = 64
// instances compile as before: every D = 72 step sits behind `if constexpr`.
#pragma once

#include <algorithm>

#include "hopper.cuh"

namespace small_attn {
namespace {  // internal linkage: each library that includes this keeps its own launch's setup record

constexpr int kMaxT = 512;
constexpr int kThreads = 384;      // producer warpgroup + two consumer warpgroups
constexpr int kRows = 64;          // query rows per tile: one consumer warpgroup
constexpr int kBlocks = 4;         // 64-key score blocks of a chunk
constexpr int kChunk = kBlocks * 64;
constexpr int kOnePass = kChunk + 16;  // T up to which a whole row (with the 16-key tail) is held
constexpr uint32_t kSlabBytes = 64 * 128;  // 64 rows of 64 bf16
constexpr uint32_t kSlab32Bytes = 64 * 32;  // 64 rows of the 16 columns 64..79 (D = 72)
constexpr uint32_t kTailBytes = 16 * 128;  // K1: keys 256-271 K-major
constexpr int kProducerRegs = 24;          // 128 * 24 + 256 * 240 = the 168 * 384 the launch gives
constexpr int kConsumerRegs = 240;

// What the head dim D changes.
template <int D>
struct Dim {
  static_assert(D == 64 || D == 72, "small_attn: head dim 64 or 72");
  static constexpr bool kWide = D > 64;  // columns 64..79 in 32-byte-wide slabs
  static constexpr uint32_t kQBytes = kSlabBytes + (kWide ? kSlab32Bytes : 0u);
  static constexpr int kKtRows = kWide ? 80 : 64;  // K1's MN-major slab: head-dim rows, a whole k step
  static constexpr uint32_t kKtSlab = kKtRows * 128;
  static constexpr int kKtTails = kWide ? 2 : 1;  // K1's K-major tails (keys 256-271): dims 0-63, 64-79
  static constexpr int kParts = kWide ? 2 : 1;    // K1's bulk copies of kt a head
  static constexpr int kMaxPartRows = kWide ? 40 : 64;
};

struct Bars {
  uint64_t k_full[2], v_full[2], empty[2], q_full[2], raw_full;
};

// Byte offsets from the 1024-aligned base of dynamic shared memory: mbarriers
// in the first 1024 bytes, the two consumers' Q tiles (D = 72: the 64-column
// slab, then the 32-byte one), the stages, and (K1 only) the raw copy of a
// head's kt (D = 72: of its larger part). Within a stage: K1's K-major tails,
// the K slabs (from k), B3's K 32-byte slabs (from k32, D = 72), the V slabs
// (from v) and V's 32-byte slabs (from v32, D = 72). Every region starts on a
// 1024-byte boundary.
struct Layout {
  int slabs, stages;
  uint32_t q, stage0, stage_bytes, k, k32, v, v32, raw, total;
};

template <int D>
__host__ __device__ inline Layout layout(int T, bool kt) {
  using G = Dim<D>;
  Layout L;
  L.slabs = (T + 63) / 64;
  const uint32_t k32_bytes = G::kWide ? L.slabs * kSlab32Bytes : 0u;
  L.k = kt ? G::kKtTails * kTailBytes : 0u;
  L.k32 = L.k + L.slabs * (kt ? G::kKtSlab : kSlabBytes);
  L.v = L.k32 + (kt ? 0u : k32_bytes);
  L.v32 = L.v + L.slabs * kSlabBytes;
  L.stage_bytes = L.v32 + k32_bytes;
  L.q = 1024;
  L.stage0 = L.q + 2 * G::kQBytes;
  const uint32_t raw_bytes = kt ? (static_cast<uint32_t>(T) * 2u * G::kMaxPartRows + 1023u) / 1024u * 1024u : 0u;
  L.stages = L.stage0 + 2 * L.stage_bytes + raw_bytes + 1024 <= static_cast<uint32_t>(kSmemLimit) ? 2 : 1;
  L.raw = L.stage0 + L.stages * L.stage_bytes;
  L.total = L.raw + raw_bytes + 1024;  // + the alignment slack of align_1024
  return L;
}

// Head-dim rows [d0, d0 + ROWS) of one head's kt, held raw (row d0 + r at
// raw + r * T) -> the swizzled MN-major slabs at kslab (slab j holds keys
// 64j .. 64j + 63 as head-dim rows of 128 bytes, `slab_bytes` apart, 16-byte
// chunk c of row d at chunk c ^ (d % 8): what a TMA box with the 128-byte
// swizzle writes); keys past T are 0. For 256 < T <= 272 also keys 256-271 as
// 16 K-major rows (key r's head dims, chunk c at c ^ (r % 8)) at ktail (dims
// 0-63) and, for D = 72, dims 64-71 as chunk 0 of a second tail 2 KB on: the B
// operand of the m64n16 tail, since an MN-major operand narrower than the
// 64-key swizzle row is not one the slabs can give.
template <int ROWS>
__device__ __forceinline__ void relayout_kt(const unsigned short* __restrict__ raw, unsigned char* kslab,
                                            uint32_t slab_bytes, unsigned char* ktail, int T, int slabs, int d0,
                                            int tid, int nthreads) {
  // not unrolled: the producer runs in kProducerRegs registers
#pragma unroll 1
  for (int it = tid; it < slabs * ROWS * 8; it += nthreads) {
    const int c = it & 7, r = (it >> 3) % ROWS, j = (it >> 3) / ROWS, d = d0 + r;
    const int key0 = j * 64 + c * 8;
    const unsigned short* src = raw + r * T + key0;
    uint32_t w[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const uint32_t lo = key0 + 2 * e < T ? src[2 * e] : 0u;
      const uint32_t hi = key0 + 2 * e + 1 < T ? src[2 * e + 1] : 0u;
      w[e] = lo | (hi << 16);
    }
    *reinterpret_cast<uint4*>(kslab + j * slab_bytes + d * 128 + ((c ^ (d & 7)) << 4)) =
        make_uint4(w[0], w[1], w[2], w[3]);
  }
  if (T > kChunk && T <= kOnePass) {
    constexpr int kC = ROWS / 8;  // chunks of 8 head dims in this part
#pragma unroll 1
    for (int it = tid; it < 16 * kC; it += nthreads) {
      const int cl = it % kC, r = it / kC, cc = d0 / 8 + cl, key = kChunk + r;
      uint32_t w[4] = {0u, 0u, 0u, 0u};
      if (key < T) {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[e] = static_cast<uint32_t>(raw[(8 * cl + 2 * e) * T + key]) |
                 (static_cast<uint32_t>(raw[(8 * cl + 2 * e + 1) * T + key]) << 16);
      }
      unsigned char* dst = cc < 8 ? ktail + r * 128 + ((cc ^ (r & 7)) << 4) : ktail + kTailBytes + r * 128 + ((r & 7) << 4);
      *reinterpret_cast<uint4*>(dst) = make_uint4(w[0], w[1], w[2], w[3]);
    }
  }
}

// Descriptor `d` moved on by `bytes` (the start address field is its low 14
// bits, in 16-byte units; no shared-memory address here carries out of them).
__device__ __forceinline__ uint64_t desc_at(uint64_t d, uint32_t bytes) { return d + (bytes >> 4); }

// Where a stage's K lies: the 64-column K slabs (K1: the MN-major kt slabs),
// K1's K-major tails, and B3's 32-byte K slabs (D = 72).
struct KStage {
  const unsigned char* k;
  const unsigned char* tail;
  const unsigned char* k32;
};

// Scores: blocks 0 .. NB-1 = Q K^T over the keys of slabs slab0 .. slab0 + NB - 1
// and, with TAIL, keys 256-271 into st. D = 72: a fifth k step over the head
// dims 64-79 (Q's and K's 32-byte slabs; K1: rows 64-79 of the kt slabs).
template <int D, bool kKt, int NB, bool TAIL>
__device__ __forceinline__ void qk(float (&sc)[kBlocks][32], float (&st)[8], const bf16* qbuf, KStage ks_, int slab0) {
  using G = Dim<D>;
  // the first k step overwrites the accumulators: zeroing them first ends the
  // previous scores' lives here, so p's registers can take theirs
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < 32; ++i) sc[b][i] = 0.f;
  if (TAIL) {
#pragma unroll
    for (int i = 0; i < 8; ++i) st[i] = 0.f;
  }
  const uint64_t qd = kmajor_desc(qbuf, 0, 0);
  const bf16* k = reinterpret_cast<const bf16*>(ks_.k);
  constexpr uint32_t kBlockBytes = kKt ? G::kKtSlab : kSlabBytes;
  // K1: slab slab0 MN-major, + one slab a block, + 16 rows (2 KB) a k step;
  // B3: row 64 * slab0 K-major, + 64 rows (8 KB) a block, + 32 bytes a k step
  const uint64_t kd = kKt ? mnmajor_desc(k + slab0 * (kBlockBytes / 2), 0, kBlockBytes) : kmajor_desc(k, slab0 * 64, 0);
  // D = 72: Q's and B3's K's 32-byte slabs, K-major (row r at 32 r bytes)
  const uint64_t qd32 = sw32_desc(reinterpret_cast<const unsigned char*>(qbuf) + kSlabBytes, 16, 256);
  const uint64_t kd32 = sw32_desc(ks_.k32 + slab0 * 64 * 32, 16, 256);
  wgmma_fence();
#pragma unroll
  for (int b = 0; b < NB; ++b) pin(sc[b]);
  if (TAIL) pin(st);
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int ks = 0; ks < 4; ++ks)
      wgmma_ss_n64_b<kKt ? 1 : 0>(sc[b], desc_at(qd, ks * 32), desc_at(kd, b * kBlockBytes + ks * (kKt ? 2048 : 32)),
                                  ks > 0);
    if constexpr (G::kWide) {
      if constexpr (kKt)
        wgmma_ss_n64_b<1>(sc[b], qd32, desc_at(kd, b * kBlockBytes + 4 * 2048), 1);
      else
        wgmma_ss_n64_b<0>(sc[b], qd32, desc_at(kd32, b * 64 * 32), 1);
    }
  }
  if (TAIL) {
    // keys 256-271 K-major: K1's tail rows, B3's K rows 256-271
    const uint64_t td = kKt ? kmajor_desc(reinterpret_cast<const bf16*>(ks_.tail), 0, 0) : kmajor_desc(k, kChunk, 0);
#pragma unroll
    for (int ks = 0; ks < 4; ++ks) wgmma_ss_n16(st, desc_at(qd, ks * 32), desc_at(td, ks * 32), ks > 0);
    if constexpr (G::kWide) {
      const uint64_t td32 = kKt ? kmajor_desc(reinterpret_cast<const bf16*>(ks_.tail + kTailBytes), 0, 0)
                                : sw32_desc(ks_.k32 + kChunk * 32, 16, 256);
      wgmma_ss_n16(st, qd32, td32, 1);
    }
  }
  wgmma_commit();
  wgmma_wait<0>();
#pragma unroll
  for (int b = 0; b < NB; ++b) pin(sc[b]);
  if (TAIL) pin(st);
}

// Keys >= T of N fragment values of a block (keys from key0) -> -inf. The
// scores stay unscaled: scale > 0, so the row max is taken on them and the
// scale is folded into the exponent (exp_block).
template <int N>
__device__ __forceinline__ void mask_block(float* s, int key0, int T, int t) {
  if (key0 + 8 * (N / 4) > T) {
#pragma unroll
    for (int n = 0; n < N / 4; ++n) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (key0 + 8 * n + 2 * t + j >= T) s[4 * n + j] = s[4 * n + 2 + j] = neg_inf();
      }
    }
  }
}

// Each thread's max over N fragment values of rows a (g) and b (g + 8).
template <int N>
__device__ __forceinline__ void max_block(const float* s, float& ma, float& mb) {
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    ma = fmaxf(ma, fmaxf(s[4 * n], s[4 * n + 1]));
    mb = fmaxf(mb, fmaxf(s[4 * n + 2], s[4 * n + 3]));
  }
}

// p = exp2(s * c - m * c) with c = scale * log2 e, one FFMA and one MUFU op
// a score (ma, mb here are m * c), on N fragment values (keys from key0); 0
// for 8-key groups wholly past T and everywhere when the warp's rows are all
// past T; l += p.
template <int N>
__device__ __forceinline__ void exp_block(float* s, int key0, int T, bool live, float c, float ma, float mb, float& la,
                                          float& lb) {
#pragma unroll
  for (int n = 0; n < N / 4; ++n) {
    if (live && key0 + 8 * n < T) {
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        s[4 * n + j] = ex2_ftz(fmaf(s[4 * n + j], c, -ma));
        s[4 * n + 2 + j] = ex2_ftz(fmaf(s[4 * n + 2 + j], c, -mb));
        la += s[4 * n + j];
        lb += s[4 * n + 2 + j];
      }
    } else {
#pragma unroll
      for (int j = 0; j < 4; ++j) s[4 * n + j] = 0.f;
    }
  }
}

// The chunk's scores from the keys at kbase: masked and folded into the row max.
template <int NB, bool TAIL>
__device__ __forceinline__ void scores_max(float (&sc)[kBlocks][32], float (&st)[8], int kbase, int T, int t,
                                           float& ma, float& mb) {
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    mask_block<32>(sc[b], kbase + 64 * b, T, t);
    max_block<32>(sc[b], ma, mb);
  }
  if (TAIL) {
    mask_block<8>(st, kChunk, T, t);
    max_block<8>(st, ma, mb);
  }
}

// p on the chunk's scores, l += p, then acc += round_bf16(p) V over its keys
// (16 keys a k step, the tail's one more), V read from the stage as it lies;
// D = 72: also acc32 += round_bf16(p) V[:, 64:80] from V's 32-byte slabs
// (MN-major, key r at 32 r bytes). `first`: acc holds nothing yet, and the
// first product overwrites it (acc is then not live while the scores are).
template <int D, int NB, bool TAIL>
__device__ __forceinline__ void exp_pv(float (&sc)[kBlocks][32], float (&st)[8], float (&acc)[32], float (&acc32)[8],
                                      const unsigned char* vst, const unsigned char* v32, int kbase, int T, bool live,
                                      float c, float ma, float mb, float& la, float& lb, bool first) {
  constexpr int kSteps = NB * 4 + (TAIL ? 1 : 0);
  uint32_t pf[kSteps][4];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    exp_block<32>(sc[b], kbase + 64 * b, T, live, c, ma, mb, la, lb);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) acc_to_a(pf[4 * b + kk], sc[b] + 8 * kk);
  }
  if (TAIL) {
    exp_block<8>(st, kChunk, T, live, c, ma, mb, la, lb);
    acc_to_a(pf[kSteps - 1], st);
  }
  const uint64_t vd = mnmajor_desc(reinterpret_cast<const bf16*>(vst), kbase, kSlabBytes);
  const uint64_t vd32 = sw32_desc(v32 + kbase * 32, kSlab32Bytes, 256);
  wgmma_fence();
  pin(acc);
  if constexpr (Dim<D>::kWide) pin(acc32);
  pin(pf);
#pragma unroll
  for (int k = 0; k < kSteps; ++k) {
    wgmma_rs_n64_tb(acc, pf[k], desc_at(vd, k * 2048), !(first && k == 0));
    if constexpr (Dim<D>::kWide) wgmma_rs_n16_tb(acc32, pf[k], desc_at(vd32, k * 512), !(first && k == 0));
  }
  wgmma_commit();
  wgmma_wait<0>();
  pin(acc);
  if constexpr (Dim<D>::kWide) pin(acc32);
  pin(pf);
}

// Scores and their max for a chunk of one of the shapes a call can take:
// 1-4 blocks without the tail, or 4 blocks and the tail.
template <int D, bool kKt>
__device__ __forceinline__ void qk_max(int nb, bool tail, float (&sc)[kBlocks][32], float (&st)[8], const bf16* qbuf,
                                       KStage kst, int slab0, int T, int t, float& ma, float& mb) {
  const int kbase = slab0 * 64;
  if (tail) {
    qk<D, kKt, 4, true>(sc, st, qbuf, kst, slab0);
    scores_max<4, true>(sc, st, kbase, T, t, ma, mb);
    return;
  }
  switch (nb) {
    case 1:
      qk<D, kKt, 1, false>(sc, st, qbuf, kst, slab0);
      scores_max<1, false>(sc, st, kbase, T, t, ma, mb);
      break;
    case 2:
      qk<D, kKt, 2, false>(sc, st, qbuf, kst, slab0);
      scores_max<2, false>(sc, st, kbase, T, t, ma, mb);
      break;
    case 3:
      qk<D, kKt, 3, false>(sc, st, qbuf, kst, slab0);
      scores_max<3, false>(sc, st, kbase, T, t, ma, mb);
      break;
    default:
      qk<D, kKt, 4, false>(sc, st, qbuf, kst, slab0);
      scores_max<4, false>(sc, st, kbase, T, t, ma, mb);
      break;
  }
}

template <int D>
__device__ __forceinline__ void exp_pv_n(int nb, bool tail, float (&sc)[kBlocks][32], float (&st)[8], float (&acc)[32],
                                         float (&acc32)[8], const unsigned char* vst, const unsigned char* v32,
                                         int kbase, int T, bool live, float c, float ma, float mb, float& la,
                                         float& lb, bool first) {
  if (tail) {
    exp_pv<D, 4, true>(sc, st, acc, acc32, vst, v32, kbase, T, live, c, ma, mb, la, lb, first);
    return;
  }
  switch (nb) {
    case 1: exp_pv<D, 1, false>(sc, st, acc, acc32, vst, v32, kbase, T, live, c, ma, mb, la, lb, first); break;
    case 2: exp_pv<D, 2, false>(sc, st, acc, acc32, vst, v32, kbase, T, live, c, ma, mb, la, lb, first); break;
    case 3: exp_pv<D, 3, false>(sc, st, acc, acc32, vst, v32, kbase, T, live, c, ma, mb, la, lb, first); break;
    default: exp_pv<D, 4, false>(sc, st, acc, acc32, vst, v32, kbase, T, live, c, ma, mb, la, lb, first); break;
  }
}
// 1 / (the quad's sum of l), 0 for a row with no p (a warp wholly past T)
__device__ __forceinline__ float inv_row_sum(float l) {
  l = quad_sum(l);
  return l > 0.f ? 1.f / l : 0.f;
}

// kFused: p (exp_block's output, fp32) times 1/l, rounded to bf16, then
// acc (+)= that V over the chunk's keys.
template <int NB, bool TAIL>
__device__ __forceinline__ void norm_pv(float (&sc)[kBlocks][32], float (&st)[8], float (&acc)[32],
                                        const unsigned char* vst, int kbase, float ia, float ib, bool first) {
  constexpr int kSteps = NB * 4 + (TAIL ? 1 : 0);
  uint32_t pf[kSteps][4];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      float* d = sc[b] + 8 * kk;
      pf[4 * b + kk][0] = pack_bf16(d[0] * ia, d[1] * ia);
      pf[4 * b + kk][1] = pack_bf16(d[2] * ib, d[3] * ib);
      pf[4 * b + kk][2] = pack_bf16(d[4] * ia, d[5] * ia);
      pf[4 * b + kk][3] = pack_bf16(d[6] * ib, d[7] * ib);
    }
  }
  if (TAIL) {
    pf[kSteps - 1][0] = pack_bf16(st[0] * ia, st[1] * ia);
    pf[kSteps - 1][1] = pack_bf16(st[2] * ib, st[3] * ib);
    pf[kSteps - 1][2] = pack_bf16(st[4] * ia, st[5] * ia);
    pf[kSteps - 1][3] = pack_bf16(st[6] * ib, st[7] * ib);
  }
  const uint64_t vd = mnmajor_desc(reinterpret_cast<const bf16*>(vst), kbase, kSlabBytes);
  wgmma_fence();
  pin(acc);
  pin(pf);
#pragma unroll
  for (int k = 0; k < kSteps; ++k) wgmma_rs_n64_tb(acc, pf[k], desc_at(vd, k * 2048), !(first && k == 0));
  wgmma_commit();
  wgmma_wait<0>();
  pin(acc);
  pin(pf);
}

// kFused: exp_block over a chunk of one of the shapes a call can take (l += p).
__device__ __forceinline__ void exp_sum_n(int nb, bool tail, float (&sc)[kBlocks][32], float (&st)[8], int kbase,
                                          int T, bool live, float c, float ma, float mb, float& la, float& lb) {
#pragma unroll
  for (int b = 0; b < kBlocks; ++b)
    if (b < nb) exp_block<32>(sc[b], kbase + 64 * b, T, live, c, ma, mb, la, lb);
  if (tail) exp_block<8>(st, kChunk, T, live, c, ma, mb, la, lb);
}

__device__ __forceinline__ void norm_pv_n(int nb, bool tail, float (&sc)[kBlocks][32], float (&st)[8],
                                          float (&acc)[32], const unsigned char* vst, int kbase, float ia, float ib,
                                          bool first) {
  if (tail) {
    norm_pv<4, true>(sc, st, acc, vst, kbase, ia, ib, first);
    return;
  }
  switch (nb) {
    case 1: norm_pv<1, false>(sc, st, acc, vst, kbase, ia, ib, first); break;
    case 2: norm_pv<2, false>(sc, st, acc, vst, kbase, ia, ib, first); break;
    case 3: norm_pv<3, false>(sc, st, acc, vst, kbase, ia, ib, first); break;
    default: norm_pv<4, false>(sc, st, acc, vst, kbase, ia, ib, first); break;
  }
}

// The kernel. kt: K1's kt (kmap, kmap32 unused); otherwise kmap / kmap32 map B3's k.
// kFused: B6's order and output layout (with B3's operands, H == Hk, D == 64).
// D = 72: qmap32 / kmap32 / vmap32 map the columns 64..79 (make_tail_map).
template <bool kKt, bool kFused, int D>
__global__ void __launch_bounds__(kThreads, 1)
    small_attn_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap kmap,
                      const __grid_constant__ CUtensorMap vmap, const __grid_constant__ CUtensorMap qmap32,
                      const __grid_constant__ CUtensorMap kmap32, const __grid_constant__ CUtensorMap vmap32,
                      const bf16* __restrict__ kt, bf16* __restrict__ o, int BH, int H, int Hk, int T,
                      float scale_log2) {
  using G = Dim<D>;
  static_assert(!kFused || D == 64, "B6's whole-head stage takes head dim 64");
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  const Layout L = layout<D>(T, kKt);
  Bars& bar = *reinterpret_cast<Bars*>(base);
  const int n_heads = (BH - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) / static_cast<int>(gridDim.x);
  const int n_tiles = (T + kRows - 1) / kRows;
  const int group = H / Hk;

  if (threadIdx.x == 0) {
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      mbar_init(&bar.k_full[s], kKt ? 128 : 1);  // K1: every producer thread, after its share of the relayout
      mbar_init(&bar.v_full[s], 1);
      mbar_init(&bar.empty[s], 8);  // the consumer warps
      mbar_init(&bar.q_full[s], 1);
    }
    mbar_init(&bar.raw_full, 1);
    mbar_fence_init();
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == 0) {
    // ---------------- producer ----------------
    setmaxnreg_dec<kProducerRegs>();
    const int tid = threadIdx.x;
    if constexpr (kKt && G::kWide) {
      // rows 72-79 of every kt slab and the second K-major tail are 0 for the
      // whole run (the relayout writes rows 0-71 and the tail's chunk 0 only)
#pragma unroll 1
      for (int s = 0; s < L.stages; ++s) {
        unsigned char* kst = base + L.stage0 + s * L.stage_bytes;
#pragma unroll 1
        for (int it = tid; it < L.slabs * 64 + kTailBytes / 16; it += 128) {
          unsigned char* dst = it < L.slabs * 64
                                   ? kst + L.k + (it >> 6) * G::kKtSlab + (72 + ((it >> 3) & 7)) * 128 + (it & 7) * 16
                                   : kst + kTailBytes + (it - L.slabs * 64) * 16;
          *reinterpret_cast<uint4*>(dst) = make_uint4(0u, 0u, 0u, 0u);
        }
      }
    }
    for (int i = 0; i < n_heads; ++i) {
      const int bh = blockIdx.x + i * gridDim.x;
      const int bhk = kKt ? bh : (bh / H) * Hk + (bh % H) / group;  // K1 has no GQA
      const int s = i % L.stages;
      unsigned char* kst = base + L.stage0 + s * L.stage_bytes;
      unsigned char* vst = kst + L.v;
      mbar_wait(&bar.empty[s], ((i / L.stages) & 1) ^ 1u);
      if (tid == 0) {
        mbar_arrive_expect_tx(&bar.v_full[s], L.slabs * (kSlabBytes + (G::kWide ? kSlab32Bytes : 0u)));
        for (int j = 0; j < L.slabs; ++j) {
          tma_load_3d(vst + j * kSlabBytes, &vmap, &bar.v_full[s], 0, 64 * j, bhk);
          if constexpr (G::kWide) tma_load_3d(kst + L.v32 + j * kSlab32Bytes, &vmap32, &bar.v_full[s], 64, 64 * j, bhk);
        }
        if constexpr (!kKt) {
          mbar_arrive_expect_tx(&bar.k_full[s], L.slabs * (kSlabBytes + (G::kWide ? kSlab32Bytes : 0u)));
          for (int j = 0; j < L.slabs; ++j) {
            tma_load_3d(kst + j * kSlabBytes, &kmap, &bar.k_full[s], 0, 64 * j, bhk);
            if constexpr (G::kWide)
              tma_load_3d(kst + L.k32 + j * kSlab32Bytes, &kmap32, &bar.k_full[s], 64, 64 * j, bhk);
          }
        }
      }
      if constexpr (kKt) {
        // kt in parts of head-dim rows (D = 64: one of 64; D = 72: 32, then 40)
#pragma unroll
        for (int p = 0; p < G::kParts; ++p) {
          constexpr int kRows0 = G::kWide ? 32 : 64;
          const int d0 = p * kRows0;
          const uint32_t bytes = static_cast<uint32_t>(T) * 2u * (G::kWide && p == 1 ? 40u : kRows0);
          if (tid == 0) {
            fence_proxy_async();  // the raw buffer's earlier generic reads before the copy overwrites it
            mbar_arrive_expect_tx(&bar.raw_full, bytes);
            bulk_load(base + L.raw, kt + (static_cast<size_t>(bh) * D + d0) * T, bytes, &bar.raw_full);
          }
          mbar_wait(&bar.raw_full, (i * G::kParts + p) & 1);
          const unsigned short* raw = reinterpret_cast<const unsigned short*>(base + L.raw);
          if (G::kWide && p == 1)
            relayout_kt<40>(raw, kst + L.k, G::kKtSlab, kst, T, L.slabs, d0, tid, 128);
          else
            relayout_kt<kRows0>(raw, kst + L.k, G::kKtSlab, kst, T, L.slabs, d0, tid, 128);
          if (p + 1 == G::kParts) {
            fence_proxy_async();  // this thread's slab writes, before wgmma reads them
            mbar_arrive(&bar.k_full[s]);
          }
          named_barrier_sync(1, 128);  // every producer thread is done with the raw buffer
        }
      }
    }
  } else {
    // ---------------- consumers: 64-row query tiles, alternating ----------------
    setmaxnreg_inc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x - wg * 128;
    const int warp = tid >> 5, lane = tid & 31;
    const int g = lane >> 2, t = lane & 3;
    const bf16* qbuf = reinterpret_cast<const bf16*>(base + L.q + cw * G::kQBytes);
    const int total = n_heads * n_tiles;
    // one pass (a whole row, with the tail past 256 keys) or two chunks of 256 keys
    const bool one_pass = T <= kOnePass;
    const bool tail = one_pass && T > kChunk;
    const int last = one_pass ? 0 : 1;  // the chunk whose scores stay in registers
    const int last_nb = one_pass ? min(kBlocks, L.slabs) : L.slabs - kBlocks;

    auto load_q = [&](int gi) {  // Q of global tile gi (head gi / n_tiles, tile gi % n_tiles)
      if (tid == 0 && gi < total) {
        const int bh = blockIdx.x + (gi / n_tiles) * gridDim.x;
        mbar_arrive_expect_tx(&bar.q_full[cw], G::kQBytes);
        tma_load_3d(const_cast<bf16*>(qbuf), &qmap, &bar.q_full[cw], 0, (gi % n_tiles) * kRows, bh);
        if constexpr (G::kWide)
          tma_load_3d(const_cast<bf16*>(qbuf) + kSlabBytes / 2, &qmap32, &bar.q_full[cw], 64, (gi % n_tiles) * kRows,
                      bh);
      }
    };
    auto release_q = [&](int gi) {  // every warp's wgmma is done with Q: load the next tile's
      named_barrier_sync(2 + cw, 128);
      load_q(gi + 2);
    };

    // The two warpgroups take turns on the tensor cores: a warpgroup computes
    // its scores only after the other's are done (barrier 4 + cw, 256 threads)
    // and lets the other go once its own are (barrier 5 - cw), so one's QK^T
    // runs while the other's exponentials do. Warpgroup 0 goes first.
    if (cw == 1) named_barrier_arrive(4, 256);

    load_q(cw);
    uint32_t q_phase = 0;
    int gi = cw;
    float sc[kBlocks][32], st[8];

    for (int i = 0; i < n_heads; ++i) {
      const int bh = blockIdx.x + i * gridDim.x;
      const int s = i % L.stages;
      const uint32_t ph = (i / L.stages) & 1;
      const unsigned char* stage = base + L.stage0 + s * L.stage_bytes;
      const KStage kst{stage + L.k, stage, stage + L.k32};
      const unsigned char* vst = stage + L.v;
      const unsigned char* v32 = stage + L.v32;
      mbar_wait(&bar.k_full[s], ph);
      for (; gi < (i + 1) * n_tiles; gi += 2) {
        const int row0 = (gi - i * n_tiles) * kRows;
        const int ra = row0 + warp * 16 + g, rb = ra + 8;
        const bool live = row0 + warp * 16 < T;  // some row of this warp is a real query
        mbar_wait(&bar.q_full[cw], q_phase);
        q_phase ^= 1u;

        float acc[32];  // the first product of exp_pv_n / norm_pv_n(..., true) overwrites it
        float acc32[8];  // D = 72: columns 64..79 (72..79 are 0)
        float ia = 1.f, ib = 1.f;
        if constexpr (!kFused) {
          // the row max over every key; the last chunk's scores stay in registers
          float ma = neg_inf(), mb = neg_inf();
          named_barrier_sync(4 + cw, 256);
          if (last == 1) qk_max<D, kKt>(kBlocks, false, sc, st, qbuf, kst, 0, T, t, ma, mb);
          qk_max<D, kKt>(last_nb, tail, sc, st, qbuf, kst, last * kBlocks, T, t, ma, mb);
          named_barrier_arrive(5 - cw, 256);
          ma = quad_max(ma) * scale_log2;  // the exponent is s * c - m * c
          mb = quad_max(mb) * scale_log2;
          if (last == 0) release_q(gi);

          float la = 0.f, lb = 0.f;
          mbar_wait(&bar.v_full[s], ph);
          exp_pv_n<D>(last_nb, tail, sc, st, acc, acc32, vst, v32, last * kChunk, T, live, scale_log2, ma, mb, la, lb,
                      true);
          if (last == 1) {  // T > 272: the first chunk's scores again (all its keys are < T)
            float ua = neg_inf(), ub = neg_inf();  // their max again, unused: ma, mb hold the row's
            qk_max<D, kKt>(kBlocks, false, sc, st, qbuf, kst, 0, T, t, ua, ub);
            release_q(gi);
            exp_pv_n<D>(kBlocks, false, sc, st, acc, acc32, vst, v32, 0, T, live, scale_log2, ma, mb, la, lb, false);
          }
          // o / l after the product, as one reciprocal a row and a multiply
          ia = 1.f / quad_sum(la);
          ib = 1.f / quad_sum(lb);
        } else {
          // l before the product: p / l rounded to bf16, then P V
          float ma = neg_inf(), mb = neg_inf(), la = 0.f, lb = 0.f;
          named_barrier_sync(4 + cw, 256);
          if (last == 1) {  // T > 272: the first chunk's max and its sum at that max
            qk_max<D, kKt>(kBlocks, false, sc, st, qbuf, kst, 0, T, t, ma, mb);
            ma = quad_max(ma);
            mb = quad_max(mb);
            exp_sum_n(kBlocks, false, sc, st, 0, T, live, scale_log2, ma * scale_log2, mb * scale_log2, la, lb);
          }
          const float m0a = ma, m0b = mb;
          qk_max<D, kKt>(last_nb, tail, sc, st, qbuf, kst, last * kBlocks, T, t, ma, mb);
          named_barrier_arrive(5 - cw, 256);
          ma = quad_max(ma) * scale_log2;
          mb = quad_max(mb) * scale_log2;
          if (last == 1) {  // the first chunk's sum rescaled to the row's max
            la *= ex2_ftz(fmaf(m0a, scale_log2, -ma));
            lb *= ex2_ftz(fmaf(m0b, scale_log2, -mb));
          } else {
            release_q(gi);
          }
          exp_sum_n(last_nb, tail, sc, st, last * kChunk, T, live, scale_log2, ma, mb, la, lb);
          const float pa = inv_row_sum(la), pb = inv_row_sum(lb);
          mbar_wait(&bar.v_full[s], ph);
          norm_pv_n(last_nb, tail, sc, st, acc, vst, last * kChunk, pa, pb, true);
          if (last == 1) {  // the first chunk's scores and p again
            float ua = neg_inf(), ub = neg_inf(), va = 0.f, vb = 0.f;
            qk_max<D, kKt>(kBlocks, false, sc, st, qbuf, kst, 0, T, t, ua, ub);
            release_q(gi);
            exp_sum_n(kBlocks, false, sc, st, 0, T, live, scale_log2, ma, mb, va, vb);
            norm_pv_n(kBlocks, false, sc, st, acc, vst, 0, pa, pb, false);
          }
        }

        // K1, B3: o [B, H, T, D]; B6: o [B, T, H * 64]
        const int ors = kFused ? H * D : D;
        bf16* oh = kFused ? o + static_cast<size_t>(bh / H) * T * H * D + (bh % H) * D
                          : o + static_cast<size_t>(bh) * T * D;
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const int col = n * 8 + 2 * t;
          if (ra < T)
            *reinterpret_cast<__nv_bfloat162*>(oh + static_cast<size_t>(ra) * ors + col) =
                __floats2bfloat162_rn(acc[4 * n] * ia, acc[4 * n + 1] * ia);
          if (rb < T)
            *reinterpret_cast<__nv_bfloat162*>(oh + static_cast<size_t>(rb) * ors + col) =
                __floats2bfloat162_rn(acc[4 * n + 2] * ib, acc[4 * n + 3] * ib);
        }
        if constexpr (G::kWide) {  // columns 64..71 (acc32[4..7], columns 72..79, are 0)
          const int col = 64 + 2 * t;
          if (ra < T)
            *reinterpret_cast<__nv_bfloat162*>(oh + static_cast<size_t>(ra) * ors + col) =
                __floats2bfloat162_rn(acc32[0] * ia, acc32[1] * ia);
          if (rb < T)
            *reinterpret_cast<__nv_bfloat162*>(oh + static_cast<size_t>(rb) * ors + col) =
                __floats2bfloat162_rn(acc32[2] * ib, acc32[3] * ib);
        }
      }
      if (lane == 0) mbar_arrive(&bar.empty[s]);  // this warpgroup is done with the head (even with no tile of it)
    }
    // Settle the turns: warpgroup 0 took (total + 1) / 2 of them and warpgroup 1
    // total / 2, after its opening arrival. An arrival no turn consumed (on
    // barrier 4 when total is even, on 5 when it is odd) is consumed here.
    if (cw == 0 && total % 2 == 0) named_barrier_sync(4, 256);
    if (cw == 1 && total % 2 == 1) named_barrier_sync(5, 256);
  }
}

// Host: the tensor maps, the persistent grid and the launch. kt is K1's kt
// (k unused) or null (B3, B6: k mapped). kFused: B6's order, o [B, T, H * 64].
// D: the head dim, 64 or 72 (kFused: 64).
template <bool kKt, bool kFused = false, int D = 64>
int launch(const void* q, const void* k, const void* kt, const void* v, void* o, int B, int H, int Hk, int T,
           float scale, cudaStream_t stream) {
  if (T <= 0 || T > kMaxT || B <= 0 || H <= 0 || Hk <= 0 || H % Hk != 0) return static_cast<int>(cudaErrorInvalidValue);
  static int done[64] = {0};  // this instantiation's record (the anonymous namespace keeps it per library)
  int sms = 0;
  cudaError_t e = device_setup(done, &sms, small_attn_kernel<kKt, kFused, D>);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap qmap, kmap, vmap;
  e = make_tile_map(&qmap, q, B * H, T, D, kRows);
  if (e == cudaSuccess) e = make_tile_map(&vmap, v, B * Hk, T, D, 64);
  if (e == cudaSuccess) e = kKt ? make_tile_map(&kmap, q, B * H, T, D, kRows) : make_tile_map(&kmap, k, B * Hk, T, D, 64);
  if (e != cudaSuccess) return static_cast<int>(e);
  CUtensorMap qmap32 = qmap, kmap32 = kmap, vmap32 = vmap;  // D = 64: unused copies
  if constexpr (Dim<D>::kWide) {
    e = make_tail_map(&qmap32, q, B * H, T, D, kRows);
    if (e == cudaSuccess) e = make_tail_map(&vmap32, v, B * Hk, T, D, 64);
    if (e == cudaSuccess && !kKt) e = make_tail_map(&kmap32, k, B * Hk, T, D, 64);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const Layout L = layout<D>(T, kKt);
  const int grid = std::min(B * H, sms);
  small_attn_kernel<kKt, kFused, D><<<grid, kThreads, L.total, stream>>>(
      qmap, kmap, vmap, qmap32, kmap32, vmap32, static_cast<const bf16*>(kt), static_cast<bf16*>(o), B * H, H, Hk, T,
      scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
}  // namespace small_attn
