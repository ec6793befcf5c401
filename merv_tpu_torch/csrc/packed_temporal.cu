// packed_temporal_attention: LanguageBind's temporal attention with all heads
// packed into one sequence per window. q/v [Bn, R, 64], kt [Bn, 64, R], bf16,
// contiguous, 16-byte aligned, R = frames * heads rows ordered (frame, head),
// R <= 512. Row r attends exactly the rows r' with r % heads == r' % heads.
//
// Replaces merv_tpu/ops/attention.py::packed_temporal_attention
// (_packed_temporal_fwd_impl / _packed_temporal_kernel, pallas_call :622).
//
// What is computed, in the TPU kernel's order: s = (q kt) * scale in fp32
// over the row's own head's keys (the TPU kernel's mask sets every other
// score to -0.7 * fp32 max, whose p is exactly 0); m = the row max; p =
// exp(s - m) in fp32 (as 2^(s c - m c), c = scale * log2 e); l = sum p in
// fp32; o = sum round_bf16(p) v in fp32, divided by l, rounded to bf16.
//
// Bound on the H100: bytes. At LanguageBind's [514, 128, 64] the kernel reads
// q, kt, v and writes o once (33.7 MB, 0.0101 ms at 3.35 TB/s). A row sees
// n = R / heads keys (8 of 128 there): the live work is 4 * Bn * R * n * 64
// flops (1.3e8, ~2 us at the card's fp32 rate), a sixteenth of the full
// R x R scores, and far below a 64-row wgmma tile.
//
// Design. Only the live scores are computed, in fp32 on the CUDA cores.
// - Persistent grid (2 blocks per SM at R = 128), 256 threads a block, each
//   block taking windows in turn through a 2-stage ring (1 stage when two do
//   not fit, R > 256), loaded one window ahead by thread 0 and completing on
//   the stage's mbarrier: q and v by TMA boxes of 64 rows with the 128-byte
//   swizzle (3-D maps (64, R, Bn), zero fill past R), kt, whose row stride
//   2R bytes no tensor map takes, by one 1-D bulk copy of 128 R bytes. No
//   transpose is staged: kt is read as it lies.
// - Two threads per row (kh = 0, 1), 16 rows a warp. Each holds the row's q
//   in registers and takes the scores of every other key of the row's head
//   (keys h + j heads, j = kh, kh + 2, ...): at a head-dim step the lanes read
//   kt[d][h + j heads] for consecutive h, one conflict-free row of kt. Keys go
//   in chunks of 8 a row (4 a thread); a row of more than 8 keys (heads < 16
//   at R = 128) takes its max over all chunks first and recomputes each.
// - The pair shares its max, its sum and each p by one shuffle. Each thread
//   accumulates half the row's 64 output columns over all of the row's keys.
//   The swizzle puts the 16-byte chunk the 8 lanes of a shared-memory phase
//   read from 4 rows (q) or 8 (v) in 8 different bank groups. Output: one
//   reciprocal a row, 16-byte stores.
#include <algorithm>

#include "hopper.cuh"

namespace {

constexpr int kD = 64;
constexpr int kMaxR = 512;
constexpr int kThreads = 256;   // 128 row pairs
constexpr int kChunkKeys = 4;   // keys a thread scores at once (8 a row)

constexpr int kBoxRows = 64;  // q and v rows a TMA box (8 KB)

// A stage, from a 1024-byte boundary: q [boxes * 64][64] and v [boxes * 64][64]
// as the TMA boxes write them (128-byte swizzle), then kt [64][R] as it lies.
struct Layout {
  int stages, boxes;
  uint32_t qv_bytes, kt_bytes, stage_bytes, total;
};

inline Layout layout(int R) {
  Layout L;
  L.boxes = (R + kBoxRows - 1) / kBoxRows;
  L.qv_bytes = L.boxes * kBoxRows * 128u;
  L.kt_bytes = 128u * static_cast<uint32_t>(R);
  L.stage_bytes = 2 * L.qv_bytes + (L.kt_bytes + 1023u) / 1024u * 1024u;
  L.stages = 1024 + 2 * L.stage_bytes + 1024 <= static_cast<uint32_t>(kSmemLimit) ? 2 : 1;
  L.total = 1024 + L.stages * L.stage_bytes + 1024;  // mbarriers, stages, the slack of align_1024
  return L;
}

// byte offset of 16-byte chunk c of row r in a swizzled q or v block
__device__ __forceinline__ uint32_t swz(int r, int c) { return r * 128u + ((c ^ (r & 7)) << 4); }

__device__ __forceinline__ float lo_f(uint32_t w) { return __uint_as_float(w << 16); }
__device__ __forceinline__ float hi_f(uint32_t w) { return __uint_as_float(w & 0xffff0000u); }
__device__ __forceinline__ float bf16_f(unsigned short b) { return __uint_as_float(static_cast<uint32_t>(b) << 16); }

// The unscaled scores of keys j = j0 + 2 i (i < kChunkKeys) of a row of head
// h with n keys: -inf for j >= n.
__device__ __forceinline__ void chunk_scores(float (&s)[kChunkKeys], const uint32_t (&qr)[32],
                                             const unsigned short* __restrict__ kts, int R, int heads, int h, int n,
                                             int j0) {
  int key[kChunkKeys];
#pragma unroll
  for (int i = 0; i < kChunkKeys; ++i) {
    const int j = j0 + 2 * i;
    key[i] = h + (j < n ? j : 0) * heads;  // a valid address for a key past the row's last
    s[i] = 0.f;
  }
#pragma unroll 4
  for (int d2 = 0; d2 < kD / 2; ++d2) {
    const float q0 = lo_f(qr[d2]), q1 = hi_f(qr[d2]);
    const unsigned short* k0 = kts + (2 * d2) * R;
#pragma unroll
    for (int i = 0; i < kChunkKeys; ++i) {
      s[i] = fmaf(q0, bf16_f(k0[key[i]]), s[i]);
      s[i] = fmaf(q1, bf16_f(k0[R + key[i]]), s[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < kChunkKeys; ++i)
    if (j0 + 2 * i >= n) s[i] = neg_inf();
}

__global__ void __launch_bounds__(kThreads, 2)
    packed_temporal_kernel(const __grid_constant__ CUtensorMap qmap, const __grid_constant__ CUtensorMap vmap,
                           const bf16* __restrict__ kt, bf16* __restrict__ o, int Bn, int R, int heads,
                           const Layout L, float scale_log2) {
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  unsigned char* base = align_1024(smem_raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(base);
  unsigned char* stage0 = base + 1024;
  const int stages = L.stages;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kh = lane & 1, pw = lane >> 1;  // key parity; the pair's row within the warp's 16
  const int n_win = (Bn - static_cast<int>(blockIdx.x) + static_cast<int>(gridDim.x) - 1) / static_cast<int>(gridDim.x);
  const int nmax = (R + heads - 1) / heads;                   // keys of the longest row
  const int n_chunks = (nmax + 2 * kChunkKeys - 1) / (2 * kChunkKeys);

  auto issue = [&](int i) {  // window i of this block into stage i % stages
    const int w = blockIdx.x + i * gridDim.x;
    const int s = i % stages;
    unsigned char* st = stage0 + s * L.stage_bytes;
    mbar_arrive_expect_tx(&full[s], 2 * L.qv_bytes + L.kt_bytes);
    for (int b = 0; b < L.boxes; ++b) {
      tma_load_3d(st + b * kBoxRows * 128, &qmap, &full[s], 0, b * kBoxRows, w);
      tma_load_3d(st + L.qv_bytes + b * kBoxRows * 128, &vmap, &full[s], 0, b * kBoxRows, w);
    }
    bulk_load(st + 2 * L.qv_bytes, kt + static_cast<size_t>(w) * R * kD, L.kt_bytes, &full[s]);
  };

  if (tid == 0) {
    for (int s = 0; s < stages; ++s) mbar_init(&full[s], 1);
    mbar_fence_init();
    for (int i = 0; i < min(stages, n_win); ++i) issue(i);
  }
  __syncthreads();

  for (int i = 0; i < n_win; ++i) {
    const int s = i % stages;
    mbar_wait(&full[s], (i / stages) & 1);
    const unsigned char* st = stage0 + s * L.stage_bytes;
    const unsigned char* qs = st;
    const unsigned short* kts = reinterpret_cast<const unsigned short*>(st + 2 * L.qv_bytes);
    const unsigned char* vs = st + L.qv_bytes;
    bf16* ow = o + (static_cast<size_t>(blockIdx.x) + static_cast<size_t>(i) * gridDim.x) * R * kD;

    // warp-uniform loop over groups of 16 rows; a pair past R computes row R - 1 and stores nothing
    for (int r0 = warp * 16; r0 < R; r0 += (kThreads / 32) * 16) {
      const int row = r0 + pw;
      const bool row_ok = row < R;
      const int r = row_ok ? row : R - 1;
      const int h = r % heads, n = (R - 1 - h) / heads + 1;
      uint32_t qr[32];
#pragma unroll
      for (int c = 0; c < 8; ++c) {
        const uint4 w = *reinterpret_cast<const uint4*>(qs + swz(r, c));
        qr[4 * c] = w.x;
        qr[4 * c + 1] = w.y;
        qr[4 * c + 2] = w.z;
        qr[4 * c + 3] = w.w;
      }

      // the row max over all its keys (computed once here when they fit one chunk)
      float sc[kChunkKeys];
      float m = neg_inf();
      for (int ch = 0; ch < n_chunks; ++ch) {
        chunk_scores(sc, qr, kts, R, heads, h, n, ch * 2 * kChunkKeys + kh);
#pragma unroll
        for (int i2 = 0; i2 < kChunkKeys; ++i2) m = fmaxf(m, sc[i2]);
      }
      m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, 1)) * scale_log2;

      float acc[4][8];
#pragma unroll
      for (int c = 0; c < 4; ++c)
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[c][e] = 0.f;
      float l = 0.f;
      for (int ch = 0; ch < n_chunks; ++ch) {
        if (n_chunks > 1) chunk_scores(sc, qr, kts, R, heads, h, n, ch * 2 * kChunkKeys + kh);
#pragma unroll
        for (int i2 = 0; i2 < kChunkKeys; ++i2) {
          const float p = ex2_ftz(fmaf(sc[i2], scale_log2, -m));  // 0 for a key past the row's last
          l += p;
          const float pb = __bfloat162float(__float2bfloat16(p));
          const float po = __shfl_xor_sync(0xffffffffu, pb, 1);  // the partner's key of this step
#pragma unroll
          for (int side = 0; side < 2; ++side) {
            const int j = ch * 2 * kChunkKeys + 2 * i2 + side;  // side == kh: this thread's key
            if (j < n) {
              const float pv = side == kh ? pb : po;
              const int vr = h + j * heads;
#pragma unroll
              for (int c = 0; c < 4; ++c) {
                const uint4 w = *reinterpret_cast<const uint4*>(vs + swz(vr, 4 * kh + c));
                acc[c][0] = fmaf(pv, lo_f(w.x), acc[c][0]);
                acc[c][1] = fmaf(pv, hi_f(w.x), acc[c][1]);
                acc[c][2] = fmaf(pv, lo_f(w.y), acc[c][2]);
                acc[c][3] = fmaf(pv, hi_f(w.y), acc[c][3]);
                acc[c][4] = fmaf(pv, lo_f(w.z), acc[c][4]);
                acc[c][5] = fmaf(pv, hi_f(w.z), acc[c][5]);
                acc[c][6] = fmaf(pv, lo_f(w.w), acc[c][6]);
                acc[c][7] = fmaf(pv, hi_f(w.w), acc[c][7]);
              }
            }
          }
        }
      }
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      if (row_ok) {
        bf16* orow = ow + static_cast<size_t>(row) * kD + 32 * kh;
        const float il = 1.f / l;  // one reciprocal a row: an IEEE division each took ~5 us of the call
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          uint4 w;
          w.x = pack_bf16(acc[c][0] * il, acc[c][1] * il);
          w.y = pack_bf16(acc[c][2] * il, acc[c][3] * il);
          w.z = pack_bf16(acc[c][4] * il, acc[c][5] * il);
          w.w = pack_bf16(acc[c][6] * il, acc[c][7] * il);
          *reinterpret_cast<uint4*>(orow + 8 * c) = w;
        }
      }
    }

    __syncthreads();  // every thread is done with stage s
    if (tid == 0 && i + stages < n_win) {
      fence_proxy_async();  // the stage's generic reads before the bulk copies overwrite it
      issue(i + stages);
    }
  }
}

}  // namespace

// q, kt, v, o: device pointers (bf16, contiguous, 16-byte aligned).
MERV_EXPORT int packed_temporal_bf16(const void* q, const void* kt, const void* v, void* o, int Bn, int R, int D,
                                     int heads, float scale, void* stream) {
  if (D != kD || R <= 0 || R > kMaxR || Bn <= 0 || heads <= 0) return static_cast<int>(cudaErrorInvalidValue);
  static int done[64] = {0};  // a local of a function that is not inline: one per library
  int sms = 0;
  cudaError_t e = device_setup(done, &sms, packed_temporal_kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  const Layout L = layout(R);
  CUtensorMap qmap, vmap;
  e = make_tile_map(&qmap, q, Bn, R, kD, kBoxRows);
  if (e == cudaSuccess) e = make_tile_map(&vmap, v, Bn, R, kD, kBoxRows);
  if (e != cudaSuccess) return static_cast<int>(e);
  int per_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, packed_temporal_kernel, kThreads, L.total);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int grid = std::min(Bn, std::max(per_sm, 1) * sms);
  packed_temporal_kernel<<<grid, kThreads, L.total, static_cast<cudaStream_t>(stream)>>>(
      qmap, vmap, static_cast<const bf16*>(kt), static_cast<bf16*>(o), Bn, R, heads, L, scale * kLog2e);
  return static_cast<int>(cudaGetLastError());
}
