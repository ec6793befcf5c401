// decode_attention (K5): attention of a few query rows over the KV cache, as
// decoding, speculative verification and short cached prefills ask for it.
//   q     bf16 [B, H, Tq, D], 1 <= Tq <= 16, D in {64, 128}, H a multiple of Hk
//   k, v  the cache [B, Hk, Tk, D]: bf16, or int8 with fp32 scales
//         k_scale / v_scale [B, Hk, Tk, 1] (one per (batch, kv head, position))
//   mask  bool [B, Tk] (valid keys) or none
//   causal: query t of row b sees key j iff j <= t + offset (offset a host int,
//         or offs[b] read on the device)
//   o     bf16 [B, H, Tq, D]
// The function is merv_tpu's T = 1 / verify attention over its cache
// (merv_tpu/models/backbones/llm/transformer.py:396-405 dequantizes, then
// ops/attention.py::attention_reference): an int8 key or value is dequantized
// as bf16(float(q8) * scale), one rounding; scores are exact fp32 sums of the
// bf16 products; masked keys get no weight; a row with no valid key gets what
// the reference's uniform softmax gives, the mean of V over the whole buffer
// (weights bf16(1/Tk)). p is rounded to bf16 before P.V; the division by the
// row sum comes after, as in the flash kernels.
//
// Replaces no Pallas kernel: merv_tpu leaves this attention to XLA, which
// fuses the dequantization into its read of the cache. The port's plain form
// (ops/decode_attention.py::decode_attention_plain) copies the layer's cache
// to the compute dtype and then to fp32 before two matmuls.
//
// Bound on the H100: bytes. Each valid cache row's K and V (and scales) are
// read once against 4 * H/Hk * Tq * D operations a row.
//
// Design (flash-decoding): a block owns one (batch, kv head, group of <= 16
// query rows: the kv head's H/Hk heads x Tq) and one split of a few 32-key
// tiles, so that B = 1 with 32 kv heads fills the card and no block walks far
// (the host picks ~16 blocks an SM: a long slot's keys spread over many
// blocks). A block first marks which of its tiles hold any valid key (key
// mask, causal bound); one with none writes an empty partial and stops. It
// loads the live tiles' K and V by 16-byte cp.async into two shared-memory
// stages (the next tile's copy runs under the current tile's arithmetic).
// Scores: a lane takes one key and a warp a quarter of D, for every query
// row, so all four warps work even at Tq = 1 (an int8 key is dequantized by
// exactly one thread); the partials meet in shared memory. Softmax: a warp
// per row, the online max and sum across its lanes, p rounded to bf16. P.V: a
// thread per output column over the tile's keys. A split writes (max, sum,
// unnormalised output) in fp32; a second kernel combines the splits.
#include "hopper.cuh"

namespace {

constexpr int kThreads = 128;
constexpr int kTile = 32;      // keys per tile: one per lane
constexpr int kRowsMax = 16;   // query rows per block
constexpr int kMaxTiles = 128; // tiles per split (the live-tile flags)

struct Args {
  const bf16* q;
  const void* k;
  const void* v;
  const float* ks;
  const float* vs;
  const unsigned char* mask;
  const long long* offs;
  float* part_o;   // [splits, B*H*Tq, D]
  float* part_ml;  // [splits, B*H*Tq, 2]: running max (log2 domain), sum of p
  bf16* o;
  int B, H, Hk, Tq, Tk, causal, offset, splits, tiles_per_split;
  float scale_log2;
};

template <int D, bool kInt8>
struct Smem {
  static constexpr int kElem = kInt8 ? 1 : 2;
  static constexpr int kRow = D * kElem;         // bytes of one cached row
  static constexpr int kKStride = kRow + 16;     // K rows padded: the lanes' 16-byte reads of 32 rows are conflict-free
  alignas(16) unsigned char k[2][kTile * kKStride];
  alignas(16) unsigned char v[2][kTile * kRow];
  alignas(16) float ks[2][kTile];
  alignas(16) float vs[2][kTile];
  alignas(16) bf16 q[kRowsMax][D];               // q is bf16: kept as it is
  alignas(16) float part[4][kRowsMax][kTile];    // each warp's partial scores (a quarter of D); part[0] then holds p
  float alpha[kRowsMax];
  unsigned char live[kMaxTiles];
};

__device__ __forceinline__ void cp_async16(void* dst, const void* src, bool in) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(in ? 16 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src, bool in) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(smem_u32(dst)), "l"(src), "r"(in ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

__device__ __forceinline__ float round_bf16(float x) { return __bfloat162float(__float2bfloat16(x)); }

// 16 bytes of a cached row (8 bf16, or 16 int8 times the row's scale) as floats
template <bool kInt8>
__device__ __forceinline__ void row_chunk(const unsigned char* p, float scale, float* out) {
  const int4 raw = *reinterpret_cast<const int4*>(p);
  if constexpr (kInt8) {
    const signed char* b = reinterpret_cast<const signed char*>(&raw);
#pragma unroll
    for (int i = 0; i < 16; ++i) out[i] = round_bf16(static_cast<float>(b[i]) * scale);
  } else {
    const bf16* h = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[i] = __bfloat162float(h[i]);
  }
}

template <bool kInt8>
__device__ __forceinline__ float cached(const void* base, const float* scales, size_t row, int D, int col) {
  if constexpr (kInt8) {
    return round_bf16(static_cast<float>(static_cast<const signed char*>(base)[row * D + col]) * scales[row]);
  } else {
    return __bfloat162float(static_cast<const bf16*>(base)[row * D + col]);
  }
}

template <int D, bool kInt8>
__global__ void __launch_bounds__(kThreads) decode_attention_kernel(Args a) {
  using S = Smem<D, kInt8>;
  __shared__ S sm;
  constexpr int kPer = 16 / S::kElem;          // cached elements per 16-byte chunk
  constexpr int kQuarter = D / 4;              // the dims of D a warp's partial score covers
  constexpr int kChunks = kQuarter * S::kElem / 16;  // 16-byte chunks of a row's quarter
  constexpr int kRowChunks = S::kRow / 16;     // 16-byte chunks of a whole row
  constexpr int kRowSets = kThreads / D;       // D = 64: two sets of rows share a column
  constexpr int kRowsPer = kRowsMax / kRowSets;

  const int split = blockIdx.x, hk = blockIdx.y % a.Hk, rg = blockIdx.y / a.Hk, b = blockIdx.z;
  const int G = a.H / a.Hk, rows_all = G * a.Tq;
  const int r0 = rg * kRowsMax, R = min(kRowsMax, rows_all - r0);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const long long off = a.causal ? (a.offs != nullptr ? a.offs[b] : static_cast<long long>(a.offset)) : 0;
  const long long last_key = a.causal ? min(static_cast<long long>(a.Tk) - 1, off + a.Tq - 1) : a.Tk - 1;
  const int n_tiles = (a.Tk + kTile - 1) / kTile;
  const int t_begin = split * a.tiles_per_split, t_end = min(n_tiles, t_begin + a.tiles_per_split);
  const size_t kv_row0 = static_cast<size_t>(b * a.Hk + hk) * a.Tk;  // row (b, hk, key 0) of the cache
  const size_t q_row0 = static_cast<size_t>(b * a.H + hk * G) * a.Tq + r0;  // the block's first query row
  const size_t bht = static_cast<size_t>(a.B) * a.H * a.Tq;

  // which tiles hold a valid key; a split with none writes (max -inf, sum 0) and stops
  for (int i = tid; i < kMaxTiles; i += kThreads) sm.live[i] = 0;
  __syncthreads();
  int any = 0;
  for (int j = t_begin * kTile + tid; j < t_end * kTile; j += kThreads) {
    if (j < a.Tk && j <= last_key && (a.mask == nullptr || a.mask[static_cast<size_t>(b) * a.Tk + j])) {
      sm.live[j / kTile - t_begin] = 1;
      any = 1;
    }
  }
  if (!__syncthreads_or(any)) {
    for (int r = tid; r < R; r += kThreads) {
      a.part_ml[(split * bht + q_row0 + r) * 2] = neg_inf();
      a.part_ml[(split * bht + q_row0 + r) * 2 + 1] = 0.f;
    }
    return;
  }
  for (int i = tid; i < R * D / 8; i += kThreads) {  // only the block's rows: the rest are never read
    const int r = i / (D / 8), c = i % (D / 8);
    *reinterpret_cast<int4*>(&sm.q[r][c * 8]) = *reinterpret_cast<const int4*>(a.q + (q_row0 + r) * D + c * 8);
  }
  auto next_live = [&](int i) {
    while (i < t_end && !sm.live[i - t_begin]) ++i;
    return i;
  };
  auto load_tile = [&](int i, int st) {
    const int key0 = i * kTile;
    for (int c = tid; c < kTile * kRowChunks; c += kThreads) {
      const int j = c / kRowChunks, ch = c % kRowChunks;
      const bool in = key0 + j < a.Tk;
      const size_t row = kv_row0 + (in ? key0 + j : 0);
      cp_async16(&sm.k[st][j * S::kKStride + ch * 16], static_cast<const unsigned char*>(a.k) + row * S::kRow + ch * 16,
                 in);
      cp_async16(&sm.v[st][j * S::kRow + ch * 16], static_cast<const unsigned char*>(a.v) + row * S::kRow + ch * 16,
                 in);
    }
    if constexpr (kInt8) {
      if (tid < kTile) {
        const bool in = key0 + tid < a.Tk;
        const size_t row = kv_row0 + (in ? key0 + tid : 0);
        cp_async4(&sm.ks[st][tid], a.ks + row, in);
        cp_async4(&sm.vs[st][tid], a.vs + row, in);
      }
    }
    cp_async_commit();
  };

  // softmax state of the warp's rows (warp, warp + 4, ...), in the log2 domain
  float m_run[kRowsMax / 4], l_run[kRowsMax / 4];
#pragma unroll
  for (int i = 0; i < kRowsMax / 4; ++i) m_run[i] = neg_inf(), l_run[i] = 0.f;
  // the thread's output column and rows (P.V)
  const int col = tid % D, rset = tid / D;
  float acc[kRowsPer];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) acc[i] = 0.f;

  int cur = next_live(t_begin), st = 0;
  load_tile(cur, 0);
  while (cur < t_end) {
    const int nxt = next_live(cur + 1);
    if (nxt < t_end) {
      load_tile(nxt, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // partial scores: lane = key, warp = a quarter of D, every row
    {
      float s[kRowsMax];
#pragma unroll
      for (int r = 0; r < kRowsMax; ++r) s[r] = 0.f;
      const unsigned char* krow = &sm.k[st][lane * S::kKStride + warp * kQuarter * S::kElem];
      const float kscale = kInt8 ? sm.ks[st][lane] : 1.f;
#pragma unroll
      for (int ch = 0; ch < kChunks; ++ch) {
        float kf[kPer];
        row_chunk<kInt8>(krow + ch * 16, kscale, kf);
#pragma unroll
        for (int r = 0; r < kRowsMax; ++r) {
          if (r < R) {
            const bf16* qr = &sm.q[r][warp * kQuarter + ch * kPer];
#pragma unroll
            for (int e = 0; e < kPer; e += 8) {
              const int4 raw = *reinterpret_cast<const int4*>(qr + e);
              const bf16* qh = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
              for (int u = 0; u < 8; ++u) s[r] += __bfloat162float(qh[u]) * kf[e + u];
            }
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRowsMax; ++r)
        if (r < R) sm.part[warp][r][lane] = s[r];
    }
    __syncthreads();

    // online softmax: warp = every fourth row, lane = key
    const int key = cur * kTile + lane;
    const bool key_ok = key < a.Tk && key <= last_key &&
                        (a.mask == nullptr || a.mask[static_cast<size_t>(b) * a.Tk + key]);
#pragma unroll
    for (int i = 0; i < kRowsMax / 4; ++i) {
      const int r = warp + 4 * i;
      if (r >= R) break;
      const int tq = (r0 + r) % a.Tq;
      const bool ok = key_ok && (!a.causal || key <= off + tq);
      const float sv =
          (sm.part[0][r][lane] + sm.part[1][r][lane] + sm.part[2][r][lane] + sm.part[3][r][lane]) * a.scale_log2;
      const float m_new = fmaxf(m_run[i], warp_max(ok ? sv : neg_inf()));
      const float p = ok ? ex2_ftz(sv - m_new) : 0.f;
      const float alpha = m_run[i] == m_new ? 1.f : ex2_ftz(m_run[i] - m_new);
      l_run[i] = l_run[i] * alpha + warp_sum(p);
      m_run[i] = m_new;
      sm.part[0][r][lane] = round_bf16(p);  // each lane read its own partials first
      if (lane == 0) sm.alpha[r] = alpha;
    }
    __syncthreads();

    // P.V: the thread's column, its rows
    float vcol[kTile];
#pragma unroll
    for (int j = 0; j < kTile; ++j) {
      if constexpr (kInt8) {
        vcol[j] = round_bf16(static_cast<float>(reinterpret_cast<const signed char*>(sm.v[st])[j * D + col]) *
                             sm.vs[st][j]);
      } else {
        vcol[j] = __bfloat162float(reinterpret_cast<const bf16*>(sm.v[st])[j * D + col]);
      }
    }
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int r = rset + kRowSets * i;
      if (r >= R) break;
      float o = acc[i] * sm.alpha[r];
      const float4* pr = reinterpret_cast<const float4*>(sm.part[0][r]);
#pragma unroll
      for (int j = 0; j < kTile / 4; ++j) {
        const float4 p4 = pr[j];
        o += p4.x * vcol[4 * j] + p4.y * vcol[4 * j + 1] + p4.z * vcol[4 * j + 2] + p4.w * vcol[4 * j + 3];
      }
      acc[i] = o;
    }
    __syncthreads();
    cur = nxt;
    st ^= 1;
  }

#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int r = rset + kRowSets * i;
    if (r >= R) break;
    a.part_o[(split * bht + q_row0 + r) * D + col] = acc[i];
  }
  if (lane == 0) {
#pragma unroll
    for (int i = 0; i < kRowsMax / 4; ++i) {
      const int r = warp + 4 * i;
      if (r >= R) break;
      a.part_ml[(split * bht + q_row0 + r) * 2] = m_run[i];
      a.part_ml[(split * bht + q_row0 + r) * 2 + 1] = l_run[i];
    }
  }
}

// one block per query row, one thread per column: the splits' partial outputs
// rescaled to their common max and divided by the total sum; a row with no
// valid key takes the mean of V over the whole buffer
template <int D, bool kInt8>
__global__ void __launch_bounds__(D) combine_kernel(Args a) {
  const size_t row = blockIdx.x, bht = static_cast<size_t>(a.B) * a.H * a.Tq;
  const int col = threadIdx.x;
  float m = neg_inf();
  for (int s = 0; s < a.splits; ++s) m = fmaxf(m, a.part_ml[(s * bht + row) * 2]);
  float out;
  if (m == neg_inf()) {
    const int b = static_cast<int>(row / (static_cast<size_t>(a.H) * a.Tq));
    const int h = static_cast<int>(row / a.Tq % a.H);
    const size_t row0 = static_cast<size_t>(b * a.Hk + h / (a.H / a.Hk)) * a.Tk;
    float sum = 0.f;
    for (int j = 0; j < a.Tk; ++j) sum += cached<kInt8>(a.v, a.vs, row0 + j, D, col);
    out = sum * round_bf16(1.f / static_cast<float>(a.Tk));
  } else {
    float l = 0.f, o = 0.f;
    for (int s = 0; s < a.splits; ++s) {
      const float ms = a.part_ml[(s * bht + row) * 2];
      if (ms == neg_inf()) continue;
      const float w = ex2_ftz(ms - m);
      l += w * a.part_ml[(s * bht + row) * 2 + 1];
      o += w * a.part_o[(s * bht + row) * D + col];
    }
    out = o / l;
  }
  a.o[row * D + col] = __float2bfloat16(out);
}

template <int D, bool kInt8>
cudaError_t launch(const Args& a, cudaStream_t stream) {
  const int rows_all = a.H / a.Hk * a.Tq, groups = (rows_all + kRowsMax - 1) / kRowsMax;
  decode_attention_kernel<D, kInt8><<<dim3(a.splits, a.Hk * groups, a.B), kThreads, 0, stream>>>(a);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  combine_kernel<D, kInt8><<<a.B * a.H * a.Tq, D, 0, stream>>>(a);
  return cudaGetLastError();
}

}  // namespace

// q, k, v, o: device pointers as above; k_scale / v_scale: fp32 scales (int8 != 0) or null; mask: bool [B, Tk]
// or null; offs: int64 [B] causal offsets or null (then `offset`); part_o / part_ml: fp32 scratch of
// splits * B*H*Tq * D and splits * B*H*Tq * 2 floats. `splits` * `tiles_per_split` * 32 must cover Tk.
MERV_EXPORT int decode_attention_bf16(const void* q, const void* k, const void* v, const void* k_scale,
                                      const void* v_scale, const void* mask, const void* offs, void* part_o,
                                      void* part_ml, void* o, int B, int H, int Hk, int Tq, int Tk, int D, int int8,
                                      int causal, int offset, int splits, int tiles_per_split, float scale,
                                      void* stream) {
  if (B < 1 || Hk < 1 || H % Hk || Tq < 1 || Tq > 16 || Tk < 1 || (D != 64 && D != 128) || splits < 1 ||
      tiles_per_split < 1 || tiles_per_split > kMaxTiles ||
      static_cast<long long>(splits) * tiles_per_split * kTile < Tk || (int8 && (k_scale == nullptr || v_scale == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{static_cast<const bf16*>(q), k, v, static_cast<const float*>(k_scale), static_cast<const float*>(v_scale),
         static_cast<const unsigned char*>(mask), static_cast<const long long*>(offs), static_cast<float*>(part_o),
         static_cast<float*>(part_ml), static_cast<bf16*>(o), B, H, Hk, Tq, Tk, causal, offset, splits,
         tiles_per_split, scale * kLog2e};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (D == 128)
    e = int8 ? launch<128, true>(a, s) : launch<128, false>(a, s);
  else
    e = int8 ? launch<64, true>(a, s) : launch<64, false>(a, s);
  return static_cast<int>(e);
}
