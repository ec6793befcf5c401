// Hopper (sm_90a) machinery shared by the flash kernels (flash_fwd.cu,
// flash_bwd.cu) and the whole-sequence kernels (small_attn_hopper.cuh): TMA
// tensor maps, bulk-tensor and 1-D bulk loads completing on mbarriers, a ring
// position for full/empty barrier pairs, named barriers, the async-proxy
// fence, wgmma shared-memory descriptors for the 128-byte swizzle, the wgmma
// instructions the kernels use, setmaxnreg, ex2.approx.ftz, and the kernels'
// once-per-device host setup. The int8 product and the decode attention
// (int8_linear.cu, decode_attention.cu) also use the tail of this file:
// thread block clusters (launch, residency, barrier, distributed shared
// memory), the m16n8k16 mma.sync product, ldmatrix, and exact int8 -> bf16.
//
// Tiles. Every operand tile in shared memory is a stack of "slabs": 64 bf16
// columns (128 bytes) of `rows` rows, written by one TMA box {64, rows, 1}
// with CU_TENSOR_MAP_SWIZZLE_128B (16-byte chunk c of row r lands at chunk
// c ^ (r % 8)). A D = 128 row is two slabs. Slabs start on 1024-byte
// boundaries, so the swizzle atom (8 rows x 128 bytes) is aligned and every
// descriptor's base offset is 0.
//
// wgmma operands from such a slab (offsets in bytes; the descriptor stores
// them in 16-byte units):
//   K-major (the reduction dimension runs along the row: Q, K in S = Q K^T):
//     start = slab + row0 * 128 + k * 2 bytes (k a multiple of 16, < 64),
//     SBO = 1024 (next 8 rows), LBO unused (1).
//   MN-major (the reduction dimension runs down the rows: V in O += P V,
//   Q / dO / K as B of the backward's second products; wgmma's transpose bit):
//     start = slab + k * 128 bytes (k the first of 16 reduction rows),
//     SBO = 1024 (next 8 reduction rows), LBO = the slab's size (the next 64
//     output columns, i.e. the next slab).
//
// The tensor map encoder, cuTensorMapEncodeTiled, is looked up at run time
// with cudaGetDriverEntryPoint(ByVersion), so the library needs no -lcuda.
#pragma once

#include <cuda.h>  // CUtensorMap and its enums only: nothing here links against libcuda

#include <utility>

#include "common.cuh"

// ---------------------------------------------------------------------------
// Host: tensor maps
// ---------------------------------------------------------------------------

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*, const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

static cudaError_t encode_tiled_fn(EncodeTiledFn* fn) {
  static EncodeTiledFn cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorSymbolNotFound;
    cached = reinterpret_cast<EncodeTiledFn>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

// Tensor map over a contiguous tensor of `rank` (2 or 3) dimensions, innermost
// first: dims[i] elements, strides[i] the bytes between steps of dimension
// i + 1, box[i] elements a copy, no interleave, the given swizzle. Boxes that
// reach past the tensor read as 0.
static cudaError_t make_map(CUtensorMap* map, CUtensorMapDataType type, int rank, const void* base,
                            const cuuint64_t* dims, const cuuint64_t* strides, const cuuint32_t* box,
                            CUtensorMapSwizzle swizzle) {
  EncodeTiledFn encode;
  cudaError_t e = encode_tiled_fn(&encode);
  if (e != cudaSuccess) return e;
  const cuuint32_t elem[3] = {1, 1, 1};
  const CUresult r = encode(map, type, rank, const_cast<void*>(base), dims, strides, box, elem,
                            CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? cudaSuccess : cudaErrorInvalidValue;
}

// Tensor map over a contiguous bf16 [BH, T, D] tensor as the 3-D box grid
// (D, T, BH), box {64, rows, 1}, 128-byte swizzle. Rows past T read as 0
// (the hardware's out-of-bounds fill), so ragged edges need no copy.
static cudaError_t make_tile_map(CUtensorMap* map, const void* base, int BH, int T, int D, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(T) * D * 2};
  const cuuint32_t box[3] = {64, static_cast<cuuint32_t>(rows), 1};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// Tensor map over the same [BH, T, D] tensor for the columns past 64 (D <= 80):
// box {16, rows, 1}, 32-byte swizzle, loaded at column 64, so a box row is 32
// bytes and the columns past D read as 0. This is the 32-byte-wide slab of the
// head dims 64..79 (the k step that follows the first 64 columns).
static cudaError_t make_tail_map(CUtensorMap* map, const void* base, int BH, int T, int D, int rows) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(D), static_cast<cuuint64_t>(T), static_cast<cuuint64_t>(BH)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(D) * 2, static_cast<cuuint64_t>(T) * D * 2};
  const cuuint32_t box[3] = {16, static_cast<cuuint32_t>(rows), 1};
  return make_map(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, base, dims, strides, box, CU_TENSOR_MAP_SWIZZLE_32B);
}

// ---------------------------------------------------------------------------
// Host: once-per-device setup
// ---------------------------------------------------------------------------

constexpr int kSmemLimit = 232448;  // dynamic shared memory a block may use on sm_90

// Raises each kernel's dynamic shared memory limit to kSmemLimit once per
// device (outside any graph capture's first launch) and gives the device's SM
// count. `done` is the caller's record of the devices set up (their SM
// counts, 0 until then). It must have internal linkage: a function-local
// static of a template or an inline function is one symbol for every library
// of the process, so a second copy of a library would take the first one's
// record for its own and launch with its kernels' limit unset.
template <typename... Kernels>
static cudaError_t device_setup(int (&done)[64], int* sms, Kernels*... kernels) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (dev < 0 || dev >= 64) return cudaErrorInvalidDevice;
  if (done[dev] == 0) {
    ((e = e == cudaSuccess ? cudaFuncSetAttribute(kernels, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmemLimit)
                           : e),
     ...);
    if (e == cudaSuccess) e = cudaDeviceGetAttribute(&done[dev], cudaDevAttrMultiProcessorCount, dev);
    if (e != cudaSuccess) {
      done[dev] = 0;
      return e;
    }
  }
  *sms = done[dev];
  return cudaSuccess;
}

// ---------------------------------------------------------------------------
// Device: shared memory, mbarriers, TMA
// ---------------------------------------------------------------------------

constexpr float kLog2e = 1.4426950408889634f;

// 2^x on the MUFU with denormal results flushed to 0. exp2f's denormal-safe
// form took ~3x K1's whole time; a p below 2^-126 changes neither l nor any
// product at bf16 precision.
__device__ __forceinline__ float ex2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float pos_inf() { return __int_as_float(0x7f800000); }

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// The dynamic shared memory rounded up to the next 1024-byte boundary (the
// launch asks for 1024 bytes more than the layout needs).
__device__ __forceinline__ unsigned char* align_1024(unsigned char* p) {
  return p + ((1024u - (smem_u32(p) & 1023u)) & 1023u);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_fence_init() { asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory"); }

// Arrive, and expect `bytes` more to land on this phase (the TMA loads it guards).
__device__ __forceinline__ void mbar_arrive_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Expect `bytes` more on this phase without arriving.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, uint32_t bytes) {
  asm volatile("mbarrier.expect_tx.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Wait until the phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

// mbar_wait that stops the kernel with an error (a trap, which the launch's
// caller sees) if the phase has not completed after `seconds`: a copy that
// never lands fails the call instead of hanging the device.
__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ void mbar_wait_or_trap(uint64_t* bar, uint32_t parity, uint64_t seconds = 4) {
  const uint32_t addr = smem_u32(bar);
  const uint64_t t0 = global_ns();
  uint32_t done;
  while (true) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\nselp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
    if (global_ns() - t0 > seconds * 1000000000ull) __trap();
  }
}

// One TMA box of `map` at coordinates (c0, c1, c2) into shared memory `dst`,
// counted on `bar`'s transaction bytes.
__device__ __forceinline__ void tma_load_3d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// One TMA box of a 2-D `map` at coordinates (c0, c1).
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], "
      "[%2];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(bar)), "r"(c0), "r"(c1)
      : "memory");
}

// One 1-D bulk copy of `bytes` (a multiple of 16; both addresses 16-byte
// aligned) from global to shared memory `dst`, counted on `bar`'s transaction
// bytes: for a block too irregular for a tensor map (a row stride that is not a
// multiple of 16 bytes).
__device__ __forceinline__ void bulk_load(void* dst, const void* src, uint32_t bytes, uint64_t* bar) {
  asm volatile("cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n" ::"r"(
                   smem_u32(dst)),
               "l"(reinterpret_cast<uint64_t>(src)), "r"(bytes), "r"(smem_u32(bar))
               : "memory");
}

// Order this thread's generic-proxy accesses to shared memory before later
// async-proxy ones (wgmma operand reads, TMA and bulk writes).
__device__ __forceinline__ void fence_proxy_async() { asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory"); }

// Barrier over `count` threads (a multiple of 32) on hardware barrier `id`
// (0 is __syncthreads'): wait for all of them, or only arrive.
__device__ __forceinline__ void named_barrier_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void named_barrier_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Stage and phase of a ring of `stages` full/empty barrier pairs. A consumer
// waits `full` at `phase`; a producer waits `empty` at `phase ^ 1`, which
// passes at once on the first round (the stages start empty).
struct RingPos {
  int stage = 0;
  uint32_t phase = 0;
  __device__ __forceinline__ void next(int stages) {
    if (++stage == stages) {
      stage = 0;
      phase ^= 1u;
    }
  }
};

template <uint32_t R>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(R));
}

template <uint32_t R>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(R));
}

// ---------------------------------------------------------------------------
// Device: wgmma
// ---------------------------------------------------------------------------

// Shared-memory matrix descriptor, 128-byte swizzle (layout type 1 in bits 62-63).
__device__ __forceinline__ uint64_t sw128_desc(const void* smem, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  return static_cast<uint64_t>((smem_u32(smem) & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFFu) << 32) | (1ull << 62);
}

// Shared-memory matrix descriptor, 32-byte swizzle (layout type 3): the
// 32-byte-wide slabs of make_tail_map (16-byte chunk c of row r at chunk
// c ^ ((r / 4) % 2)), 8 rows = 256 bytes a swizzle atom.
//   K-major: start = slab + row0 * 32 bytes (16 reduction columns, one k step), SBO = 256.
//   MN-major: start = slab + k * 32 bytes (k the first of 16 reduction rows; 16 output
//   columns), SBO = 256, LBO the next 16 output columns (unused at N = 16).
__device__ __forceinline__ uint64_t sw32_desc(const void* smem, uint32_t lbo_bytes, uint32_t sbo_bytes) {
  return static_cast<uint64_t>((smem_u32(smem) & 0x3FFFFu) >> 4) |
         (static_cast<uint64_t>((lbo_bytes >> 4) & 0x3FFFu) << 16) |
         (static_cast<uint64_t>((sbo_bytes >> 4) & 0x3FFFu) << 32) | (3ull << 62);
}

// K-major operand: rows [row0, row0 + 64 or N) and reduction columns [k, k + 16) of a slab.
__device__ __forceinline__ uint64_t kmajor_desc(const bf16* slab, int row0, int k) {
  return sw128_desc(slab + row0 * 64 + k, 16, 1024);
}

// MN-major operand: reduction rows [k, k + 16) of a stack of slabs `slab_bytes` apart.
__device__ __forceinline__ uint64_t mnmajor_desc(const bf16* slab, int k, uint32_t slab_bytes) {
  return sw128_desc(slab + k * 64, slab_bytes, 1024);
}

__device__ __forceinline__ void wgmma_fence() { asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory"); }
__device__ __forceinline__ void wgmma_commit() { asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory"); }
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers that an in-flight wgmma reads or writes: the compiler may not
// move them across this point (call after wgmma_fence and after wgmma_wait).
template <int R>
__device__ __forceinline__ void pin(float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+f"(d[i])::"memory");
}
__device__ __forceinline__ void pin(uint32_t (&a)[4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[j])::"memory");
}
template <int R>
__device__ __forceinline__ void pin(uint32_t (&a)[R][4]) {
#pragma unroll
  for (int i = 0; i < R; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(a[i][j])::"memory");
}

// Accumulator layout of wgmma m64nNk16 (f32), per thread (w = warp in the
// warpgroup, g = lane / 4, t = lane % 4): d[4n + 2i + j] holds row
// 16w + g + 8i, column 8n + 2t + j. The A register fragment of a 16-column
// chunk kk is the mma.sync m16n8k16 A fragment of the warp's 16 rows, so the
// accumulator of one product converts to the A operand of the next:
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float* d) {
  a[0] = pack_bf16(d[0], d[1]);
  a[1] = pack_bf16(d[2], d[3]);
  a[2] = pack_bf16(d[4], d[5]);
  a[3] = pack_bf16(d[6], d[7]);
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A and B from shared memory, A K-major,
// B K-major (TB = 0) or MN-major (TB = 1, wgmma's transpose bit).
template <int TB>
__device__ __forceinline__ void wgmma_ss_n64_b(float (&d)[32], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate), "n"(TB));
}

// D[64 x 16] (+)= A[64 x 16] B[16 x 16]: A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, %8, %9, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A and B from shared memory, both K-major.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da, uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// D[64 x 64] (+)= A[64 x 16] B[16 x 64]: A from registers (the m16n8k16 A fragment of each
// warp's 16 rows), B from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n64_tb(float (&d)[32], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 16] (+)= A[64 x 16] B[16 x 16]: A from registers (the m16n8k16 A fragment of each
// warp's 16 rows), B from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n16_tb(float (&d)[8], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}

// D[64 x 128] (+)= A[64 x 16] B[16 x 128]: A from registers (the m16n8k16 A fragment of each
// warp's 16 rows), B from shared memory, MN-major (transposed).
__device__ __forceinline__ void wgmma_rs_n128_tb(float (&d)[64], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(accumulate));
}


template <int N>
__device__ __forceinline__ void wgmma_rs_tb(float (&d)[N / 2], const uint32_t (&a)[4], uint64_t db, int accumulate) {
  if constexpr (N == 64) {
    wgmma_rs_n64_tb(d, a, db, accumulate);
  } else {
    wgmma_rs_n128_tb(d, a, db, accumulate);
  }
}

// ---------------------------------------------------------------------------
// Thread block clusters
// ---------------------------------------------------------------------------

// Launch `kernel` with clusters of `cluster` blocks along x (gridDim.x a multiple of it).
// `early`: programmatic dependent launch: the kernel may start once the kernel
// before it on the stream has signalled (griddep_launch_dependents) in every
// block, and must call griddep_wait before it touches what that kernel writes.
template <typename... Params, typename... Args>
static cudaError_t launch_clustered(void (*kernel)(Params...), dim3 grid, int threads, size_t smem, int cluster,
                                   cudaStream_t stream, bool early, Args&&... args) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = grid;
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = early ? 2 : 1;
  return cudaLaunchKernelEx(&cfg, kernel, std::forward<Args>(args)...);
}

// Programmatic dependent launch: wait until the kernels this one may overlap
// have finished and their writes are visible (returns at once if none), and
// let the next kernel on the stream, if launched `early`, start.
__device__ __forceinline__ void griddep_wait() { asm volatile("griddepcontrol.wait;\n" ::: "memory"); }
__device__ __forceinline__ void griddep_launch_dependents() {
  asm volatile("griddepcontrol.launch_dependents;\n" ::: "memory");
}

// How many clusters of 1 .. `n` blocks of `kernel` the card holds at once (its
// real residency: shared memory, registers, and the SMs of a GPC that one
// cluster must share): out[c - 1] for a cluster of c.
template <typename Kernel>
static cudaError_t cluster_residency(Kernel* kernel, int threads, size_t smem, int n, int* out) {
  for (int c = 1; c <= n; ++c) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(c, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = c;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    const cudaError_t e = cudaOccupancyMaxActiveClusters(&out[c - 1], kernel, &cfg);
    if (e != cudaSuccess) return e;
  }
  return cudaSuccess;
}

// Every thread of every block of the cluster arrives; then waits for all. The
// release / acquire pair makes each block's shared-memory writes before it
// visible to the others' reads after it.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive.release.aligned;\nbarrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

// The address in the shared memory of cluster block `rank` that `p` has in this block's.
__device__ __forceinline__ uint32_t cluster_addr(const void* p, int rank) {
  uint32_t r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(smem_u32(p)), "r"(rank));
  return r;
}

__device__ __forceinline__ float ld_cluster(uint32_t addr) {
  float v;
  asm volatile("ld.shared::cluster.f32 %0, [%1];\n" : "=f"(v) : "r"(addr) : "memory");
  return v;
}

__device__ __forceinline__ float2 ld_cluster2(uint32_t addr) {
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n" : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// ---------------------------------------------------------------------------
// mma.sync, ldmatrix, int8 -> bf16
// ---------------------------------------------------------------------------

// d (+)= a b: m16n8k16, bf16 in, fp32 sum; fragments as common.cuh's layout.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, "
      "{%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices, transposed: lane i names row i % 8 of matrix i / 8;
// r[j] is matrix j's B fragment (rows 2t, 2t+1 of column g).
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(row))
               : "memory");
}

__device__ __forceinline__ uint4 lds128(const void* p) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(smem_u32(p)));
  return v;
}

__device__ __forceinline__ void sts128(void* p, uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(smem_u32(p)), "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

// Byte i of a word whose bytes were flipped by ^ 0x80808080 (a signed int8
// made unsigned), as an exact float: 2^23 + (byte ^ 0x80) - (2^23 + 128).
__device__ __forceinline__ float i8_to_float(uint32_t w_biased, int i) {
  return __uint_as_float(__byte_perm(w_biased, 0x4B000000u, 0x7540u + i)) - 8388736.0f;
}

// Bytes (lo, lo + 1) of an int8 word as a bf16 pair (exact: |q| <= 128).
__device__ __forceinline__ uint32_t i8_pair(uint32_t w, int lo) {
  const uint32_t u = w ^ 0x80808080u;
  return pack_bf16(i8_to_float(u, lo), i8_to_float(u, lo + 1));
}

// Bytes (lo, lo + 1) of an int8 word times `scale`, each rounded once to bf16.
__device__ __forceinline__ uint32_t i8_pair_scaled(uint32_t w, int lo, float scale) {
  const uint32_t u = w ^ 0x80808080u;
  return pack_bf16(i8_to_float(u, lo) * scale, i8_to_float(u, lo + 1) * scale);
}
