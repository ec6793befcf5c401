// Shared helpers for the port's hand-written sm_90a kernels: bf16x2
// packing, quad reductions over the four threads that share an accumulator
// row, and the exported error-string hook the ctypes wrappers use.
//
// Fragment layout of the m16n8k16 tensor-core product, which wgmma's register
// A operand and each warp's share of its accumulator follow (hopper.cuh's
// acc_to_a; per lane: g = lane / 4, t = lane % 4):
//   A (16x16, row-major): a[0] = (row g,   cols 2t, 2t+1)   a[1] = (row g+8, cols 2t, 2t+1)
//                         a[2] = (row g,   cols 2t+8, 2t+9) a[3] = (row g+8, cols 2t+8, 2t+9)
//   B (16x8, "col"):      b0 = (rows 2t, 2t+1, col g)      b1 = (rows 2t+8, 2t+9, col g)
//   C/D (16x8, fp32):     d[0], d[1] = (row g, cols 2t, 2t+1); d[2], d[3] = (row g+8, same cols)
// The lower column index sits in the lower 16 bits of each packed register.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

#define MERV_EXPORT extern "C" __attribute__((visibility("default")))

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return x;
}

__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x;
}

__device__ __forceinline__ float neg_inf() { return __int_as_float(0xff800000); }

MERV_EXPORT const char* merv_cuda_error_string(int e) { return cudaGetErrorString(static_cast<cudaError_t>(e)); }
