// Device code shared by the port's CUDA kernels: block and thread-group
// reductions, bf16 rounding and loads, and the launch helper for dynamic
// shared memory.
//
// Thread groups.  group_sync and group_sum run on a group of NT threads (a
// whole block, or a warp-aligned part of one): `tid` is the thread's index
// in the group and `bar` its barrier, 0 for __syncthreads (the whole block)
// or a named barrier 1..15 of NT threads; block_sum is the whole-block form
// (tid = threadIdx.x, bar 0).  CG = true reads a global input with
// ld.global.cg (L2, not L1): for data that other blocks of a persistent
// kernel wrote during the same launch.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace qtts {

constexpr int MAX_G = 8;          // query heads per kv head
constexpr float NEG = -1e30f;

__device__ __forceinline__ float bf16r(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

__device__ __forceinline__ float bf2f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <int NT>
__device__ __forceinline__ void group_sync(int bar) {
  if (bar == 0)
    __syncthreads();
  else
    asm volatile("bar.sync %0, %1;" ::"r"(bar), "r"(NT) : "memory");
}

template <bool CG>
__device__ __forceinline__ float ld_bf(const __nv_bfloat16* p) {
  if (CG)
    return __bfloat162float(__ushort_as_bfloat16(
        __ldcg(reinterpret_cast<const unsigned short*>(p))));
  return __bfloat162float(*p);
}

template <bool CG>
__device__ __forceinline__ uint4 ld_16(const void* p) {
  if (CG) return __ldcg(reinterpret_cast<const uint4*>(p));
  return *reinterpret_cast<const uint4*>(p);
}

// Sum / max over a group of NT threads (NT a multiple of 32); every thread
// gets the result.  `red` holds NT / 32 floats.  The order of the sum is
// fixed (warp butterfly, then warps in order), so every thread and every
// run agree.
template <int NT>
__device__ __forceinline__ float group_sum(float v, float* red, int tid,
                                           int bar) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  group_sync<NT>(bar);  // red may still be read by a previous call
  if ((tid & 31) == 0) red[tid >> 5] = v;
  group_sync<NT>(bar);
  float s = red[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) s += red[w];
  return s;
}

// Sum over a warp by the xor butterfly (16, 8, 4, 2, 1): every lane gets
// the same sum, in this order.
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int NT>
__device__ __forceinline__ float block_sum(float v, float* red) {
  return group_sum<NT>(v, red, threadIdx.x, 0);
}

template <int NT>
__device__ __forceinline__ float block_max(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) s = fmaxf(s, red[w]);
  return s;
}

// Launch helper: raise the kernel's dynamic shared memory limit once when
// a launch needs more than the default 48 KB.
template <typename K>
inline cudaError_t allow_smem(K kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace qtts
