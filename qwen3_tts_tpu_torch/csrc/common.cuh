// Device code shared by the port's CUDA kernels: the decode-attention tile
// loop (flash_decode.cu, talker_step.cu, predictor_frame.cu), block
// reductions, bf16 rounding, and the launch helper for dynamic shared memory.
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

// Sum / max over a block of NT threads (NT a multiple of 32); every thread
// gets the result.  `red` holds NT / 32 floats.  The order of the sum is
// fixed (warp butterfly, then warps in order), so every thread and every
// run agree.
template <int NT>
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  __syncthreads();  // red may still be read by a previous call
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float s = red[0];
#pragma unroll
  for (int w = 1; w < NT / 32; ++w) s += red[w];
  return s;
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

// Online-softmax attention of G query heads (q_s[g][*], f32 in shared
// memory) against slots [0, end) of one (lane, kv-head) cache row block
// kp / vp ([C, DH] bf16), for a block of DH threads; thread t owns output
// column t of acc.  Slot c is visible iff c < length, c >= prompt_cap or
// c == cursor.  Scores are the f32 dot times `score_scale`; masked slots
// get p = 0 exactly.  Thread t scores slot t of each DH-slot tile (the row
// read as 16-byte vectors), the block takes the tile's max, then thread t
// accumulates its column of P.V over the tile.
template <int DH>
__device__ __forceinline__ void attend_tiles(
    const float (*q_s)[DH], int G, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, int end, int length, int cursor,
    int prompt_cap, float score_scale, float (*p_s)[DH],
    float (*red_s)[DH / 32], float* m, float* l, float* acc) {
  constexpr int NW = DH / 32;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  for (int t0 = 0; t0 < end; t0 += DH) {
    // ---- scores: thread t takes slot c = t0 + t
    const int c = t0 + t;
    const bool live = c < end;
    const bool valid =
        live && (c < length || c >= prompt_cap || c == cursor);
    float s[MAX_G];
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) s[g] = 0.f;
    if (live) {
      const uint4* krow = reinterpret_cast<const uint4*>(kp + (size_t)c * DH);
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) {
        const uint4 u = krow[i];
        const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h2[j]);
          const int d = i * 8 + 2 * j;
#pragma unroll
          for (int g = 0; g < MAX_G; ++g)
            if (g < G) s[g] += q_s[g][d] * f.x + q_s[g][d + 1] * f.y;
        }
      }
    }
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) s[g] *= score_scale;
    // ---- tile max per head: warp shuffle, then across warps
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        float x = valid ? s[g] : NEG;
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
        if (lane == 0) red_s[g][warp] = x;
      }
    }
    __syncthreads();
#pragma unroll
    for (int g = 0; g < MAX_G; ++g) {
      if (g < G) {
        float tmax = red_s[g][0];
#pragma unroll
        for (int w = 1; w < NW; ++w) tmax = fmaxf(tmax, red_s[g][w]);
        const float m_new = fmaxf(m[g], tmax);
        const float alpha = expf(m[g] - m_new);
        p_s[g][t] = valid ? expf(s[g] - m_new) : 0.f;
        m[g] = m_new;
        l[g] *= alpha;
        acc[g] *= alpha;
      }
    }
    __syncthreads();
    // ---- P.V: thread t owns output column t
    const int n = min(DH, end - t0);
    const __nv_bfloat16* vt = vp + (size_t)t0 * DH + t;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float vv = __bfloat162float(vt[(size_t)j * DH]);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
          const float p = p_s[g][j];
          acc[g] += p * vv;
          l[g] += p;
        }
      }
    }
    __syncthreads();  // p_s and red_s are rewritten by the next tile
  }
}

// For a block of DH threads: read the G query heads of kv head `kvh`
// (heads kvh*G .. kvh*G+G-1), its k head and its v head from one fused
// qkv row [(H + 2*Hkv) * DH] bf16; give each q and k head its RMSNorm
// (f32: (x * (1 / sqrt(mean(x^2) + eps))) * w, then bf16) and its rope
// (f32: x * cos + rotate_half(x) * sin, then bf16).  On return q_s[g][t]
// holds column t of q head g (bf16 values, as f32; visible to the whole
// block), *k_out and *v_out column t of k and v.  x_s: [MAX_G + 1][DH]
// scratch; red: DH / 32 floats.
template <int DH>
__device__ __forceinline__ void norm_rope_heads(
    const __nv_bfloat16* __restrict__ row, int H, int Hkv, int kvh, int G,
    const float* __restrict__ qn, const float* __restrict__ kn,
    const float* __restrict__ cos, const float* __restrict__ sin, float eps,
    float (*q_s)[DH], float (*x_s)[DH], float* red, float* k_out,
    float* v_out) {
  const int t = threadIdx.x;
  float raw[MAX_G + 1];
#pragma unroll
  for (int g = 0; g <= MAX_G; ++g) {
    if (g < G)
      raw[g] = bf2f(row[(size_t)(kvh * G + g) * DH + t]);
    else if (g == G)
      raw[g] = bf2f(row[(size_t)(H + kvh) * DH + t]);
  }
  *v_out = bf2f(row[(size_t)(H + Hkv + kvh) * DH + t]);
#pragma unroll
  for (int g = 0; g <= MAX_G; ++g) {
    if (g <= G) {
      const float ss = block_sum<DH>(raw[g] * raw[g], red);
      const float inv = 1.0f / sqrtf(ss / (float)DH + eps);
      x_s[g][t] = bf16r(__fmul_rn(__fmul_rn(raw[g], inv),
                                  g < G ? qn[t] : kn[t]));
    }
  }
  __syncthreads();
  const float c = cos[t], s = sin[t];
#pragma unroll
  for (int g = 0; g <= MAX_G; ++g) {
    if (g <= G) {
      const float x = x_s[g][t];
      const float rot = t < DH / 2 ? -x_s[g][t + DH / 2] : x_s[g][t - DH / 2];
      const float r = bf16r(__fadd_rn(__fmul_rn(x, c), __fmul_rn(rot, s)));
      if (g < G)
        q_s[g][t] = r;
      else
        *k_out = r;
    }
  }
  __syncthreads();
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
