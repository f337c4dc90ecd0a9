// The w4a8 GEMV body shared by talker_step.cu and chunk_step.cu: grouped
// int4 weights (ops/quant.py pack_int4 layout) times int8 activations
// quantized per row, with the JAX package's `_qmm4` numerics.
//
// quantize_rows: the block's prologue, rows in [NB, K] bf16 (RMS-normed
// with weights norm_w when RMS) quantized to int8 xq [NB, K] with per-row
// scale sx_s: sx = max(amax, 1e-8) * f32(1/127), xq = round_half_even(h /
// sx).  Each row is read from global memory once (with ld.global.cg when
// CG: data other blocks of a persistent kernel wrote) into xs [NB, K] bf16
// in shared memory, which then holds the normed row; each thread touches
// only its own strided elements there, so the passes need no barrier of
// their own.
//
// w4a8_warp_row: one warp's output column `row` (and row + N for R = 2, the
// SwiGLU pair).  Its lanes cover 8 groups of 128 K rows per 512-byte sweep,
// four lanes per group; the exact int32 group dots go to the warp's
// shared-memory slice gw [R, ng, NB], and lane b < NB sums them in f32 in
// the JAX order (group i, then group nb + i, for i < nb = ng / 2) times the
// group scales (bf16 for the talker, f32 for the chunk kernel's predictor),
// returning y[r] = bf16(acc * sx[b]).
#pragma once

#include "common.cuh"

namespace qtts {

constexpr int W4_GROUP = 128;          // int4 group along K
constexpr float INV127 = (float)(1.0 / 127.0);

__device__ __forceinline__ float scale_f32(__nv_bfloat16 s) {
  return __bfloat162float(s);
}
__device__ __forceinline__ float scale_f32(float s) { return s; }

template <int NB, bool RMS, int NT, bool CG>
__device__ __forceinline__ void quantize_rows(
    const __nv_bfloat16* __restrict__ in, const float* __restrict__ norm_w,
    int K, float eps, __nv_bfloat16* xs, int8_t* xq, float* sx_s,
    float* red) {
  const int tid = threadIdx.x;
  for (int b = 0; b < NB; ++b) {
    const __nv_bfloat16* xr = in + (size_t)b * K;
    __nv_bfloat16* sr = xs + (size_t)b * K;
    float ss = 0.f;
    for (int k = tid; k < K; k += NT) {
      const float v = ld_bf<CG>(xr + k);
      sr[k] = __float2bfloat16_rn(v);
      ss += v * v;
    }
    float inv = 1.f;
    if (RMS) {
      ss = block_sum<NT>(ss, red);
      inv = 1.0f / sqrtf(ss / (float)K + eps);
    }
    float am = 0.f;
    for (int k = tid; k < K; k += NT) {
      const float v = bf2f(sr[k]);
      const float h = RMS ? bf16r(__fmul_rn(__fmul_rn(v, inv), norm_w[k])) : v;
      sr[k] = __float2bfloat16_rn(h);
      am = fmaxf(am, fabsf(h));
    }
    am = block_max<NT>(am, red);
    const float sx = __fmul_rn(fmaxf(am, 1e-8f), INV127);
    if (tid == 0) sx_s[b] = sx;
    for (int k = tid; k < K; k += NT)
      xq[(size_t)b * K + k] = (int8_t)rintf(__fdiv_rn(bf2f(sr[k]), sx));
  }
  __syncthreads();
}

// quantize_rows<1, false, NT, *> for one row that is already in shared
// memory (xs, bf16; chunk_step.cu stages the predictor's attention context
// there): the same amax, scale and rounding, without the load.
template <int NT>
__device__ __forceinline__ void quantize_staged(int K,
                                                const __nv_bfloat16* xs,
                                                int8_t* xq, float* sx_s,
                                                float* red) {
  const int tid = threadIdx.x;
  float am = 0.f;
  for (int k = tid; k < K; k += NT) am = fmaxf(am, fabsf(bf2f(xs[k])));
  am = block_max<NT>(am, red);
  const float sx = __fmul_rn(fmaxf(am, 1e-8f), INV127);
  if (tid == 0) *sx_s = sx;
  for (int k = tid; k < K; k += NT)
    xq[k] = (int8_t)rintf(__fdiv_rn(bf2f(xs[k]), sx));
  __syncthreads();
}

__device__ __forceinline__ int sext4(uint32_t nibbles) {
  // four 4-bit two's complement values, one per byte -> four int8
  return (int)__vsub4(nibbles ^ 0x08080808u, 0x08080808u);
}

// Valid in lanes b < NB only; the caller writes y.  gw: this warp's
// [R, ng, NB] ints; the caller __syncwarp()s before reusing it.
template <int NB, int R, typename S>
__device__ __forceinline__ void w4a8_warp_row(
    const int8_t* xq, const float* sx_s, int K,
    const uint8_t* __restrict__ wq, const S* __restrict__ ws, int N,
    int row, int* gw, float* y) {
  const int lane = threadIdx.x & 31;
  const int ng = K / W4_GROUP;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const uint8_t* wrow = wq + (size_t)(row + r * N) * (K / 2);
    for (int g0 = 0; g0 < ng; g0 += 8) {
      const int g = g0 + (lane >> 2);
      int dot[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) dot[b] = 0;
      if (g < ng) {
        const int quarter = lane & 3;                 // 32 of the 128 rows
        const uint4 wv =
            *reinterpret_cast<const uint4*>(wrow + g * 64 + quarter * 16);
        const uint32_t ww[4] = {wv.x, wv.y, wv.z, wv.w};
        const int k0 = g * W4_GROUP + quarter * 32;
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const int4* xv = reinterpret_cast<const int4*>(xq + (size_t)b * K + k0);
          const int4 x0 = xv[0], x1 = xv[1];
          const int xs[8] = {x0.x, x0.y, x0.z, x0.w, x1.x, x1.y, x1.z, x1.w};
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            dot[b] = __dp4a(sext4(ww[i] & 0x0F0F0F0Fu), xs[2 * i], dot[b]);
            dot[b] = __dp4a(sext4((ww[i] >> 4) & 0x0F0F0F0Fu), xs[2 * i + 1],
                            dot[b]);
          }
        }
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        dot[b] += __shfl_xor_sync(0xffffffffu, dot[b], 1);
        dot[b] += __shfl_xor_sync(0xffffffffu, dot[b], 2);
      }
      if ((lane & 3) == 0 && g < ng) {
#pragma unroll
        for (int b = 0; b < NB; ++b) gw[((size_t)r * ng + g) * NB + b] = dot[b];
      }
    }
  }
  __syncwarp();
  if (lane >= NB) return;
  const int b = lane;
  const int nb = ng / 2;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const S* sr = ws + (size_t)(row + r * N) * ng;
    const int* dr = gw + (size_t)r * ng * NB + b;
    float acc = 0.f;
    for (int i = 0; i < nb; ++i) {          // JAX order: i, then nb + i
      acc = __fadd_rn(acc, __fmul_rn((float)dr[i * NB], scale_f32(sr[i])));
      acc = __fadd_rn(acc, __fmul_rn((float)dr[(nb + i) * NB],
                                     scale_f32(sr[nb + i])));
    }
    y[r] = bf16r(__fmul_rn(acc, sx_s[b]));
  }
}

}  // namespace qtts
