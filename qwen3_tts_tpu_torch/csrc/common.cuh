// Device code shared by the port's CUDA kernels: the decode-attention tile
// loop (talker_step.cu, predictor_frame.cu, kv_lanes.cu) and the current
// token's column after it (talker_step.cu,
// kv_lanes.cu), the per-head q/k norm + rope, the predictor's 16-slot token
// attention,
// block and thread-group reductions, bf16 rounding, and the launch helper
// for dynamic shared memory.
//
// Thread groups.  The `_g` functions run on a group of NT threads (a whole
// block, or a warp-aligned part of one): `tid` is the thread's index in the
// group and `bar` its barrier, 0 for __syncthreads (the whole block) or a
// named barrier 1..15 of NT threads.  The functions without `_g` are the
// whole-block forms (tid = threadIdx.x, bar 0).  CG = true reads every
// global input with ld.global.cg (L2, not L1): for data that other blocks
// of a persistent kernel wrote during the same launch.
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

// Online-softmax attention of G query heads (q_s[g][*], f32 in shared
// memory) against slots [0, end) of one (lane, kv-head) cache row block
// kp / vp ([C, DH] bf16), for a block of DH threads; thread t owns output
// column t of acc.  Slot c is visible iff c < length, c >= prompt_cap or
// c == cursor.  Scores are the f32 dot times `score_scale`; masked slots
// get p = 0 exactly.  Thread t scores slot t of each DH-slot tile (the row
// read as 16-byte vectors), the block takes the tile's max, then thread t
// accumulates its column of P.V over the tile.
template <int DH, bool CG>
__device__ __forceinline__ void attend_tiles_g(
    const float (*q_s)[DH], int G, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, int end, int length, int cursor,
    int prompt_cap, float score_scale, float (*p_s)[DH],
    float (*red_s)[DH / 32], float* m, float* l, float* acc, int t,
    int bar) {
  constexpr int NW = DH / 32;
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
      const __nv_bfloat16* krow = kp + (size_t)c * DH;
#pragma unroll
      for (int i = 0; i < DH / 8; ++i) {
        const uint4 u = ld_16<CG>(krow + i * 8);
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
    group_sync<DH>(bar);
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
    group_sync<DH>(bar);
    // ---- P.V: thread t owns output column t
    const int n = min(DH, end - t0);
    const __nv_bfloat16* vt = vp + (size_t)t0 * DH + t;
#pragma unroll 4
    for (int j = 0; j < n; ++j) {
      const float vv = ld_bf<CG>(vt + (size_t)j * DH);
#pragma unroll
      for (int g = 0; g < MAX_G; ++g) {
        if (g < G) {
          const float p = p_s[g][j];
          acc[g] += p * vv;
          l[g] += p;
        }
      }
    }
    group_sync<DH>(bar);  // p_s and red_s are rewritten by the next tile
  }
}

template <int DH>
__device__ __forceinline__ void attend_tiles(
    const float (*q_s)[DH], int G, const __nv_bfloat16* __restrict__ kp,
    const __nv_bfloat16* __restrict__ vp, int end, int length, int cursor,
    int prompt_cap, float score_scale, float (*p_s)[DH],
    float (*red_s)[DH / 32], float* m, float* l, float* acc) {
  attend_tiles_g<DH, false>(q_s, G, kp, vp, end, length, cursor, prompt_cap,
                            score_scale, p_s, red_s, m, l, acc, threadIdx.x,
                            0);
}

// After attend_tiles over the prefix [0, cursor): the current token as
// the last column, always visible, its k and v from registers (thread t
// holds column t: k_t, v_t); then head g's normalised output, column t, at
// out[g * DH + t] in bf16.  For a block of DH threads; red: DH / 32 floats.
template <int DH>
__device__ __forceinline__ void attend_current(
    const float (*q_s)[DH], int G, float k_t, float v_t, float* m, float* l,
    float* acc, float* red, __nv_bfloat16* out) {
  const int t = threadIdx.x;
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    if (g < G) {
      const float sc = block_sum<DH>(q_s[g][t] * k_t, red);
      const float m_f = fmaxf(m[g], sc);
      const float alpha = expf(m[g] - m_f);
      const float p = expf(sc - m_f);
      acc[g] = acc[g] * alpha + p * v_t;
      l[g] = l[g] * alpha + p;
      out[(size_t)g * DH + t] =
          __float2bfloat16_rn(acc[g] / fmaxf(l[g], 1e-30f));
    }
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
template <int DH, bool CG>
__device__ __forceinline__ void norm_rope_heads_g(
    const __nv_bfloat16* __restrict__ row, int H, int Hkv, int kvh, int G,
    const float* __restrict__ qn, const float* __restrict__ kn,
    const float* __restrict__ cos, const float* __restrict__ sin, float eps,
    float (*q_s)[DH], float (*x_s)[DH], float* red, float* k_out,
    float* v_out, int t, int bar) {
  float raw[MAX_G + 1];
#pragma unroll
  for (int g = 0; g <= MAX_G; ++g) {
    if (g < G)
      raw[g] = ld_bf<CG>(row + (size_t)(kvh * G + g) * DH + t);
    else if (g == G)
      raw[g] = ld_bf<CG>(row + (size_t)(H + kvh) * DH + t);
  }
  *v_out = ld_bf<CG>(row + (size_t)(H + Hkv + kvh) * DH + t);
#pragma unroll
  for (int g = 0; g <= MAX_G; ++g) {
    if (g <= G) {
      const float ss = group_sum<DH>(raw[g] * raw[g], red, t, bar);
      const float inv = 1.0f / sqrtf(ss / (float)DH + eps);
      x_s[g][t] = bf16r(__fmul_rn(__fmul_rn(raw[g], inv),
                                  g < G ? qn[t] : kn[t]));
    }
  }
  group_sync<DH>(bar);
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
  group_sync<DH>(bar);
}

template <int DH>
__device__ __forceinline__ void norm_rope_heads(
    const __nv_bfloat16* __restrict__ row, int H, int Hkv, int kvh, int G,
    const float* __restrict__ qn, const float* __restrict__ kn,
    const float* __restrict__ cos, const float* __restrict__ sin, float eps,
    float (*q_s)[DH], float (*x_s)[DH], float* red, float* k_out,
    float* v_out) {
  norm_rope_heads_g<DH, false>(row, H, Hkv, kvh, G, qn, kn, cos, sin, eps,
                               q_s, x_s, red, k_out, v_out, threadIdx.x, 0);
}

// Scratch of one token-attention group of DH threads (token_attend_g).
template <int DH>
struct AttnScratch {
  float q[MAX_G][DH];
  float x[MAX_G + 1][DH];
  float p[MAX_G][DH];
  float red_s[MAX_G][DH / 32];
  float red[DH / 32];
};

// The predictor's attention of token `tok` for kv head `kvh`, on a group of
// DH threads: q/k norm and rope at position tok (cos/sin rows of that
// position), the k/v row written into slot tok of the head's 16-slot
// block kp/vp ([16, DH] bf16), then attention over slots [0, tok] with
// scores (q . k) * scale in f32.  Returns thread t's column of each query
// head's context in ctx[g] (g < G).
template <int DH, bool CG>
__device__ __forceinline__ void token_attend_g(
    const __nv_bfloat16* __restrict__ row, int H, int Hkv, int kvh, int G,
    const float* __restrict__ qn, const float* __restrict__ kn,
    const float* __restrict__ cos, const float* __restrict__ sin, float eps,
    __nv_bfloat16* kp, __nv_bfloat16* vp, int tok, float scale,
    AttnScratch<DH>& s, float* ctx, int t, int bar) {
  float kv, vv;
  norm_rope_heads_g<DH, CG>(row, H, Hkv, kvh, G, qn, kn, cos, sin, eps, s.q,
                            s.x, s.red, &kv, &vv, t, bar);
  kp[(size_t)tok * DH + t] = __float2bfloat16_rn(kv);
  vp[(size_t)tok * DH + t] = __float2bfloat16_rn(vv);
  group_sync<DH>(bar);
  float m[MAX_G], l[MAX_G], acc[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    m[g] = NEG;
    l[g] = 0.f;
    acc[g] = 0.f;
  }
  // every slot s <= tok is visible (length 0, prompt_cap 0)
  attend_tiles_g<DH, CG>(s.q, G, kp, vp, tok + 1, 0, tok, 0, scale, s.p,
                         s.red_s, m, l, acc, t, bar);
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
    if (g < G) ctx[g] = acc[g] / fmaxf(l[g], 1e-30f);
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
