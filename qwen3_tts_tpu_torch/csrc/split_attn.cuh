// Split-prefix decode attention of one warp per work item, shared by the
// chunk kernel's talker attention (chunk_step.cu talker_attn) and the
// talker decode step (talker_step.cu): the q . k scores of up to SPLIT = 64
// slots (score_slots), their P.V (pv_slots), and the per-head q/k RMSNorm
// and rope of one (lane, kv head) item (qk_warp).  Head dim 128.  The sums
// run in the orders that kernels/chunk_step.py replays
// (_scores_kernel_order, _attend_kernel_order, _rms_kernel_order "qk").
//
// A warp's scratch W (shared memory) holds q[CG][128] (the normed, roped
// query heads times the score scale), s[CG][SPLIT] (a split's scores, then
// its p), k[128] and v[128] (the item's own k and v rows); CG is the most
// query heads per kv head the caller instantiates.
#pragma once

#include "common.cuh"

namespace qtts {

constexpr int SPLIT = 64;         // prefix slots per work item

template <int CG>
struct SplitWarp {
  float q[CG][128];
  float s[CG][SPLIT];
  float k[128];
  float v[128];
};

// Scores of n <= SPLIT slots, slot j's k row at krow(j) (bf16, or the
// warp's own w.k where own(j)), into w.s[g][j] (valid(j) ? score : NEG):
// 8 lanes per slot, 4 slots a pass; lane part p dots dims 16p .. 16p + 15
// in order (one fma each), then the 8 lanes' butterfly (xor 4, 2, 1).
// kernels/chunk_step.py _scores_kernel_order.
// The k rows of SB passes are loaded before their products.
template <typename W, typename RowFn, typename OwnFn, typename ValidFn>
__device__ __forceinline__ void score_slots(W& w, int G, int n,
                                            RowFn krow, OwnFn own,
                                            ValidFn valid) {
  constexpr int SB = 4;
  constexpr int CG = sizeof(W::q) / sizeof(W::q[0]);
  const int lane = threadIdx.x & 31;
  const int sub = lane >> 3, part = lane & 7;
  for (int j0 = 0; j0 < n; j0 += 4 * SB) {
    uint4 u[SB][2];
#pragma unroll
    for (int q = 0; q < SB; ++q) {
      const int j = j0 + 4 * q + sub;
      if (j < n && !own(j)) {
        const __nv_bfloat16* kr = krow(j) + part * 16;
        u[q][0] = qtts::ld_16<true>(kr);
        u[q][1] = qtts::ld_16<true>(kr + 8);
      } else {
        u[q][0] = u[q][1] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int q = 0; q < SB; ++q) {
      const int j = j0 + 4 * q + sub;
      float kf[16];
      if (j < n && own(j)) {
#pragma unroll
        for (int e = 0; e < 16; ++e) kf[e] = w.k[part * 16 + e];
      } else {
#pragma unroll
        for (int hv = 0; hv < 2; ++hv) {
          const __nv_bfloat162* h2 =
              reinterpret_cast<const __nv_bfloat162*>(&u[q][hv]);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float2 f2 = __bfloat1622float2(h2[e]);
            kf[hv * 8 + 2 * e] = f2.x;
            kf[hv * 8 + 2 * e + 1] = f2.y;
          }
        }
      }
      float sc[CG];
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        sc[g] = 0.f;
        if (g < G) {
#pragma unroll
          for (int e = 0; e < 16; ++e)
            sc[g] = fmaf(w.q[g][part * 16 + e], kf[e], sc[g]);
        }
#pragma unroll
        for (int o = 4; o > 0; o >>= 1)
          sc[g] = __fadd_rn(sc[g], __shfl_xor_sync(0xffffffffu, sc[g], o));
        if (part == 0 && j < n && g < G)
          w.s[g][j] = valid(j) ? sc[g] : qtts::NEG;
      }
    }
  }
  __syncwarp();
}

// acc[g][i] = fma(p_g[j], v[j][4 lane + i], acc[g][i]) for slots j < n in
// order, p from
// w.s, v row j at vrow(j) (bf16, or the warp's own w.v where own(j)); the
// rows of 8 slots are loaded before their products.
template <typename W, int CG, typename RowFn, typename OwnFn>
__device__ __forceinline__ void pv_slots(const W& w, int n,
                                         RowFn vrow, OwnFn own,
                                         float (&acc)[CG][4]) {
  const int lane = threadIdx.x & 31;
  for (int j0 = 0; j0 < n; j0 += 8) {
    uint2 u[8];
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = j0 + q;
      u[q] = j < n && !own(j)
                 ? __ldcg(reinterpret_cast<const uint2*>(vrow(j) + 4 * lane))
                 : make_uint2(0u, 0u);
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int j = j0 + q;
      if (j >= n) break;
      float vf[4];
      if (own(j)) {
#pragma unroll
        for (int i = 0; i < 4; ++i) vf[i] = w.v[4 * lane + i];
      } else {
        const __nv_bfloat162* h2 =
            reinterpret_cast<const __nv_bfloat162*>(&u[q]);
        const float2 va = __bfloat1622float2(h2[0]);
        const float2 vb = __bfloat1622float2(h2[1]);
        vf[0] = va.x;
        vf[1] = va.y;
        vf[2] = vb.x;
        vf[3] = vb.y;
      }
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        const float p = w.s[g][j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
      }
    }
  }
}

// The G <= CG query heads and the k head of kv head kvh from one fused qkv
// row [(H + 2 Hkv) * 128] bf16 (written by other blocks: ld.global.cg),
// on one warp: per head the RMSNorm (lane holds dims lane + 32 i: each
// set's butterfly, then the sets in order; f32 (x * (1 / sqrt(ss / 128 +
// eps))) * w, then bf16) and rope at the row's position (cos/sin [128]; f32
// x * cos + rotate_half(x) * sin, then bf16); q times `scale` into w.q,
// k into w.k, the raw v row into w.v.
template <typename W>
__device__ __forceinline__ void qk_warp(const __nv_bfloat16* row, int H,
                                        int Hkv, int kvh, int G,
                                        const float* qn, const float* kn,
                                        const float* cs, const float* sn,
                                        float eps, float scale, W& w) {
  constexpr int CG = sizeof(W::q) / sizeof(W::q[0]);
  constexpr int DH = 128;
  const int lane = threadIdx.x & 31;
  // every head's row loaded first: q heads h < G, the k head at CG
  float rr[CG + 1][4], vr[4];
#pragma unroll
  for (int h = 0; h <= CG; ++h) {
    const bool live = h == CG || h < G;
    const __nv_bfloat16* src =
        row + (size_t)(h == CG ? H + kvh : kvh * G + h) * DH;
#pragma unroll
    for (int i = 0; i < 4; ++i)
      rr[h][i] = live ? ld_bf<true>(src + lane + 32 * i) : 0.f;
  }
  const __nv_bfloat16* vsrc = row + (size_t)(H + Hkv + kvh) * DH;
#pragma unroll
  for (int i = 0; i < 4; ++i) vr[i] = ld_bf<true>(vsrc + lane + 32 * i);
#pragma unroll
  for (int h = 0; h <= CG; ++h) {
    if (h < CG && h >= G) continue;
    const bool is_k = h == CG;
    const float* nw = is_k ? kn : qn;
    float x[4];
    float ss = warp_sum(__fmul_rn(rr[h][0], rr[h][0]));
#pragma unroll
    for (int i = 1; i < 4; ++i)
      ss = __fadd_rn(ss, warp_sum(__fmul_rn(rr[h][i], rr[h][i])));
    const float inv = 1.0f / sqrtf(ss / (float)DH + eps);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      x[i] = bf16r(__fmul_rn(__fmul_rn(rr[h][i], inv), nw[lane + 32 * i]));
#pragma unroll
    for (int i = 0; i < 4; ++i) {              // dim d < 64 pairs with d + 64
      const int d = lane + 32 * i;
      const float rot = i < 2 ? -x[i + 2] : x[i - 2];
      const float y =
          bf16r(__fadd_rn(__fmul_rn(x[i], cs[d]), __fmul_rn(rot, sn[d])));
      if (is_k)
        w.k[d] = y;
      else
        w.q[h][d] = __fmul_rn(y, scale);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) w.v[lane + 32 * i] = vr[i];
  __syncwarp();
}

}  // namespace qtts
