// Split-prefix decode attention of one warp per work item, shared by the
// chunk kernel's talker attention (chunk_step.cu talker_attn), the talker
// decode step (talker_step.cu attn_phase) and flash_gqa_decode_append
// (kv_lanes.cu): the q . k scores of up to SPLIT = 64 slots (score_slots),
// their P.V (pv_slots), the per-head q/k RMSNorm and rope of one (lane, kv
// head) item (qk_warp, head dim 128), and the whole item (split_item: a
// split's softmax and partials, the last arriver's combine, the token's
// row and the current token merged last).  Head dim 64 or 128: a lane
// holds DH / 32 output columns.  The sums run in the orders that
// kernels/chunk_step.py replays (_scores_kernel_order,
// _attend_kernel_order, _rms_kernel_order "qk").
//
// A warp's scratch W (shared memory) holds q[CG][DH] (the normed, roped
// query heads times the score scale), s[CG][SPLIT] (a split's scores, then
// its p), k[DH] and v[DH] (the item's own k and v rows); CG is the most
// query heads per kv head the caller instantiates.
#pragma once

#include "common.cuh"

namespace qtts {

constexpr int SPLIT = 64;         // prefix slots per work item

template <int CG, int DH = 128>
struct SplitWarp {
  float q[CG][DH];
  float s[CG][SPLIT];
  float k[DH];
  float v[DH];
};

// Scores of n <= SPLIT slots, slot j's k row at krow(j) (bf16, or the
// warp's own w.k where own(j)), into w.s[g][j] (valid(j) ? score : NEG):
// 8 lanes per slot, 4 slots a pass; lane part p dots dims PD p .. PD p +
// PD - 1 in order (PD = DH / 8; one fma each), then the 8 lanes' butterfly
// (xor 4, 2, 1).
// kernels/chunk_step.py _scores_kernel_order.
// The k rows of SB passes are loaded before their products.
template <int SB = 4, typename W, typename RowFn, typename OwnFn,
          typename ValidFn>
__device__ __forceinline__ void score_slots(W& w, int G, int n,
                                            RowFn krow, OwnFn own,
                                            ValidFn valid) {
  constexpr int CG = sizeof(W::q) / sizeof(W::q[0]);
  constexpr int PD = sizeof(W::k) / sizeof(W::k[0]) / 8;   // dims a part
  constexpr int NV = PD / 8;                               // 16-byte loads
  const int lane = threadIdx.x & 31;
  const int sub = lane >> 3, part = lane & 7;
  for (int j0 = 0; j0 < n; j0 += 4 * SB) {
    uint4 u[SB][NV];
#pragma unroll
    for (int q = 0; q < SB; ++q) {
      const int j = j0 + 4 * q + sub;
      if (j < n && !own(j)) {
        const __nv_bfloat16* kr = krow(j) + part * PD;
#pragma unroll
        for (int hv = 0; hv < NV; ++hv)
          u[q][hv] = qtts::ld_16<true>(kr + 8 * hv);
      } else {
#pragma unroll
        for (int hv = 0; hv < NV; ++hv) u[q][hv] = make_uint4(0u, 0u, 0u, 0u);
      }
    }
#pragma unroll
    for (int q = 0; q < SB; ++q) {
      const int j = j0 + 4 * q + sub;
      float kf[PD];
      if (j < n && own(j)) {
#pragma unroll
        for (int e = 0; e < PD; ++e) kf[e] = w.k[part * PD + e];
      } else {
#pragma unroll
        for (int hv = 0; hv < NV; ++hv) {
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
          for (int e = 0; e < PD; ++e)
            sc[g] = fmaf(w.q[g][part * PD + e], kf[e], sc[g]);
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

// acc[g][i] = fma(p_g[j], v[j][NC lane + i], acc[g][i]) for slots j < n
// in order (NC = DH / 32 columns a lane), p from w.s, v row j at vrow(j)
// (bf16, or the warp's own w.v where own(j)); the rows of PB slots are
// loaded before their products.
template <int NC>
struct Cols;                    // a lane's NC bf16 values as one load
template <>
struct Cols<4> {
  using T = uint2;
};
template <>
struct Cols<2> {
  using T = unsigned int;
};

template <int PB = 8, typename W, int CG, int NC, typename RowFn,
          typename OwnFn>
__device__ __forceinline__ void pv_slots(const W& w, int n,
                                         RowFn vrow, OwnFn own,
                                         float (&acc)[CG][NC]) {
  using T = typename Cols<NC>::T;
  static_assert(sizeof(W::v) / sizeof(W::v[0]) == 32 * NC, "NC = DH / 32");
  const int lane = threadIdx.x & 31;
  for (int j0 = 0; j0 < n; j0 += PB) {
    T u[PB];
#pragma unroll
    for (int q = 0; q < PB; ++q) {
      const int j = j0 + q;
      u[q] = j < n && !own(j)
                 ? __ldcg(reinterpret_cast<const T*>(vrow(j) + NC * lane))
                 : T{};
    }
#pragma unroll
    for (int q = 0; q < PB; ++q) {
      const int j = j0 + q;
      if (j >= n) break;
      float vf[NC];
      if (own(j)) {
#pragma unroll
        for (int i = 0; i < NC; ++i) vf[i] = w.v[NC * lane + i];
      } else {
        const __nv_bfloat162* h2 =
            reinterpret_cast<const __nv_bfloat162*>(&u[q]);
#pragma unroll
        for (int i = 0; i < NC / 2; ++i) {
          const float2 f2 = __bfloat1622float2(h2[i]);
          vf[2 * i] = f2.x;
          vf[2 * i + 1] = f2.y;
        }
      }
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        const float p = w.s[g][j];
#pragma unroll
        for (int i = 0; i < NC; ++i) acc[g][i] = fmaf(p, vf[i], acc[g][i]);
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

// The split partials of one launch (or one phase of a persistent kernel):
// acc rows [n_rows][DH], then (m, l) pairs [n_rows][2], row (bh * nsmax +
// s) * G + g for item bh = lane * Hkv + kv head, split s, query head g;
// arrive[bh] counts an item's finished splits and is 0 between launches.
struct SplitParts {
  float* acc;
  float* ml;
  unsigned* arrive;
  int nsmax;                      // ceil(C / SPLIT)
};

// A lane's NC f32 columns as one vector store / load (NC = 4 or 2).
template <int NC>
__device__ __forceinline__ void st_cols(float* p, const float (&x)[NC]) {
  if constexpr (NC == 4)
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  else
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
}
template <int NC>
__device__ __forceinline__ void ld_cols(const float* p, float (&x)[NC]) {
  if constexpr (NC == 4) {
    const float4 v = __ldcg(reinterpret_cast<const float4*>(p));
    x[0] = v.x;
    x[1] = v.y;
    x[2] = v.z;
    x[3] = v.w;
  } else {
    const float2 v = __ldcg(reinterpret_cast<const float2*>(p));
    x[0] = v.x;
    x[1] = v.y;
  }
}

// One work item on one warp: split s of the prefix [0, end) of item bh
// (ns = max(1, ceil(end / SPLIT)) splits), its k/v rows kp / vp ([C, DH]
// bf16), slot c visible iff c < length or c >= prompt_cap; w.q, w.k, w.v
// set by the caller (the G query heads times the score scale, the token's
// k and v rows).  Per split (the order of chunk_step._attend_kernel_order):
// scores, m = max, p = exp(s - m) (0 where masked), l = the lanes'
// butterfly of p[lane] + p[lane + 32], acc = P.V by fma in slot order.
// With several splits each writes (acc, m, l) to `parts` and the warp that
// raises the item's arrival counter to ns combines them in split order
// (M = max m_s, l and acc by fma with weights exp(m_s - M)) and sets the
// counter back to 0; a counter found at ns or more (not 0 when the launch
// began) traps, so the launch fails instead of combining stale partials.
// The merging warp (the split itself when ns == 1) writes the token's k/v
// row at kd / vd (skipped when null; no split reads that slot), merges the
// current token (from w.k / w.v, always visible) as one more
// online-softmax step and returns true with o[g][i] = acc / max(l, 1e-30)
// for head g, column NC lane + i.  Every other warp returns false.  SB and
// PB (score_slots' passes and pv_slots' rows loaded at a time) change no
// sum, only how many loads a warp keeps in flight.
template <int SB = 4, int PB = 8, typename W, int CG, int NC>
__device__ __forceinline__ bool split_item(
    W& w, int G, const __nv_bfloat16* kp, const __nv_bfloat16* vp, int end,
    int length, int prompt_cap, int s, int ns, int bh, const SplitParts& sp,
    __nv_bfloat16* kd, __nv_bfloat16* vd, float (&o)[CG][NC]) {
  constexpr int DH = 32 * NC;
  static_assert(sizeof(W::k) / sizeof(W::k[0]) == DH, "NC = DH / 32");
  const int lane = threadIdx.x & 31;
  // ---- split s: slots [c0, c0 + n)
  const int c0 = s * SPLIT;
  const int n = max(0, min(SPLIT, end - c0));
  score_slots<SB>(
      w, G, n, [&](int j) { return kp + (size_t)(c0 + j) * DH; },
      [](int) { return false; },
      [&](int j) { return c0 + j < length || c0 + j >= prompt_cap; });
  float m[CG], ls[CG], acc[CG][NC];
#pragma unroll
  for (int g = 0; g < CG; ++g) {
    const float sa = lane < n ? w.s[g][lane] : NEG;
    const float sb = lane + 32 < n ? w.s[g][lane + 32] : NEG;
    float mx = fmaxf(sa, sb);
#pragma unroll
    for (int o_ = 16; o_ > 0; o_ >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o_));
    const float pa = sa > NEG ? expf(sa - mx) : 0.f;
    const float pb = sb > NEG ? expf(sb - mx) : 0.f;
    m[g] = mx;
    ls[g] = warp_sum(__fadd_rn(pa, pb));
    __syncwarp();
    if (g < G) {
      w.s[g][lane] = pa;
      w.s[g][lane + 32] = pb;
    }
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[g][i] = 0.f;
  }
  __syncwarp();
  pv_slots<PB>(w, n, [&](int j) { return vp + (size_t)(c0 + j) * DH; },
               [](int) { return false; }, acc);
  if (ns > 1) {
    const size_t row0 = (size_t)bh * sp.nsmax * G;
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      if (g >= G) continue;
      const size_t r = row0 + (size_t)s * G + g;
      st_cols<NC>(sp.acc + r * DH + NC * lane, acc[g]);
      if (lane == 0) {
        sp.ml[r * 2] = m[g];
        sp.ml[r * 2 + 1] = ls[g];
      }
    }
    __threadfence();
    __syncwarp();
    unsigned old = 0;
    if (lane == 0) old = atomicAdd(sp.arrive + bh, 1u);
    old = __shfl_sync(0xffffffffu, old, 0);
    if (old >= (unsigned)ns) __trap();
    if (old != (unsigned)ns - 1) {
      __syncwarp();
      return false;
    }
    __threadfence();
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      if (g >= G) continue;
      const size_t r0 = row0 + g;
      float mm = NEG;
#pragma unroll 4
      for (int z = 0; z < ns; ++z)
        mm = fmaxf(mm, __ldcg(sp.ml + (r0 + (size_t)z * G) * 2));
      float l_ = 0.f, ac[NC];
#pragma unroll
      for (int i = 0; i < NC; ++i) ac[i] = 0.f;
#pragma unroll 4
      for (int z = 0; z < ns; ++z) {
        const size_t r = r0 + (size_t)z * G;
        const float wz = expf(__ldcg(sp.ml + r * 2) - mm);
        l_ = fmaf(__ldcg(sp.ml + r * 2 + 1), wz, l_);
        float pz[NC];
        ld_cols<NC>(sp.acc + r * DH + NC * lane, pz);
#pragma unroll
        for (int i = 0; i < NC; ++i) ac[i] = fmaf(pz[i], wz, ac[i]);
      }
      m[g] = mm;
      ls[g] = l_;
#pragma unroll
      for (int i = 0; i < NC; ++i) acc[g][i] = ac[i];
    }
    if (lane == 0) sp.arrive[bh] = 0u;          // for the next launch
  }
  // ---- the merging warp: the token's k/v row, then the current token
  if (kd != nullptr) {
#pragma unroll
    for (int i = 0; i < NC; ++i) {
      kd[lane + 32 * i] = __float2bfloat16_rn(w.k[lane + 32 * i]);
      vd[lane + 32 * i] = __float2bfloat16_rn(w.v[lane + 32 * i]);
    }
  }
  auto own = [](int) { return true; };
  score_slots(w, G, 1, [&](int) { return kp; }, own,
              [](int) { return true; });
  float lsum[CG];
#pragma unroll
  for (int g = 0; g < CG; ++g) {
    const float mx = fmaxf(m[g], w.s[g][0]);
    const float alpha = expf(m[g] - mx);
    lsum[g] = __fmul_rn(ls[g], alpha);
#pragma unroll
    for (int i = 0; i < NC; ++i) acc[g][i] = __fmul_rn(acc[g][i], alpha);
    __syncwarp();
    const float p = expf(w.s[g][0] - mx);
    lsum[g] = __fadd_rn(lsum[g], p);
    __syncwarp();
    if (lane == 0) w.s[g][0] = p;
  }
  __syncwarp();
  pv_slots(w, 1, [&](int) { return vp; }, own, acc);
#pragma unroll
  for (int g = 0; g < CG; ++g) {
    const float den = fmaxf(lsum[g], 1e-30f);
#pragma unroll
    for (int i = 0; i < NC; ++i) o[g][i] = acc[g][i] / den;
  }
  return true;
}

}  // namespace qtts
