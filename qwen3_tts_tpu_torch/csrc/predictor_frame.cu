// The predictor's 15 residual codes of one frame, int8 weights, for Hopper.
//
// Replaces: qwen3_tts_tpu/kernels/predictor_frame.py predict_frame_fused
// (the Pallas TPU kernel).  Contract: x [B, D] bf16 (the projected talker
// hidden, rounded), code0 [B] int32 -> codes [B, 16] int32.  Token t sits
// at rope position t (t = 0: the hidden, t = 1: emb(code0), t >= 2:
// emb(code_{t-1})); each runs all layers with attention over the slots
// s <= t of a 16-slot KV that the caller zeroes; after token t >= 1 the
// final norm and the 2048-row int8 window t - 1 of the lm-head give the
// logits, whose argmax (lowest index on ties) is code t; the next token's
// input is tables[t][code t].  Numerics follow the Pallas kernel (see
// kernels/predictor_frame.py): `_qmm` = bf16(x_bf16 . w_int8 in f32) *
// bf16(scale), rounded to bf16; head logits = (x_bf16 . w_int8) * scale in
// f32.
//
// The window logits of every token stay in logits [B, 15, 2048] f32.
//
// Weights (kernels/predictor_frame.prep_predictor_weights): int8 [L, N, K]
// (output-major: one output column's K values contiguous) with f32 scales
// [L, N]; lm-head int8 [15 * 2048, D] with f32 per-row scales.
//
// What bounds it on the card: bytes.  The 6 layers hold 75.5 MB of int8
// weights at full width, and the frame's 16 tokens read them 16 times:
// 1.2 GB per frame, ~0.36 ms at 3.35 TB/s, plus 15 head windows of 2 MB.
// The TPU kernel keeps all layers resident in its 128 MB VMEM and reads
// them once per frame; one H100's 50 MB L2 cannot hold them, so this
// kernel streams them from device memory for every token.  That is the
// open problem for the version that makes it fast (e.g. split the layers
// over SMs, each keeping its slice in shared memory, in a persistent
// kernel).
//
// What the design does now: one C call per frame runs the whole token loop
// on the caller's stream with no host sync; codes go from the argmax to
// the embedding gather through device memory.  Per token and layer there
// are five launches (qkv GEMV with RMSNorm prologue, attention, wo GEMV +
// residual, gate_up GEMV + SwiGLU, down GEMV + residual), then the head
// window GEMV and one argmax + gather launch.  A warp owns one output
// column and reads its int8 weights as 16-byte vectors against the bf16
// activations in shared memory.  Batches are run in chunks of up to four
// lanes.

#include "common.cuh"

namespace {

using qtts::bf16r;
using qtts::bf2f;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int N_TOKENS = 16;
constexpr int MAX_NB = 4;

enum { EPI_STORE = 0, EPI_RESID = 1, EPI_SWIGLU = 2, EPI_LOGITS = 3 };

// dst[b, n] for n < N: the int8-weight product of the (normed) input rows
// with output column n (and n + N for the SwiGLU pair), then the epilogue.
template <int NB, bool RMS, int EPI>
__global__ void __launch_bounds__(THREADS)
i8_gemv_kernel(const __nv_bfloat16* __restrict__ in,
               const float* __restrict__ norm_w, float eps, int K,
               const int8_t* __restrict__ wq, const float* __restrict__ ws,
               int N, void* __restrict__ dst, int ldd) {
  constexpr int R = EPI == EPI_SWIGLU ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);   // [NB, K]
  __shared__ float red[WARPS];
  const int tid = threadIdx.x;
  for (int b = 0; b < NB; ++b) {
    const __nv_bfloat16* xr = in + (size_t)b * K;
    if (RMS) {
      float ss = 0.f;
      for (int k = tid; k < K; k += THREADS) {
        const float v = bf2f(xr[k]);
        ss += v * v;
      }
      ss = qtts::block_sum<THREADS>(ss, red);
      const float inv = 1.0f / sqrtf(ss / (float)K + eps);
      for (int k = tid; k < K; k += THREADS)
        xs[(size_t)b * K + k] = __float2bfloat16_rn(
            __fmul_rn(__fmul_rn(bf2f(xr[k]), inv), norm_w[k]));
    } else {
      for (int k = tid; k < K; k += THREADS) xs[(size_t)b * K + k] = xr[k];
    }
  }
  __syncthreads();

  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int row = blockIdx.x * WARPS + warp;
  if (row >= N) return;
  float acc[R][NB];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[r][b] = 0.f;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int8_t* wrow = wq + (size_t)(row + r * N) * K;
    for (int k0 = lane * 16; k0 < K; k0 += 32 * 16) {
      const uint4 wv = *reinterpret_cast<const uint4*>(wrow + k0);
      const int8_t* w8 = reinterpret_cast<const int8_t*>(&wv);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const uint4* xv = reinterpret_cast<const uint4*>(xs + (size_t)b * K + k0);
        const uint4 xa = xv[0], xb = xv[1];
        const __nv_bfloat162* h0 = reinterpret_cast<const __nv_bfloat162*>(&xa);
        const __nv_bfloat162* h1 = reinterpret_cast<const __nv_bfloat162*>(&xb);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f0 = __bfloat1622float2(h0[j]);
          const float2 f1 = __bfloat1622float2(h1[j]);
          // bf16 x int8 products are exact in f32
          acc[r][b] = fmaf(f0.x, (float)w8[2 * j], acc[r][b]);
          acc[r][b] = fmaf(f0.y, (float)w8[2 * j + 1], acc[r][b]);
          acc[r][b] = fmaf(f1.x, (float)w8[8 + 2 * j], acc[r][b]);
          acc[r][b] = fmaf(f1.y, (float)w8[8 + 2 * j + 1], acc[r][b]);
        }
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[r][b] += __shfl_xor_sync(0xffffffffu, acc[r][b], o);
  }
  if (lane != 0) return;
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    if (EPI == EPI_LOGITS) {
      static_cast<float*>(dst)[(size_t)b * ldd + row] =
          __fmul_rn(acc[0][b], ws[row]);
      continue;
    }
    float y[R];
#pragma unroll
    for (int r = 0; r < R; ++r)
      y[r] = bf16r(__fmul_rn(bf16r(acc[r][b]), bf16r(ws[row + r * N])));
    __nv_bfloat16* o = static_cast<__nv_bfloat16*>(dst) + (size_t)b * ldd + row;
    if (EPI == EPI_STORE) {
      *o = __float2bfloat16_rn(y[0]);
    } else if (EPI == EPI_RESID) {
      *o = __float2bfloat16_rn(__fadd_rn(bf2f(*o), y[0]));
    } else {
      const float act = bf16r(__fdiv_rn(y[0], 1.0f + expf(-y[0])));
      *o = __float2bfloat16_rn(__fmul_rn(act, y[R - 1]));
    }
  }
}

// Token t of lanes [b0, b0 + gridDim.y): q/k norm and rope at position t,
// k/v written into slot t, attention over slots [0, t] (common.cuh
// token_attend_g).
template <int DH>
__global__ void __launch_bounds__(DH)
frame_attn_kernel(const __nv_bfloat16* __restrict__ qkv,
                  __nv_bfloat16* __restrict__ ctx, __nv_bfloat16* kc,
                  __nv_bfloat16* vc, const float* __restrict__ cos,
                  const float* __restrict__ sin, const float* __restrict__ qn,
                  const float* __restrict__ kn, int layer, int b0, int B,
                  int H, int Hkv, int tok, float eps, float scale) {
  using qtts::MAX_G;
  const int kvh = blockIdx.x;
  const int bl = blockIdx.y;                 // lane within the chunk
  const int t = threadIdx.x;
  const int G = H / Hkv;

  __shared__ qtts::AttnScratch<DH> sc;
  const size_t head = ((size_t)layer * B + b0 + bl) * Hkv + kvh;
  float c[MAX_G];
  qtts::token_attend_g<DH, false>(
      qkv + (size_t)bl * (H + 2 * Hkv) * DH, H, Hkv, kvh, G, qn, kn,
      cos + (size_t)tok * DH, sin + (size_t)tok * DH, eps,
      kc + head * N_TOKENS * DH, vc + head * N_TOKENS * DH, tok, scale, sc,
      c, t, 0);
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
    if (g < G)
      ctx[((size_t)bl * H + kvh * G + g) * DH + t] = __float2bfloat16_rn(c[g]);
}

// One block per lane: code t (code0 at t = 0, else the argmax of the
// window logits [b, t - 1, :], lowest index on ties) into codes[b, t]; for
// t < 15 the next token's input x[b] = tables[t][code].
__global__ void __launch_bounds__(THREADS)
feed_kernel(const float* __restrict__ logits, const int* __restrict__ code0,
            int* __restrict__ codes, const __nv_bfloat16* __restrict__ tables,
            __nv_bfloat16* __restrict__ x, int tok, int V, int R, int D) {
  __shared__ float best_v[THREADS];
  __shared__ int best_i[THREADS];
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  int code;
  if (tok == 0) {
    code = code0[b];
  } else {
    const float* lg = logits + ((size_t)b * (N_TOKENS - 1) + tok - 1) * V;
    float bv = -INFINITY;
    int bi = V;
    for (int k = tid; k < V; k += THREADS) {
      const float v = lg[k];
      if (bi == V || v > bv) {
        bv = v;
        bi = k;
      }
    }
    best_v[tid] = bv;
    best_i[tid] = bi;
    __syncthreads();
    for (int s = THREADS / 2; s > 0; s >>= 1) {
      if (tid < s) {
        const float ov = best_v[tid + s];
        const int oi = best_i[tid + s];
        if (ov > best_v[tid] || (ov == best_v[tid] && oi < best_i[tid])) {
          best_v[tid] = ov;
          best_i[tid] = oi;
        }
      }
      __syncthreads();
    }
    code = best_i[0];
  }
  if (tid == 0) codes[(size_t)b * N_TOKENS + tok] = code;
  if (tok < N_TOKENS - 1) {
    code = min(max(code, 0), R - 1);
    const __nv_bfloat16* src = tables + ((size_t)tok * R + code) * D;
    for (int k = tid; k < D; k += THREADS) x[(size_t)b * D + k] = src[k];
  }
}

template <int NB, bool RMS, int EPI>
cudaError_t gemv(const __nv_bfloat16* in, const float* norm_w, float eps,
                 int K, const int8_t* wq, const float* ws, int N, void* dst,
                 cudaStream_t st, int ldd = 0) {
  const size_t smem = (size_t)NB * K * sizeof(__nv_bfloat16);
  auto kernel = i8_gemv_kernel<NB, RMS, EPI>;
  cudaError_t e = qtts::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<(N + WARPS - 1) / WARPS, THREADS, smem, st>>>(
      in, norm_w, eps, K, wq, ws, N, dst, ldd > 0 ? ldd : N);
  return cudaGetLastError();
}

struct Frame {
  const float *ln1, *ln2, *qn, *kn, *fn;
  const int8_t *wqkv_q, *wo_q, *gu_q, *dn_q, *head_q;
  const float *wqkv_s, *wo_s, *gu_s, *dn_s, *head_s;
  const float *cos, *sin;
  const __nv_bfloat16* tables;
  __nv_bfloat16 *kc, *vc;
  int L, B, D, H, Hkv, DH, F, R, V;
  float eps, scale;
};

template <int DH>
cudaError_t attn(const Frame& f, const __nv_bfloat16* qkv, __nv_bfloat16* ctx,
                 int l, int b0, int nb, int tok, cudaStream_t st) {
  frame_attn_kernel<DH><<<dim3(f.Hkv, nb), DH, 0, st>>>(
      qkv, ctx, f.kc, f.vc, f.cos, f.sin, f.qn + (size_t)l * DH,
      f.kn + (size_t)l * DH, l, b0, f.B, f.H, f.Hkv, tok, f.eps, f.scale);
  return cudaGetLastError();
}

// The whole frame of lanes [b0, b0 + NB).
template <int NB>
cudaError_t run_frame(const Frame& f, int b0, const int* code0, int* codes,
                      __nv_bfloat16* x, __nv_bfloat16* qkv,
                      __nv_bfloat16* ctx, __nv_bfloat16* ff, float* logits,
                      cudaStream_t st) {
  const int D = f.D, F = f.F, dq = f.H * f.DH;
  const int nqkv = (f.H + 2 * f.Hkv) * f.DH;
  x += (size_t)b0 * D;
  qkv += (size_t)b0 * nqkv;
  ctx += (size_t)b0 * dq;
  ff += (size_t)b0 * F;
  logits += (size_t)b0 * (N_TOKENS - 1) * f.V;
  code0 += b0;
  codes += (size_t)b0 * N_TOKENS;
  cudaError_t e = cudaSuccess;
  for (int tok = 0; tok < N_TOKENS && e == cudaSuccess; ++tok) {
    for (int l = 0; l < f.L && e == cudaSuccess; ++l) {
      e = gemv<NB, true, EPI_STORE>(x, f.ln1 + (size_t)l * D, f.eps, D,
                                    f.wqkv_q + (size_t)l * nqkv * D,
                                    f.wqkv_s + (size_t)l * nqkv, nqkv, qkv,
                                    st);
      if (e != cudaSuccess) break;
      e = f.DH == 64 ? attn<64>(f, qkv, ctx, l, b0, NB, tok, st)
                     : attn<128>(f, qkv, ctx, l, b0, NB, tok, st);
      if (e != cudaSuccess) break;
      e = gemv<NB, false, EPI_RESID>(ctx, nullptr, f.eps, dq,
                                     f.wo_q + (size_t)l * D * dq,
                                     f.wo_s + (size_t)l * D, D, x, st);
      if (e != cudaSuccess) break;
      e = gemv<NB, true, EPI_SWIGLU>(x, f.ln2 + (size_t)l * D, f.eps, D,
                                     f.gu_q + (size_t)l * 2 * F * D,
                                     f.gu_s + (size_t)l * 2 * F, F, ff, st);
      if (e != cudaSuccess) break;
      e = gemv<NB, false, EPI_RESID>(ff, nullptr, f.eps, F,
                                     f.dn_q + (size_t)l * D * F,
                                     f.dn_s + (size_t)l * D, D, x, st);
    }
    if (e != cudaSuccess) break;
    if (tok >= 1) {
      const size_t w0 = (size_t)(tok - 1) * f.V;     // window tok - 1
      e = gemv<NB, true, EPI_LOGITS>(x, f.fn, f.eps, D, f.head_q + w0 * D,
                                     f.head_s + w0, f.V, logits + w0, st,
                                     (N_TOKENS - 1) * f.V);
      if (e != cudaSuccess) break;
    }
    feed_kernel<<<NB, THREADS, 0, st>>>(logits, code0, codes, f.tables, x,
                                        tok, f.V, f.R, D);
    e = cudaGetLastError();
  }
  return e;
}

}  // namespace

extern "C" int qtts_predictor_frame(
    const int* code0, int* codes, const float* ln1, const float* ln2,
    const float* qn, const float* kn, const float* fn, const void* wqkv_q,
    const float* wqkv_s, const void* wo_q, const float* wo_s,
    const void* gu_q, const float* gu_s, const void* dn_q, const float* dn_s,
    const void* head_q, const float* head_s, const float* cos,
    const float* sin, const void* tables, void* x, void* k_cache,
    void* v_cache, void* qkv_buf, void* ctx_buf, void* ff_buf, float* logits,
    int L, int B, int D, int H, int Hkv, int DH, int F, int R, int V,
    float eps, float scale, void* stream) {
  if (B < 1 || (DH != 64 && DH != 128) || Hkv <= 0 || H % Hkv != 0 ||
      H / Hkv > qtts::MAX_G || D % 16 != 0 || (H * DH) % 16 != 0 ||
      F % 16 != 0 || L <= 0 || V <= 0 || R <= 0)
    return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  const Frame f{ln1, ln2, qn, kn, fn,
                static_cast<const int8_t*>(wqkv_q),
                static_cast<const int8_t*>(wo_q),
                static_cast<const int8_t*>(gu_q),
                static_cast<const int8_t*>(dn_q),
                static_cast<const int8_t*>(head_q),
                wqkv_s, wo_s, gu_s, dn_s, head_s, cos, sin,
                static_cast<const bf*>(tables), static_cast<bf*>(k_cache),
                static_cast<bf*>(v_cache), L, B, D, H, Hkv, DH, F, R, V, eps,
                scale};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  bf* xb = static_cast<bf*>(x);
  bf* qb = static_cast<bf*>(qkv_buf);
  bf* cb = static_cast<bf*>(ctx_buf);
  bf* fb = static_cast<bf*>(ff_buf);
  cudaError_t e = cudaSuccess;
  for (int b0 = 0; b0 < B && e == cudaSuccess; b0 += MAX_NB) {
    switch (min(MAX_NB, B - b0)) {
      case 1: e = run_frame<1>(f, b0, code0, codes, xb, qb, cb, fb, logits, st); break;
      case 2: e = run_frame<2>(f, b0, code0, codes, xb, qb, cb, fb, logits, st); break;
      case 3: e = run_frame<3>(f, b0, code0, codes, xb, qb, cb, fb, logits, st); break;
      default: e = run_frame<4>(f, b0, code0, codes, xb, qb, cb, fb, logits, st); break;
    }
  }
  return (int)e;
}
