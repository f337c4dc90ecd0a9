// One talker decode step over all layers, for Hopper, in four weight modes.
//
// Replaces: qwen3_tts_tpu/kernels/talker_step.py talker_step_fused (the
// Pallas TPU kernel) in its weight modes "w4a8" (the default), "int8",
// "w8a8" and "bf16" (`_qmm4` and `_qmm`), at the JAX gate's decode batches:
// B <= 4, or B % 8 == 0 up to 96; one cursor per lane.
// Contract: x [B, D] bf16 in; out [B, D] bf16 = the hidden state BEFORE
// the final norm.  The current token's k/v row of every layer goes either
// IN PLACE into the k/v caches [L, B, Hkv, C, Dh] bf16 at slot
// write_idx[b] (uniform mode: k_tok == nullptr), or into the token buffers
// k_tok / v_tok [L, B, Hkv, Dh] (per-lane mode, continuous batching), from
// which the caller's one append_kv_lanes launch (kv_lanes.cu) writes them,
// as the JAX kernel does.  Either way attention reads only slots below
// write_idx[b] and takes the current token from registers, so the two
// modes compute the same numbers.  Numerics follow the Pallas kernel op
// for op (see kernels/talker_step.py).  Every lane's arithmetic is that of
// B = 1, so a lane's outputs are bit-equal to the one-lane kernel's on its
// inputs, in every mode.
//
// Weights (kernels/talker_step.prep_layer_weights), output-major (output
// column n's K values contiguous):
//   w4a8  uint8 [L, N, K/2] (ops/quant.py pack_int4: each 4-byte word
//         holds K rows 8m..8m+3 in its low nibbles and 8m+4..8m+7 in its
//         high nibbles), bf16 scales [L, N, K/128]: per-row int8
//         activations, exact integer dots per 128-row group, groups summed
//         in f32 in the JAX order with the bf16 scales;
//   int8  int8 [L, N, K], f32 scales [L, N]: y = bf16(bf16(sum x*q in f32)
//         * bf16(s)), the bf16 activations read from shared memory;
//   w8a8  the int8 weights, per-row int8 activations (the w4a8 prologue):
//         one exact __dp4a int32 dot, y = bf16(f32(acc) * sx * s);
//   bf16  bf16(q * s) [L, N, K] with unit f32 scales: the int8 mode's dot.
//
// What bounds it on the card: bytes.  At full width (28 layers, d 2048,
// d_ff 6144: 1.41 G weights) a step reads 0.70 GB of int4 weights and
// 22 MB of scales in w4a8 (about 0.22 ms at 3.35 TB/s), 1.41 GB in int8
// and w8a8 (0.42 ms), 2.82 GB in bf16 (0.84 ms), against ~1.4 G
// multiply-adds per lane, far below the card's rates; attention adds the
// live KV prefix.
//
// What the design does about it: weights are read once, as 16-byte vectors
// along each output column; int4 nibbles are unpacked in registers
// (__vsub4 sign extension) into __dp4a dot products against int8
// activations in shared memory, int8 weights go to __dp4a (w8a8) or to
// f32 multiply-adds against the bf16 rows (int8, bf16); no weight is
// dequantized to memory.  Batch rows run in tiles of NB <= 8 (NB = B for
// B <= 4, else 8): a GEMV block normalises (and in w4a8 / w8a8 quantizes)
// its tile's rows into shared memory (w4a8 159 KB at K = 6144, NB = 8;
// w8a8 147 KB; int8 and bf16 96 KB), and grid.x runs over the B / NB
// tiles, so the tiles that read one block of weight columns are neighbours
// in launch order and mostly meet those weights in L2.  Per layer there
// are five launches on the caller's stream:
//   qkv     GEMV whose prologue recomputes RMSNorm(x) (and the int8
//           quantization of the row) in every block (2048 values: cheaper
//           than a launch) -> qkv [B, Nqkv] bf16;
//   attn    one block per (kv head, lane), serving its G query heads from
//           one K/V read: q/k RMSNorm, rope, the k/v write, the
//           live-prefix loop of flash_decode.cu (common.cuh attend_tiles)
//           and the current token as one more column from registers;
//   wo      GEMV + residual add into out;
//   gate_up GEMV with RMSNorm prologue, a warp owning columns j and
//           j + d_ff, SwiGLU epilogue -> ff [B, d_ff] bf16;
//   down    GEMV + residual add into out.
// A warp owns one output column (or pair).  w4a8: its lanes cover 8 groups
// per 512-byte sweep, four lanes per group, and the group dots (exact
// int32) are summed in f32 by one lane per batch row in the JAX order.
// int8 / w8a8 / bf16: each lane takes 16 K values per 512-value sweep and
// the warp adds its lanes' sums by a butterfly.  This is simple first: the
// serial group sum, the 2048-row prologue repeated by every block, and 140
// launches per step are what a faster version removes (a persistent
// kernel with TMA weight streaming).

#include "w4a8.cuh"

namespace {

using qtts::bf16r;
using qtts::bf2f;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int GROUP = qtts::W4_GROUP;

enum { EPI_STORE = 0, EPI_RESID = 1, EPI_SWIGLU = 2 };
// kernels/talker_step.MODES
enum { MODE_W4A8 = 0, MODE_INT8 = 1, MODE_W8A8 = 2, MODE_BF16 = 3 };

// Write one output element o from its GEMV value(s) y[R].
template <int EPI, int R>
__device__ __forceinline__ void epilogue(__nv_bfloat16* o, const float* y) {
  if (EPI == EPI_STORE) {
    *o = __float2bfloat16_rn(y[0]);
  } else if (EPI == EPI_RESID) {
    *o = __float2bfloat16_rn(__fadd_rn(bf2f(*o), y[0]));
  } else {
    const float gate = y[0];
    const float act = bf16r(__fdiv_rn(gate, 1.0f + expf(-gate)));
    *o = __float2bfloat16_rn(__fmul_rn(act, y[R - 1]));
  }
}

// The int8 / bf16 modes' prologue: rows in [NB, K] bf16 to xs [NB, K] bf16
// in shared memory, RMS-normed with weights norm_w when RMS, with the
// arithmetic of qtts::quantize_rows (w4a8.cuh) up to its quantization.
template <int NB, bool RMS>
__device__ __forceinline__ void norm_rows(
    const __nv_bfloat16* __restrict__ in, const float* __restrict__ norm_w,
    int K, float eps, __nv_bfloat16* xs, float* red) {
  const int tid = threadIdx.x;
  for (int b = 0; b < NB; ++b) {
    const __nv_bfloat16* xr = in + (size_t)b * K;
    __nv_bfloat16* sr = xs + (size_t)b * K;
    if (!RMS) {
      for (int k = tid; k < K; k += THREADS) sr[k] = xr[k];
      continue;
    }
    float ss = 0.f;
    for (int k = tid; k < K; k += THREADS) {
      const float v = bf2f(xr[k]);
      sr[k] = xr[k];
      ss += v * v;
    }
    ss = qtts::block_sum<THREADS>(ss, red);
    const float inv = 1.0f / sqrtf(ss / (float)K + eps);
    for (int k = tid; k < K; k += THREADS)
      sr[k] = __float2bfloat16_rn(
          __fmul_rn(__fmul_rn(bf2f(sr[k]), inv), norm_w[k]));
  }
  __syncthreads();
}

// dst[b, n] for n < N in the int8, w8a8 and bf16 modes: output column n
// (and n + N for the SwiGLU pair) of the (normed) input rows, then the
// epilogue.  wq: int8 [N(*R), K] (int8, w8a8) or bf16 (bf16), ws: f32.
template <int NB, bool RMS, int EPI, int MODE>
__global__ void __launch_bounds__(THREADS)
q8_gemv_kernel(const __nv_bfloat16* __restrict__ in,
               const float* __restrict__ norm_w, float eps, int K,
               const void* __restrict__ wq, const float* __restrict__ ws,
               int N, __nv_bfloat16* __restrict__ dst) {
  constexpr int R = EPI == EPI_SWIGLU ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(smem);  // [NB, K]
  int8_t* xq = reinterpret_cast<int8_t*>(                     // [NB, K]
      smem + (size_t)NB * K * sizeof(__nv_bfloat16));
  __shared__ float red[WARPS];
  __shared__ float sx_s[NB];

  const int tile = blockIdx.x;      // batch rows [tile * NB, tile * NB + NB)
  in += (size_t)tile * NB * K;
  dst += (size_t)tile * NB * N;
  if (MODE == MODE_W8A8)
    qtts::quantize_rows<NB, RMS, THREADS, false>(in, norm_w, K, eps, xs, xq,
                                                 sx_s, red);
  else
    norm_rows<NB, RMS>(in, norm_w, K, eps, xs, red);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.y * WARPS + warp;
  if (row >= N) return;  // warp-uniform; no block barrier follows
  float y[NB][R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const size_t col = (size_t)(row + r * N) * K;
    if (MODE == MODE_W8A8) {
      const int8_t* wrow = static_cast<const int8_t*>(wq) + col;
      int acc[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b] = 0;
      for (int k0 = lane * 16; k0 < K; k0 += 32 * 16) {
        const int4 wv = *reinterpret_cast<const int4*>(wrow + k0);
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const int4 xv =
              *reinterpret_cast<const int4*>(xq + (size_t)b * K + k0);
          acc[b] = __dp4a(wv.x, xv.x, acc[b]);
          acc[b] = __dp4a(wv.y, xv.y, acc[b]);
          acc[b] = __dp4a(wv.z, xv.z, acc[b]);
          acc[b] = __dp4a(wv.w, xv.w, acc[b]);
        }
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], o);
        // JAX: (f32(acc) * sx) * s, then bf16
        y[b][r] = bf16r(__fmul_rn(__fmul_rn((float)acc[b], sx_s[b]),
                                  ws[row + r * N]));
      }
    } else {
      float acc[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b] = 0.f;
      for (int k0 = lane * 16; k0 < K; k0 += 32 * 16) {
        float wf[16];
        if (MODE == MODE_INT8) {
          const uint4 wv = *reinterpret_cast<const uint4*>(
              static_cast<const int8_t*>(wq) + col + k0);
          const int8_t* w8 = reinterpret_cast<const int8_t*>(&wv);
#pragma unroll
          for (int j = 0; j < 16; ++j) wf[j] = (float)w8[j];
        } else {
          const uint4* wp = reinterpret_cast<const uint4*>(
              static_cast<const __nv_bfloat16*>(wq) + col + k0);
          const uint4 wa = wp[0], wb = wp[1];
          const __nv_bfloat162* h0 = reinterpret_cast<const __nv_bfloat162*>(&wa);
          const __nv_bfloat162* h1 = reinterpret_cast<const __nv_bfloat162*>(&wb);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f0 = __bfloat1622float2(h0[j]);
            const float2 f1 = __bfloat1622float2(h1[j]);
            wf[2 * j] = f0.x;
            wf[2 * j + 1] = f0.y;
            wf[8 + 2 * j] = f1.x;
            wf[8 + 2 * j + 1] = f1.y;
          }
        }
#pragma unroll
        for (int b = 0; b < NB; ++b) {
          const uint4* xv =
              reinterpret_cast<const uint4*>(xs + (size_t)b * K + k0);
          // the lane's 16 values in K order into one f32 sum (the order
          // kernels/talker_step.qmm8_lanes_plain repeats); bf16 x int8 and
          // bf16 x bf16 products are exact in f32
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const uint4 xa = xv[h];
            const __nv_bfloat162* x2 =
                reinterpret_cast<const __nv_bfloat162*>(&xa);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
              const float2 f = __bfloat1622float2(x2[j]);
              acc[b] = fmaf(f.x, wf[8 * h + 2 * j], acc[b]);
              acc[b] = fmaf(f.y, wf[8 * h + 2 * j + 1], acc[b]);
            }
          }
        }
      }
#pragma unroll
      for (int b = 0; b < NB; ++b) {
#pragma unroll
        for (int o = 16; o > 0; o >>= 1)
          acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], o);
        // JAX `_qmm`: bf16(dot) * bf16(s), a bf16 multiply
        y[b][r] = bf16r(__fmul_rn(bf16r(acc[b]), bf16r(ws[row + r * N])));
      }
    }
  }
  if (lane != 0) return;
#pragma unroll
  for (int b = 0; b < NB; ++b)
    epilogue<EPI, R>(dst + (size_t)b * N + row, y[b]);
}

// dst[b, n] for n < N: the w4a8 product of the (normed) input rows with
// output columns n (and n + N for the SwiGLU pair), then the epilogue
// (w4a8.cuh: quantize_rows, w4a8_warp_row).
template <int NB, bool RMS, int EPI>
__global__ void __launch_bounds__(THREADS)
w4a8_gemv_kernel(const __nv_bfloat16* __restrict__ in,
                 const float* __restrict__ norm_w, float eps, int K,
                 const uint8_t* __restrict__ wq,
                 const __nv_bfloat16* __restrict__ ws, int N,
                 __nv_bfloat16* __restrict__ dst) {
  constexpr int R = EPI == EPI_SWIGLU ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem[];
  int8_t* xq = reinterpret_cast<int8_t*>(smem);             // [NB, K]
  int* gd = reinterpret_cast<int*>(smem + (size_t)NB * K);  // [W, R, ng, NB]
  __nv_bfloat16* xs = reinterpret_cast<__nv_bfloat16*>(      // [NB, K]
      gd + (size_t)WARPS * R * (K / GROUP) * NB);
  __shared__ float red[WARPS];
  __shared__ float sx_s[NB];

  const int tile = blockIdx.x;      // batch rows [tile * NB, tile * NB + NB)
  in += (size_t)tile * NB * K;
  dst += (size_t)tile * NB * N;
  qtts::quantize_rows<NB, RMS, THREADS, false>(in, norm_w, K, eps, xs, xq,
                                               sx_s, red);

  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = blockIdx.y * WARPS + warp;
  if (row >= N) return;  // warp-uniform; no block barrier follows
  const int ng = K / GROUP;
  float y[R];
  qtts::w4a8_warp_row<NB, R>(xq, sx_s, K, wq, ws, N, row,
                             gd + (size_t)warp * R * ng * NB, y);
  if (lane >= NB) return;
  epilogue<EPI, R>(dst + (size_t)lane * N + row, y);
}

// Attention of one (kv head, lane) for the current token; see the header.
template <int DH>
__global__ void __launch_bounds__(DH)
step_attn_kernel(const __nv_bfloat16* __restrict__ qkv,
                 __nv_bfloat16* __restrict__ ctx, __nv_bfloat16* kc,
                 __nv_bfloat16* vc, __nv_bfloat16* __restrict__ k_tok,
                 __nv_bfloat16* __restrict__ v_tok,
                 const float* __restrict__ cos,
                 const float* __restrict__ sin, const float* __restrict__ qn,
                 const float* __restrict__ kn, const int* __restrict__ lengths,
                 const int* __restrict__ write_idx, int layer, int B, int H,
                 int Hkv, int C, int prompt_cap, float eps, float scale) {
  using qtts::MAX_G;
  const int kvh = blockIdx.x;
  const int b = blockIdx.y;
  const int t = threadIdx.x;
  const int G = H / Hkv;

  __shared__ float q_s[MAX_G][DH];
  __shared__ float x_s[MAX_G + 1][DH];
  __shared__ float p_s[MAX_G][DH];
  __shared__ float red_s[MAX_G][DH / 32];
  __shared__ float red[DH / 32];

  float kv, vv;
  qtts::norm_rope_heads<DH>(qkv + (size_t)b * (H + 2 * Hkv) * DH, H, Hkv,
                            kvh, G, qn, kn, cos + (size_t)b * DH,
                            sin + (size_t)b * DH, eps, q_s, x_s, red, &kv,
                            &vv);
#pragma unroll
  for (int g = 0; g < MAX_G; ++g)
    if (g < G) q_s[g][t] = __fmul_rn(q_s[g][t], scale);

  const int length = lengths[b];
  const int cursor = write_idx[b];
  const size_t head = ((size_t)layer * B + b) * Hkv + kvh;
  __nv_bfloat16* kp = kc + head * (size_t)C * DH;
  __nv_bfloat16* vp = vc + head * (size_t)C * DH;
  if (k_tok != nullptr) {             // per-lane mode: the token buffer
    k_tok[head * DH + t] = __float2bfloat16_rn(kv);
    v_tok[head * DH + t] = __float2bfloat16_rn(vv);
  } else if (cursor >= 0 && cursor < C) {
    kp[(size_t)cursor * DH + t] = __float2bfloat16_rn(kv);
    vp[(size_t)cursor * DH + t] = __float2bfloat16_rn(vv);
  }
  __syncthreads();

  float m[MAX_G], l[MAX_G], acc[MAX_G];
#pragma unroll
  for (int g = 0; g < MAX_G; ++g) {
    m[g] = qtts::NEG;
    l[g] = 0.f;
    acc[g] = 0.f;
  }
  // the live prefix [0, cursor): prompt slots < length, generated slots
  // >= prompt_cap
  qtts::attend_tiles<DH>(q_s, G, kp, vp, max(0, min(cursor, C)), length,
                         cursor, prompt_cap, 1.0f, p_s, red_s, m, l, acc);
  // the current token: one more column, always visible
  qtts::attend_current<DH>(q_s, G, kv, vv, m, l, acc, red,
                           ctx + ((size_t)b * H + kvh * G) * DH);
}

// One GEMV launch of mode MODE: wq / ws are the mode's weight and scale
// pointers (see the header).
template <int NB, bool RMS, int EPI, int MODE>
cudaError_t gemv(const __nv_bfloat16* in, const float* norm_w, float eps,
                 int K, const void* wq, const void* ws, int N,
                 __nv_bfloat16* dst, int tiles, cudaStream_t st) {
  constexpr int R = EPI == EPI_SWIGLU ? 2 : 1;
  const dim3 grid(tiles, (N + WARPS - 1) / WARPS);
  if (MODE == MODE_W4A8) {
    const size_t smem =
        (size_t)NB * K * (1 + sizeof(__nv_bfloat16)) +
        (size_t)WARPS * R * (K / GROUP) * NB * sizeof(int);
    auto kernel = w4a8_gemv_kernel<NB, RMS, EPI>;
    cudaError_t e = qtts::allow_smem(kernel, smem);
    if (e != cudaSuccess) return e;
    kernel<<<grid, THREADS, smem, st>>>(
        in, norm_w, eps, K, static_cast<const uint8_t*>(wq),
        static_cast<const __nv_bfloat16*>(ws), N, dst);
  } else {
    const size_t smem = (size_t)NB * K *
        (sizeof(__nv_bfloat16) + (MODE == MODE_W8A8 ? 1 : 0));
    auto kernel = q8_gemv_kernel<NB, RMS, EPI, MODE>;
    // the 48 KB default covers static + dynamic shared memory: count the
    // kernel's static red[] and sx_s[] (w8a8 at NB = 8, K = 2048 needs
    // exactly 48 KB of dynamic memory)
    cudaError_t e =
        qtts::allow_smem(kernel, smem + (WARPS + NB) * sizeof(float));
    if (e != cudaSuccess) return e;
    kernel<<<grid, THREADS, smem, st>>>(in, norm_w, eps, K, wq,
                                        static_cast<const float*>(ws), N,
                                        dst);
  }
  return cudaGetLastError();
}

// Bytes of one layer's weight matrix [N, K] and of its scales, by mode.
template <int MODE>
inline size_t w_bytes(size_t n, size_t k) {
  return MODE == MODE_W4A8 ? n * k / 2
         : MODE == MODE_BF16 ? n * k * 2 : n * k;
}
template <int MODE>
inline size_t s_bytes(size_t n, size_t k) {
  return MODE == MODE_W4A8 ? n * (k / GROUP) * 2 : n * 4;
}

template <int NB, int MODE>
cudaError_t run_step(const __nv_bfloat16* x, __nv_bfloat16* out,
                     const float* cos, const float* sin, const float* ln1,
                     const float* ln2, const float* qn, const float* kn,
                     const char* wqkv_q, const char* wqkv_s,
                     const char* wo_q, const char* wo_s,
                     const char* gu_q, const char* gu_s,
                     const char* dn_q, const char* dn_s,
                     __nv_bfloat16* kc, __nv_bfloat16* vc,
                     __nv_bfloat16* k_tok, __nv_bfloat16* v_tok,
                     const int* lengths, const int* write_idx,
                     __nv_bfloat16* qkv, __nv_bfloat16* ctx,
                     __nv_bfloat16* ff, int L, int B, int D, int H, int Hkv,
                     int DH, int F, int C, int prompt_cap, float eps,
                     float scale, cudaStream_t st) {
  const int dq = H * DH;
  const int nqkv = (H + 2 * Hkv) * DH;
  const int tiles = B / NB;
  cudaError_t e = cudaMemcpyAsync(out, x, (size_t)B * D * sizeof(*x),
                                  cudaMemcpyDeviceToDevice, st);
  for (int l = 0; l < L && e == cudaSuccess; ++l) {
    e = gemv<NB, true, EPI_STORE, MODE>(
        out, ln1 + (size_t)l * D, eps, D, wqkv_q + l * w_bytes<MODE>(nqkv, D),
        wqkv_s + l * s_bytes<MODE>(nqkv, D), nqkv, qkv, tiles, st);
    if (e != cudaSuccess) break;
    step_attn_kernel<128><<<dim3(Hkv, B), 128, 0, st>>>(
        qkv, ctx, kc, vc, k_tok, v_tok, cos, sin, qn + (size_t)l * DH,
        kn + (size_t)l * DH, lengths, write_idx, l, B, H, Hkv, C, prompt_cap,
        eps, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) break;
    e = gemv<NB, false, EPI_RESID, MODE>(
        ctx, nullptr, eps, dq, wo_q + l * w_bytes<MODE>(D, dq),
        wo_s + l * s_bytes<MODE>(D, dq), D, out, tiles, st);
    if (e != cudaSuccess) break;
    e = gemv<NB, true, EPI_SWIGLU, MODE>(
        out, ln2 + (size_t)l * D, eps, D, gu_q + l * w_bytes<MODE>(2 * F, D),
        gu_s + l * s_bytes<MODE>(2 * F, D), F, ff, tiles, st);
    if (e != cudaSuccess) break;
    e = gemv<NB, false, EPI_RESID, MODE>(
        ff, nullptr, eps, F, dn_q + l * w_bytes<MODE>(D, F),
        dn_s + l * s_bytes<MODE>(D, F), D, out, tiles, st);
  }
  return e;
}

}  // namespace

extern "C" int qtts_talker_step(
    const void* x, void* out, const float* cos, const float* sin,
    const float* ln1, const float* ln2, const float* qn, const float* kn,
    const void* wqkv_q, const void* wqkv_s, const void* wo_q,
    const void* wo_s, const void* gu_q, const void* gu_s, const void* dn_q,
    const void* dn_s, void* k_cache, void* v_cache, const int* lengths,
    const int* write_idx, void* qkv_buf, void* ctx_buf, void* ff_buf,
    void* k_tok, void* v_tok, int L, int B, int D, int H, int Hkv, int DH,
    int F, int C, int prompt_cap, int mode, float eps, float scale,
    void* stream) {
  // contraction dims: whole 256-row nibble groups (w4a8), whole 16-byte
  // int8 vectors (the other modes), at most 8192 (shared memory)
  const int kq = mode == MODE_W4A8 ? 2 * GROUP : 16;
  const bool batch_ok = (B >= 1 && B <= 4) || (B % 8 == 0 && B <= 96);
  if (!batch_ok || mode < MODE_W4A8 || mode > MODE_BF16 || DH != 128 ||
      Hkv <= 0 || H % Hkv != 0 || H / Hkv > qtts::MAX_G || D % kq != 0 ||
      (H * DH) % kq != 0 || F % kq != 0 || D > 8192 || H * DH > 8192 ||
      F > 8192 || C <= 0 || L <= 0)
    return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  auto bp = [](const void* p) { return static_cast<const bf*>(p); };
  auto cp = [](const void* p) { return static_cast<const char*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QTTS_STEP(NB, MODE)                                                  \
  run_step<NB, MODE>(bp(x), static_cast<bf*>(out), cos, sin, ln1, ln2, qn,   \
                     kn, cp(wqkv_q), cp(wqkv_s), cp(wo_q), cp(wo_s),          \
                     cp(gu_q), cp(gu_s), cp(dn_q), cp(dn_s),                  \
                     static_cast<bf*>(k_cache), static_cast<bf*>(v_cache),    \
                     static_cast<bf*>(k_tok), static_cast<bf*>(v_tok),        \
                     lengths, write_idx, static_cast<bf*>(qkv_buf),           \
                     static_cast<bf*>(ctx_buf), static_cast<bf*>(ff_buf), L,  \
                     B, D, H, Hkv, DH, F, C, prompt_cap, eps, scale, st)
#define QTTS_MODES(NB)                                                       \
  switch (mode) {                                                            \
    case MODE_W4A8: e = QTTS_STEP(NB, MODE_W4A8); break;                     \
    case MODE_INT8: e = QTTS_STEP(NB, MODE_INT8); break;                     \
    case MODE_W8A8: e = QTTS_STEP(NB, MODE_W8A8); break;                     \
    default: e = QTTS_STEP(NB, MODE_BF16); break;                            \
  }
  cudaError_t e;
  switch (B) {
    case 1: QTTS_MODES(1) break;
    case 2: QTTS_MODES(2) break;
    case 3: QTTS_MODES(3) break;
    case 4: QTTS_MODES(4) break;
    default: QTTS_MODES(8) break;         // B % 8 == 0: B / 8 row tiles
  }
#undef QTTS_MODES
#undef QTTS_STEP
  return (int)e;
}
