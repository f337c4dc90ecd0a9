// One talker decode step over all layers, w4a8, for Hopper.
//
// Replaces: qwen3_tts_tpu/kernels/talker_step.py talker_step_fused (the
// Pallas TPU kernel) in its default weight mode "w4a8", at the JAX gate's
// decode batches: B <= 4, or B % 8 == 0 up to 96; one cursor per lane.
// Contract: x [B, D] bf16 in; out [B, D] bf16 = the hidden state BEFORE
// the final norm.  The current token's k/v row of every layer goes either
// IN PLACE into the k/v caches [L, B, Hkv, C, Dh] bf16 at slot
// write_idx[b] (uniform mode: k_tok == nullptr), or into the token buffers
// k_tok / v_tok [L, B, Hkv, Dh] (per-lane mode, continuous batching), from
// which the caller's one append_kv_lanes launch (kv_lanes.cu) writes them,
// as the JAX kernel does.  Either way attention reads only slots below
// write_idx[b] and takes the current token from registers, so the two
// modes compute the same numbers.  Numerics follow the Pallas kernel op
// for op (see kernels/talker_step.py): per-row int8 activations, exact
// integer dots per 128-row group, groups summed in f32 in the JAX order
// with the bf16 scales.  Every lane's arithmetic is that of B = 1, so a
// lane's outputs are bit-equal to the one-lane kernel's on its inputs.
//
// Weights (ops/quant.py pack_int4): per matrix uint8 [L, N, K/2], output
// column n's K values contiguous, each 4-byte word holding K rows 8m..8m+3
// in its low nibbles and 8m+4..8m+7 in its high nibbles; scales bf16
// [L, N, K/128].
//
// What bounds it on the card: bytes.  A step reads 0.70 GB of int4 weights
// and 22 MB of scales at full width (28 layers, d 2048, d_ff 6144), about
// 0.22 ms at 3.35 TB/s, against ~1.4 Gop of int8 dot work, far below the
// card's rates; attention adds the live KV prefix.
//
// What the design does about it: weights are read once, as 16-byte vectors
// along each output column, with the int4 nibbles unpacked in registers
// (__vsub4 sign extension) into __dp4a dot products against int8
// activations in shared memory; no weight is dequantized to memory.
// Batch rows run in tiles of NB <= 8 (NB = B for B <= 4, else 8): a GEMV
// block quantizes its tile's rows into shared memory (NB * K * 3 bytes +
// the group dots: 159 KB at K = 6144, NB = 8; 16 rows would not fit in
// 227 KB), and grid.x runs over the B / NB tiles, so the tiles that read
// one block of weight columns are neighbours in launch order and mostly
// meet those weights in L2.  Per layer there are five launches on the
// caller's stream:
//   qkv     w4a8 GEMV whose prologue recomputes RMSNorm(x) and the int8
//           quantization of the row in every block (2048 values: cheaper
//           than a launch) -> qkv [B, Nqkv] bf16;
//   attn    one block per (kv head, lane), serving its G query heads from
//           one K/V read: q/k RMSNorm, rope, the k/v write, the
//           live-prefix loop of flash_decode.cu (common.cuh attend_tiles)
//           and the current token as one more column from registers;
//   wo      w4a8 GEMV + residual add into out;
//   gate_up w4a8 GEMV with RMSNorm prologue, a warp owning columns j and
//           j + d_ff, SwiGLU epilogue -> ff [B, d_ff] bf16;
//   down    w4a8 GEMV + residual add into out.
// A warp owns one output column (or pair); its lanes cover 8 groups per
// 512-byte sweep, four lanes per group, and the group dots (exact int32)
// are summed in f32 by one lane per batch row in the JAX order.  This is
// simple first: the serial group sum, the 2048-row prologue repeated by
// every block, and 140 launches per step are what a faster version
// removes (a persistent kernel with TMA weight streaming).

#include "w4a8.cuh"

namespace {

using qtts::bf16r;
using qtts::bf2f;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int GROUP = qtts::W4_GROUP;

enum { EPI_STORE = 0, EPI_RESID = 1, EPI_SWIGLU = 2 };

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
  __nv_bfloat16* o = dst + (size_t)lane * N + row;
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

template <int NB, bool RMS, int EPI>
cudaError_t gemv(const __nv_bfloat16* in, const float* norm_w, float eps,
                 int K, const uint8_t* wq, const __nv_bfloat16* ws, int N,
                 __nv_bfloat16* dst, int tiles, cudaStream_t st) {
  constexpr int R = EPI == EPI_SWIGLU ? 2 : 1;
  const size_t smem =
      (size_t)NB * K * (1 + sizeof(__nv_bfloat16)) +
      (size_t)WARPS * R * (K / GROUP) * NB * sizeof(int);
  auto kernel = w4a8_gemv_kernel<NB, RMS, EPI>;
  cudaError_t e = qtts::allow_smem(kernel, smem);
  if (e != cudaSuccess) return e;
  kernel<<<dim3(tiles, (N + WARPS - 1) / WARPS), THREADS, smem, st>>>(
      in, norm_w, eps, K, wq, ws, N, dst);
  return cudaGetLastError();
}

template <int NB>
cudaError_t run_step(const __nv_bfloat16* x, __nv_bfloat16* out,
                     const float* cos, const float* sin, const float* ln1,
                     const float* ln2, const float* qn, const float* kn,
                     const uint8_t* wqkv_q, const __nv_bfloat16* wqkv_s,
                     const uint8_t* wo_q, const __nv_bfloat16* wo_s,
                     const uint8_t* gu_q, const __nv_bfloat16* gu_s,
                     const uint8_t* dn_q, const __nv_bfloat16* dn_s,
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
    e = gemv<NB, true, EPI_STORE>(out, ln1 + (size_t)l * D, eps, D,
                                  wqkv_q + (size_t)l * nqkv * (D / 2),
                                  wqkv_s + (size_t)l * nqkv * (D / GROUP),
                                  nqkv, qkv, tiles, st);
    if (e != cudaSuccess) break;
    step_attn_kernel<128><<<dim3(Hkv, B), 128, 0, st>>>(
        qkv, ctx, kc, vc, k_tok, v_tok, cos, sin, qn + (size_t)l * DH,
        kn + (size_t)l * DH, lengths, write_idx, l, B, H, Hkv, C, prompt_cap,
        eps, scale);
    e = cudaGetLastError();
    if (e != cudaSuccess) break;
    e = gemv<NB, false, EPI_RESID>(ctx, nullptr, eps, dq,
                                   wo_q + (size_t)l * D * (dq / 2),
                                   wo_s + (size_t)l * D * (dq / GROUP), D,
                                   out, tiles, st);
    if (e != cudaSuccess) break;
    e = gemv<NB, true, EPI_SWIGLU>(out, ln2 + (size_t)l * D, eps, D,
                                   gu_q + (size_t)l * 2 * F * (D / 2),
                                   gu_s + (size_t)l * 2 * F * (D / GROUP), F,
                                   ff, tiles, st);
    if (e != cudaSuccess) break;
    e = gemv<NB, false, EPI_RESID>(ff, nullptr, eps, F,
                                   dn_q + (size_t)l * D * (F / 2),
                                   dn_s + (size_t)l * D * (F / GROUP), D, out,
                                   tiles, st);
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
    int F, int C, int prompt_cap, float eps, float scale, void* stream) {
  const int g2 = 2 * GROUP;
  const bool batch_ok = (B >= 1 && B <= 4) || (B % 8 == 0 && B <= 96);
  if (!batch_ok || DH != 128 || Hkv <= 0 || H % Hkv != 0 ||
      H / Hkv > qtts::MAX_G || D % g2 != 0 || (H * DH) % g2 != 0 ||
      F % g2 != 0 || C <= 0 || L <= 0)
    return (int)cudaErrorInvalidValue;
  using bf = __nv_bfloat16;
  auto bp = [](const void* p) { return static_cast<const bf*>(p); };
  auto up = [](const void* p) { return static_cast<const uint8_t*>(p); };
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define QTTS_STEP(NB)                                                        \
  run_step<NB>(bp(x), static_cast<bf*>(out), cos, sin, ln1, ln2, qn, kn,      \
               up(wqkv_q), bp(wqkv_s), up(wo_q), bp(wo_s), up(gu_q),          \
               bp(gu_s), up(dn_q), bp(dn_s), static_cast<bf*>(k_cache),       \
               static_cast<bf*>(v_cache), static_cast<bf*>(k_tok),            \
               static_cast<bf*>(v_tok), lengths, write_idx,                   \
               static_cast<bf*>(qkv_buf), static_cast<bf*>(ctx_buf),          \
               static_cast<bf*>(ff_buf), L, B, D, H, Hkv, DH, F, C,           \
               prompt_cap, eps, scale, st)
  cudaError_t e;
  switch (B) {
    case 1: e = QTTS_STEP(1); break;
    case 2: e = QTTS_STEP(2); break;
    case 3: e = QTTS_STEP(3); break;
    case 4: e = QTTS_STEP(4); break;
    default: e = QTTS_STEP(8); break;     // B % 8 == 0: B / 8 row tiles
  }
#undef QTTS_STEP
  return (int)e;
}
