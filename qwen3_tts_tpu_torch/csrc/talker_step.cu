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
// for op (see kernels/talker_step.py); the f32 sums of the norms and of
// attention run in the orders of kernels/chunk_step.py KERNEL_ORDERS.
// Every lane's arithmetic is that of B = 1, so a lane's outputs are
// bit-equal to the one-lane kernel's on its inputs, in every mode.
//
// Weights (kernels/talker_step.prep_layer_weights), output-major (output
// column n's K values contiguous):
//   w4a8  uint8 [L, N, K/2] (ops/quant.py pack_int4), bf16 scales
//         [L, N, K/128]: per-row int8 activations, exact integer dots per
//         128-row group, groups summed in f32 in the JAX order;
//   int8  int8 [L, N, K], f32 scales [L, N]: y = bf16(bf16(sum x*q in f32)
//         * bf16(s)), lane l of a warp adding the 16 products
//         [512 s + 16 l, +16) of each sweep s in K order, then the warp's
//         butterfly (talker_step.qmm8_lanes_plain);
//   w8a8  the int8 weights, per-row int8 activations: one exact int32 dot,
//         y = bf16(f32(acc) * sx * s);
//   bf16  bf16(q * s) [L, N, K] with unit f32 scales: the int8 mode's dot.
//
// What bounds it on the card: bytes.  At full width (28 layers, d 2048,
// d_ff 6144) a step reads 0.70 GB of int4 weights and 22 MB of scales in
// w4a8 (0.22 ms at 3.35 TB/s), 1.41 GB in int8 and w8a8 (0.42 ms), 2.82 GB
// in bf16 (0.84 ms); attention adds each lane's live KV prefix.  At B
// lanes every block also reads each GEMV input row (B x K bytes) from L2.
//
// The design: ONE cooperative launch per step, a persistent grid (one
// 256-thread block per SM, ~200 KB of dynamic shared memory) that runs
// seven phases per layer separated by grid barriers (gemv_stream.cuh):
//   norm1   block b (< B) RMS-normalises lane b's residual row (256
//           threads: w4a8.cuh quantize_rows, the order of KERNEL_ORDERS
//           "rms") and writes it once, as int8 + scale (w4a8, w8a8) or bf16
//           (int8, bf16): no GEMV block repeats it;
//   qkv     GEMV -> qkv [B, Nqkv] bf16;
//   attn    split-prefix attention: work items (lane, kv head, 64-slot
//           split of the lane's prefix [0, write_idx)), one warp each over
//           the whole grid (split_attn.cuh, as chunk_step.cu talker_attn):
//           q/k norm and rope, scores, the split's softmax and P.V; the
//           warp that finishes an item's last split (an arrival counter)
//           combines the splits in split order, writes the token's k/v row,
//           merges the current token from registers, writes the context
//           row and raises the lane's running max |ctx| (atomicMax);
//   wo      GEMV (input quantized as it is staged, from that max) +
//           residual;
//   norm2   as norm1;
//   gate_up GEMV, a warp owning the gate tile and its up tile, SwiGLU ->
//           ff [B, d_ff] bf16, raising the lane's max |ff|;
//   down    GEMV + residual.
// A GEMV phase gives each block a contiguous range of 8-column output
// tiles.  The block stages the lanes' input rows in shared memory (16 at a
// time, 32 above 16 lanes), and its warps run the tiles on the tensor
// cores (w4a8 / w8a8: mma.sync m16n8k32 s8, the int4 nibbles unpacked in
// registers; gemv_stream.cuh), the lanes as the M rows, so every lane
// shares one read of each weight byte; with fewer tiles than warps (up to
// 16 lanes) each tile's K range is split over warps, the w4a8 group dots
// kept exact in shared memory and summed in the JAX order by one warp.  The
// int8 and bf16 modes keep a warp per output column with the lane order
// above, 8 rows a pass.  196 barriers per step at full depth; no host sync.
// Measured (PERF.md): a phase is a chain of dependent memory round trips
// (~1 us each) plus a ~1 us barrier; a bulk L2 prefetch of the next phase's
// weights, issued a phase ahead, gained nothing and cost 2-4 us to issue,
// so there is none.

#include "gemv_stream.cuh"
#include "split_attn.cuh"

namespace {

using bf16 = __nv_bfloat16;
using qtts::bf16r;
using qtts::bf2f;
using qtts::SPLIT;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int GROUP = qtts::W4_GROUP;
constexpr int DH = 128;
constexpr int MAX_B = 96;
constexpr int KINDS = 7;                  // phases per layer
constexpr size_t SMEM_A = 200 * 1024;     // staged GEMV rows
constexpr int N_PTRS = 33, N_INTS = 10, N_FLTS = 2;

enum { K_NORM1, K_QKV, K_ATTN, K_WO, K_NORM2, K_GU, K_DN };
enum { M_QKV, M_WO, M_GU, M_DN };
enum { EPI_STORE = 0, EPI_RESID = 1, EPI_SWIGLU = 2 };
// kernels/talker_step.MODES
enum { MODE_W4A8 = 0, MODE_INT8 = 1, MODE_W8A8 = 2, MODE_BF16 = 3 };

struct Args {
  const bf16* x;
  bf16* out;                       // the residual stream, then the result
  const float *cos, *sin, *ln1, *ln2, *qn, *kn;
  const char *wq[4], *ws[4];       // qkv, wo, gate_up, down
  bf16 *kc, *vc, *k_tok, *v_tok;
  const int *lengths, *write_idx;
  // scratch (kernels/talker_step.step_scratch)
  bf16 *qkv, *ctx, *ff, *hn;       // hn: normed rows [B, D] (int8, bf16)
  int8_t* xq;                      // normed rows quantized [B, D]
  float* sx;                       // their scales [B]
  unsigned* amax;                  // [L, 2, B] max |ctx|, max |ff| (f32 bits)
  float* part;                     // split partials (attn_phase)
  unsigned* arrive;                // [B * Hkv], 0 between phases
  unsigned* barrier;               // [2], 0 between launches
  long long* trace;                // optional: block 0's phase clocks
  int L, B, D, H, Hkv, F, C, prompt_cap, mode, max_blocks;
  float eps, scale;
};

struct Small {
  float sx[32];                    // the staged rows' scales
  unsigned amax[32];               // the staged rows' running max |ff|
  float red[WARPS];
  int cum[MAX_B + 1];              // attention items before lane b
};

template <int MODE>
__host__ __device__ inline size_t w_bytes(size_t n, size_t k) {
  return MODE == MODE_W4A8 ? n * k / 2 : MODE == MODE_BF16 ? n * k * 2 : n * k;
}
template <int MODE>
__host__ __device__ inline size_t s_bytes(size_t n, size_t k) {
  return MODE == MODE_W4A8 ? n * (k / GROUP) * 2 : n * 4;
}

// (N, K, R) of matrix m: N output columns (per half of the SwiGLU pair)
__device__ inline void mat_shape(const Args& a, int m, int& n, int& k,
                                 int& r) {
  const int nqkv = (a.H + 2 * a.Hkv) * DH, dq = a.H * DH;
  n = m == M_QKV ? nqkv : m == M_GU ? a.F : a.D;
  k = m == M_WO ? dq : m == M_DN ? a.F : a.D;
  r = m == M_GU ? 2 : 1;
}

// This block's slice of matrix m of layer l into L2.
// ------------------------------------------------------------------- norms
// norm1 / norm2 of layer l: lane b's row on block b (grid-stride) through
// quantize_rows (256 threads: KERNEL_ORDERS "rms"), into xq / sx and, for
// the int8 and bf16 modes, hn.  Layer 0's norm1 also copies x into out.
template <int MODE>
__device__ void norm_phase(const Args& a, int l, bool first,
                           unsigned char* smem, Small& sm) {
  bf16* xs = reinterpret_cast<bf16*>(smem);
  const float* w = (first ? a.ln1 : a.ln2) + (size_t)l * a.D;
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const bool in = l == 0 && first;
    const bf16* src = (in ? a.x : a.out) + (size_t)b * a.D;
    if (in)
      for (int k = threadIdx.x; k < a.D; k += THREADS)
        a.out[(size_t)b * a.D + k] = src[k];
    qtts::quantize_rows<1, true, THREADS, true>(
        src, w, a.D, a.eps, xs, a.xq + (size_t)b * a.D, a.sx + b, sm.red);
    if (MODE == MODE_INT8 || MODE == MODE_BF16)
      for (int k = threadIdx.x; k < a.D; k += THREADS)
        a.hn[(size_t)b * a.D + k] = xs[k];
    __syncthreads();                // xs is rewritten by the next lane
  }
}

// ------------------------------------------------------------------- GEMVs
// Stage rows [r0, r0 + nr) of the phase's input into A.
// w4a8 / w8a8: int8 rows (stride lda), their scales in sm.sx: the norm's
// xq / sx by cp.async, or (wo, down) bf16 rows quantized as they are
// loaded with sx = max(amax, 1e-8) * f32(1/127) (quantize_rows' numbers).
// int8 / bf16: bf16 rows by cp.async.
template <int MODE>
__device__ void stage_rows(const Args& a, int l, int m, int K, int r0, int nr,
                           unsigned char* A, int lda, Small& sm) {
  const int tid = threadIdx.x;
  const bool quant = MODE == MODE_W4A8 || MODE == MODE_W8A8;
  const bf16* src = m == M_WO ? a.ctx : m == M_DN ? a.ff : a.hn;
  if (quant && (m == M_QKV || m == M_GU)) {
    const int per = K / 16;
    for (int i = tid; i < nr * per; i += THREADS) {
      const int row = i / per, c = i % per;
      qtts::cp_async16(A + (size_t)row * lda + 16 * c,
                       a.xq + (size_t)(r0 + row) * K + 16 * c, 16);
    }
    qtts::cp_async_commit();
    if (tid < nr) sm.sx[tid] = __ldcg(a.sx + r0 + tid);
    qtts::cp_async_wait<0>();
  } else if (quant) {
    const unsigned* am = a.amax + ((size_t)l * 2 + (m == M_DN)) * a.B;
    if (tid < nr)
      sm.sx[tid] = __fmul_rn(fmaxf(__uint_as_float(__ldcg(am + r0 + tid)),
                                   1e-8f), qtts::INV127);
    __syncthreads();
    // UQ 16-byte loads of each thread in flight, then their quantization
    constexpr int UQ = 8;
    const int per = K / 8, total = nr * per;
    for (int i0 = tid; i0 < total; i0 += UQ * THREADS) {
      uint4 u[UQ];
#pragma unroll
      for (int q = 0; q < UQ; ++q) {
        const int i = i0 + q * THREADS;
        u[q] = i < total ? __ldcg(reinterpret_cast<const uint4*>(
                               src + (size_t)(r0 + i / per) * K +
                               8 * (i % per)))
                         : make_uint4(0u, 0u, 0u, 0u);
      }
#pragma unroll
      for (int q = 0; q < UQ; ++q) {
        const int i = i0 + q * THREADS;
        if (i >= total) break;
        const int row = i / per, c = i % per;
        const __nv_bfloat162* h =
            reinterpret_cast<const __nv_bfloat162*>(&u[q]);
        const float s = sm.sx[row];
        uint32_t w2[2] = {0u, 0u};
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float2 f = __bfloat1622float2(h[j]);
          const uint32_t lo = (uint8_t)(int8_t)rintf(__fdiv_rn(f.x, s));
          const uint32_t hi = (uint8_t)(int8_t)rintf(__fdiv_rn(f.y, s));
          w2[j >> 1] |= (lo | hi << 8) << (16 * (j & 1));
        }
        *reinterpret_cast<uint2*>(A + (size_t)row * lda + 8 * c) =
            make_uint2(w2[0], w2[1]);
      }
    }
  } else {
    const int per = K / 8;
    for (int i = tid; i < nr * per; i += THREADS) {
      const int row = i / per, c = i % per;
      qtts::cp_async16(A + (size_t)row * lda + 16 * c,
                       src + (size_t)(r0 + row) * K + 8 * c, 16);
    }
    qtts::cp_async_commit();
    qtts::cp_async_wait<0>();
  }
}

// One output element (row b of the batch, column n) from its value(s) y.
template <int EPI, int R>
__device__ __forceinline__ void epilogue(const Args& a, int l, int b, int n,
                                         const float* y, Small& sm,
                                         int row) {
  if (EPI == EPI_STORE) {
    const int nqkv = (a.H + 2 * a.Hkv) * DH;
    a.qkv[(size_t)b * nqkv + n] = __float2bfloat16_rn(y[0]);
  } else if (EPI == EPI_RESID) {
    bf16* o = a.out + (size_t)b * a.D + n;
    const float r = qtts::ld_bf<true>(o);
    *o = __float2bfloat16_rn(__fadd_rn(r, y[0]));
  } else {
    const float gate = y[0];
    const float act = bf16r(__fdiv_rn(gate, 1.0f + expf(-gate)));
    const bf16 v = __float2bfloat16_rn(__fmul_rn(act, y[R - 1]));
    a.ff[(size_t)b * a.F + n] = v;
    atomicMax(&sm.amax[row], __float_as_uint(fabsf(bf2f(v))));
  }
}

// The w4a8 / w8a8 tiles [t0, t1) of this block on the staged rows.  With
// fewer tiles than warps (and MT = 1) each tile's K range is split over
// ks warps: w4a8 keeps each group's exact int32 dot in shared memory
// (`dots`) and the tile's first warp adds them in the JAX order (the
// bits of the unsplit sum); w8a8 adds the warps' int32 partial dots.
template <int MODE, int MT, int R, int EPI>
__device__ void mma_tiles(const Args& a, int l, int m, int N, int K, int t0,
                          int t1, int r0, int nr, const unsigned char* A,
                          int lda, int* dots, Small& sm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const char* wq = a.wq[m] + l * w_bytes<MODE>((size_t)N * R, K);
  const char* ws = a.ws[m] + l * s_bytes<MODE>((size_t)N * R, K);
  const int nt = t1 - t0;
  const int span = MODE == MODE_W4A8 ? K / (2 * GROUP) : K / 64;
  const int ks = (MT == 1 && dots != nullptr) ? qtts::k_split(nt, WARPS, span)
                                              : 1;
  // ks > 1: warp w takes tile t0 + w / ks, K share w % ks, one unit each
  const int units = ks > 1 ? nt * ks : nt;
  float y[R][MT][4];
  int dsum[R][MT][4];
  for (int u = warp; u < (ks > 1 ? WARPS : units); u += WARPS) {
    const bool live = u < units;
    const int tile = t0 + (ks > 1 ? u / ks : u), part = ks > 1 ? u % ks : 0;
    const int n0 = 8 * tile;
    // the residual's values, loaded before the products
    float res[MT][4];
    if (EPI == EPI_RESID && live && part == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * mt + g + 8 * (e >> 1);
          res[mt][e] = row < nr ? qtts::ld_bf<true>(
                                      a.out + (size_t)(r0 + row) * a.D + n0 +
                                      2 * t + (e & 1))
                                : 0.f;
        }
    }
    const int p0 = part * span / ks, p1 = (part + 1) * span / ks;
    int* tdots = dots != nullptr && ks > 1
                     ? dots + (size_t)(u / ks) * R * (MODE == MODE_W4A8
                                                          ? K / GROUP * 128
                                                          : ks * 128)
                     : nullptr;
    if (live) {
      if constexpr (MODE == MODE_W4A8) {
        qtts::w4a8_tile<MT, R>(A, lda, nr,
                               reinterpret_cast<const uint8_t*>(wq),
                               reinterpret_cast<const bf16*>(ws), N, K, n0,
                               p0, p1, y, tdots);
      } else {
        qtts::w8a8_tile<MT, R>(A, lda, nr, reinterpret_cast<const int8_t*>(wq),
                               N, K, n0, p0, p1, dsum);
        if (tdots != nullptr) {
#pragma unroll
          for (int r = 0; r < R; ++r)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              tdots[((r * ks + part) * 4 + e) * 32 + lane] = dsum[r][0][e];
        }
      }
    }
    if (ks > 1) {
      __syncthreads();                    // every share of every tile
      if (!live || part != 0) continue;
      if constexpr (MODE == MODE_W4A8) {
        float acc1[R][1][4];
        qtts::w4a8_sum_dots<R>(tdots, reinterpret_cast<const bf16*>(ws), N,
                               K, n0, acc1);
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) y[r][0][e] = acc1[r][0][e];
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            int v = 0;
            for (int j = 0; j < ks; ++j)
              v += tdots[((r * ks + j) * 4 + e) * 32 + lane];
            dsum[r][0][e] = v;
          }
      }
    }
    if constexpr (MODE == MODE_W4A8) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * mt + g + 8 * (e >> 1);
          const float sx = row < nr ? sm.sx[row] : 0.f;
#pragma unroll
          for (int r = 0; r < R; ++r)
            y[r][mt][e] = bf16r(__fmul_rn(y[r][mt][e], sx));
        }
    } else {
      const float* s = reinterpret_cast<const float*>(ws);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * mt + g + 8 * (e >> 1);
          const float sx = row < nr ? sm.sx[row] : 0.f;
#pragma unroll
          for (int r = 0; r < R; ++r)
            // JAX: (f32(acc) * sx) * s, then bf16
            y[r][mt][e] = bf16r(__fmul_rn(
                __fmul_rn((float)dsum[r][mt][e], sx),
                s[n0 + r * N + 2 * t + (e & 1)]));
        }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * mt + g + 8 * (e >> 1);
        if (row >= nr) continue;
        if (EPI == EPI_RESID) {
          a.out[(size_t)(r0 + row) * a.D + n0 + 2 * t + (e & 1)] =
              __float2bfloat16_rn(__fadd_rn(res[mt][e], y[0][mt][e]));
          continue;
        }
        float v[R];
#pragma unroll
        for (int r = 0; r < R; ++r) v[r] = y[r][mt][e];
        epilogue<EPI, R>(a, l, r0 + row, n0 + 2 * t + (e & 1), v, sm, row);
      }
  }
}

// The int8 and bf16 modes: a warp per output column (and its SwiGLU
// partner), the rows of the pass (<= 8) from A (bf16, stride lda bytes).
template <int MODE, int R, int EPI>
__device__ void lane_cols(const Args& a, int l, int m, int N, int K, int t0,
                          int t1, int r0, int nr, const unsigned char* A,
                          int lda, Small& sm) {
  constexpr int NB = 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const char* wq = a.wq[m] + l * w_bytes<MODE>((size_t)N * R, K);
  const float* ws = reinterpret_cast<const float*>(
      a.ws[m] + l * s_bytes<MODE>((size_t)N * R, K));
  for (int col = 8 * t0 + warp; col < 8 * t1; col += WARPS) {
    float y[NB][R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const size_t c = (size_t)(col + r * N);
      float acc[NB];
#pragma unroll
      for (int b = 0; b < NB; ++b) acc[b] = 0.f;
      for (int k0 = lane * 16; k0 < K; k0 += 32 * 16) {
        float wf[16];
        if constexpr (MODE == MODE_INT8) {
          const uint4 wv = qtts::ld_w(wq + c * K + k0);
          const int8_t* w8 = reinterpret_cast<const int8_t*>(&wv);
#pragma unroll
          for (int j = 0; j < 16; ++j) wf[j] = (float)w8[j];
        } else {
          const bf16* wp = reinterpret_cast<const bf16*>(wq) + c * K + k0;
          const uint4 wa = qtts::ld_w(wp), wb = qtts::ld_w(wp + 8);
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
          if (b >= nr) break;
          const uint4* xv = reinterpret_cast<const uint4*>(
              A + (size_t)b * lda + (size_t)k0 * 2);
          // the lane's 16 values in K order into one f32 sum; bf16 x int8
          // and bf16 x bf16 products are exact in f32
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
        y[b][r] = bf16r(__fmul_rn(bf16r(acc[b]), bf16r(ws[c])));
      }
    }
    if (lane != 0) continue;
#pragma unroll
    for (int b = 0; b < NB; ++b)
      if (b < nr) epilogue<EPI, R>(a, l, r0 + b, col, y[b], sm, b);
  }
}

template <int MODE, int R, int EPI>
__device__ void gemv_phase(const Args& a, int l, int m, unsigned char* A,
                           Small& sm) {
  int N, K, r;
  mat_shape(a, m, N, K, r);
  int t0, t1;
  qtts::tile_range(N / 8, t0, t1);
  if (t0 >= t1) return;
  constexpr bool quant = MODE == MODE_W4A8 || MODE == MODE_W8A8;
  const int lda = quant ? K + (MODE == MODE_W4A8 ? 16 : 64) : 2 * K + 16;
  // up to 16 lanes one m16 tile, with room for the K split's dots; more
  // lanes in passes of two m16 tiles (32 rows) when they fit
  const int rp = quant ? (a.B > 16 && (size_t)32 * lda <= SMEM_A ? 32 : 16)
                       : 8;
  const size_t dot_bytes =
      (size_t)(t1 - t0) * r * 512 * (MODE == MODE_W4A8 ? K / GROUP : WARPS);
  int* dots = quant && rp == 16 && (size_t)16 * lda + dot_bytes <= SMEM_A
                  ? reinterpret_cast<int*>(A + (size_t)16 * lda)
                  : nullptr;
  for (int r0 = 0; r0 < a.B; r0 += rp) {
    const int nr = min(rp, a.B - r0);
    if (EPI == EPI_SWIGLU && threadIdx.x < 32) sm.amax[threadIdx.x] = 0u;
    stage_rows<MODE>(a, l, m, K, r0, nr, A, lda, sm);
    __syncthreads();
    if constexpr (!quant)
      lane_cols<MODE, R, EPI>(a, l, m, N, K, t0, t1, r0, nr, A, lda, sm);
    else if (nr > 16)
      mma_tiles<MODE, 2, R, EPI>(a, l, m, N, K, t0, t1, r0, nr, A, lda,
                                 nullptr, sm);
    else
      mma_tiles<MODE, 1, R, EPI>(a, l, m, N, K, t0, t1, r0, nr, A, lda, dots,
                                 sm);
    __syncthreads();                  // A is restaged by the next pass
    if (EPI == EPI_SWIGLU && quant && threadIdx.x < nr)
      atomicMax(a.amax + ((size_t)l * 2 + 1) * a.B + r0 + threadIdx.x,
                sm.amax[threadIdx.x]);
  }
}

// --------------------------------------------------------------- attention
// sm.cum[b]: the attention items (kv head, split) of lanes before b.
__device__ void count_items(const Args& a, Small& sm) {
  if (threadIdx.x == 0) {
    sm.cum[0] = 0;
    for (int b = 0; b < a.B; ++b) {
      const int end = max(0, min(a.write_idx[b], a.C));
      sm.cum[b + 1] = sm.cum[b] + a.Hkv * max(1, (end + SPLIT - 1) / SPLIT);
    }
  }
  __syncthreads();
}

// Items (lane b, kv head, split s of the lane's prefix [0, end_b), end_b =
// min(write_idx[b], C), ns_b = max(1, ceil(end_b / SPLIT)) splits), one
// warp each over the grid: the q/k norms and rope of the item's heads
// (qk_warp), then split_attn.cuh's split_item (a split's softmax and P.V,
// the last arriver's combine in split order, the token's k/v row written
// at cache slot write_idx[b] or into the token buffers, the current token
// merged last).  The merging warp writes the context row and raises the
// lane's max |ctx|.
template <int CG>
__device__ void attn_phase(const Args& a, int l, unsigned char* smem,
                           Small& sm) {
  using W = qtts::SplitWarp<CG>;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  W& w = reinterpret_cast<W*>(smem)[warp];
  const int G = a.H / a.Hkv;
  const int nqkv = (a.H + 2 * a.Hkv) * DH, dq = a.H * DH;
  const int nsmax = (a.C + SPLIT - 1) / SPLIT;
  count_items(a, sm);
  const size_t n_rows = (size_t)a.B * a.Hkv * nsmax * G;
  const qtts::SplitParts sp{a.part, a.part + n_rows * DH, a.arrive, nsmax};
  const int n_items = sm.cum[a.B];
  for (int it = blockIdx.x + warp * gridDim.x; it < n_items;
       it += gridDim.x * WARPS) {
    int b = 0;
    while (sm.cum[b + 1] <= it) ++b;
    const int cursor = a.write_idx[b];
    const int end = max(0, min(cursor, a.C));
    const int ns = max(1, (end + SPLIT - 1) / SPLIT);
    const int kvh = (it - sm.cum[b]) / ns, s = (it - sm.cum[b]) % ns;
    const size_t head = ((size_t)l * a.B + b) * a.Hkv + kvh;
    bf16* kp = a.kc + head * a.C * DH;
    bf16* vp = a.vc + head * a.C * DH;
    qtts::qk_warp(a.qkv + (size_t)b * nqkv, a.H, a.Hkv, kvh, G,
                  a.qn + (size_t)l * DH, a.kn + (size_t)l * DH,
                  a.cos + (size_t)b * DH, a.sin + (size_t)b * DH, a.eps,
                  a.scale, w);
    const bool in = cursor >= 0 && cursor < a.C;
    bf16* kd = a.k_tok != nullptr ? a.k_tok + head * DH
               : in ? kp + (size_t)cursor * DH : nullptr;
    bf16* vd = a.k_tok != nullptr ? a.v_tok + head * DH
               : in ? vp + (size_t)cursor * DH : nullptr;
    float o[CG][4];
    if (!qtts::split_item(w, G, kp, vp, end, a.lengths[b], a.prompt_cap, s,
                          ns, b * a.Hkv + kvh, sp, kd, vd, o))
      continue;
    float amx = 0.f;
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      if (g >= G) continue;
      __nv_bfloat162 o2[2];
      o2[0] = __floats2bfloat162_rn(o[g][0], o[g][1]);
      o2[1] = __floats2bfloat162_rn(o[g][2], o[g][3]);
      *reinterpret_cast<uint2*>(a.ctx + (size_t)b * dq +
                                ((size_t)kvh * G + g) * DH + 4 * lane) =
          *reinterpret_cast<const uint2*>(o2);
      amx = fmaxf(amx, fmaxf(fmaxf(fabsf(__low2float(o2[0])),
                                   fabsf(__high2float(o2[0]))),
                             fmaxf(fabsf(__low2float(o2[1])),
                                   fabsf(__high2float(o2[1])))));
    }
#pragma unroll
    for (int o_ = 16; o_ > 0; o_ >>= 1)
      amx = fmaxf(amx, __shfl_xor_sync(0xffffffffu, amx, o_));
    if (lane == 0)
      atomicMax(a.amax + (size_t)l * 2 * a.B + b, __float_as_uint(amx));
    __syncwarp();                  // w is rewritten by the warp's next item
  }
}

// ------------------------------------------------------------------ kernel
template <int MODE, int CG>
__global__ void __launch_bounds__(THREADS, 1) step_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Small& sm = *reinterpret_cast<Small*>(smem + SMEM_A);
  unsigned target = 0;
  if (a.trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    a.trace[0] = clock64();
  if (blockIdx.x == 0)               // first read after a barrier
    for (int i = threadIdx.x; i < a.L * 2 * a.B; i += THREADS) a.amax[i] = 0u;
  for (int p = 0; p < KINDS * a.L; ++p) {
    if (p > 0) qtts::grid_sync(a.barrier, target, a.trace);
    const int l = p / KINDS;
    switch (p % KINDS) {
      case K_NORM1:
        norm_phase<MODE>(a, l, true, smem, sm);
        break;
      case K_QKV:
        gemv_phase<MODE, 1, EPI_STORE>(a, l, M_QKV, smem, sm);
        break;
      case K_ATTN:
        attn_phase<CG>(a, l, smem, sm);
        break;
      case K_WO:
        gemv_phase<MODE, 1, EPI_RESID>(a, l, M_WO, smem, sm);
        break;
      case K_NORM2:
        norm_phase<MODE>(a, l, false, smem, sm);
        break;
      case K_GU:
        gemv_phase<MODE, 2, EPI_SWIGLU>(a, l, M_GU, smem, sm);
        break;
      default:
        gemv_phase<MODE, 1, EPI_RESID>(a, l, M_DN, smem, sm);
        break;
    }
  }
  if (a.trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    a.trace[KINDS * a.L] = clock64();
  qtts::grid_exit(a.barrier);
}

template <int MODE, int CG>
cudaError_t launch(const Args& a, int* info, cudaStream_t st) {
  auto kernel = step_kernel<MODE, CG>;
  const size_t smem = SMEM_A + sizeof(Small);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = qtts::allow_smem(kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      THREADS, smem);
  if (e != cudaSuccess) return e;
  if (!coop) return cudaErrorNotSupported;
  const int blocks = min(per_sm, 1) * sms;
  if (blocks < 1 || blocks > a.max_blocks)
    return cudaErrorCooperativeLaunchTooLarge;
  info[0] = blocks;
  void* params[] = {(void*)&a};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                  dim3(THREADS), params, smem, st);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// One w4a8 GEMV phase alone on the step kernel's core, for the checks
// (kernels/talker_step.w4a8_gemv): rows xq int8 [B, K] with scales sx [B]
// -> y [B, N] bf16 = bf16(group sum * sx), a warp per 8-column tile, the
// rows staged in shared memory 32 at a time.
__global__ void __launch_bounds__(THREADS)
w4a8_gemv_kernel(const int8_t* __restrict__ xq, const float* __restrict__ sx,
                 const uint8_t* __restrict__ wq, const bf16* __restrict__ ws,
                 int B, int N, int K, bf16* __restrict__ y) {
  extern __shared__ __align__(16) unsigned char A[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int lda = K + 16;
  const int tile = blockIdx.x * WARPS + warp;
  for (int r0 = 0; r0 < B; r0 += 32) {
    const int nr = min(32, B - r0);
    const int per = K / 16;
    for (int i = threadIdx.x; i < nr * per; i += THREADS) {
      const int row = i / per, c = i % per;
      qtts::cp_async16(A + (size_t)row * lda + 16 * c,
                       xq + (size_t)(r0 + row) * K + 16 * c, 16);
    }
    qtts::cp_async_commit();
    qtts::cp_async_wait<0>();
    __syncthreads();
    if (tile < N / 8) {
      float acc[1][2][4];
      qtts::w4a8_tile<2, 1>(A, lda, nr, wq, ws, N, K, 8 * tile, 0,
                            K / (2 * GROUP), acc);
#pragma unroll
      for (int mt = 0; mt < 2; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * mt + g + 8 * (e >> 1);
          if (row < nr)
            y[(size_t)(r0 + row) * N + 8 * tile + 2 * t + (e & 1)] =
                __float2bfloat16_rn(__fmul_rn(acc[0][mt][e], sx[r0 + row]));
        }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int qtts_w4a8_gemv(const void* xq, const float* sx,
                              const void* wq, const void* ws, int B, int N,
                              int K, void* y, void* stream) {
  if (B < 1 || N % 8 != 0 || K % (2 * GROUP) != 0 || K > 8192)
    return (int)cudaErrorInvalidValue;
  const size_t smem = (size_t)32 * (K + 16);
  cudaError_t e = qtts::allow_smem(w4a8_gemv_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  w4a8_gemv_kernel<<<(N / 8 + WARPS - 1) / WARPS, THREADS, smem,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int8_t*>(xq), sx, static_cast<const uint8_t*>(wq),
      static_cast<const bf16*>(ws), B, N, K, static_cast<bf16*>(y));
  return (int)cudaGetLastError();
}

// ptrs / ints / flts in the order of kernels/talker_step.talker_step_fused;
// info (host) gets the grid's block count.
extern "C" int qtts_talker_step(void* const* ptrs, int n_ptrs,
                                const int* ints, int n_ints,
                                const float* flts, int n_flts, int* info,
                                void* stream) {
  if (n_ptrs != N_PTRS || n_ints != N_INTS || n_flts != N_FLTS)
    return (int)cudaErrorInvalidValue;
  Args a;
  int i = 0;
  auto P = [&]() { return ptrs[i++]; };
  a.x = (const bf16*)P(); a.out = (bf16*)P();
  a.cos = (const float*)P(); a.sin = (const float*)P();
  a.ln1 = (const float*)P(); a.ln2 = (const float*)P();
  a.qn = (const float*)P(); a.kn = (const float*)P();
  for (int m = 0; m < 4; ++m) {
    a.wq[m] = (const char*)P();
    a.ws[m] = (const char*)P();
  }
  a.kc = (bf16*)P(); a.vc = (bf16*)P();
  a.k_tok = (bf16*)P(); a.v_tok = (bf16*)P();
  a.lengths = (const int*)P(); a.write_idx = (const int*)P();
  a.qkv = (bf16*)P(); a.ctx = (bf16*)P(); a.ff = (bf16*)P();
  a.hn = (bf16*)P(); a.xq = (int8_t*)P(); a.sx = (float*)P();
  a.amax = (unsigned*)P(); a.part = (float*)P();
  a.arrive = (unsigned*)P(); a.barrier = (unsigned*)P();
  a.trace = (long long*)P();
  int j = 0;
  a.L = ints[j++]; a.B = ints[j++]; a.D = ints[j++]; a.H = ints[j++];
  a.Hkv = ints[j++]; a.F = ints[j++]; a.C = ints[j++];
  a.prompt_cap = ints[j++]; a.mode = ints[j++]; a.max_blocks = ints[j++];
  a.eps = flts[0];
  a.scale = flts[1];
  // contraction dims: whole 256-row nibble groups (w4a8), whole 64-byte
  // blocks (the other modes), at most 8192 (shared memory)
  const int kq = a.mode == MODE_W4A8 ? 2 * GROUP : 64;
  const int dq = a.H * DH;
  const bool batch_ok =
      (a.B >= 1 && a.B <= 4) || (a.B % 8 == 0 && a.B <= MAX_B);
  if (!batch_ok || a.mode < MODE_W4A8 || a.mode > MODE_BF16 || a.Hkv <= 0 ||
      a.H % a.Hkv != 0 || a.H / a.Hkv > qtts::MAX_G || a.D % kq != 0 ||
      dq % kq != 0 || a.F % kq != 0 || a.D > 8192 || dq > 8192 ||
      a.F > 8192 || a.C <= 0 || a.L <= 0 || a.max_blocks < 1 ||
      (a.k_tok == nullptr) != (a.v_tok == nullptr))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool wide = a.H / a.Hkv > 2;
  cudaError_t e;
#define QTTS_STEP(MODE)                                                      \
  e = wide ? launch<MODE, qtts::MAX_G>(a, info, st)                          \
           : launch<MODE, 2>(a, info, st);
  switch (a.mode) {
    case MODE_W4A8: QTTS_STEP(MODE_W4A8) break;
    case MODE_INT8: QTTS_STEP(MODE_INT8) break;
    case MODE_W8A8: QTTS_STEP(MODE_W8A8) break;
    default: QTTS_STEP(MODE_BF16) break;
  }
#undef QTTS_STEP
  return (int)e;
}
