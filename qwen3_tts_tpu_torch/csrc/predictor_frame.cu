// The predictor's 15 residual codes of one frame, int8 weights, for Hopper.
//
// Replaces: qwen3_tts_tpu/kernels/predictor_frame.py predict_frame_fused
// (the Pallas TPU kernel).  Contract: h [B, D] f32 (the projected talker
// hidden; rounded to bf16), code0 [B] int32 -> codes [B, 16] int32, B <=
// 32.  Token t sits at rope position t (t = 0: the hidden, t = 1:
// emb(code0), t >= 2: emb(code_{t-1})); each runs all layers with attention
// over the slots s <= t of a 16-slot KV; after token t >= 1 the final norm
// and the 2048-row int8 window t - 1 of the lm-head give the logits, whose
// argmax (lowest index on ties) is code t; the next token's input is
// tables[t][code t].  Numerics follow the Pallas kernel (see
// kernels/predictor_frame.py): `_qmm` = bf16(x_bf16 . w_int8 in f32) *
// bf16(scale), rounded to bf16; head logits = (x_bf16 . w_int8) * scale in
// f32.  The window logits of every token stay in logits [B, 15, 2048] f32.
//
// Weights (kernels/predictor_frame.prep_predictor_weights): int8 [L, N, K]
// (output-major) with f32 scales [L, N]; lm-head int8 [15 * 2048, D] with
// f32 per-row scales.
//
// What bounds it on the card: bytes.  The 6 layers hold 75.5 MB of int8
// weights at full width and the lm-head 31.5 MB: read once, 0.032 ms at
// 3.35 TB/s.  One H100's 50 MB L2 cannot keep the layers over the frame's
// 16 tokens, so each token streams them from device memory again: 16 x
// 75.5 MB + 15 x 2 MiB = 1.24 GB, 0.37 ms, the floor this design is built
// against.  At 16 x 6 = 96 dependent layer steps a frame, the latency of
// each dependent phase sets the time as much as the bytes do.
//
// The design: ONE cooperative launch per frame for all B lanes, a
// persistent grid (one 256-thread block per SM) running four phases per
// token and layer, one per token for the head, and one to finish,
// separated by grid barriers (gemv_stream.cuh):
//   qkv     the block stages the B input rows RMS-normed (ln1) in shared
//           memory; each warp computes 8-column output tiles of the fused
//           qkv matrix for all B rows at once on the tensor cores
//           (mma.sync m16n8k16 bf16 -> f32, each int8 weight turned into
//           bf16 in registers: exact), so each token reads each weight
//           once whatever B is.  The block that finishes the last tile of a
//           kv head (an arrival counter per kv head) then runs that head's
//           attention for every lane, a warp per lane: q/k norm and rope at
//           position t, the k/v row into slot t, scores over slots <= t,
//           softmax, P.V -> ctx.  No attention phase of its own;
//   wo      ctx staged, GEMV + residual; each block also writes its
//           columns' share of every lane's sum of squares, so the next
//           phase's RMSNorm needs no pass of its own (each block adds the
//           shares in block order);
//   gate_up RMS-normed (ln2) rows, the gate and up tiles of a warp, SwiGLU;
//   down    GEMV + residual + sum-of-squares shares;
//   head    (tokens 1..15) final norm, the 2048-row window: logits, and
//           each block's best (value, lowest index) per lane over its rows;
//           the next token's qkv phase reduces them in every block, writes
//           the code and stages the table row of it as its input;
//   finish  code 15.
// The GEMV tiles: mma.sync m16n8k16 bf16 -> f32 with the int8 weights
// turned into bf16 in registers, the lanes as the M rows; with fewer tiles
// than warps each tile's K range is split over warps and the partial sums
// added in split order (gemv_stream.cuh).
// 16 x 6 x 4 + 15 + 1 = 400 phases a frame at full depth, 399 barriers.
// Each lane's arithmetic is the same at every B (rows are independent in
// the products; the norms' sums run in an order fixed by the grid), so a
// lane gives the same codes and logits alone and in a batch.

#include <climits>

#include "gemv_stream.cuh"

namespace {

using bf16 = __nv_bfloat16;
using qtts::bf16r;
using qtts::bf2f;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int N_TOKENS = 16;
constexpr int MAX_B = 32;
constexpr int MAX_HKV = 32;
constexpr size_t SMEM_A = 200 * 1024;     // staged GEMV rows
constexpr int N_PTRS = 34, N_INTS = 10, N_FLTS = 2;

enum { P_QKV, P_WO, P_GU, P_DN, P_HEAD, P_FINISH };
enum { EPI_STORE, EPI_RESID, EPI_SWIGLU, EPI_LOGITS };

struct Args {
  const float* h;
  const int* code0;
  int* codes;
  const float *ln1, *ln2, *qn, *kn, *fn;
  const int8_t *wq[5];               // qkv, wo, gate_up, down, head
  const float* ws[5];
  const float *cos, *sin;
  const bf16* tables;
  float* logits;
  // scratch (kernels/predictor_frame.frame_scratch)
  bf16 *x, *qkv, *ctx, *ff, *kc, *vc;
  float* ssq;                        // [2, B, max_blocks] sum-of-squares shares
  float* best_v;                     // [B, max_blocks]
  int* best_i;
  unsigned* arrive;                  // [Hkv], 0 between phases
  unsigned* barrier;                 // [2], 0 between launches
  long long* trace;                  // optional: block 0's phase clocks
  int L, B, D, H, Hkv, DH, F, R, V, max_blocks;
  float eps, scale;
};

struct Small {
  float inv[MAX_B];                  // the staged rows' 1 / rms
  float bv[WARPS][MAX_B];
  int bi[WARPS][MAX_B];
  float part[WARPS][2 * 2 * 4 * 32];  // a K split's partial sums (R, MT)
  int last[MAX_HKV];                 // kv heads whose attention this block runs
  int n_last;
};

// (N, K, R) of matrix m (5 = the head window)
__device__ inline void mat_shape(const Args& a, int m, int& n, int& k,
                                 int& r) {
  const int nqkv = (a.H + 2 * a.Hkv) * a.DH, dq = a.H * a.DH;
  n = m == P_QKV ? nqkv : m == P_GU ? a.F : m == P_HEAD ? a.V : a.D;
  k = m == P_WO ? dq : m == P_DN ? a.F : a.D;
  r = m == P_GU ? 2 : 1;
}

// Matrix m of layer l (window w for the head): weights and scales.
__device__ inline void mat_ptrs(const Args& a, int m, int l, int w,
                                const int8_t*& q, const float*& s) {
  int n, k, r;
  mat_shape(a, m, n, k, r);
  const size_t cols = (size_t)n * r * (m == P_HEAD ? w : l);
  q = a.wq[m] + cols * k;
  s = a.ws[m] + cols;
}

// The code of lane b from the head phase's per-block bests (value, lowest
// index on ties), on one whole warp: its lanes take every 32nd block, then
// a butterfly.
__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

__device__ __forceinline__ int reduce_code(const Args& a, int b) {
  const int lane = threadIdx.x & 31;
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int k = lane; k < gridDim.x; k += 32) {
    const float v = __ldcg(a.best_v + (size_t)b * a.max_blocks + k);
    const int i = __ldcg(a.best_i + (size_t)b * a.max_blocks + k);
    if (better(v, i, bv, bi)) {
      bv = v;
      bi = i;
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const float ov = __shfl_xor_sync(0xffffffffu, bv, o);
    const int oi = __shfl_xor_sync(0xffffffffu, bi, o);
    if (better(ov, oi, bv, bi)) {
      bv = ov;
      bi = oi;
    }
  }
  return bi == INT_MAX ? 0 : bi;
}

// Code tok - 1 of lane b (tok >= 1: code0, or the head phase's choice; a
// whole warp) and the input row of token tok, tables[tok - 1][code].
__device__ __forceinline__ int input_code(const Args& a, int tok, int b) {
  return tok == 1 ? a.code0[b] : reduce_code(a, b);
}
__device__ __forceinline__ const bf16* input_row(const Args& a, int tok,
                                                 int code) {
  return a.tables +
         ((size_t)(tok - 1) * a.R + min(max(code, 0), a.R - 1)) * a.D;
}

// At token tok's first phase, block b % gridDim.x writes lane b's code
// tok - 1 (tok >= 1) and its input row into the residual stream x.
__device__ void write_input(const Args& a, int tok) {
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    const int code = tok > 0 ? input_code(a, tok, b) : 0;   // every warp
    if (tok > 0 && threadIdx.x == 0)
      a.codes[(size_t)b * N_TOKENS + tok - 1] = code;
    const bf16* trow = tok > 0 ? input_row(a, tok, code) : nullptr;
    for (int k = threadIdx.x; k < a.D; k += THREADS)
      a.x[(size_t)b * a.D + k] =
          tok == 0 ? __float2bfloat16_rn(a.h[(size_t)b * a.D + k]) : trow[k];
  }
}

// Stage rows [r0, r0 + nr) of phase m's input (token tok, layer l) into A
// (bf16, stride lda bytes): ctx / ff as they are; x RMS-normed for qkv,
// gate_up and the head, with 1 / rms from the residual's sum-of-squares
// shares, or (the token's input, layer 0) from the row itself: h (tok 0)
// or the table row of the code the head phase chose (tok >= 1).
__device__ void stage(const Args& a, int m, int tok, int l, int r0, int nr,
                      unsigned char* A, int lda, Small& sm) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  int n, K, r;
  mat_shape(a, m, n, K, r);
  const int per = K / 8;
  if (m == P_WO || m == P_DN) {
    const bf16* src = m == P_WO ? a.ctx : a.ff;
    for (int i = tid; i < nr * per; i += THREADS) {
      const int row = i / per, c = i % per;
      qtts::cp_async16(A + (size_t)row * lda + 16 * c,
                       src + (size_t)(r0 + row) * K + 8 * c, 16);
    }
    qtts::cp_async_commit();
    qtts::cp_async_wait<0>();
    __syncthreads();
    return;
  }
  const bool input = m == P_QKV && l == 0;
  if (input) {
    // the token's input row; each warp sums its rows' squares in one order
    for (int row = warp; row < nr; row += WARPS) {
      const int b = r0 + row;
      const bf16* trow = nullptr;
      if (tok > 0) trow = input_row(a, tok, input_code(a, tok, b));
      bf16* dst = reinterpret_cast<bf16*>(A + (size_t)row * lda);
      float ss = 0.f;
      for (int k = lane; k < K; k += 32) {
        const bf16 v = tok == 0 ? __float2bfloat16_rn(a.h[(size_t)b * K + k])
                                : trow[k];
        dst[k] = v;
        const float f = bf2f(v);
        ss = fmaf(f, f, ss);
      }
      ss = qtts::warp_sum(ss);
      if (lane == 0) sm.inv[row] = 1.0f / sqrtf(ss / (float)K + a.eps);
    }
    __syncthreads();
  } else {
    for (int i = tid; i < nr * per; i += THREADS) {
      const int row = i / per, c = i % per;
      qtts::cp_async16(A + (size_t)row * lda + 16 * c,
                       a.x + (size_t)(r0 + row) * K + 8 * c, 16);
    }
    qtts::cp_async_commit();
    const float* shares =
        a.ssq + (size_t)(m == P_GU ? 0 : 1) * a.B * a.max_blocks;
    for (int row = warp; row < nr; row += WARPS) {  // a warp per row
      const float* s = shares + (size_t)(r0 + row) * a.max_blocks;
      float ss = 0.f;
      for (int k = lane; k < gridDim.x; k += 32) ss += __ldcg(s + k);
      ss = qtts::warp_sum(ss);
      if (lane == 0) sm.inv[row] = 1.0f / sqrtf(ss / (float)K + a.eps);
    }
    qtts::cp_async_wait<0>();
    __syncthreads();
  }
  // RMSNorm in place: bf16((x * inv) * w)
  const float* w = m == P_HEAD ? a.fn
                   : (m == P_QKV ? a.ln1 : a.ln2) + (size_t)l * K;
  for (int i = tid; i < nr * per; i += THREADS) {
    const int row = i / per, c = i % per;
    uint4* p = reinterpret_cast<uint4*>(A + (size_t)row * lda + 16 * c);
    uint4 u = *p;
    __nv_bfloat162* h2 = reinterpret_cast<__nv_bfloat162*>(&u);
    const float inv = sm.inv[row];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f = __bfloat1622float2(h2[j]);
      const int k = 8 * c + 2 * j;
      h2[j] = __floats2bfloat162_rn(__fmul_rn(__fmul_rn(f.x, inv), w[k]),
                                    __fmul_rn(__fmul_rn(f.y, inv), w[k + 1]));
    }
    *p = u;
  }
  __syncthreads();
}

// Phase m's tiles of this block on the staged rows [r0, r0 + nr).  With
// fewer tiles than warps, each tile's K range is split over ks warps, whose
// partial sums the tile's first warp adds in split order.
template <int MT, int R, int EPI>
__device__ void tiles(const Args& a, int m, int tok, int l, int t0, int t1,
                      int r0, int nr, const unsigned char* A, int lda,
                      Small& sm) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  int N, K, rr;
  mat_shape(a, m, N, K, rr);
  const int8_t* wq;
  const float* ws;
  mat_ptrs(a, m, l, tok - 1, wq, ws);
  const int nqkv = (a.H + 2 * a.Hkv) * a.DH;
  const int nt = t1 - t0, nk = K / 64;
  const int ks = qtts::k_split(nt, WARPS, nk);
  const int units = nt * ks;
  // per-thread running (sum of squares | best) of its rows
  float part[MT][2];
  int pidx[MT][2];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      part[mt][h] = EPI == EPI_LOGITS ? -INFINITY : 0.f;
      pidx[mt][h] = INT_MAX;
    }
  for (int u = warp; u < (ks > 1 ? WARPS : units); u += WARPS) {
    const bool live = u < units;
    const int tile = t0 + u / ks, kp = u % ks;
    const int n0 = 8 * tile;
    // the residual's values, loaded before the products
    float res[MT][4];
    if (EPI == EPI_RESID && live && kp == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int row = 16 * mt + g + 8 * (e >> 1);
          res[mt][e] = row < nr ? qtts::ld_bf<true>(
                                      a.x + (size_t)(r0 + row) * a.D + n0 +
                                      2 * t + (e & 1))
                                : 0.f;
        }
    }
    float acc[R][MT][4];
    if (live)
      qtts::i8bf_tile<MT, R>(A, lda, nr, wq, N, K, n0, kp * nk / ks,
                             (kp + 1) * nk / ks, acc);
    if (ks > 1) {
      float* mine = sm.part[warp];
      if (live) {
#pragma unroll
        for (int r = 0; r < R; ++r)
#pragma unroll
          for (int mt = 0; mt < MT; ++mt)
#pragma unroll
            for (int e = 0; e < 4; ++e)
              mine[((r * MT + mt) * 4 + e) * 32 + lane] = acc[r][mt][e];
      }
      __syncthreads();                  // every share of every tile
      if (!live || kp != 0) continue;
#pragma unroll
      for (int r = 0; r < R; ++r)
#pragma unroll
        for (int mt = 0; mt < MT; ++mt)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float v = acc[r][mt][e];
            for (int j = 1; j < ks; ++j)
              v += sm.part[warp + j][((r * MT + mt) * 4 + e) * 32 + lane];
            acc[r][mt][e] = v;
          }
    }
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = 16 * mt + g + 8 * (e >> 1);
        if (row >= nr) continue;
        const int b = r0 + row, n = n0 + 2 * t + (e & 1);
        if (EPI == EPI_LOGITS) {
          const float v = __fmul_rn(acc[0][mt][e], ws[n]);
          a.logits[((size_t)b * (N_TOKENS - 1) + tok - 1) * a.V + n] = v;
          float& bv = part[mt][e >> 1];
          int& bi = pidx[mt][e >> 1];
          if (better(v, n, bv, bi)) {
            bv = v;
            bi = n;
          }
          continue;
        }
        float y[R];
#pragma unroll
        for (int r = 0; r < R; ++r)
          y[r] = bf16r(__fmul_rn(bf16r(acc[r][mt][e]), bf16r(ws[n + r * N])));
        if (EPI == EPI_STORE) {
          a.qkv[(size_t)b * nqkv + n] = __float2bfloat16_rn(y[0]);
        } else if (EPI == EPI_RESID) {
          const bf16 v = __float2bfloat16_rn(__fadd_rn(res[mt][e], y[0]));
          a.x[(size_t)b * a.D + n] = v;
          const float f = bf2f(v);
          part[mt][e >> 1] = fmaf(f, f, part[mt][e >> 1]);
        } else {
          const float act = bf16r(__fdiv_rn(y[0], 1.0f + expf(-y[0])));
          a.ff[(size_t)b * a.F + n] =
              __float2bfloat16_rn(__fmul_rn(act, y[R - 1]));
        }
      }
  }
  if (EPI != EPI_RESID && EPI != EPI_LOGITS) return;
  // the rows' shares over the block's columns: the 4 lanes of a row, the
  // warps in order
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float v = part[mt][h];
      int i = pidx[mt][h];
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, o);
        const int oi = __shfl_xor_sync(0xffffffffu, i, o);
        if (EPI == EPI_RESID) {
          v += ov;
        } else if (better(ov, oi, v, i)) {
          v = ov;
          i = oi;
        }
      }
      if (t == 0) {
        const int row = 16 * mt + g + 8 * h;
        sm.bv[warp][row] = v;
        sm.bi[warp][row] = i;
      }
    }
  __syncthreads();
  for (int row = threadIdx.x; row < nr; row += THREADS) {
    float v = sm.bv[0][row];
    int i = sm.bi[0][row];
    for (int w = 1; w < WARPS; ++w) {
      const float ov = sm.bv[w][row];
      const int oi = sm.bi[w][row];
      if (EPI == EPI_RESID) {
        v += ov;
      } else if (better(ov, oi, v, i)) {
        v = ov;
        i = oi;
      }
    }
    const size_t k = (size_t)(r0 + row) * a.max_blocks + blockIdx.x;
    if (EPI == EPI_RESID) {
      a.ssq[(size_t)(m == P_WO ? 0 : 1) * a.B * a.max_blocks + k] = v;
    } else {
      a.best_v[k] = v;
      a.best_i[k] = i;
    }
  }
  __syncthreads();
}

// The kv head of output column n of the fused qkv matrix.
__device__ __forceinline__ int kv_head_of(const Args& a, int n) {
  const int dq = a.H * a.DH, G = a.H / a.Hkv;
  return n < dq ? n / a.DH / G
                : n < dq + a.Hkv * a.DH ? (n - dq) / a.DH
                                        : (n - dq - a.Hkv * a.DH) / a.DH;
}

// Attention of token tok, layer l, lane b, kv head kvh on one warp, with
// `ws` its shared scratch (attn_bytes<DH>()): the k/v rows of slots < tok
// are copied there in one batch (cp.async) while the warp computes the q/k
// RMSNorm and rope at position tok (f32 (x * (1 / sqrt(ss / DH + eps))) *
// w, then bf16; f32 x * cos + rotate_half(x) * sin, then bf16; lane
// holding dims lane + 32 i) and writes slot tok; then scores (q . k) *
// scale in f32, one (head, slot) per lane; softmax and P.V per head.
template <int DH>
__host__ __device__ constexpr size_t attn_bytes() {
  return (size_t)2 * N_TOKENS * (DH + 8) * 2 +               // k, v rows
         (size_t)qtts::MAX_G * (DH + N_TOKENS) * 4;           // q, p
}

template <int DH>
__device__ void attend(const Args& a, int tok, int l, int b, int kvh,
                       unsigned char* ws) {
  constexpr int DL = DH / 32, LD = DH + 8;      // rows padded: no conflicts
  const int lane = threadIdx.x & 31;
  const int G = a.H / a.Hkv;
  const int nqkv = (a.H + 2 * a.Hkv) * DH;
  bf16* ks = reinterpret_cast<bf16*>(ws);                 // [16][LD]
  bf16* vs = ks + N_TOKENS * LD;                          // [16][LD]
  float* qs = reinterpret_cast<float*>(vs + N_TOKENS * LD);   // [G][DH]
  float* ps = qs + qtts::MAX_G * DH;                      // [G][16]
  const bf16* row = a.qkv + (size_t)b * nqkv;
  const float* cs = a.cos + (size_t)tok * DH;
  const float* sn = a.sin + (size_t)tok * DH;
  const size_t head = (((size_t)l * a.B + b) * a.Hkv + kvh) * N_TOKENS * DH;
  bf16* kp = a.kc + head;
  bf16* vp = a.vc + head;
  for (int c = lane; c < tok * DH / 8; c += 32) {
    const int j = c / (DH / 8), o = 8 * (c % (DH / 8));
    qtts::cp_async16(ks + j * LD + o, kp + (size_t)j * DH + o, 16);
    qtts::cp_async16(vs + j * LD + o, vp + (size_t)j * DH + o, 16);
  }
  qtts::cp_async_commit();
  // every head's row loaded first: q heads g < G, the k head, the v head
  float raw[qtts::MAX_G + 2][DL];
#pragma unroll
  for (int h = 0; h < qtts::MAX_G + 2; ++h) {
    const int col = h < G ? kvh * G + h
                  : h == qtts::MAX_G ? a.H + kvh
                  : h == qtts::MAX_G + 1 ? a.H + a.Hkv + kvh : -1;
#pragma unroll
    for (int i = 0; i < DL; ++i)
      raw[h][i] = col >= 0 ? qtts::ld_bf<true>(row + (size_t)col * DH +
                                               lane + 32 * i)
                           : 0.f;
  }
  auto norm_rope = [&](const float (&x0)[DL], const float* nw,
                       float (&o)[DL]) {
    float x[DL];
    float ss = 0.f;
#pragma unroll
    for (int i = 0; i < DL; ++i) {
      x[i] = x0[i];
      ss = __fadd_rn(ss, qtts::warp_sum(__fmul_rn(x[i], x[i])));
    }
    const float inv = 1.0f / sqrtf(ss / (float)DH + a.eps);
#pragma unroll
    for (int i = 0; i < DL; ++i)
      x[i] = bf16r(__fmul_rn(__fmul_rn(x[i], inv), nw[lane + 32 * i]));
#pragma unroll
    for (int i = 0; i < DL; ++i) {         // dim d < DH / 2 pairs with d + DH / 2
      const int d = lane + 32 * i;
      const float rot = i < DL / 2 ? -x[i + DL / 2] : x[i - DL / 2];
      o[i] = bf16r(__fadd_rn(__fmul_rn(x[i], cs[d]), __fmul_rn(rot, sn[d])));
    }
  };
#pragma unroll
  for (int g = 0; g < qtts::MAX_G; ++g) {
    if (g >= G) break;
    float q[DL];
    norm_rope(raw[g], a.qn + (size_t)l * DH, q);
#pragma unroll
    for (int i = 0; i < DL; ++i) qs[g * DH + lane + 32 * i] = q[i];
  }
  float k[DL];
  norm_rope(raw[qtts::MAX_G], a.kn + (size_t)l * DH, k);
#pragma unroll
  for (int i = 0; i < DL; ++i) {
    const int d = lane + 32 * i;
    const bf16 kb = __float2bfloat16_rn(k[i]);
    const bf16 vb = __float2bfloat16_rn(raw[qtts::MAX_G + 1][i]);
    kp[(size_t)tok * DH + d] = kb;
    vp[(size_t)tok * DH + d] = vb;
    ks[tok * LD + d] = kb;
    vs[tok * LD + d] = vb;
  }
  qtts::cp_async_wait<0>();
  __syncwarp();
  // scores: lane takes (head, slot) pairs, 8 dims a step
  const int ns = tok + 1;
  for (int pi = lane; pi < G * ns; pi += 32) {
    const int g = pi / ns, j = pi % ns;
    const float* q = qs + g * DH;
    const bf16* kr = ks + j * LD;
    float d = 0.f;
#pragma unroll 4
    for (int i = 0; i < DH; i += 8) {
      const uint4 u = *reinterpret_cast<const uint4*>(kr + i);
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(h2[e]);
        d = fmaf(q[i + 2 * e], f.x, d);
        d = fmaf(q[i + 2 * e + 1], f.y, d);
      }
    }
    ps[g * N_TOKENS + j] = __fmul_rn(d, a.scale);
  }
  __syncwarp();
  const int dq = a.H * DH;
  for (int g = 0; g < G; ++g) {
    const float* sg = ps + g * N_TOKENS;
    float mx = sg[0];
    for (int j = 1; j < ns; ++j) mx = fmaxf(mx, sg[j]);
    float den = 0.f, acc[DL];
#pragma unroll
    for (int i = 0; i < DL; ++i) acc[i] = 0.f;
    for (int j = 0; j < ns; ++j) {
      const float p = expf(sg[j] - mx);
      den += p;
#pragma unroll
      for (int i = 0; i < DL; ++i)
        acc[i] = fmaf(p, bf2f(vs[j * LD + lane + 32 * i]), acc[i]);
    }
#pragma unroll
    for (int i = 0; i < DL; ++i)
      a.ctx[(size_t)b * dq + (size_t)(kvh * G + g) * DH + lane + 32 * i] =
          __float2bfloat16_rn(acc[i] / den);
  }
  __syncwarp();                    // the scratch is rewritten by the next item
}

template <int R, int EPI>
__device__ void gemv_phase(const Args& a, int m, int tok, int l,
                           unsigned char* A, Small& sm) {
  int N, K, r;
  mat_shape(a, m, N, K, r);
  int t0, t1;
  qtts::tile_range(N / 8, t0, t1);
  const int lda = 2 * K + 16;
  const int rp = (size_t)32 * lda <= SMEM_A ? 32 : 16;
  if (t0 < t1) {
    for (int r0 = 0; r0 < a.B; r0 += rp) {
      const int nr = min(rp, a.B - r0);
      stage(a, m, tok, l, r0, nr, A, lda, sm);
      if (nr > 16)
        tiles<2, R, EPI>(a, m, tok, l, t0, t1, r0, nr, A, lda, sm);
      else
        tiles<1, R, EPI>(a, m, tok, l, t0, t1, r0, nr, A, lda, sm);
      __syncthreads();                // A is restaged by the next pass
    }
  } else if (EPI == EPI_RESID || EPI == EPI_LOGITS) {
    // no columns here: a neutral share for every lane
    for (int b = threadIdx.x; b < a.B; b += THREADS) {
      const size_t k = (size_t)b * a.max_blocks + blockIdx.x;
      if (EPI == EPI_RESID) {
        a.ssq[(size_t)(m == P_WO ? 0 : 1) * a.B * a.max_blocks + k] = 0.f;
      } else {
        a.best_v[k] = -INFINITY;
        a.best_i[k] = INT_MAX;
      }
    }
  }
  if (m != P_QKV) return;
  // ---- the attention of every kv head whose last tile this block wrote
  __threadfence();                    // this block's qkv columns, then count
  __syncthreads();
  if (threadIdx.x == 0) {
    sm.n_last = 0;
    if (t0 < t1) {
      const int per_head = (a.H / a.Hkv + 2) * a.DH / 8;
      int tile = t0;
      while (tile < t1) {
        const int kvh = kv_head_of(a, 8 * tile);
        int cnt = 0;
        while (tile < t1 && kv_head_of(a, 8 * tile) == kvh) {
          ++cnt;
          ++tile;
        }
        const unsigned old = atomicAdd(a.arrive + kvh, (unsigned)cnt);
        if (old + cnt == (unsigned)per_head) {
          a.arrive[kvh] = 0u;          // for the next phase
          sm.last[sm.n_last++] = kvh;
        }
      }
      __threadfence();
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int items = sm.n_last * a.B;
  for (int it = warp; it < items; it += WARPS) {
    const int kvh = sm.last[it / a.B], b = it % a.B;
    if (a.DH == 64)
      attend<64>(a, tok, l, b, kvh, A + warp * attn_bytes<64>());
    else
      attend<128>(a, tok, l, b, kvh, A + warp * attn_bytes<128>());
  }
}

__global__ void __launch_bounds__(THREADS, 1) frame_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  Small& sm = *reinterpret_cast<Small*>(smem + SMEM_A);
  unsigned target = 0;
  bool first = true;
  if (a.trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    a.trace[0] = clock64();
  for (int tok = 0; tok < N_TOKENS; ++tok) {
    for (int l = 0; l < a.L; ++l) {
      for (int m = P_QKV; m <= P_DN; ++m) {
        if (!first) qtts::grid_sync(a.barrier, target, a.trace);
        first = false;
        if (m == P_QKV && l == 0) write_input(a, tok);
        switch (m) {
          case P_QKV: gemv_phase<1, EPI_STORE>(a, m, tok, l, smem, sm); break;
          case P_WO: gemv_phase<1, EPI_RESID>(a, m, tok, l, smem, sm); break;
          case P_GU: gemv_phase<2, EPI_SWIGLU>(a, m, tok, l, smem, sm); break;
          default: gemv_phase<1, EPI_RESID>(a, m, tok, l, smem, sm); break;
        }
      }
    }
    if (tok >= 1) {
      qtts::grid_sync(a.barrier, target, a.trace);
      gemv_phase<1, EPI_LOGITS>(a, P_HEAD, tok, a.L, smem, sm);
    }
  }
  // ---- finish: code 15
  qtts::grid_sync(a.barrier, target, a.trace);
  for (int b = blockIdx.x; b < a.B; b += gridDim.x) {
    if (threadIdx.x >= 32) break;               // warp 0
    const int code = reduce_code(a, b);
    if (threadIdx.x == 0) a.codes[(size_t)b * N_TOKENS + N_TOKENS - 1] = code;
  }
  if (a.trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    a.trace[target / gridDim.x + 1] = clock64();
  qtts::grid_exit(a.barrier);
}

}  // namespace

// ptrs / ints / flts in the order of kernels/predictor_frame.
// predict_frame_fused; info (host) gets the grid's block count.
extern "C" int qtts_predictor_frame(void* const* ptrs, int n_ptrs,
                                    const int* ints, int n_ints,
                                    const float* flts, int n_flts, int* info,
                                    void* stream) {
  if (n_ptrs != N_PTRS || n_ints != N_INTS || n_flts != N_FLTS)
    return (int)cudaErrorInvalidValue;
  Args a;
  int i = 0;
  auto P = [&]() { return ptrs[i++]; };
  a.h = (const float*)P(); a.code0 = (const int*)P(); a.codes = (int*)P();
  a.ln1 = (const float*)P(); a.ln2 = (const float*)P();
  a.qn = (const float*)P(); a.kn = (const float*)P();
  a.fn = (const float*)P();
  for (int m = 0; m < 5; ++m) {
    a.wq[m] = (const int8_t*)P();
    a.ws[m] = (const float*)P();
  }
  a.cos = (const float*)P(); a.sin = (const float*)P();
  a.tables = (const bf16*)P(); a.logits = (float*)P();
  a.x = (bf16*)P(); a.qkv = (bf16*)P(); a.ctx = (bf16*)P();
  a.ff = (bf16*)P(); a.kc = (bf16*)P(); a.vc = (bf16*)P();
  a.ssq = (float*)P(); a.best_v = (float*)P(); a.best_i = (int*)P();
  a.arrive = (unsigned*)P(); a.barrier = (unsigned*)P();
  a.trace = (long long*)P();
  int j = 0;
  a.L = ints[j++]; a.B = ints[j++]; a.D = ints[j++]; a.H = ints[j++];
  a.Hkv = ints[j++]; a.DH = ints[j++]; a.F = ints[j++]; a.R = ints[j++];
  a.V = ints[j++]; a.max_blocks = ints[j++];
  a.eps = flts[0];
  a.scale = flts[1];
  if (a.B < 1 || a.B > MAX_B || (a.DH != 64 && a.DH != 128) || a.Hkv <= 0 ||
      a.Hkv > MAX_HKV || a.H % a.Hkv != 0 || a.H / a.Hkv > qtts::MAX_G ||
      a.D % 128 != 0 || (a.H * a.DH) % 64 != 0 || a.F % 64 != 0 ||
      a.V % 8 != 0 || a.L <= 0 || a.V <= 0 || a.R <= 0 ||
      a.max_blocks < 1 || (size_t)16 * (2 * max(a.D, max(a.F, a.H * a.DH)) +
                                        16) > SMEM_A)
    return (int)cudaErrorInvalidValue;
  const size_t smem = SMEM_A + sizeof(Small);
  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess) e = qtts::allow_smem(frame_kernel, smem);
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, frame_kernel,
                                                      THREADS, smem);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  const int blocks = min(per_sm, 1) * sms;
  if (blocks < 1 || blocks > a.max_blocks)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  info[0] = blocks;
  void* params[] = {(void*)&a};
  e = cudaLaunchCooperativeKernel((const void*)frame_kernel, dim3(blocks),
                                  dim3(THREADS), params, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}
