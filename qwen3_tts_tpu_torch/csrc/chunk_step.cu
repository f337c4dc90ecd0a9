// Whole decode frames of one chunk in ONE cooperative launch, for Hopper.
//
// Replaces: qwen3_tts_tpu/kernels/chunk_step.py gen_chunk_fused (the Pallas
// TPU kernel) at its batches: 1 lane, 8 or 16 lanes at F <= 8 frames, 24 or
// 32 lanes at F <= 4 (the JAX gate), with its in-kernel sampler
// `_sample_inkernel`.
// Contract (kernels/chunk_step.py): F <= 8 frames; each frame samples
// code_0 of every lane from the carried codec logits (greedy, or the
// threshold sampler with the caller's uniform u[f, b]), projects the f32
// hidden 2048 -> 1024, runs the predictor's 16 tokens (w4a8 weights, f32
// group scales, 16-slot KV, window argmax, next input ctab_pred[t][code_t]),
// sums the feedback (16 codec-table rows + tts_pad), runs the 28-layer w4a8
// talker step writing the frame's k/v row IN PLACE at slot write_idx + f
// (one cursor for every lane: write_idx[0]; the prompt lengths are per
// lane), and applies the final norm (kept as the f32 hidden) and the int8
// codec head over rows [0, 2160) for the next frame's logits.  It rounds to
// bf16 where the Pallas kernel and kernels/chunk_step.gen_chunk_plain do,
// but its f32 sums run in its own order: the talker's cache prefix goes in
// SPLIT = 64-slot splits combined in split order (the plain version and the
// JAX kernel: 512-slot tiles), so the online softmax rescales at other
// points; chip_smoke.py holds the result to that drift, and the talker
// layer by layer to the plain layer in these orders
// (chunk_step.KERNEL_ORDERS).  Every lane of a batched launch computes
// exactly what the one-lane launch computes on that lane's inputs (bit for
// bit; chip_smoke.py checks it): the JAX kernel's batched loop scores q.k
// and p.v in bf16, a TPU matrix-unit artefact that is not carried over, nor
// is its bf16 proj_w at b >= 24.
//
// Design.  The TPU kernel runs frames and layer groups as a sequential grid
// on one core; Hopper runs blocks in parallel and carries nothing between
// launches.  So this is a persistent kernel: as many 256-thread blocks as
// can be resident at once (cudaOccupancyMaxActiveBlocksPerMultiprocessor x
// SMs), launched with cudaLaunchCooperativeKernel, which refuses (and the
// wrapper raises) rather than run a grid that could deadlock.  The frame is
// a fixed sequence of phases separated by a grid-wide barrier (a counter in
// device memory: each block adds one and waits for the phase's total; the
// last block to leave the launch sets it back to 0).
// Each phase splits its work over the blocks with a grid-stride loop and
// runs the device code of talker_step.cu and predictor_frame.cu (shared in
// w4a8.cuh and common.cuh) with the block's index in that loop in place of
// blockIdx:
//   sample + project  block b < B samples code_0 of lane b (same arithmetic
//                     as ops.sampling.sample_threshold); every block
//                     projects rows of h1024 = hidden . proj_w^T + proj_b
//                     (f32) for its lanes;
//   predictor         per token t and layer: qkv GEMV (RMSNorm + int8
//                     prologue recomputed by every block); attention + wo
//                     + residual in ONE phase: every block that has wo rows
//                     computes its lanes' context of token t itself
//                     (pred_ctx_block: norms and rope a warp per (lane, kv
//                     head), scores a thread per (item, slot), softmax a
//                     thread per (item, head), P.V a thread per (item,
//                     columns); slots < t from pk/pv, slot t from its own
//                     shared copy) into the wo GEMV's staged input rows
//                     (no round trip through memory), and one block per
//                     lane writes slot t's k/v row to pk/pv, read only from
//                     token t + 1's phase on; gate_up + SwiGLU, down +
//                     residual; after token t >= 1 the final norm and the
//                     2048-row int8 window GEMV, each block writing its
//                     rows' best (value, lowest index) per lane to scratch;
//                     the next phase reduces those in every block (no extra
//                     barrier) and gathers the next input row from ctab_pred;
//   feedback          code_15 as above, then x = bf16(sum of 16 rows + pad);
//   talker            per layer: qkv; attention split over the whole grid:
//                     work items (lane, kv head, prefix split of SPLIT
//                     slots), one warp each, spread over the blocks first;
//                     each item recomputes its q heads' norm and rope,
//                     scores its slots with 8 lanes per slot (16 dims a
//                     lane, then a 3-step butterfly), takes the split's
//                     softmax and P.V, and writes (max, sum, acc[Dh]) per
//                     query head to scratch; the last warp to finish a
//                     (lane, kv head) (an arrival counter after
//                     __threadfence; it sets the counter back to 0 for the
//                     next layer) combines the splits in split order,
//                     writes the frame's k/v row at slot start + f once,
//                     then merges the chunk's own slots start .. start + f
//                     as one last merge (the JAX order); wo, gate_up, down.
//                     The last-arriver combine, not one in the wo phase's
//                     prologue: that prologue runs in every block, so each
//                     block would read every split of its lanes (up to
//                     16 x 8 x 2 x 130 floats a lane) to combine what one
//                     warp combines here once;
//   codec head        final norm -> hidden (f32), int8 head -> logits.
// Data that other blocks wrote during the launch is read with ld.global.cg
// (L2; L1 is not coherent across SMs); weights with ordinary loads.
//
// Lanes.  One lane runs `chunk_kernel` (a static shared-memory union of
// ~29 KB: two blocks per SM).  B = 8-32 lanes run `chunk_kernel_rows`
// (namespace `rows`), the same phases written for row tiles of NB lanes
// and instantiated at ROWS = 8: the blocks are split into B / 8 groups,
// group i serving lanes 8i .. 8i + 7 in every row-wise phase (GEMVs,
// projection, heads, feedback), so each block normalises and quantizes its
// tile's 8 rows once per phase and reads each weight column once for all 8
// (w4a8.cuh's NB-row GEMV, as talker_step.cu runs it); the B / 8 groups
// read the same columns at about the same time, mostly from L2.  Eight
// int8 + bf16 rows of K = 6144 and their group dots take 156 KB of
// dynamic shared memory, so that kernel runs one block per SM.  The
// predictor's attention runs in each block for its tile's 8 lanes (its
// scratch inside the GEMV region, after the staged rows); the talker's
// items span every block; the argmax scratch holds one slot per (lane,
// block).
//
// Barriers per frame: 1 + 16 x 6 x 4 + 15 + 1 + 28 x 5 + 1 = 542 at full
// width, at every B (638 before the predictor's attention went into its
// wo phase).  Measured on an H100 at B = 1 before that (chip_smoke.py
// reads block 0's clock at each barrier through `clocks`): 5.3 ms per
// frame, the lightest phases (the predictor's wo) ~4 us each; the
// attention phases, which kept only 2-4 blocks busy, took 11 us
// (predictor) and 27 us (talker) each.
//
// What bounds it on the card: bytes.  Per frame at full width, the
// talker's 0.70 GB of int4 weights and 22 MB of bf16 scales (0.216 ms at
// 3.35 TB/s), the predictor's 37.7 MB of int4 and 2.4 MB of f32 scales,
// read once if the 50 MB L2 keeps them over the 16 tokens (0.012 ms) or
// 16 times if not (0.19 ms), and 31 MB of lm-head windows (0.009 ms):
// 0.24-0.42 ms per frame, plus barrier latency, plus at B lanes each lane's
// visible cache prefix.  Later work, not here: the GEMV blocks' per-block
// 8-row prologue, the B / 8 weight re-reads, wgmma / TMA weight streaming,
// an L2 access-policy window that pins the predictor, fewer barriers in the
// talker.

#include <algorithm>
#include <climits>

#include "split_attn.cuh"
#include "w4a8.cuh"

namespace {

using bf16 = __nv_bfloat16;
using qtts::bf16r;
using qtts::bf2f;
using qtts::ld_bf;
using qtts::pv_slots;
using qtts::score_slots;
using qtts::warp_sum;

constexpr int WARPS = 8;
constexpr int THREADS = WARPS * 32;
constexpr int N_TOKENS = 16;
constexpr int WINDOW = 2048;       // predictor lm-head rows per codebook
constexpr int MAX_FRAMES = 8;
constexpr int MAX_K = 8192;        // widest GEMV input (int8 row in smem)
constexpr int MAX_D = 4096;        // widest row a block stages
constexpr int MAX_V = 4096;        // sampler columns
constexpr int TDH = 128;           // talker head_dim
constexpr int PDH = 64;            // predictor head_dim
constexpr int ROWS = 8;            // lanes per row tile of the batched form
constexpr int MAX_B = 32;
constexpr int CG = 2;              // query heads per kv head (both models)
constexpr int SPLIT = 64;          // talker prefix slots per work item
constexpr int N_PTRS = 66, N_INTS = 21, N_FLTS = 7;
constexpr long long BARRIER_TIMEOUT = 1LL << 34;   // SM cycles, ~8 s

enum { EPI_STORE = 0, EPI_RESID = 1, EPI_SWIGLU = 2 };

struct Args {
  // inputs
  const float *logits, *hidden, *cos, *sin, *u;
  const int *lengths, *write_idx;
  // talker (talker_step.prep_layer_weights)
  const float *t_ln1, *t_ln2, *t_qn, *t_kn;
  const uint8_t* t_wqkv_q; const bf16* t_wqkv_s;
  const uint8_t* t_wo_q;   const bf16* t_wo_s;
  const uint8_t* t_gu_q;   const bf16* t_gu_s;
  const uint8_t* t_dn_q;   const bf16* t_dn_s;
  bf16 *cache_k, *cache_v;
  // extras (chunk_step.prep_chunk_extras)
  const float* tfn; const int8_t* chead_q; const float* chead_s;
  const float *proj_w, *proj_b, *tts_pad;
  const void* ctab_fb; const bf16* ctab_pred;
  const float* pfn; const int8_t* phead_q; const float* phead_s;
  const float *pcos, *psin;
  // predictor (chunk_step.prep_predictor_w4)
  const float *p_ln1, *p_ln2, *p_qn, *p_kn;
  const uint8_t* p_wqkv_q; const float* p_wqkv_s;
  const uint8_t* p_wo_q;   const float* p_wo_s;
  const uint8_t* p_gu_q;   const float* p_gu_s;
  const uint8_t* p_dn_q;   const float* p_dn_s;
  // outputs
  int* codes; float *logits_out, *hidden_out, *taps;
  bf16* xtaps;                     // optional, batched form: [B, F, L + 1, D]
  // scratch
  bf16 *x, *qkv, *ctx, *ff, *px, *pqkv, *pff, *pk, *pv;
  float* part;                     // talker splits: acc [B*Hkv, NS, CG, Dh]
                                   //   then (max, sum) [B*Hkv, NS, CG, 2]
  unsigned* arrive;                // [B * Hkv] splits done, 0 between phases
  float* best_v; int* best_i;      // one lane: [blocks]; B: [B, blocks]
  unsigned* barrier;               // [arrivals, check-outs], 0 at launch
  long long* trace;                // optional: phase clocks of block 0
  // sizes
  int F, L, D, H, Hkv, t_dh, FF, C, prompt_cap, LP, DP, PH, PHkv, p_dh, PFF,
      R_fb, R_pd, V, fb_bf16, max_blocks_per_sm, B;
  float t_eps, p_eps, temperature, top_k, top_p, t_scale, p_scale;
  // the batched form's shared-memory layout (set by the launcher)
  int kmax, gd_ints;
};

// Per-warp scratch of the talker's split attention (talker_attn).
struct TalkWarp {
  float q[CG][TDH];                // normed, roped q heads times the scale
  float s[CG][SPLIT];              // a split's scores, then its p
  float k[TDH];                    // the frame's k row (bf16 values)
  float v[TDH];                    // and its v row
};

struct GemvSmem {
  int8_t xq[MAX_K];
  int gd[WARPS * 2 * (MAX_K / qtts::W4_GROUP)];
  uint16_t xs_raw[MAX_K];          // the (normed) input row, bf16 bits
  float sx[1];
};
struct RowSmem {
  float h[MAX_D];
  __align__(16) uint16_t xb_raw[MAX_D];   // bf16 bits (see xb())
  float bv[WARPS];
  int bi[WARPS];
};
// Floats of the predictor attention's shared scratch for ni (lane, kv
// head) items (pred_ctx_block): q [ni, CG, PDH], k [ni, PDH], v [ni, PDH],
// scores then p [ni, CG, N_TOKENS], sums [ni, CG].
__host__ __device__ inline size_t pred_attn_floats(int ni) {
  return (size_t)ni * (CG * PDH + 2 * PDH + CG * N_TOKENS + CG);
}

union Smem {
  GemvSmem g;
  RowSmem r;
  TalkWarp tw[WARPS];
};

__device__ __forceinline__ bf16* xb(Smem& sm) {
  return reinterpret_cast<bf16*>(sm.r.xb_raw);
}

// ------------------------------------------------------------- the barrier
// bar[0] is a monotonic arrival counter: barrier n of the launch completes
// when it reaches n * gridDim.x.  Arrival with release and polling with
// acquire semantics at GPU scope, as cooperative_groups' grid sync does;
// the block barriers around them order the other threads' accesses.  A
// block that waits for ~8 s traps (the launch then fails with an error)
// instead of hanging the card.  With `trace`, block 0 stores its SM clock
// as it leaves barrier n into trace[n] (trace[0]: at the kernel's start).
__device__ __forceinline__ void grid_sync(unsigned* bar, unsigned& target,
                                          long long* trace) {
  target += gridDim.x;
  __syncthreads();
  if (threadIdx.x == 0) {
    unsigned v;
    asm volatile("atom.add.release.gpu.u32 %0,[%1],%2;"
                 : "=r"(v) : "l"(bar), "r"(1u) : "memory");
    const long long t0 = clock64();
    do {
      asm volatile("ld.acquire.gpu.u32 %0,[%1];"
                   : "=r"(v) : "l"(bar) : "memory");
      if (clock64() - t0 > BARRIER_TIMEOUT) __trap();
    } while (v < target);
    if (trace != nullptr && blockIdx.x == 0)
      trace[target / gridDim.x] = clock64();
  }
  __syncthreads();
}

// After the last barrier each block checks out on bar[1]; the last one to
// do so sets both words back to 0 for the next launch.  By then every
// block has left its last poll of bar[0], so nothing reads it any more.
__device__ __forceinline__ void grid_exit(unsigned* bar) {
  if (threadIdx.x == 0) {
    unsigned old;
    asm volatile("atom.add.acq_rel.gpu.u32 %0,[%1],%2;"
                 : "=r"(old) : "l"(bar + 1), "r"(1u) : "memory");
    if (old == gridDim.x - 1) {
      bar[0] = 0u;
      bar[1] = 0u;
    }
  }
}

// ------------------------------------------------------------- reductions
__device__ __forceinline__ int block_min_int(int v, int* ired) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  __syncthreads();
  if ((threadIdx.x & 31) == 0) ired[threadIdx.x >> 5] = v;
  __syncthreads();
  int s = ired[0];
#pragma unroll
  for (int w = 1; w < WARPS; ++w) s = min(s, ired[w]);
  return s;
}

__device__ __forceinline__ bool better(float v, int i, float bv, int bi) {
  return v > bv || (v == bv && i < bi);
}

// ---------------------------------------------------------------- sampler
// One block: code from logits lg [V] (V <= MAX_V) and uniform u, the same
// arithmetic as ops.sampling.sample_threshold (f32 bisections: 24 for the
// top-k threshold, 24 for the nucleus threshold, 12 on the column index
// for the inverse CDF).  Every thread returns the code.
template <bool CG>
__device__ int sample_block(const float* lg, int V, float u, float temp,
                            float top_k, float top_p, float* red,
                            int* ired) {
  constexpr int PER = MAX_V / THREADS;
  const int tid = threadIdx.x;
  float v[PER];
  float m = -INFINITY;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int k = tid + i * THREADS;
    v[i] = k < V ? (CG ? __ldcg(lg + k) : lg[k]) : -INFINITY;
    m = fmaxf(m, v[i]);
  }
  m = qtts::block_max<THREADS>(m, red);
  if (temp <= 0.f) {
    int best = V;
#pragma unroll
    for (int i = 0; i < PER; ++i) {
      const int k = tid + i * THREADS;
      if (k < V && v[i] >= m) best = min(best, k);
    }
    return block_min_int(best, ired);
  }
  float lo = -1e5f, hi = m;
  for (int it = 0; it < 24; ++it) {
    const float mid = 0.5f * (lo + hi);
    float cnt = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) cnt += v[i] >= mid ? 1.f : 0.f;
    const bool ge = qtts::block_sum<THREADS>(cnt, red) >= top_k;
    lo = ge ? mid : lo;
    hi = ge ? hi : mid;
  }
  const float temp_c = fmaxf(temp, 1e-6f);
  float p[PER];
  bool keep[PER];
  float z = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    const int k = tid + i * THREADS;
    keep[i] = k < V && (v[i] >= lo || top_k <= 0.f);
    p[i] = keep[i] ? expf(__fdiv_rn(v[i] - m, temp_c)) : 0.f;
    z += p[i];
  }
  z = qtts::block_sum<THREADS>(z, red);
  float pmax = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    p[i] = __fdiv_rn(p[i], z);
    pmax = fmaxf(pmax, p[i]);
  }
  float plo = 0.f, phi = qtts::block_max<THREADS>(pmax, red);
  for (int it = 0; it < 24; ++it) {
    const float q = 0.5f * (plo + phi);
    float mass = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i) mass += p[i] > q ? p[i] : 0.f;
    const bool ge = qtts::block_sum<THREADS>(mass, red) >= top_p;
    plo = ge ? q : plo;
    phi = ge ? phi : q;
  }
  float tot = 0.f;
#pragma unroll
  for (int i = 0; i < PER; ++i) {
    p[i] = keep[i] && p[i] > plo ? p[i] : 0.f;
    tot += p[i];
  }
  const float target = u * qtts::block_sum<THREADS>(tot, red);
  int ilo = 0, ihi = V - 1;
  for (int it = 0; it < 12; ++it) {                 // 2^12 >= MAX_V
    const int imid = (ilo + ihi) / 2;
    float pref = 0.f;
#pragma unroll
    for (int i = 0; i < PER; ++i)
      pref += tid + i * THREADS <= imid ? p[i] : 0.f;
    const bool gt = qtts::block_sum<THREADS>(pref, red) > target;
    ihi = gt ? imid : ihi;
    ilo = gt ? ilo : imid + 1;
  }
  return ihi;
}

// ------------------------------------------------------------ row helpers
// 1 / sqrt(mean(x^2) + eps) over a bf16 row written during the launch.
__device__ __forceinline__ float rms_inv(const bf16* x, int K, float eps,
                                         float* red) {
  float ss = 0.f;
  for (int k = threadIdx.x; k < K; k += THREADS) {
    const float v = ld_bf<true>(x + k);
    ss += v * v;
  }
  ss = qtts::block_sum<THREADS>(ss, red);
  return 1.0f / sqrtf(ss / (float)K + eps);
}

// A full warp's dot of int8 row w [K] with bf16 xs [K] (shared), in f32;
// every lane gets the sum.  K % 16 == 0.
__device__ __forceinline__ float i8_row_dot(const int8_t* __restrict__ w,
                                            const bf16* xs, int K) {
  const int lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int k0 = lane * 16; k0 < K; k0 += 32 * 16) {
    const uint4 wv = *reinterpret_cast<const uint4*>(w + k0);
    const int8_t* w8 = reinterpret_cast<const int8_t*>(&wv);
    const uint4* xv = reinterpret_cast<const uint4*>(xs + k0);
    const uint4 xa = xv[0], xb = xv[1];
    const __nv_bfloat162* h0 = reinterpret_cast<const __nv_bfloat162*>(&xa);
    const __nv_bfloat162* h1 = reinterpret_cast<const __nv_bfloat162*>(&xb);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float2 f0 = __bfloat1622float2(h0[j]);
      const float2 f1 = __bfloat1622float2(h1[j]);
      acc = fmaf(f0.x, (float)w8[2 * j], acc);
      acc = fmaf(f0.y, (float)w8[2 * j + 1], acc);
      acc = fmaf(f1.x, (float)w8[8 + 2 * j], acc);
      acc = fmaf(f1.y, (float)w8[8 + 2 * j + 1], acc);
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
  return acc;
}

// (value, lowest index) over the blocks' scratch entries; every thread
// gets the index.
__device__ int grid_argmax(const Args& a, float* red, int* ired) {
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int i = threadIdx.x; i < (int)gridDim.x; i += THREADS) {
    const float v = __ldcg(a.best_v + i);
    const int k = __ldcg(a.best_i + i);
    if (better(v, k, bv, bi)) {
      bv = v;
      bi = k;
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
  __syncthreads();
  if ((threadIdx.x & 31) == 0) {
    red[threadIdx.x >> 5] = bv;
    ired[threadIdx.x >> 5] = bi;
  }
  __syncthreads();
  float v = red[0];
  int k = ired[0];
  for (int w = 1; w < WARPS; ++w)
    if (better(red[w], ired[w], v, k)) {
      v = red[w];
      k = ired[w];
    }
  return k;
}

// ------------------------------------------------------------------ phases
// dst[n] for n < N (grid-stride over output columns, one warp each): the
// w4a8 product of the (normed) input row with column n (and n + N for the
// SwiGLU pair), then the epilogue; the talker_step.cu GEMV body.  in ==
// nullptr: the input row is already staged in xs_raw (not normed).
template <int R, bool RMS, int EPI, typename S>
__device__ void gemv(const bf16* in, const float* norm_w, float eps, int K,
                     const uint8_t* wq, const S* ws, int N, bf16* dst,
                     Smem& sm, float* red) {
  if (in == nullptr)
    qtts::quantize_staged<THREADS>(K, reinterpret_cast<bf16*>(sm.g.xs_raw),
                                   sm.g.xq, sm.g.sx, red);
  else
    qtts::quantize_rows<1, RMS, THREADS, true>(
        in, norm_w, K, eps, reinterpret_cast<bf16*>(sm.g.xs_raw), sm.g.xq,
        sm.g.sx, red);
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* gw = sm.g.gd + warp * R * (K / qtts::W4_GROUP);
  for (int row = blockIdx.x * WARPS + warp; row < N;
       row += gridDim.x * WARPS) {
    float y[R];
    qtts::w4a8_warp_row<1, R>(sm.g.xq, sm.g.sx, K, wq, ws, N, row, gw, y);
    if (lane == 0) {
      bf16* o = dst + row;
      if (EPI == EPI_STORE) {
        *o = __float2bfloat16_rn(y[0]);
      } else if (EPI == EPI_RESID) {
        *o = __float2bfloat16_rn(__fadd_rn(ld_bf<true>(o), y[0]));
      } else {
        const float gate = y[0];
        const float act = bf16r(__fdiv_rn(gate, 1.0f + expf(-gate)));
        *o = __float2bfloat16_rn(__fmul_rn(act, y[R - 1]));
      }
    }
    __syncwarp();                  // gw is rewritten by the next column
  }
}

// Block 0: code_0 of frame f.  Every block: px = bf16(hid . proj_w^T + b).
__device__ void sample_project(const Args& a, int f, Smem& sm, float* red,
                               int* ired) {
  const float* lg = f == 0 ? a.logits : a.logits_out;
  const float* hid = f == 0 ? a.hidden : a.hidden_out;
  if (blockIdx.x == 0) {
    const int c0 = sample_block<true>(lg, a.V, a.u[f], a.temperature,
                                      a.top_k, a.top_p, red, ired);
    if (threadIdx.x == 0) a.codes[f * N_TOKENS] = c0;
  }
  for (int k = threadIdx.x; k < a.D; k += THREADS) sm.r.h[k] = __ldcg(hid + k);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int row = blockIdx.x * WARPS + warp; row < a.DP;
       row += gridDim.x * WARPS) {
    const float* w = a.proj_w + (size_t)row * a.D;
    float acc = 0.f;
    for (int k = lane * 4; k < a.D; k += 32 * 4) {
      const float4 wv = *reinterpret_cast<const float4*>(w + k);
      acc = fmaf(sm.r.h[k], wv.x, acc);
      acc = fmaf(sm.r.h[k + 1], wv.y, acc);
      acc = fmaf(sm.r.h[k + 2], wv.z, acc);
      acc = fmaf(sm.r.h[k + 3], wv.w, acc);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc += __shfl_xor_sync(0xffffffffu, acc, o);
    if (lane == 0)
      a.px[row] = __float2bfloat16_rn(__fadd_rn(acc, a.proj_b[row]));
  }
}

// ------------------------------------------------------------- attention

// The predictor's attention of token tok, layer l, for lanes lane0 ..
// lane0 + NB - 1, on the whole block: the G <= CG query heads' context
// (bf16) of each (lane, kv head) item into the lane's row of xs (stride
// PH * PDH) at the c-major positions of wo's input (position c * PHkv +
// kvh for head kvh * G + c); with `write`, token tok's k/v rows into slot
// tok of pk/pv (one block per lane writes; every block keeps its own copy
// in the scratch ps, pred_attn_floats(NB * PHkv) floats, and reads only
// slots < tok, written in earlier phases).  Four steps, each a loop of
// independent pieces over the block's threads, a barrier between them:
// 1. q/k norms and rope, one warp per item (norm_rope_heads_g's
//    arithmetic; lane holds dims lane and lane + 32, rotate_half's pairs;
//    the loads of the warp's items first);
// 2. scores, one thread per (item, slot): q . k by fma in dim order, times
//    the scale (slots > tok masked);
// 3. softmax, one thread per (item, head): max, p = exp(s - max), the sum
//    of p in slot order;
// 4. P.V, one thread per (item, DC columns): fma over the slots in order.
// Each item's arithmetic is the same whatever NB, so a batched launch's
// lanes equal the one-lane launch's.
template <int NB>
__device__ void pred_ctx_block(const Args& a, int lane0, int tok, int l,
                               bool write, float* ps, bf16* xs) {
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = a.PH / a.PHkv;
  const int NI = NB * a.PHkv;
  const int pnqkv = (a.PH + 2 * a.PHkv) * PDH, pdq = a.PH * PDH;
  float* qs = ps;                                   // [NI, CG, PDH]
  float* ks = qs + (size_t)NI * CG * PDH;           // [NI, PDH]
  float* vs = ks + (size_t)NI * PDH;                // [NI, PDH]
  float* ss = vs + (size_t)NI * PDH;                // [NI, CG, N_TOKENS]
  float* sums = ss + (size_t)NI * CG * N_TOKENS;    // [NI, CG]
  const float* cs = a.pcos + (size_t)tok * PDH;
  const float* sn = a.psin + (size_t)tok * PDH;
  auto kv_head = [&](int it) {                      // item it = b * PHkv + kvh
    return (((size_t)(lane0 + it / a.PHkv) * a.LP + l) * a.PHkv +
            it % a.PHkv) * N_TOKENS * PDH;
  };
  // ---- 1. norms and rope: IG items of the warp at a time, their rows
  // loaded first
  constexpr int IG = NB < 4 ? NB : 4;
  for (int it0 = warp; it0 < NI; it0 += IG * WARPS) {
    float raw[IG][CG + 1][2], rv[IG][2];
#pragma unroll
    for (int r = 0; r < IG; ++r) {
      const int it = it0 + r * WARPS;
      if (it < NI) {
        const int kvh = it % a.PHkv;
        const bf16* row = a.pqkv + (size_t)(lane0 + it / a.PHkv) * pnqkv;
#pragma unroll
        for (int h = 0; h <= CG; ++h) {          // q heads h < G; k at CG
          const bool live = h == CG || h < G;
          const bf16* src =
              row + (size_t)(h == CG ? a.PH + kvh : kvh * G + h) * PDH;
          raw[r][h][0] = live ? ld_bf<true>(src + lane) : 0.f;
          raw[r][h][1] = live ? ld_bf<true>(src + lane + 32) : 0.f;
        }
        const bf16* vsrc = row + (size_t)(a.PH + a.PHkv + kvh) * PDH;
        rv[r][0] = ld_bf<true>(vsrc + lane);
        rv[r][1] = ld_bf<true>(vsrc + lane + 32);
      }
    }
#pragma unroll
    for (int r = 0; r < IG; ++r) {
      const int it = it0 + r * WARPS;
      if (it >= NI) continue;
#pragma unroll
      for (int h = 0; h <= CG; ++h) {
        const float r0 = raw[r][h][0], r1 = raw[r][h][1];
        const float sq = __fadd_rn(warp_sum(__fmul_rn(r0, r0)),
                                   warp_sum(__fmul_rn(r1, r1)));
        const float inv = 1.0f / sqrtf(sq / (float)PDH + a.p_eps);
        const float* nw = (h == CG ? a.p_kn : a.p_qn) + (size_t)l * PDH;
        const float x0 = bf16r(__fmul_rn(__fmul_rn(r0, inv), nw[lane]));
        const float x1 = bf16r(__fmul_rn(__fmul_rn(r1, inv), nw[lane + 32]));
        float* dst = h == CG ? ks + (size_t)it * PDH
                             : qs + ((size_t)it * CG + h) * PDH;
        dst[lane] = bf16r(__fadd_rn(__fmul_rn(x0, cs[lane]),
                                    __fmul_rn(-x1, sn[lane])));
        dst[lane + 32] = bf16r(__fadd_rn(__fmul_rn(x1, cs[lane + 32]),
                                         __fmul_rn(x0, sn[lane + 32])));
      }
      vs[(size_t)it * PDH + lane] = rv[r][0];
      vs[(size_t)it * PDH + lane + 32] = rv[r][1];
      if (write) {
        __syncwarp();
        bf16* kr = a.pk + kv_head(it) + (size_t)tok * PDH;
        bf16* vr = a.pv + kv_head(it) + (size_t)tok * PDH;
        kr[lane] = __float2bfloat16_rn(ks[(size_t)it * PDH + lane]);
        kr[lane + 32] = __float2bfloat16_rn(ks[(size_t)it * PDH + lane + 32]);
        vr[lane] = __float2bfloat16_rn(rv[r][0]);
        vr[lane + 32] = __float2bfloat16_rn(rv[r][1]);
      }
    }
  }
  __syncthreads();
  // ---- 2. scores (the next pair's k row loaded during this pair's dots)
  auto load_k = [&](int pr, uint4 (&u)[PDH / 8]) {
    const int it = pr / N_TOKENS, j = pr % N_TOKENS;
    const bool g_ = pr < NI * N_TOKENS && j < tok;
    const bf16* kr = a.pk + (g_ ? kv_head(it) + (size_t)j * PDH : 0);
#pragma unroll
    for (int i = 0; i < PDH / 8; ++i)
      u[i] = g_ ? qtts::ld_16<true>(kr + i * 8) : make_uint4(0u, 0u, 0u, 0u);
  };
  uint4 un[PDH / 8];
  load_k(tid, un);
  for (int pr = tid; pr < NI * N_TOKENS; pr += THREADS) {
    const int it = pr / N_TOKENS, j = pr % N_TOKENS;
    uint4 u[PDH / 8];
#pragma unroll
    for (int i = 0; i < PDH / 8; ++i) u[i] = un[i];
    load_k(pr + THREADS, un);
    float* srow = ss + (size_t)it * CG * N_TOKENS + j;   // head g: g * 16
    if (j > tok) {
#pragma unroll
      for (int g = 0; g < CG; ++g) srow[g * N_TOKENS] = qtts::NEG;
      continue;
    }
    const float* qi = qs + (size_t)it * CG * PDH;
    const float* ki = ks + (size_t)it * PDH;
    float acc[CG];
#pragma unroll
    for (int g = 0; g < CG; ++g) acc[g] = 0.f;
#pragma unroll
    for (int i = 0; i < PDH / 8; ++i) {
      float kf[8];
      const __nv_bfloat162* h2 = reinterpret_cast<const __nv_bfloat162*>(&u[i]);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f2 = __bfloat1622float2(h2[e]);
        kf[2 * e] = j < tok ? f2.x : ki[i * 8 + 2 * e];
        kf[2 * e + 1] = j < tok ? f2.y : ki[i * 8 + 2 * e + 1];
      }
#pragma unroll
      for (int g = 0; g < CG; ++g)
#pragma unroll
        for (int e = 0; e < 8; ++e)
          acc[g] = fmaf(qi[g * PDH + i * 8 + e], kf[e], acc[g]);
    }
#pragma unroll
    for (int g = 0; g < CG; ++g)
      srow[g * N_TOKENS] = __fmul_rn(acc[g], a.p_scale);
  }
  __syncthreads();
  // ---- 3. softmax
  for (int rw = tid; rw < NI * CG; rw += THREADS) {
    if (rw % CG >= G) continue;
    float* srow = ss + (size_t)rw * N_TOKENS;
    float mx = qtts::NEG;
    for (int j = 0; j <= tok; ++j) mx = fmaxf(mx, srow[j]);
    float sum = 0.f;
    for (int j = 0; j <= tok; ++j) {
      const float p = expf(srow[j] - mx);
      srow[j] = p;
      sum += p;
    }
    sums[rw] = sum;
  }
  __syncthreads();
  // ---- 4. P.V: DC columns a thread, the v rows of JB slots loaded first
  constexpr int DC = NB == 1 ? 4 : 8;
  constexpr int JB = NB == 1 ? N_TOKENS : 8;
  constexpr int NCH = PDH / DC;
  for (int o = tid; o < NI * NCH; o += THREADS) {
    const int it = o / NCH, d0 = (o % NCH) * DC;
    const bf16* vb = a.pv + kv_head(it) + d0;
    const float* vi = vs + (size_t)it * PDH + d0;
    const float* pi = ss + (size_t)it * CG * N_TOKENS;
    float acc[CG][DC];
#pragma unroll
    for (int g = 0; g < CG; ++g)
#pragma unroll
      for (int e = 0; e < DC; ++e) acc[g][e] = 0.f;
    for (int j0 = 0; j0 <= tok; j0 += JB) {
      uint2 u[JB][DC / 4];
#pragma unroll
      for (int q = 0; q < JB; ++q)
#pragma unroll
        for (int c = 0; c < DC / 4; ++c)
          u[q][c] = j0 + q < tok
                        ? __ldcg(reinterpret_cast<const uint2*>(
                              vb + (size_t)(j0 + q) * PDH + 4 * c))
                        : make_uint2(0u, 0u);
#pragma unroll
      for (int q = 0; q < JB; ++q) {
        const int j = j0 + q;
        if (j > tok) break;
        float vf[DC];
#pragma unroll
        for (int c = 0; c < DC / 4; ++c) {
          const __nv_bfloat162* h2 =
              reinterpret_cast<const __nv_bfloat162*>(&u[q][c]);
          const float2 va = __bfloat1622float2(h2[0]);
          const float2 vb2 = __bfloat1622float2(h2[1]);
          vf[4 * c] = j < tok ? va.x : vi[4 * c];
          vf[4 * c + 1] = j < tok ? va.y : vi[4 * c + 1];
          vf[4 * c + 2] = j < tok ? vb2.x : vi[4 * c + 2];
          vf[4 * c + 3] = j < tok ? vb2.y : vi[4 * c + 3];
        }
#pragma unroll
        for (int g = 0; g < CG; ++g) {
          const float p = pi[g * N_TOKENS + j];
#pragma unroll
          for (int e = 0; e < DC; ++e) acc[g][e] = fmaf(p, vf[e], acc[g][e]);
        }
      }
    }
    const int bl = it / a.PHkv, kvh = it % a.PHkv;
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      if (g >= G) break;
      const float den = fmaxf(sums[(size_t)it * CG + g], 1e-30f);
      bf16* c = xs + (size_t)bl * pdq + ((size_t)g * a.PHkv + kvh) * PDH + d0;
#pragma unroll
      for (int e = 0; e < DC; ++e) c[e] = __float2bfloat16_rn(acc[g][e] / den);
    }
  }
  __syncthreads();
}

// The talker's q heads and k head of (lane b, kv head kvh) at frame f,
// layer l, on one warp: norm_rope_heads_g's arithmetic (its sums of
// squares in the same order: lane holds dims lane + 32 i, each set's
// butterfly, then the sets in order), q times the score scale, into w.q;
// the k row (roped) and the v row into w.k and w.v.
__device__ void talker_qk_warp(const Args& a, int b, int kvh, int f, int l,
                               TalkWarp& w) {
  qtts::qk_warp(a.qkv + (size_t)b * (a.H + 2 * a.Hkv) * TDH, a.H, a.Hkv, kvh,
                a.H / a.Hkv, a.t_qn + (size_t)l * TDH, a.t_kn + (size_t)l * TDH,
                a.cos + ((size_t)f * a.B + b) * TDH,
                a.sin + ((size_t)f * a.B + b) * TDH, a.t_eps, a.t_scale, w);
}


// Talker attention of frame f, layer l, split over the whole grid: items
// (lane b, kv head, split s of the cache prefix [0, start)), one warp
// each, items spread over the blocks first.  Per split: its scores
// (score_slots; slot c visible iff c < length or c >= prompt_cap), its
// max m, p = exp(s - m) (masked: 0 exactly), l = the 32 lanes' butterfly
// of p[lane] + p[lane + 32], acc = P.V in slot order by fma (lane: columns
// 4 lane .. 4 lane + 3).  With more than one split each writes (acc, m, l)
// to a.part; the warp that finishes last (a.arrive) combines them in split
// order: M = max m_s, acc = sum_s acc_s exp(m_s - M) by fma, l likewise.
// That warp then writes the frame's k/v row at slot start + f and merges
// the chunk's own slots start .. start + f (always visible) as one last
// online-softmax step, the JAX order.  Context out in head order.
__device__ void talker_attn(const Args& a, int f, int l, int start,
                            TalkWarp* tw) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  TalkWarp& w = tw[warp];
  const int G = a.H / a.Hkv;
  const int dq = a.H * TDH;
  const int end = min(start, a.C);             // the cache prefix
  const int ns = max(1, (end + SPLIT - 1) / SPLIT);
  const int nsmax = (a.C + SPLIT - 1) / SPLIT;
  const size_t n_heads = (size_t)a.B * a.Hkv * nsmax * CG;
  float* part_acc = a.part;
  float* part_ml = a.part + n_heads * TDH;
  const int n_items = a.B * a.Hkv * ns;
  for (int it = blockIdx.x + warp * gridDim.x; it < n_items;
       it += gridDim.x * WARPS) {
    const int s = it % ns, bh = it / ns;
    const int b = bh / a.Hkv, kvh = bh % a.Hkv;
    const int length = a.lengths[b];
    const size_t head = ((size_t)l * a.B + b) * a.Hkv + kvh;
    bf16* kp = a.cache_k + head * a.C * TDH;
    bf16* vp = a.cache_v + head * a.C * TDH;
    talker_qk_warp(a, b, kvh, f, l, w);
    // ---- split s: slots [c0, c0 + n)
    const int c0 = s * SPLIT;
    const int n = max(0, min(SPLIT, end - c0));
    const int pc = a.prompt_cap;
    score_slots(
        w, G, n, [&](int j) { return kp + (size_t)(c0 + j) * TDH; },
        [](int) { return false; },
        [&](int j) { return c0 + j < length || c0 + j >= pc; });
    float m[CG], ls[CG], acc[CG][4];
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      const float sa = lane < n ? w.s[g][lane] : qtts::NEG;
      const float sb = lane + 32 < n ? w.s[g][lane + 32] : qtts::NEG;
      float mx = fmaxf(sa, sb);
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float pa = sa > qtts::NEG ? expf(sa - mx) : 0.f;
      const float pb = sb > qtts::NEG ? expf(sb - mx) : 0.f;
      m[g] = mx;
      ls[g] = warp_sum(__fadd_rn(pa, pb));
      __syncwarp();
      if (g < G) {
        w.s[g][lane] = pa;
        w.s[g][lane + 32] = pb;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][i] = 0.f;
    }
    __syncwarp();
    pv_slots(w, n, [&](int j) { return vp + (size_t)(c0 + j) * TDH; },
             [](int) { return false; }, acc);
    if (ns > 1) {
      // ---- this split's partials out; the last of the item's splits
      // combines them
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        if (g >= G) continue;
        const size_t r = ((size_t)bh * nsmax + s) * CG + g;
        *reinterpret_cast<float4*>(part_acc + r * TDH + 4 * lane) =
            make_float4(acc[g][0], acc[g][1], acc[g][2], acc[g][3]);
        if (lane == 0) {
          part_ml[r * 2] = m[g];
          part_ml[r * 2 + 1] = ls[g];
        }
      }
      __threadfence();
      __syncwarp();
      unsigned old = 0;
      if (lane == 0) old = atomicAdd(a.arrive + bh, 1u);
      old = __shfl_sync(0xffffffffu, old, 0);
      if (old != (unsigned)ns - 1) continue;
      __threadfence();
#pragma unroll
      for (int g = 0; g < CG; ++g) {
        if (g >= G) continue;
        const size_t r0 = (size_t)bh * nsmax * CG + g;
        float mm = qtts::NEG;
#pragma unroll 4
        for (int z = 0; z < ns; ++z)
          mm = fmaxf(mm, __ldcg(part_ml + (r0 + (size_t)z * CG) * 2));
        float l_ = 0.f, ac[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll 4
        for (int z = 0; z < ns; ++z) {
          const size_t r = r0 + (size_t)z * CG;
          const float wz = expf(__ldcg(part_ml + r * 2) - mm);
          l_ = fmaf(__ldcg(part_ml + r * 2 + 1), wz, l_);
          const float4 pz = __ldcg(
              reinterpret_cast<const float4*>(part_acc + r * TDH + 4 * lane));
          ac[0] = fmaf(pz.x, wz, ac[0]);
          ac[1] = fmaf(pz.y, wz, ac[1]);
          ac[2] = fmaf(pz.z, wz, ac[2]);
          ac[3] = fmaf(pz.w, wz, ac[3]);
        }
        m[g] = mm;
        ls[g] = l_;
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[g][i] = ac[i];
      }
      if (lane == 0) a.arrive[bh] = 0u;          // for the next layer
    }
    // ---- the merging warp: slot start + f written once, then the chunk's
    // frames 0..f at slots start .. start + f as one merge
    const int slot = start + f;
    if (slot < a.C) {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        kp[(size_t)slot * TDH + lane + 32 * i] =
            __float2bfloat16_rn(w.k[lane + 32 * i]);
        vp[(size_t)slot * TDH + lane + 32 * i] =
            __float2bfloat16_rn(w.v[lane + 32 * i]);
      }
    }
    const int n_loc = min(f + 1, a.C - start);
    auto own = [&](int j) { return j == f; };
    score_slots(
        w, G, n_loc, [&](int j) { return kp + (size_t)(start + j) * TDH; },
        own, [](int) { return true; });
    // rescale the prefix by exp(m - mx), then p = exp(s - mx) of each own
    // slot into w.s for pv_slots
    float lsum[CG];
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      float mx = m[g];
      for (int j = 0; j < n_loc; ++j) mx = fmaxf(mx, w.s[g][j]);
      const float alpha = expf(m[g] - mx);
      lsum[g] = __fmul_rn(ls[g], alpha);
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[g][i] = __fmul_rn(acc[g][i], alpha);
      __syncwarp();
      float pj = 0.f;
      for (int j = 0; j < n_loc; ++j) {
        const float p = expf(w.s[g][j] - mx);
        lsum[g] = __fadd_rn(lsum[g], p);
        if (lane == j) pj = p;
      }
      __syncwarp();
      if (lane < n_loc) w.s[g][lane] = pj;
    }
    __syncwarp();
    pv_slots(w, n_loc, [&](int j) { return vp + (size_t)(start + j) * TDH; },
             own, acc);
#pragma unroll
    for (int g = 0; g < CG; ++g) {
      if (g >= G) continue;
      float* ac = acc[g];
      const float den = fmaxf(lsum[g], 1e-30f);
      __nv_bfloat162 o2[2];
      o2[0] = __floats2bfloat162_rn(ac[0] / den, ac[1] / den);
      o2[1] = __floats2bfloat162_rn(ac[2] / den, ac[3] / den);
      *reinterpret_cast<uint2*>(a.ctx + (size_t)b * dq +
                                ((size_t)kvh * G + g) * TDH + 4 * lane) =
          *reinterpret_cast<const uint2*>(o2);
    }
    __syncwarp();                  // w is rewritten by the warp's next item
  }
}

// The predictor's attention and wo phase of token tok, layer l (one lane):
// a block with wo rows stages the context in xs_raw (pred_ctx_block, its
// scratch after the staged row; block 0 writes the k/v rows) and runs the
// wo GEMV on it.
__device__ void pred_attn_wo(const Args& a, int tok, int l, Smem& sm,
                             float* red) {
  const int pdq = a.PH * PDH;
  if ((int)blockIdx.x * WARPS >= a.DP) return;   // no wo rows here
  bf16* xs = reinterpret_cast<bf16*>(sm.g.xs_raw);
  pred_ctx_block<1>(a, 0, tok, l, blockIdx.x == 0,
                    reinterpret_cast<float*>(sm.g.xs_raw + pdq), xs);
  gemv<1, false, EPI_RESID, float>(
      nullptr, nullptr, a.p_eps, pdq,
      a.p_wo_q + (size_t)l * a.DP * (pdq / 2),
      a.p_wo_s + (size_t)l * a.DP * (pdq / qtts::W4_GROUP), a.DP, a.px, sm,
      red);
}

// Window tok - 1 of the predictor's lm-head: logits into taps, each
// block's best (value, lowest row) into the scratch.
__device__ void pred_head(const Args& a, int f, int tok, Smem& sm,
                          float* red) {
  const float inv = rms_inv(a.px, a.DP, a.p_eps, red);
  for (int k = threadIdx.x; k < a.DP; k += THREADS)
    xb(sm)[k] = __float2bfloat16_rn(
        __fmul_rn(__fmul_rn(ld_bf<true>(a.px + k), inv), a.pfn[k]));
  __syncthreads();
  const int win = tok - 1;
  const int8_t* W = a.phead_q + (size_t)win * WINDOW * a.DP;
  const float* S = a.phead_s + (size_t)win * WINDOW;
  float* out = a.taps == nullptr
                   ? nullptr
                   : a.taps + ((size_t)f * (N_TOKENS - 1) + win) * WINDOW;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float bv = -INFINITY;
  int bi = INT_MAX;
  for (int row = blockIdx.x * WARPS + warp; row < WINDOW;
       row += gridDim.x * WARPS) {
    const float lg = __fmul_rn(i8_row_dot(W + (size_t)row * a.DP, xb(sm),
                                          a.DP), S[row]);
    if (lane == 0 && out != nullptr) out[row] = lg;
    if (lg > bv) {                  // rows rise: the first max is kept
      bv = lg;
      bi = row;
    }
  }
  if (lane == 0) {
    sm.r.bv[warp] = bv;
    sm.r.bi[warp] = bi;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < WARPS; ++w)
      if (better(sm.r.bv[w], sm.r.bi[w], bv, bi)) {
        bv = sm.r.bv[w];
        bi = sm.r.bi[w];
      }
    a.best_v[blockIdx.x] = bv;
    a.best_i[blockIdx.x] = bi;
  }
}

// x = bf16(sum_q ctab_fb[q][code_q] (f32, q in order) + tts_pad).
__device__ void feedback(const Args& a, int f, int code15) {
  int code[N_TOKENS];
#pragma unroll
  for (int q = 0; q < N_TOKENS; ++q) {
    const int c = q < N_TOKENS - 1 ? __ldcg(a.codes + f * N_TOKENS + q)
                                   : code15;
    code[q] = min(max(c, 0), a.R_fb - 1);
  }
  for (int k = blockIdx.x * THREADS + threadIdx.x; k < a.D;
       k += gridDim.x * THREADS) {
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < N_TOKENS; ++q) {
      const size_t i = ((size_t)q * a.R_fb + code[q]) * a.D + k;
      s = __fadd_rn(s, a.fb_bf16 ? bf2f(static_cast<const bf16*>(a.ctab_fb)[i])
                                 : static_cast<const float*>(a.ctab_fb)[i]);
    }
    a.x[k] = __float2bfloat16_rn(__fadd_rn(s, a.tts_pad[k]));
  }
}

// hidden = RMSNorm(x, tfn) in f32 (block 0 writes it out); logits[n] =
// (bf16(hidden) . chead_q[n]) * chead_s[n] for n < V.
__device__ void codec_head(const Args& a, Smem& sm, float* red) {
  const float inv = rms_inv(a.x, a.D, a.t_eps, red);
  for (int k = threadIdx.x; k < a.D; k += THREADS) {
    const float h = __fmul_rn(__fmul_rn(ld_bf<true>(a.x + k), inv), a.tfn[k]);
    xb(sm)[k] = __float2bfloat16_rn(h);
    if (blockIdx.x == 0) a.hidden_out[k] = h;
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int row = blockIdx.x * WARPS + warp; row < a.V;
       row += gridDim.x * WARPS) {
    const float acc = i8_row_dot(a.chead_q + (size_t)row * a.D, xb(sm), a.D);
    if (lane == 0) a.logits_out[row] = __fmul_rn(acc, a.chead_s[row]);
  }
}

__global__ void __launch_bounds__(THREADS, 2) chunk_kernel(const Args a) {
  __shared__ __align__(16) Smem sm;
  __shared__ float red[WARPS];
  __shared__ int ired[WARPS];
  unsigned target = 0;             // bar[0] at the next barrier
  if (a.trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    a.trace[0] = clock64();
  const int start = a.write_idx[0];
  const int GRP = qtts::W4_GROUP;
  // predictor and talker matrix sizes
  const int pnqkv = (a.PH + 2 * a.PHkv) * PDH;
  const int nqkv = (a.H + 2 * a.Hkv) * TDH, dq = a.H * TDH;
  const int DP = a.DP, D = a.D;

  for (int f = 0; f < a.F; ++f) {
    sample_project(a, f, sm, red, ired);
    grid_sync(a.barrier, target, a.trace);

    // ---- predictor: 16 tokens x LP layers
    for (int tok = 0; tok < N_TOKENS; ++tok) {
      for (int l = 0; l < a.LP; ++l) {
        const bf16* in = a.px;
        if (l == 0 && tok >= 1) {
          // the input of token tok: ctab_pred[tok - 1][code_{tok - 1}]
          const int prev = tok - 1;
          int code = prev == 0 ? __ldcg(a.codes + f * N_TOKENS)
                               : grid_argmax(a, red, ired);
          if (prev >= 1 && blockIdx.x == 0 && threadIdx.x == 0)
            a.codes[f * N_TOKENS + prev] = code;
          code = min(max(code, 0), a.R_pd - 1);
          in = a.ctab_pred + ((size_t)prev * a.R_pd + code) * DP;
          if (blockIdx.x == 0)
            for (int k = threadIdx.x; k < DP; k += THREADS) a.px[k] = in[k];
        }
        gemv<1, true, EPI_STORE, float>(
            in, a.p_ln1 + (size_t)l * DP, a.p_eps, DP,
            a.p_wqkv_q + (size_t)l * pnqkv * (DP / 2),
            a.p_wqkv_s + (size_t)l * pnqkv * (DP / GRP), pnqkv, a.pqkv, sm,
            red);
        grid_sync(a.barrier, target, a.trace);
        pred_attn_wo(a, tok, l, sm, red);
        grid_sync(a.barrier, target, a.trace);
        gemv<2, true, EPI_SWIGLU, float>(
            a.px, a.p_ln2 + (size_t)l * DP, a.p_eps, DP,
            a.p_gu_q + (size_t)l * 2 * a.PFF * (DP / 2),
            a.p_gu_s + (size_t)l * 2 * a.PFF * (DP / GRP), a.PFF, a.pff, sm,
            red);
        grid_sync(a.barrier, target, a.trace);
        gemv<1, false, EPI_RESID, float>(
            a.pff, nullptr, a.p_eps, a.PFF,
            a.p_dn_q + (size_t)l * DP * (a.PFF / 2),
            a.p_dn_s + (size_t)l * DP * (a.PFF / GRP), DP, a.px, sm, red);
        grid_sync(a.barrier, target, a.trace);
      }
      if (tok >= 1) {
        pred_head(a, f, tok, sm, red);
        grid_sync(a.barrier, target, a.trace);
      }
    }

    // ---- feedback (code_15 is the last window's argmax)
    const int code15 = grid_argmax(a, red, ired);
    if (blockIdx.x == 0 && threadIdx.x == 0)
      a.codes[f * N_TOKENS + N_TOKENS - 1] = code15;
    feedback(a, f, code15);
    grid_sync(a.barrier, target, a.trace);

    // ---- talker step
    for (int l = 0; l < a.L; ++l) {
      gemv<1, true, EPI_STORE, bf16>(
          a.x, a.t_ln1 + (size_t)l * D, a.t_eps, D,
          a.t_wqkv_q + (size_t)l * nqkv * (D / 2),
          a.t_wqkv_s + (size_t)l * nqkv * (D / GRP), nqkv, a.qkv, sm, red);
      grid_sync(a.barrier, target, a.trace);
      talker_attn(a, f, l, start, sm.tw);
      grid_sync(a.barrier, target, a.trace);
      gemv<1, false, EPI_RESID, bf16>(
          a.ctx, nullptr, a.t_eps, dq, a.t_wo_q + (size_t)l * D * (dq / 2),
          a.t_wo_s + (size_t)l * D * (dq / GRP), D, a.x, sm, red);
      grid_sync(a.barrier, target, a.trace);
      gemv<2, true, EPI_SWIGLU, bf16>(
          a.x, a.t_ln2 + (size_t)l * D, a.t_eps, D,
          a.t_gu_q + (size_t)l * 2 * a.FF * (D / 2),
          a.t_gu_s + (size_t)l * 2 * a.FF * (D / GRP), a.FF, a.ff, sm, red);
      grid_sync(a.barrier, target, a.trace);
      gemv<1, false, EPI_RESID, bf16>(
          a.ff, nullptr, a.t_eps, a.FF,
          a.t_dn_q + (size_t)l * D * (a.FF / 2),
          a.t_dn_s + (size_t)l * D * (a.FF / GRP), D, a.x, sm, red);
      grid_sync(a.barrier, target, a.trace);
    }
    codec_head(a, sm, red);
    grid_sync(a.barrier, target, a.trace);
  }
  grid_exit(a.barrier);
}

// One block per row: the sampler alone (sample_block), for the tests.
__global__ void __launch_bounds__(THREADS)
sample_kernel(const float* __restrict__ logits, const float* __restrict__ u,
              int* __restrict__ out, int V, float temp, float top_k,
              float top_p) {
  __shared__ float red[WARPS];
  __shared__ int ired[WARPS];
  const int c = sample_block<false>(logits + (size_t)blockIdx.x * V, V,
                                    u[blockIdx.x], temp, top_k, top_p, red,
                                    ired);
  if (threadIdx.x == 0) out[blockIdx.x] = c;
}

// ============================================ the batched form (B = 8-32)
// The phases of chunk_kernel for NB lanes at once, each lane's arithmetic
// that of the one-lane code above (so every lane is bit-equal to a
// one-lane launch): each row-wise phase serves the block's row tile of NB
// lanes; attention phases take (lane, kv head) items over all blocks.
namespace rows {

// What a phase sees of the block's dynamic shared memory, for NB rows
// (lanes) at once; the phases' regions overlap (one phase at a time).
template <int NB>
struct Views {
  int8_t* xq;                      // [NB, K] GEMV: int8 rows
  bf16* xs;                        // [NB, K] GEMV: (normed) bf16 rows
  int* gd;                         // [WARPS, R, K / 128, NB] group dots
  float* sx;                       // [NB] GEMV: row scales
  float* h;                        // [NB, D] projection: f32 hidden rows
  bf16* xb;                        // [NB, K] heads: normed bf16 rows
  TalkWarp* tw;                    // [WARPS] talker attention
  float* pa;                       // p_wo: predictor attention scratch,
                                   //   after the staged context rows
};

// Small per-block state, in static shared memory.
template <int NB>
struct Small {
  float red[WARPS];
  int ired[WARPS];
  float bv[WARPS * NB];            // the head's best (value, row) per warp
  int bi[WARPS * NB];              //   and lane
  int code[NB];                    // the block's lanes' codes
  int row[NB];                     // and their (clamped) table rows
};

// The block's row tile: lanes tile * NB .. tile * NB + NB - 1, served by
// the nblk blocks with blockIdx.x % tiles == tile; rank is the block's
// index among them.  One tile: every block, rank = blockIdx.x.
struct Part {
  int tile, rank, nblk;
};

__device__ __forceinline__ Part partition(int tiles) {
  Part p;
  p.tile = blockIdx.x % tiles;
  p.rank = blockIdx.x / tiles;
  p.nblk = (gridDim.x - p.tile + tiles - 1) / tiles;
  return p;
}

// The input rows of a GEMV: row b is base + (idx ? idx[b] : first + b) * K;
// base == nullptr: the rows are already staged in the block's xs (not
// normed).
struct Rows {
  const bf16* base;
  const int* idx;
  int first;
};

template <int NB>
__device__ __forceinline__ float pick(const float (&x)[NB], int i) {
  float r = x[0];
#pragma unroll
  for (int b = 1; b < NB; ++b)
    if (b == i) r = x[b];
  return r;
}

// A full warp's dots of int8 row w [K] with the NB bf16 rows xs [NB, K]
// (shared), in f32; every lane gets every sum.  K % 16 == 0.  Each row's
// sum runs in the one-row order.
template <int NB>
__device__ __forceinline__ void i8_rows_dot(const int8_t* __restrict__ w,
                                            const bf16* xs, int K,
                                            float (&acc)[NB]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int b = 0; b < NB; ++b) acc[b] = 0.f;
  for (int k0 = lane * 16; k0 < K; k0 += 32 * 16) {
    const uint4 wv = *reinterpret_cast<const uint4*>(w + k0);
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
        acc[b] = fmaf(f0.x, (float)w8[2 * j], acc[b]);
        acc[b] = fmaf(f0.y, (float)w8[2 * j + 1], acc[b]);
        acc[b] = fmaf(f1.x, (float)w8[8 + 2 * j], acc[b]);
        acc[b] = fmaf(f1.y, (float)w8[8 + 2 * j + 1], acc[b]);
      }
    }
  }
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int o = 16; o > 0; o >>= 1)
      acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], o);
}

// s.code[b] = the window argmax of lane tile * NB + b: (value, lowest
// index) over the entries of the tile's blocks, one warp per lane.
template <int NB>
__device__ void lane_argmax(const Args& a, const Part& p, Small<NB>& s) {
  static_assert(NB <= WARPS, "one warp per lane");
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (warp < NB) {
    const size_t base = (size_t)(p.tile * NB + warp) * gridDim.x;
    float bv = -INFINITY;
    int bi = INT_MAX;
    for (int r = lane; r < p.nblk; r += 32) {
      const float v = __ldcg(a.best_v + base + r);
      const int k = __ldcg(a.best_i + base + r);
      if (better(v, k, bv, bi)) {
        bv = v;
        bi = k;
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
    if (lane == 0) s.code[warp] = bi;
  }
  __syncthreads();
}

// dst[lane, n] for n < N and the block's NB lanes (grid-stride over output
// columns within the tile, one warp each): the w4a8 product of each lane's
// (normed) input row with column n (and n + N for the SwiGLU pair), then
// the epilogue; the talker_step.cu GEMV body.  Each row is quantized alone,
// as at B = 1.
template <int NB, int R, bool RMS, int EPI, typename S>
__device__ void gemv(const Rows& in, const float* norm_w, float eps, int K,
                     const uint8_t* wq, const S* ws, int N, bf16* dst,
                     const Views<NB>& v, const Part& p, float* red) {
#pragma unroll 1
  for (int b = 0; b < NB; ++b) {
    if (in.base == nullptr)
      qtts::quantize_staged<THREADS>(K, v.xs + (size_t)b * K,
                                     v.xq + (size_t)b * K, v.sx + b, red);
    else
      qtts::quantize_rows<1, RMS, THREADS, true>(
          in.base + (size_t)(in.idx ? in.idx[b] : in.first + b) * K, norm_w,
          K, eps, v.xs + (size_t)b * K, v.xq + (size_t)b * K, v.sx + b,
          red);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int* gw = v.gd + (size_t)warp * R * (K / qtts::W4_GROUP) * NB;
  for (int col = p.rank * WARPS + warp; col < N; col += p.nblk * WARPS) {
    float y[R];
    qtts::w4a8_warp_row<NB, R>(v.xq, v.sx, K, wq, ws, N, col, gw, y);
    if (lane < NB) {
      bf16* o = dst + (size_t)(p.tile * NB + lane) * N + col;
      if (EPI == EPI_STORE) {
        *o = __float2bfloat16_rn(y[0]);
      } else if (EPI == EPI_RESID) {
        *o = __float2bfloat16_rn(__fadd_rn(ld_bf<true>(o), y[0]));
      } else {
        const float gate = y[0];
        const float act = bf16r(__fdiv_rn(gate, 1.0f + expf(-gate)));
        *o = __float2bfloat16_rn(__fmul_rn(act, y[R - 1]));
      }
    }
    __syncwarp();                  // gw is rewritten by the next column
  }
}

// Block b < B: code_0 of lane b, frame f.  Every block: px = bf16(hid .
// proj_w^T + b) for its lanes.
template <int NB>
__device__ void sample_project(const Args& a, int f, const Views<NB>& v,
                               const Part& p, Small<NB>& s) {
  const float* lg = f == 0 ? a.logits : a.logits_out;
  const float* hid = f == 0 ? a.hidden : a.hidden_out;
  if ((int)blockIdx.x < a.B) {
    const int b = blockIdx.x;
    const int c0 = sample_block<true>(lg + (size_t)b * a.V, a.V,
                                      a.u[f * a.B + b], a.temperature,
                                      a.top_k, a.top_p, s.red, s.ired);
    if (threadIdx.x == 0) a.codes[((size_t)b * a.F + f) * N_TOKENS] = c0;
  }
  const int lane0 = p.tile * NB;
  for (int b = 0; b < NB; ++b)
    for (int k = threadIdx.x; k < a.D; k += THREADS)
      v.h[(size_t)b * a.D + k] = __ldcg(hid + (size_t)(lane0 + b) * a.D + k);
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int row = p.rank * WARPS + warp; row < a.DP;
       row += p.nblk * WARPS) {
    const float* w = a.proj_w + (size_t)row * a.D;
    float acc[NB];
#pragma unroll
    for (int b = 0; b < NB; ++b) acc[b] = 0.f;
    for (int k = lane * 4; k < a.D; k += 32 * 4) {
      const float4 wv = *reinterpret_cast<const float4*>(w + k);
#pragma unroll
      for (int b = 0; b < NB; ++b) {
        const float* h = v.h + (size_t)b * a.D;
        acc[b] = fmaf(h[k], wv.x, acc[b]);
        acc[b] = fmaf(h[k + 1], wv.y, acc[b]);
        acc[b] = fmaf(h[k + 2], wv.z, acc[b]);
        acc[b] = fmaf(h[k + 3], wv.w, acc[b]);
      }
    }
#pragma unroll
    for (int b = 0; b < NB; ++b)
#pragma unroll
      for (int o = 16; o > 0; o >>= 1)
        acc[b] += __shfl_xor_sync(0xffffffffu, acc[b], o);
    if (lane < NB)
      a.px[(size_t)(lane0 + lane) * a.DP + row] =
          __float2bfloat16_rn(__fadd_rn(pick(acc, lane), a.proj_b[row]));
  }
}

// The input rows of token tok >= 1, layer 0: ctab_pred[tok - 1][code] of
// each of the block's lanes (code_0 from the sampler; later codes from the
// last window's argmax, which the tile's first block also writes out).
// The tile's first block copies them into px for the residual adds.
template <int NB>
__device__ Rows token_rows(const Args& a, int f, int tok, const Part& p,
                           Small<NB>& s) {
  const int prev = tok - 1;
  const int lane0 = p.tile * NB;
  if (prev == 0) {
    if (threadIdx.x < NB)
      s.code[threadIdx.x] = __ldcg(
          a.codes + ((size_t)(lane0 + threadIdx.x) * a.F + f) * N_TOKENS);
    __syncthreads();
  } else {
    lane_argmax<NB>(a, p, s);
  }
  if (threadIdx.x < NB) {
    const int c = s.code[threadIdx.x];
    if (prev >= 1 && p.rank == 0)
      a.codes[((size_t)(lane0 + threadIdx.x) * a.F + f) * N_TOKENS + prev] = c;
    s.row[threadIdx.x] = min(max(c, 0), a.R_pd - 1);
  }
  __syncthreads();
  const Rows in{a.ctab_pred + (size_t)prev * a.R_pd * a.DP, s.row, 0};
  if (p.rank == 0)
    for (int b = 0; b < NB; ++b)
      for (int k = threadIdx.x; k < a.DP; k += THREADS)
        a.px[(size_t)(lane0 + b) * a.DP + k] =
            in.base[(size_t)s.row[b] * a.DP + k];
  return in;
}

// The predictor's attention and wo phase of token tok, layer l, for the
// block's lanes: a block with wo rows stages its tile's contexts in xs
// (pred_ctx_block; the tile's first block writes the k/v rows) and runs
// the wo GEMV on them.
template <int NB>
__device__ void pred_attn_wo(const Args& a, int tok, int l,
                             const Views<NB>& v, const Part& p, float* red) {
  const int pdq = a.PH * PDH;
  if (p.rank * WARPS >= a.DP) return;          // no wo rows here
  const int lane0 = p.tile * NB;
  pred_ctx_block<NB>(a, lane0, tok, l, p.rank == 0, v.pa, v.xs);
  gemv<NB, 1, false, EPI_RESID, float>(
      Rows{nullptr, nullptr, lane0}, nullptr, a.p_eps, pdq,
      a.p_wo_q + (size_t)l * a.DP * (pdq / 2),
      a.p_wo_s + (size_t)l * a.DP * (pdq / qtts::W4_GROUP), a.DP, a.px, v,
      p, red);
}

// Window tok - 1 of the predictor's lm-head for the block's lanes: logits
// into taps, each block's best (value, lowest row) per lane into the
// scratch.
template <int NB>
__device__ void pred_head(const Args& a, int f, int tok, const Views<NB>& v,
                          const Part& p, Small<NB>& s) {
  const int lane0 = p.tile * NB;
  for (int b = 0; b < NB; ++b) {
    const bf16* x = a.px + (size_t)(lane0 + b) * a.DP;
    const float inv = rms_inv(x, a.DP, a.p_eps, s.red);
    for (int k = threadIdx.x; k < a.DP; k += THREADS)
      v.xb[(size_t)b * a.DP + k] = __float2bfloat16_rn(
          __fmul_rn(__fmul_rn(ld_bf<true>(x + k), inv), a.pfn[k]));
  }
  __syncthreads();
  const int win = tok - 1;
  const int8_t* W = a.phead_q + (size_t)win * WINDOW * a.DP;
  const float* S = a.phead_s + (size_t)win * WINDOW;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* out = a.taps == nullptr || lane >= NB
                   ? nullptr
                   : a.taps + (((size_t)(lane0 + lane) * a.F + f) *
                                   (N_TOKENS - 1) + win) * WINDOW;
  float bv[NB];
  int bi[NB];
#pragma unroll
  for (int b = 0; b < NB; ++b) {
    bv[b] = -INFINITY;
    bi[b] = INT_MAX;
  }
  for (int row = p.rank * WARPS + warp; row < WINDOW;
       row += p.nblk * WARPS) {
    float lg[NB];
    i8_rows_dot<NB>(W + (size_t)row * a.DP, v.xb, a.DP, lg);
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      lg[b] = __fmul_rn(lg[b], S[row]);
      if (lg[b] > bv[b]) {          // rows rise: the first max is kept
        bv[b] = lg[b];
        bi[b] = row;
      }
    }
    if (out != nullptr) out[row] = pick(lg, lane);
  }
  if (lane == 0)
#pragma unroll
    for (int b = 0; b < NB; ++b) {
      s.bv[warp * NB + b] = bv[b];
      s.bi[warp * NB + b] = bi[b];
    }
  __syncthreads();
  if (threadIdx.x < NB) {
    const int b = threadIdx.x;
    float best = s.bv[b];
    int at = s.bi[b];
    for (int w = 1; w < WARPS; ++w)
      if (better(s.bv[w * NB + b], s.bi[w * NB + b], best, at)) {
        best = s.bv[w * NB + b];
        at = s.bi[w * NB + b];
      }
    const size_t slot = (size_t)(lane0 + b) * gridDim.x + p.rank;
    a.best_v[slot] = best;
    a.best_i[slot] = at;
  }
}

// x = bf16(sum_q ctab_fb[q][code_q] (f32, q in order) + tts_pad) for the
// block's lanes; code15: their last codes.
template <int NB>
__device__ void feedback(const Args& a, int f, const int* code15,
                         const Part& p) {
  for (int b = 0; b < NB; ++b) {
    const int ln = p.tile * NB + b;
    const int* cr = a.codes + ((size_t)ln * a.F + f) * N_TOKENS;
    int code[N_TOKENS];
#pragma unroll
    for (int q = 0; q < N_TOKENS; ++q) {
      const int c = q < N_TOKENS - 1 ? __ldcg(cr + q) : code15[b];
      code[q] = min(max(c, 0), a.R_fb - 1);
    }
    for (int k = p.rank * THREADS + threadIdx.x; k < a.D;
         k += p.nblk * THREADS) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < N_TOKENS; ++q) {
        const size_t i = ((size_t)q * a.R_fb + code[q]) * a.D + k;
        s = __fadd_rn(s, a.fb_bf16
                             ? bf2f(static_cast<const bf16*>(a.ctab_fb)[i])
                             : static_cast<const float*>(a.ctab_fb)[i]);
      }
      a.x[(size_t)ln * a.D + k] = __float2bfloat16_rn(__fadd_rn(s, a.tts_pad[k]));
    }
  }
}

// xtaps[lane, f, slot] = x of every lane (the talker's residual entering
// layer `slot`, or the last layer's output at slot L), when asked for: x
// is only read in the phase that calls this.
__device__ void tap_x(const Args& a, int f, int slot) {
  if (a.xtaps == nullptr) return;
  const int n = a.B * a.D;
  for (int i = blockIdx.x * THREADS + threadIdx.x; i < n;
       i += gridDim.x * THREADS) {
    const int b = i / a.D, k = i % a.D;
    a.xtaps[(((size_t)b * a.F + f) * (a.L + 1) + slot) * a.D + k] =
        __float2bfloat16_rn(ld_bf<true>(a.x + i));
  }
}

// hidden = RMSNorm(x, tfn) in f32 (the tile's first block writes it out);
// logits[n] = (bf16(hidden) . chead_q[n]) * chead_s[n] for n < V, for the
// block's lanes.
template <int NB>
__device__ void codec_head(const Args& a, const Views<NB>& v, const Part& p,
                           float* red) {
  const int lane0 = p.tile * NB;
  for (int b = 0; b < NB; ++b) {
    const bf16* x = a.x + (size_t)(lane0 + b) * a.D;
    const float inv = rms_inv(x, a.D, a.t_eps, red);
    for (int k = threadIdx.x; k < a.D; k += THREADS) {
      const float h = __fmul_rn(__fmul_rn(ld_bf<true>(x + k), inv), a.tfn[k]);
      v.xb[(size_t)b * a.D + k] = __float2bfloat16_rn(h);
      if (p.rank == 0) a.hidden_out[(size_t)(lane0 + b) * a.D + k] = h;
    }
  }
  __syncthreads();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int row = p.rank * WARPS + warp; row < a.V; row += p.nblk * WARPS) {
    float acc[NB];
    i8_rows_dot<NB>(a.chead_q + (size_t)row * a.D, v.xb, a.D, acc);
    if (lane < NB)
      a.logits_out[(size_t)(lane0 + lane) * a.V + row] =
          __fmul_rn(pick(acc, lane), a.chead_s[row]);
  }
}

// The launch: F frames of every phase, NB lanes per row tile.
template <int NB>
__device__ void run(const Args& a, const Views<NB>& v, Small<NB>& s) {
  const Part p = partition(a.B / NB);
  unsigned target = 0;             // bar[0] at the next barrier
  if (a.trace != nullptr && blockIdx.x == 0 && threadIdx.x == 0)
    a.trace[0] = clock64();
  const int start = a.write_idx[0];
  const int GRP = qtts::W4_GROUP;
  const int lane0 = p.tile * NB;
  // predictor and talker matrix sizes
  const int pnqkv = (a.PH + 2 * a.PHkv) * PDH;
  const int nqkv = (a.H + 2 * a.Hkv) * TDH, dq = a.H * TDH;
  const int DP = a.DP, D = a.D;

  for (int f = 0; f < a.F; ++f) {
    sample_project<NB>(a, f, v, p, s);
    grid_sync(a.barrier, target, a.trace);

    // ---- predictor: 16 tokens x LP layers
    for (int tok = 0; tok < N_TOKENS; ++tok) {
      for (int l = 0; l < a.LP; ++l) {
        Rows in{a.px, nullptr, lane0};
        if (l == 0 && tok >= 1) in = token_rows<NB>(a, f, tok, p, s);
        gemv<NB, 1, true, EPI_STORE, float>(
            in, a.p_ln1 + (size_t)l * DP, a.p_eps, DP,
            a.p_wqkv_q + (size_t)l * pnqkv * (DP / 2),
            a.p_wqkv_s + (size_t)l * pnqkv * (DP / GRP), pnqkv, a.pqkv, v,
            p, s.red);
        grid_sync(a.barrier, target, a.trace);
        pred_attn_wo<NB>(a, tok, l, v, p, s.red);
        grid_sync(a.barrier, target, a.trace);
        gemv<NB, 2, true, EPI_SWIGLU, float>(
            Rows{a.px, nullptr, lane0}, a.p_ln2 + (size_t)l * DP, a.p_eps,
            DP, a.p_gu_q + (size_t)l * 2 * a.PFF * (DP / 2),
            a.p_gu_s + (size_t)l * 2 * a.PFF * (DP / GRP), a.PFF, a.pff, v,
            p, s.red);
        grid_sync(a.barrier, target, a.trace);
        gemv<NB, 1, false, EPI_RESID, float>(
            Rows{a.pff, nullptr, lane0}, nullptr, a.p_eps, a.PFF,
            a.p_dn_q + (size_t)l * DP * (a.PFF / 2),
            a.p_dn_s + (size_t)l * DP * (a.PFF / GRP), DP, a.px, v, p,
            s.red);
        grid_sync(a.barrier, target, a.trace);
      }
      if (tok >= 1) {
        pred_head<NB>(a, f, tok, v, p, s);
        grid_sync(a.barrier, target, a.trace);
      }
    }

    // ---- feedback (code_15 is the last window's argmax)
    lane_argmax<NB>(a, p, s);
    if (threadIdx.x < NB && p.rank == 0)
      a.codes[((size_t)(lane0 + threadIdx.x) * a.F + f) * N_TOKENS +
              N_TOKENS - 1] = s.code[threadIdx.x];
    feedback<NB>(a, f, s.code, p);
    grid_sync(a.barrier, target, a.trace);

    // ---- talker step
    for (int l = 0; l < a.L; ++l) {
      tap_x(a, f, l);
      gemv<NB, 1, true, EPI_STORE, bf16>(
          Rows{a.x, nullptr, lane0}, a.t_ln1 + (size_t)l * D, a.t_eps, D,
          a.t_wqkv_q + (size_t)l * nqkv * (D / 2),
          a.t_wqkv_s + (size_t)l * nqkv * (D / GRP), nqkv, a.qkv, v, p,
          s.red);
      grid_sync(a.barrier, target, a.trace);
      talker_attn(a, f, l, start, v.tw);
      grid_sync(a.barrier, target, a.trace);
      gemv<NB, 1, false, EPI_RESID, bf16>(
          Rows{a.ctx, nullptr, lane0}, nullptr, a.t_eps, dq,
          a.t_wo_q + (size_t)l * D * (dq / 2),
          a.t_wo_s + (size_t)l * D * (dq / GRP), D, a.x, v, p, s.red);
      grid_sync(a.barrier, target, a.trace);
      gemv<NB, 2, true, EPI_SWIGLU, bf16>(
          Rows{a.x, nullptr, lane0}, a.t_ln2 + (size_t)l * D, a.t_eps, D,
          a.t_gu_q + (size_t)l * 2 * a.FF * (D / 2),
          a.t_gu_s + (size_t)l * 2 * a.FF * (D / GRP), a.FF, a.ff, v, p,
          s.red);
      grid_sync(a.barrier, target, a.trace);
      gemv<NB, 1, false, EPI_RESID, bf16>(
          Rows{a.ff, nullptr, lane0}, nullptr, a.t_eps, a.FF,
          a.t_dn_q + (size_t)l * D * (a.FF / 2),
          a.t_dn_s + (size_t)l * D * (a.FF / GRP), D, a.x, v, p, s.red);
      grid_sync(a.barrier, target, a.trace);
    }
    tap_x(a, f, a.L);
    codec_head<NB>(a, v, p, s.red);
    grid_sync(a.barrier, target, a.trace);
  }
  grid_exit(a.barrier);
}

// Byte offset of p_wo's predictor attention scratch in the batched form's
// dynamic shared memory: after the int8 rows and the staged contexts.
__host__ __device__ inline size_t pred_attn_offset(const Args& a) {
  return (size_t)ROWS * a.kmax + (size_t)2 * ROWS * a.PH * PDH;
}

// Bytes of dynamic shared memory of the batched form: the largest of its
// phases' regions (Views).
size_t smem_bytes(const Args& a) {
  const size_t gemv = std::max(
      (size_t)3 * ROWS * a.kmax + (size_t)4 * a.gd_ints + 4 * ROWS,
      pred_attn_offset(a) + 4 * pred_attn_floats(ROWS * a.PHkv));
  const size_t proj = (size_t)4 * ROWS * a.D;
  const size_t head = (size_t)2 * ROWS * std::max(a.D, a.DP);
  const size_t ta = WARPS * sizeof(TalkWarp);
  return std::max({gemv, proj, head, ta});
}

}  // namespace rows

// B = 8-32 lanes in row tiles of ROWS: dynamic shared memory
// (rows::smem_bytes), one block per SM at full width.
__global__ void __launch_bounds__(THREADS, 1) chunk_kernel_rows(const Args a) {
  extern __shared__ __align__(16) unsigned char dyn[];
  __shared__ rows::Small<ROWS> s;
  rows::Views<ROWS> v;
  v.xq = reinterpret_cast<int8_t*>(dyn);
  v.xs = reinterpret_cast<bf16*>(dyn + (size_t)ROWS * a.kmax);
  v.gd = reinterpret_cast<int*>(dyn + (size_t)3 * ROWS * a.kmax);
  v.sx = reinterpret_cast<float*>(v.gd + a.gd_ints);
  v.h = reinterpret_cast<float*>(dyn);
  v.xb = reinterpret_cast<bf16*>(dyn);
  v.tw = reinterpret_cast<TalkWarp*>(dyn);
  v.pa = reinterpret_cast<float*>(dyn + rows::pred_attn_offset(a));
  rows::run<ROWS>(a, v, s);
}

}  // namespace

// ptrs / ints / flts in the order of kernels/chunk_step.gen_chunk_fused;
// info (host) gets the grid: blocks, blocks per SM.
extern "C" int qtts_chunk_step(void* const* ptrs, int n_ptrs,
                               const int* ints, int n_ints,
                               const float* flts, int n_flts, int* info,
                               void* stream) {
  if (n_ptrs != N_PTRS || n_ints != N_INTS || n_flts != N_FLTS)
    return (int)cudaErrorInvalidValue;
  Args a;
  int i = 0;
  auto P = [&]() { return ptrs[i++]; };
  a.logits = (const float*)P(); a.hidden = (const float*)P();
  a.cos = (const float*)P(); a.sin = (const float*)P();
  a.u = (const float*)P(); a.lengths = (const int*)P();
  a.write_idx = (const int*)P();
  a.t_ln1 = (const float*)P(); a.t_ln2 = (const float*)P();
  a.t_qn = (const float*)P(); a.t_kn = (const float*)P();
  a.t_wqkv_q = (const uint8_t*)P(); a.t_wqkv_s = (const bf16*)P();
  a.t_wo_q = (const uint8_t*)P(); a.t_wo_s = (const bf16*)P();
  a.t_gu_q = (const uint8_t*)P(); a.t_gu_s = (const bf16*)P();
  a.t_dn_q = (const uint8_t*)P(); a.t_dn_s = (const bf16*)P();
  a.cache_k = (bf16*)P(); a.cache_v = (bf16*)P();
  a.tfn = (const float*)P(); a.chead_q = (const int8_t*)P();
  a.chead_s = (const float*)P(); a.proj_w = (const float*)P();
  a.proj_b = (const float*)P(); a.tts_pad = (const float*)P();
  a.ctab_fb = P(); a.ctab_pred = (const bf16*)P();
  a.pfn = (const float*)P(); a.phead_q = (const int8_t*)P();
  a.phead_s = (const float*)P(); a.pcos = (const float*)P();
  a.psin = (const float*)P();
  a.p_ln1 = (const float*)P(); a.p_ln2 = (const float*)P();
  a.p_qn = (const float*)P(); a.p_kn = (const float*)P();
  a.p_wqkv_q = (const uint8_t*)P(); a.p_wqkv_s = (const float*)P();
  a.p_wo_q = (const uint8_t*)P(); a.p_wo_s = (const float*)P();
  a.p_gu_q = (const uint8_t*)P(); a.p_gu_s = (const float*)P();
  a.p_dn_q = (const uint8_t*)P(); a.p_dn_s = (const float*)P();
  a.codes = (int*)P(); a.logits_out = (float*)P();
  a.hidden_out = (float*)P(); a.taps = (float*)P();
  a.xtaps = (bf16*)P();
  a.x = (bf16*)P(); a.qkv = (bf16*)P(); a.ctx = (bf16*)P();
  a.ff = (bf16*)P(); a.px = (bf16*)P(); a.pqkv = (bf16*)P();
  a.pff = (bf16*)P(); a.pk = (bf16*)P(); a.pv = (bf16*)P();
  a.part = (float*)P(); a.arrive = (unsigned*)P();
  a.best_v = (float*)P(); a.best_i = (int*)P();
  a.barrier = (unsigned*)P(); a.trace = (long long*)P();
  int j = 0;
  a.F = ints[j++]; a.L = ints[j++]; a.D = ints[j++]; a.H = ints[j++];
  a.Hkv = ints[j++]; a.t_dh = ints[j++]; a.FF = ints[j++]; a.C = ints[j++];
  a.prompt_cap = ints[j++]; a.LP = ints[j++]; a.DP = ints[j++];
  a.PH = ints[j++]; a.PHkv = ints[j++]; a.p_dh = ints[j++];
  a.PFF = ints[j++]; a.R_fb = ints[j++]; a.R_pd = ints[j++];
  a.V = ints[j++]; a.fb_bf16 = ints[j++]; a.max_blocks_per_sm = ints[j++];
  a.B = ints[j++];
  a.t_eps = flts[0]; a.p_eps = flts[1]; a.temperature = flts[2];
  a.top_k = flts[3]; a.top_p = flts[4]; a.t_scale = flts[5];
  a.p_scale = flts[6];

  const int g2 = 2 * qtts::W4_GROUP;
  // the JAX gate: 1 lane, 8 or 16 at F <= 8, 24 or 32 at F <= 4
  const bool batch_ok =
      a.B == 1 || (a.B % ROWS == 0 && a.B <= MAX_B &&
                   (a.B <= 16 || a.F <= 4));
  const bool ok =
      batch_ok && a.F >= 1 && a.F <= MAX_FRAMES && a.L >= 1 && a.LP >= 1 &&
      a.t_dh == TDH && a.p_dh == PDH && a.Hkv > 0 && a.H % a.Hkv == 0 &&
      a.H / a.Hkv <= CG && a.PHkv > 0 && a.PH % a.PHkv == 0 &&
      a.PH / a.PHkv <= CG && a.D % g2 == 0 && a.D <= MAX_D &&
      a.DP % g2 == 0 && a.DP <= MAX_D && a.FF % g2 == 0 && a.FF <= MAX_K &&
      a.PFF % g2 == 0 && a.PFF <= MAX_K && (a.H * TDH) % g2 == 0 &&
      a.H * TDH <= MAX_K && (a.PH * PDH) % g2 == 0 && a.PH * PDH <= MAX_K &&
      a.C > 0 && a.V > 0 && a.V <= MAX_V && a.R_fb > 0 && a.R_pd > 0 &&
      a.max_blocks_per_sm >= 1 &&
      // one lane: the predictor attention's scratch after the staged row
      4 * pred_attn_floats(a.PHkv) <= (size_t)2 * (MAX_K - a.PH * PDH);
  if (!ok) return (int)cudaErrorInvalidValue;

  // the batched form's shared memory: ROWS rows of the widest GEMV input,
  // and the group dots of the widest R * K (gate_up: R = 2)
  a.kmax = std::max({a.D, a.H * TDH, a.FF, a.DP, a.PH * PDH, a.PFF});
  a.gd_ints = WARPS * ROWS * std::max(a.kmax, 2 * std::max(a.D, a.DP)) /
              qtts::W4_GROUP;
  const bool rows = a.B > 1;
  const size_t smem = rows ? rows::smem_bytes(a) : 0;
  const void* kernel = rows ? (const void*)chunk_kernel_rows
                            : (const void*)chunk_kernel;

  int dev = 0, sms = 0, coop = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
  if (e == cudaSuccess && rows) e = qtts::allow_smem(chunk_kernel_rows, smem);
  if (e == cudaSuccess)
    e = rows ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &per_sm, chunk_kernel_rows, THREADS, smem)
             : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                   &per_sm, chunk_kernel, THREADS, 0);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  per_sm = min(per_sm, a.max_blocks_per_sm);   // the scratch's slots
  // every lane needs a block for its sampler
  if (per_sm < 1 || per_sm * sms < a.B)
    return (int)cudaErrorCooperativeLaunchTooLarge;
  info[0] = per_sm * sms;
  info[1] = per_sm;
  void* params[] = {(void*)&a};
  e = cudaLaunchCooperativeKernel(kernel, dim3(per_sm * sms), dim3(THREADS),
                                  params, smem,
                                  static_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

extern "C" int qtts_sample_threshold(const float* logits, const float* u,
                                     int* out, int B, int V, float temp,
                                     float top_k, float top_p,
                                     void* stream) {
  if (B < 1 || V < 1 || V > MAX_V) return (int)cudaErrorInvalidValue;
  sample_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      logits, u, out, V, temp, top_k, top_p);
  return (int)cudaGetLastError();
}
